"""The port's ONNX reader and weight loader against the JAX package's.

A real exporter-named graph: the torch twin (tests/torch_semseg_twin.py)
at stage sizes (1,1,1,1), exported at 48x96 with torch's legacy exporter
(tests/test_onnx_port._export_twin_onnx, no ``onnx`` package needed).

Checked, with the tolerances held here:
  * the port's onnx_pb reads the same initializers and nodes as the JAX
    package's, bit-exact, and its writer's files read back the same way;
  * the port's load against JAX load_onnx_variables + the Flax forward at
    precision 'highest': logits within 2e-2, argmax agreement >= 99.8%
    (README's ONNX-port rule); against the twin itself: max abs 1e-4;
  * the structural fallback on a name-mangled file and on the
    dynamo-exporter-style graph: the same weights as the by-name load;
  * JAX variables -> export_named_tensors -> onnx_pb.write_initializers
    -> load_semseg_model: the Flax model's logits within 1e-4;
  * a truncated or malformed .onnx raises; a missing path gives random
    weights and the warning; weight files round-trip exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.models import onnx_pb as jpb
from pc_accumulation_lib_tpu.models import onnx_port as jport
from pc_accumulation_lib_tpu.models.resnet_semseg import (
    ResNet50DilatedFCN as FlaxFCN)
from pc_accumulation_lib_tpu.models.resnet_semseg import init_params
from pc_accumulation_lib_tpu_torch.models import checkpoint as tckpt
from pc_accumulation_lib_tpu_torch.models import onnx_pb as tpb
from pc_accumulation_lib_tpu_torch.models import onnx_port as tport
from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    ResNet50DilatedFCN)
from pc_accumulation_lib_tpu_torch.models.semseg import (
    SemSegTorch, load_named_tensors, load_semseg_model)
from test_onnx_port import _export_twin_onnx, _to_dynamo_universe
from torch_semseg_twin import TorchResNet50DilatedFCN, randomize_

STAGES = (1, 1, 1, 1)
H, W = 48, 96


def _port_model(path=None):
    net = ResNet50DilatedFCN(stage_sizes=STAGES).eval()
    if path is not None:
        tport.load_onnx_weights(path, net)
    return net


def _state(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope='module')
def twin(tmp_path_factory):
    """The exported twin: (twin module, image, .onnx path, twin logits)."""
    net = TorchResNet50DilatedFCN(stage_sizes=STAGES).eval()
    randomize_(net, seed=4)
    img = np.random.default_rng(1).integers(0, 255, (1, H, W, 3)).astype(
        np.float32)
    path = str(tmp_path_factory.mktemp('onnx') / 'twin.onnx')
    _export_twin_onnx(net, img, path)
    with torch.no_grad():
        logits = net(torch.from_numpy(img)).numpy()
    return net, img, path, logits


@pytest.fixture(scope='module')
def by_name(twin):
    """The port's model loaded by name from the twin's file."""
    return _state(_port_model(twin[2]))


def _dynamo_file(path, out):
    named, nodes = tpb.read_graph(path)
    d_named, d_nodes = _to_dynamo_universe(named, nodes)
    tpb.write_graph(out, d_named, d_nodes)
    return out


def _typed_file(path, out):
    named = {
        'i32': np.array([-1, -2147483648, 2147483647, 0], np.int32),
        'i64': np.array([-1, -(1 << 62), (1 << 62), 7], np.int64),
        'i8': np.array([-128, 127, -1], np.int8),
        'b': np.array([True, False, True], np.bool_),
        'f16': np.array([1.5, -2.25, 65504.0], np.float16),
        'f32': np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5,
        'f64': np.array([1e-300, -3.25], np.float64),
    }
    tpb.write_initializers(out, named, identities=[('f32', 'f32_alias')],
                           encoding='typed')
    return out


@pytest.mark.parametrize('make', [None, _dynamo_file, _typed_file],
                         ids=['torch_export', 'dynamo_graph', 'typed'])
def test_reader_matches_jax_reader(twin, tmp_path, make):
    """The port's reader against the JAX package's on the exporter's file
    and on files the port's writer made: same names, dtypes, values and
    nodes, bit-exact."""
    path = twin[2] if make is None else make(twin[2],
                                             str(tmp_path / 'f.onnx'))
    named_t, nodes_t = tpb.read_graph(path)
    named_j, nodes_j = jpb.read_graph(path)
    assert set(named_t) == set(named_j) and len(named_t) > 6
    for k in named_j:
        assert named_t[k].dtype == named_j[k].dtype, k
        np.testing.assert_array_equal(named_t[k], named_j[k], err_msg=k)
    assert nodes_t == nodes_j
    if make is None:
        sd = twin[0].state_dict()
        assert all(np.array_equal(named_t[k], v.numpy()) for k, v in
                   sd.items() if 'num_batches_tracked' not in k)


def test_load_matches_flax_and_twin(twin, by_name):
    _, img, path, t_logits = twin
    net = _port_model()
    net.load_state_dict(by_name)
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, t_logits, rtol=0, atol=1e-4)
    model = FlaxFCN(stage_sizes=STAGES, dtype=jnp.float32)
    template = init_params(model, jax.random.PRNGKey(0), img_hw=(H, W))
    variables = jport.load_onnx_variables(path, variables=template)
    with jax.default_matmul_precision('highest'):
        want = np.asarray(model.apply(variables, jnp.asarray(img),
                                      train=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.998


def _mangled_file(path, out):
    """Every initializer renamed to an opaque t<i>, node inputs to
    match."""
    named, nodes = tpb.read_graph(path)
    ren = {k: f't{i}' for i, k in enumerate(sorted(named))}
    tpb.write_graph(out, {ren[k]: v for k, v in named.items()},
                    [(op, [ren.get(x, x) for x in ins], outs)
                     for op, ins, outs in nodes])
    return out


@pytest.mark.parametrize('make', [_mangled_file, _dynamo_file],
                         ids=['mangled', 'dynamo'])
def test_structural_fallback(twin, by_name, tmp_path, make):
    path = make(twin[2], str(tmp_path / 'g.onnx'))
    named = tpb.read_graph(path)[0]
    with pytest.raises(KeyError):
        load_named_tensors(_port_model(), named, ignore_unused=True)
    _assert_same_state(_state(_port_model(path)), by_name)


def test_jax_variables_route(tmp_path):
    """Weights trained with the JAX package reach the port as an .onnx
    file of its export_named_tensors; prefixed names exercise the suffix
    rule."""
    model = FlaxFCN(stage_sizes=STAGES, dtype=jnp.float32)
    variables = init_params(model, jax.random.PRNGKey(3), img_hw=(H, W))
    named = jport.export_named_tensors(variables)
    rng = np.random.default_rng(5)
    for k in named:                     # non-trivial batch-norm tensors
        if k.endswith(('running_mean', 'bn1.bias', 'bn.bias')):
            named[k] = rng.normal(0, 0.1, named[k].shape).astype(np.float32)
        elif k.endswith('running_var'):
            named[k] = rng.uniform(0.5, 1.5, named[k].shape).astype(
                np.float32)
    variables = jport.convert_named_tensors(named, variables=variables)
    path = str(tmp_path / 'jax.onnx')
    jpb.write_initializers(path, {'model.' + k: v for k, v in named.items()})
    sem = load_semseg_model(path, stage_sizes=STAGES, device='cpu')
    img = np.random.default_rng(6).integers(0, 256, (2, H, W, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = sem.model(torch.from_numpy(img)).numpy()
    with jax.default_matmul_precision('highest'):
        want = np.asarray(model.apply(variables, jnp.asarray(img),
                                      train=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _truncated(tmp_path):
    path = tmp_path / 'bad.onnx'
    path.write_bytes(bytes([0x3A, 0x7F, 0x01]))   # graph, 127 B declared
    return str(path), 'truncated'


def _not_onnx(tmp_path):
    path = tmp_path / 'text.onnx'
    path.write_bytes(b'\x08\x07')                 # ir_version only
    return str(path), 'no graph initializers'


def _wrong_graph(tmp_path):
    path = str(tmp_path / 'wrong.onnx')
    tpb.write_graph(path, {'w': np.ones((4, 3, 3, 3), np.float32)},
                    [('Conv', ['x', 'w'], ['y'])])
    return path, 'by name .* and by structure'


@pytest.mark.parametrize('make', [_truncated, _not_onnx, _wrong_graph],
                         ids=['truncated', 'not_onnx', 'wrong_graph'])
def test_malformed_onnx_raises(tmp_path, make, capsys):
    path, match = make(tmp_path)
    with pytest.raises(ValueError, match=match):
        load_semseg_model(path, stage_sizes=STAGES, device='cpu')
    assert 'WARNING' not in capsys.readouterr().out


def test_unpacked_typed_floats_read(tmp_path):
    """UNPACKED repeated float_data (one fixed32 record per element)."""
    import struct
    tensor = (bytes([0x08, 0x02, 0x10, 0x01, 0x42, 0x01]) + b'w'
              + bytes([0x25]) + struct.pack('<f', 1.5)
              + bytes([0x25]) + struct.pack('<f', -2.0))
    graph = bytes([0x2A, len(tensor)]) + tensor
    path = tmp_path / 'unpacked.onnx'
    path.write_bytes(bytes([0x3A, len(graph)]) + graph)
    np.testing.assert_array_equal(tpb.read_initializers(str(path))['w'],
                                  np.array([1.5, -2.0], np.float32))


def test_missing_path_gives_random_weights(tmp_path, capsys):
    path = str(tmp_path / 'missing.onnx')
    sem = load_semseg_model(path, seed=2, stage_sizes=STAGES, device='cpu')
    assert 'not found' in capsys.readouterr().out
    _assert_same_state(sem.model.state_dict(), SemSegTorch(
        'cpu', seed=2, stage_sizes=STAGES).model.state_dict())
    load_semseg_model('', stage_sizes=STAGES, device='cpu')
    assert capsys.readouterr().out == ''


def test_weight_file_roundtrip(tmp_path, by_name):
    sem = SemSegTorch('cpu', seed=1, stage_sizes=STAGES)
    sem.model.load_state_dict(by_name)
    path = str(tmp_path / 'w.pt')
    tckpt.save_semseg_weights(sem, path)
    got = load_semseg_model(path, stage_sizes=STAGES, device='cpu')
    _assert_same_state(got.model.state_dict(), sem.model.state_dict())
    img = np.random.default_rng(7).integers(0, 256, (H, W, 3), np.uint8)
    np.testing.assert_array_equal(got(img), sem(img))


def test_suffix_lookup_and_its_errors(by_name):
    named = {k: v.numpy() for k, v in by_name.items()
             if 'num_batches_tracked' not in k}
    net = _port_model()
    load_named_tensors(net, {'m.' + k: v for k, v in named.items()})
    _assert_same_state(_state(net), by_name)
    twice = dict({'a.' + k: v for k, v in named.items()},
                 **{'b.decode_head.conv_seg.bias':
                    named['decode_head.conv_seg.bias']})
    with pytest.raises(KeyError, match=r'several for \[.decode_head'
                       r'.conv_seg.bias'):
        load_named_tensors(net, twice)
    bad = dict(named, **{'decode_head.conv_seg.weight':
                         named['decode_head.conv_seg.weight'][:, :8]})
    with pytest.raises(ValueError, match='shape mismatch for decode_head'):
        load_named_tensors(net, bad)
    _assert_same_state(_state(net), by_name)     # failed loads change none
