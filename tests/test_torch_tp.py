"""The port's tensor-parallel (DP+TP) semseg training against the JAX
package's.

Two gloo worlds of spawned ranks (tests/torch_mesh_worlds.train_tp_cases):
2 ranks on a (1, 2) ('data', 'model') mesh and 4 on (2, 2), the
reduced-depth model (stage sizes (1,1,1,1)) at full channel widths, on
the global batch of 2 images at 16x32 of tests/test_torch_mesh_train.py.
The JAX side runs models/train.make_train_setup on the same meshes of
its CPU devices; its initial weights reach the port by name
(export_named_tensors -> models/semseg.load_named_tensors into a
one-device model, whose state dict the TP model loads through
models/train.shard_named). Float32 on
both sides. Tolerances, as test_torch_mesh_train.py holds data
parallelism: step-1 loss rtol 1e-5; step-1 gradients, gathered to full,
rtol 1e-4 with atol GRAD_FLOOR * max|g| per tensor; running statistics
after step 1 rtol 1e-5 with atol 1e-5 * max|stat|; three steps' losses
rtol 1e-4 against JAX's one-device trainer, and against JAX's trainer on
the same mesh within twice the distance between JAX's own one-device and
mesh losses (at least 1e-4); parameters within 2 * lr * steps. The port's
TP step is held to its one-device step the same way. Checkpoints move
between layouts bit-exactly.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pc_accumulation_lib_tpu.models import onnx_port as jport
from pc_accumulation_lib_tpu.models import train as jtrain
from pc_accumulation_lib_tpu.models.resnet_semseg import (
    ResNet50DilatedFCN as FlaxFCN)
from pc_accumulation_lib_tpu_torch.models import resnet_semseg as tres
from pc_accumulation_lib_tpu_torch.models import train as ttrain
from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun

import torch_mesh_worlds as w

GRAD_FLOOR = 5e-5
RUN_TP_RTOL = 1e-3          # test_torch_mesh_train.RUN_TP_RTOL's comment
LAYOUTS = ((1, 2), (2, 2))
# The full-depth model's parameters and those of one TP rank (counted
# from the layer shapes: 31,967,232 of the 32,975,219 lie in convs of at
# least 256 output channels and their batch norms).
FULL_PARAMS = 32_975_219
PARAMS_PER_RANK = {2: 16_991_603, 4: 8_999_795}


def _shards(root):
    rng = np.random.default_rng(4)
    for s in range(2):
        labels = rng.integers(0, 19, (5, *w.TRAIN_HW)).astype(np.uint8)
        labels[0] = 255
        np.savez(os.path.join(root, f'shard{s}.npz'),
                 images=rng.integers(0, 256, (5, *w.TRAIN_HW, 3), np.uint8),
                 labels=labels)
    return os.path.join(root, 'shard*.npz')


def _jax_run(layout):
    """JAX make_train_setup on a ``layout`` mesh: initial named tensors,
    losses; on a mesh above one device also step-1 named gradients,
    running statistics after step 1, named tensors after step 3."""
    n = layout[0] * layout[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(layout),
                ('data', 'model'))
    state, step = jtrain.make_train_setup(
        mesh, lr=w.TRAIN_LR, img_hw=w.TRAIN_HW, seed=0,
        stage_sizes=w.TRAIN_STAGES, dtype=jnp.float32)
    named = jport.export_named_tensors(state.variables)
    out = {'named': named, 'losses': []}
    if layout != (1, 1):
        model = FlaxFCN(stage_sizes=w.TRAIN_STAGES, dtype=jnp.float32)

        def loss_fn(params, batch_stats, images, labels):
            logits, _ = model.apply(
                {'params': params, 'batch_stats': batch_stats}, images,
                train=True, mutable=['batch_stats'])
            return jtrain.cross_entropy_loss(logits, labels)

        images, labels = w.train_batch(0)
        grads = jax.jit(jax.grad(loss_fn))(
            state.variables['params'], state.variables['batch_stats'],
            jnp.asarray(images), jnp.asarray(labels))
        out['grads'] = jport.export_named_tensors({'params': grads})
    for i in range(w.TRAIN_STEPS):
        images, labels = w.train_batch(i)
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        out['losses'].append(float(loss))
        if layout == (1, 1):
            continue
        if i == 0:
            out['stats'] = {k: v for k, v in jport.export_named_tensors(
                state.variables).items() if 'running' in k}
        if i == w.TRAIN_STEPS - 1:
            out['after'] = jport.export_named_tensors(state.variables)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('tp')
    data_glob = _shards(str(base))
    jax_runs = {layout: _jax_run(layout) for layout in ((1, 1),) + LAYOUTS}
    named_path = str(base / 'named.npz')
    np.savez(named_path, **jax_runs[LAYOUTS[0]]['named'])
    port = {}
    for dp, tp in LAYOUTS:
        n = dp * tp
        world = base / f'world{n}'
        world.mkdir()
        w.spawn_world('train_tp_cases', n, world, named_path, data_glob)
        port[(dp, tp)] = [w.load(world, f'tp{n}_r{r}') for r in range(n)]
    _, single = trun.run(data_glob, steps=3, batch_size=2,
                         ckpt_dir=str(base / 'ckpt_single'), ckpt_every=0,
                         stage_sizes=w.TRAIN_STAGES, log_every=3,
                         device='cpu')
    return dict(jax=jax_runs, port=port, single=single)


def _hold_step1(port, want):
    """Step 1 of ``port`` (loss, gathered gradients, running statistics)
    against ``want``'s."""
    np.testing.assert_allclose(port['losses'][0], want['losses'][0],
                               rtol=1e-5)
    assert len(want['stats']) == 2 * 20
    for k, v in want['stats'].items():
        np.testing.assert_allclose(port['stats'][k], v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    assert set(port['grads']) == set(want['grads'])
    for k, g in want['grads'].items():
        np.testing.assert_allclose(port['grads'][k], g, rtol=1e-4,
                                   atol=GRAD_FLOOR * np.abs(g).max(),
                                   err_msg=k)


def _hold_params(port, want_after):
    for k in port['grads']:                   # the parameters
        diff = np.abs(port['after'][k] - want_after[k])
        assert diff.max() <= 2 * w.TRAIN_LR * w.TRAIN_STEPS, (k, diff.max())


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_first_step_matches_jax(runs, layout):
    _hold_step1(runs['port'][layout][0], runs['jax'][layout])


def _float32_floor(runs, layout):
    """The rtol of three float32 steps' losses on ``layout`` against
    another layout: twice the distance between JAX's own one-device and
    ``layout`` losses, at least 1e-4 (Adam's first step turns gradients
    at the float32 floor into different weights on two layouts)."""
    j1 = np.array(runs['jax'][(1, 1)]['losses'])
    jm = np.array(runs['jax'][layout]['losses'])
    return max(1e-4, 2 * np.max(np.abs(jm - j1) / np.abs(j1)))


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_three_steps_match_jax(runs, layout):
    port = runs['port'][layout][0]
    np.testing.assert_allclose(port['losses'], runs['jax'][(1, 1)]['losses'],
                               rtol=1e-4)
    np.testing.assert_allclose(port['losses'], runs['jax'][layout]['losses'],
                               rtol=_float32_floor(runs, layout))
    _hold_params(port, runs['jax'][layout]['after'])


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_matches_one_device_step(runs, layout):
    """The port's TP step against its one-device step from the same
    weights and batches, under the same tolerances."""
    port = runs['port'][layout][0]
    _hold_step1(port, port['one'])
    np.testing.assert_allclose(port['losses'], port['one']['losses'],
                               rtol=1e-4)
    _hold_params(port, port['one']['after'])


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_ranks_consistent(runs, layout):
    """shard_variables keeps rank r's rows of the loaded tensors;
    replicated tensors stay bit-equal across every rank after each step,
    and their gradients across the model ranks of a data rank before the
    step's collectives; every rank reports the same losses."""
    ranks = runs['port'][layout]
    assert len(ranks[0]['sharded']) == 13 * 5   # 13 convs, 4 of each BN
    for r in ranks:
        assert r['sharded'] == ranks[0]['sharded']
        assert r['unsliced'] == []
        assert r['losses'] == ranks[0]['losses']
    r0 = ranks[0]
    assert r0['grads_unequal'] == []
    for i in range(w.TRAIN_STEPS):
        assert r0[f'replicas_unequal_{i}'] == []


def test_param_spec_matches_jax():
    """The port's rule shards exactly the tensors that JAX param_spec
    shards, by name over the whole full-depth model."""
    model = FlaxFCN(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 128, 3)), train=False))
    flags = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.broadcast_to(
            np.float32(jtrain.param_spec(path, leaf) != jax.sharding
                       .PartitionSpec()), leaf.shape), shapes)
    jax_sharded = {k for k, v in jport.export_named_tensors(flags).items()
                   if v.flat[0]}
    port = tres.ResNet50DilatedFCN()
    state = port.state_dict()
    port_sharded = {k for k, v in state.items() if ttrain.param_spec(k, v)}
    assert port_sharded == jax_sharded
    assert len(port_sharded) == 39 * 5       # 39 convs, 4 of each one's BN
    assert all('num_batches_tracked' not in k for k in port_sharded)


def _fake_mesh(tp, rank=0):
    return types.SimpleNamespace(mesh_dim_names=('data', 'model'),
                                 size=lambda dim: (1, tp)[dim],
                                 get_local_rank=lambda axis: rank)


@pytest.mark.parametrize('tp', sorted(PARAMS_PER_RANK))
def test_params_per_rank_at_full_depth(tp):
    model = tres.ResNet50DilatedFCN()
    assert sum(p.numel() for p in model.parameters()) == FULL_PARAMS
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    ttrain.shard_variables(model, _fake_mesh(tp, rank=tp - 1))
    assert sum(p.numel() for p in model.parameters()) == PARAMS_PER_RANK[tp]
    for k, v in model.state_dict().items():
        if k in model.model_axis.sharded:
            assert v.shape == (shapes[k][0] // tp, *shapes[k][1:]), k
        else:
            assert v.shape == shapes[k], k


def test_tp_3_raises():
    model = tres.ResNet50DilatedFCN(stage_sizes=w.TRAIN_STAGES)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="'model' axis of 3 does not "
                       'divide.*param_spec'):
        ttrain.shard_variables(model, _fake_mesh(3))
    assert model.model_axis is None
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_checkpoints_are_layout_free(runs, layout):
    """A TP checkpoint restored on one device equals the TP state,
    gathered (weights, running statistics, Adam moments), bit for bit;
    saved there and restored into TP, it equals the TP state, rank by
    rank; the restored states go on training as the original does."""
    ranks = runs['port'][layout]
    r0 = ranks[0]
    assert r0['ckpt_files'] == [str(w.TRAIN_STEPS)]
    assert r0['one_restored'] == (w.TRAIN_STEPS, [])
    for r in ranks:
        assert r['back'] == (w.TRAIN_STEPS, [], [])
        loss, loss_back = r['next']
        assert loss == loss_back
        assert r['next_unequal'] == []
    np.testing.assert_allclose(r0['one_restored_next'], r0['next'][0],
                               rtol=1e-5)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_weights_load_on_one_device(runs, layout):
    """save_semseg_weights of a TP model writes the full tensors, which
    load_semseg_model reads into a one-device model."""
    assert runs['port'][layout][0]['weights_unequal'] == []


@pytest.mark.parametrize('layout', LAYOUTS)
def test_tp_export_named_tensors_gathers(runs, layout):
    """export_named_tensors of a TP model, called on every rank, gives
    the full tensors under their names, batch-norm step counters left
    out."""
    assert runs['port'][layout][0]['export_unequal'] == []


@pytest.mark.parametrize('layout', LAYOUTS)
def test_train_semseg_run_takes_jax_layout(runs, layout):
    """train_semseg.run with no dp lays 2 ranks out as (1, 2) and 4 as
    (2, 2), the JAX runner's default; one set of checkpoints; the global
    losses of one process's run: step 1 at rtol 1e-5, the three at
    test_torch_mesh_train.RUN_TP_RTOL (its comment)."""
    ranks = runs['port'][layout]
    for r in ranks:
        assert r['run']['layout'] == layout
        assert r['run']['step'] == 3
        assert r['run']['losses'] == ranks[0]['run']['losses']
        assert r['run']['ckpts'] == ['2', '3']
    np.testing.assert_allclose(ranks[0]['run']['losses'][0],
                               runs['single'][0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]['run']['losses'], runs['single'],
                               rtol=RUN_TP_RTOL)
