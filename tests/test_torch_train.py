"""The port's semseg training against the JAX package's.

The reduced-depth model (stage sizes (1,1,1,1)) on batch 2 at 16x32, so
that the deepest batch norms see 16 values per channel and torch's
unbiased n/(n-1) running variance would show. The JAX side is
models/train.make_train_setup on a 1x1 CPU mesh with float32 convs; its
initial weights are carried into the port by name (export_named_tensors
-> load_named_tensors). Tolerances, held here:
  * cross_entropy_loss: rtol 1e-6; an all-ignored batch gives 0;
  * step 1: loss rtol 1e-5; gradients by name rtol 1e-4 with atol
    GRAD_FLOOR * max|g| per tensor (the JAX side takes them with
    jax.value_and_grad); batch-norm running statistics rtol 1e-5 with
    atol 1e-5 * max|stat| per tensor (a running mean is a mean of
    activations that nearly cancel: 0.1 * a batch mean of ~1e-2 carries
    the float32 rounding of its ~1-sized terms, a few 1e-7);
    parameters 1e-6 wherever the gradient is 100x clear of that floor;
  * three steps: losses rtol 1e-4; no parameter differs by more than
    2 * lr * steps (Adam moves a weight by about lr per step whatever
    its gradient's size, so a gradient at the float32 floor can take
    either sign on either side: after three steps 14% of the port's own
    float32 parameters lie more than 1e-5 from its float64 run's).
Checkpoints round-trip bit-exactly; train_semseg.run draws the JAX
runner's batches.
"""
import os
import types

import flax.linen as fnn
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
from pc_accumulation_lib_tpu.runners import train_semseg as jrun
from pc_accumulation_lib_tpu_torch.models import checkpoint as tckpt
from pc_accumulation_lib_tpu_torch.models import resnet_semseg as tres
from pc_accumulation_lib_tpu_torch.models import train as ttrain
from pc_accumulation_lib_tpu_torch.models.semseg import load_named_tensors
from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun

STAGES = (1, 1, 1, 1)
HW = (16, 32)
LR = 1e-3
STEPS = 3
# The float32 floor of a step-1 gradient, as a share of its tensor's
# largest: the batch norms' backward over 16 values per channel puts
# either side's float32 gradients 0.7-2.3e-5 of max|g| from a float64 run
# of the port (the JAX model's batch norms are float32 even under x64).
GRAD_FLOOR = 5e-5


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, *HW, 3)).astype(np.float32)
    labels = rng.integers(0, 19, (2, *HW)).astype(np.int32)
    labels[0, :3] = 255
    return images, labels


def _port_setup(named=None, dtype=torch.float32):
    state, step = ttrain.make_train_setup(lr=LR, stage_sizes=STAGES,
                                          compute_dtype=dtype, device='cpu')
    state.model.to(dtype)               # float64: the gradient-parity run
    if named is not None:
        load_named_tensors(state.model, named)
    return state, step


def _named_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _jax_run(dtype):
    """JAX make_train_setup on a 1x1 CPU mesh, ``dtype`` convs and
    variables: (initial named tensors, step-1 named gradients, per-step
    losses, named tensors after step 1 and after the last step)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('data', 'model'))
    jstate, jstep = jtrain.make_train_setup(
        mesh, lr=LR, img_hw=HW, seed=0, stage_sizes=STAGES, dtype=dtype)
    variables = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                       jstate.variables)
    jstate = jstate._replace(variables=variables)
    model = FlaxFCN(stage_sizes=STAGES, dtype=dtype)

    def loss_fn(params, batch_stats, images, labels):
        logits, _ = model.apply(
            {'params': params, 'batch_stats': batch_stats}, images,
            train=True, mutable=['batch_stats'])
        return jtrain.cross_entropy_loss(logits, labels)

    named = jport.export_named_tensors(variables)
    images, labels = _batch(0)
    _, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables['params'], variables['batch_stats'],
        jnp.asarray(images, dtype), jnp.asarray(labels))
    grads = jport.export_named_tensors({'params': grads})
    losses, after = [], []
    for i in range(STEPS):
        images, labels = _batch(i)
        jstate, loss = jstep(jstate, jnp.asarray(images, dtype),
                             jnp.asarray(labels))
        losses.append(float(loss))
        if i in (0, STEPS - 1):
            after.append(jport.export_named_tensors(jstate.variables))
    return named, grads, losses, after


def _port_run(named, dtype):
    state, step = _port_setup(named, dtype)
    losses, after, grads = [], [], None
    for i in range(STEPS):
        images, labels = _batch(i)
        state, loss = step(state, torch.from_numpy(images).to(dtype),
                           torch.from_numpy(labels))
        losses.append(float(loss))
        if i == 0:
            grads = _named_grads(state.model)
        if i in (0, STEPS - 1):
            after.append({k: v.detach().numpy().copy()
                          for k, v in state.model.state_dict().items()})
    return grads, losses, after, state


@pytest.fixture(scope='module')
def runs():
    """Three steps on both sides from the JAX initial weights."""
    named, jgrads, jlosses, jafter = _jax_run(jnp.float32)
    tgrads, tlosses, tafter, state = _port_run(named, torch.float32)
    return dict(jgrads=jgrads, jlosses=jlosses, jafter=jafter,
                tgrads=tgrads, tlosses=tlosses, tafter=tafter, tstate=state)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 5, 7, 19)).astype(np.float32)
    labels = rng.integers(0, 19, (2, 5, 7)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = 255
    for lab in (labels, np.full_like(labels, 255)):
        want = float(jtrain.cross_entropy_loss(jnp.asarray(logits),
                                               jnp.asarray(lab)))
        got = float(ttrain.cross_entropy_loss(torch.from_numpy(logits),
                                              torch.from_numpy(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == 0.0 == want                 # all ignored: 0, not NaN


def test_first_step_matches_jax(runs):
    np.testing.assert_allclose(runs['tlosses'][0], runs['jlosses'][0],
                               rtol=1e-5)
    stats = [k for k in runs['jafter'][0] if 'running' in k]
    assert len(stats) == 2 * 20
    for k in stats:
        want = runs['jafter'][0][k]
        np.testing.assert_allclose(runs['tafter'][0][k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert set(runs['tgrads']) == set(runs['jgrads'])
    for k, g in runs['jgrads'].items():
        np.testing.assert_allclose(runs['tgrads'][k], g, rtol=1e-4,
                                   atol=GRAD_FLOOR * np.abs(g).max(),
                                   err_msg=k)


def test_three_steps_match_jax(runs):
    np.testing.assert_allclose(runs['tlosses'], runs['jlosses'], rtol=1e-4)
    assert runs['tstate'].step == STEPS
    for k, _ in runs['tstate'].model.named_parameters():
        # Adam's first step is lr * g / (|g| + eps) on both sides: equal
        # wherever the gradient stands clear of the float32 floor.
        g = runs['jgrads'][k]
        clear = np.abs(g) >= 100 * GRAD_FLOOR * np.abs(g).max()
        np.testing.assert_allclose(runs['tafter'][0][k][clear],
                                   runs['jafter'][0][k][clear], rtol=0,
                                   atol=1e-6, err_msg=k)
        diff = np.abs(runs['tafter'][1][k] - runs['jafter'][1][k])
        assert diff.max() <= 2 * LR * STEPS, (k, diff.max())


def test_bn_running_stats_are_flax_biased():
    """One train-mode batch-norm call against flax's BatchNorm(momentum
    0.9): the same output and running statistics, the running variance
    the biased one. torch's own BatchNorm2d stores the unbiased one."""
    x = np.random.default_rng(2).normal(1.0, 2.0, (2, 3, 2, 4)).astype(
        np.float32)                           # 16 values per channel
    bn = tres._BN(4).train()
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(2.0)
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    init = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {'params': init['params'], 'batch_stats': {
        'mean': jnp.full(4, 0.5), 'var': jnp.full(4, 2.0)}}
    want, upd = flax_bn.apply(variables, jnp.asarray(x),
                              mutable=['batch_stats'])
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd['batch_stats']['mean']),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd['batch_stats']['var']),
                               rtol=1e-6)
    plain = torch.nn.BatchNorm2d(4).train()
    with torch.no_grad():
        plain.running_var.fill_(2.0)
        plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(plain.running_var.numpy(),
                           bn.running_var.numpy(), rtol=1e-4)


def _equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict()['state'], b.optimizer.state_dict()[
        'state']
    assert set(oa) == set(ob) and oa
    for i in oa:
        for k in ('exp_avg', 'exp_avg_sq', 'step'):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def test_checkpoint_roundtrip(tmp_path):
    ckpt_dir = str(tmp_path / 'ckpt')
    state, step = _port_setup()
    snapshots = {}
    for i in (1, 2):
        state, _ = step(state, *(torch.from_numpy(a) for a in _batch(i)))
        tckpt.save_train_state(ckpt_dir, state.step, state)
        snapshots[i] = tckpt.restore_train_state(ckpt_dir, _port_setup()[0])
    assert sorted(os.listdir(ckpt_dir)) == ['1', '2']
    latest = tckpt.restore_train_state(ckpt_dir, _port_setup()[0])
    assert latest.step == 2
    _equal_states(latest, state)
    first = tckpt.restore_train_state(ckpt_dir, _port_setup()[0], step=1)
    assert first.step == 1
    _equal_states(first, snapshots[1])
    with pytest.raises(FileExistsError):
        tckpt.save_train_state(ckpt_dir, 2, state)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(str(tmp_path / 'none'), state)
    # Training goes on from the restored state as from the saved one.
    batch = [torch.from_numpy(a) for a in _batch(3)]
    _, loss_a = step(state, *batch)
    _, loss_b = step(latest, *batch)
    assert torch.equal(loss_a, loss_b)


def test_train_setup_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ttrain.make_train_setup(stage_sizes=STAGES)


@pytest.fixture
def shards(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for s in range(2):
        labels = rng.integers(0, 19, (5, *HW)).astype(np.uint8)
        labels[0] = 255                         # one image wholly ignored
        path = str(tmp_path / f'shard{s}.npz')
        np.savez(path, images=rng.integers(0, 256, (5, *HW, 3), np.uint8),
                 labels=labels)
        paths.append(path)
    return paths


def test_iterate_batches_matches_jax(shards):
    it_j = jrun.iterate_batches(shards, 2, seed=7)
    it_t = trun.iterate_batches(shards, 2, seed=7)
    for _ in range(9):                        # across shard boundaries
        (ij, lj), (it, lt) = next(it_j), next(it_t)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(lt, lj)


def test_run_trains_and_checkpoints(shards, tmp_path):
    ckpt_dir = str(tmp_path / 'ckpt')
    data_glob = os.path.join(os.path.dirname(shards[0]), 'shard*.npz')
    state, losses = trun.run(data_glob, steps=5, batch_size=2,
                             ckpt_dir=ckpt_dir, ckpt_every=2,
                             stage_sizes=STAGES, log_every=5, device='cpu')
    assert state.step == 5 and len(losses) == 5
    assert np.isfinite(losses).all()
    assert sorted(os.listdir(ckpt_dir), key=int) == ['2', '4', '5']
    _equal_states(tckpt.restore_train_state(ckpt_dir, _port_setup()[0]),
                  state)
    # Data parallelism needs as many ranks; a 'model' axis must divide
    # the sharded channel counts (multiples of 256).
    with pytest.raises(ValueError, match='exceeds the 1 ranks'):
        trun.run(data_glob, steps=1, dp=2, device='cpu')
    tp_mesh = types.SimpleNamespace(mesh_dim_names=('data', 'model'),
                                    size=lambda dim: (1, 3)[dim])
    with pytest.raises(ValueError, match="'model' axis of 3 does not "
                       'divide.*param_spec'):
        ttrain.make_train_setup(stage_sizes=STAGES, device='cpu',
                                mesh=tp_mesh)
