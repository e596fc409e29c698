"""The port's data-parallel and GPipe training against the JAX package's.

Two gloo worlds of spawned ranks (tests/torch_mesh_worlds): 2 ranks for
the data-parallel step on a (2, 1) ('data', 'model') mesh and
train_semseg.run over them, 4 ranks for GPipe on a ('pp',) mesh of 4
stages and train_semseg.run with dp=2, which trains DP+TP on (2, 2).
The JAX side runs models/train.make_train_setup on a (2, 1) mesh of its
CPU devices and parallel/pipeline.gpipe_apply on 4; its initial weights
are carried into the port (the ResNet by name, the pipeline's
stage-stacked convs with pipeline.stage_weights_from_flax). Tolerances,
held here:
  * the data-parallel step, as tests/test_torch_train.py holds the
    one-device step (float32 on both sides): step-1 loss rtol 1e-5;
    gradients rtol 1e-4 with atol GRAD_FLOOR * max|g| per tensor;
    batch-norm running statistics rtol 1e-5 with atol 1e-5 * max|stat|;
    three steps' losses rtol 1e-4 against JAX's one-device trainer, and
    against its (2, 1) trainer within twice the distance between JAX's
    own one-device and (2, 1) losses (at least 1e-4): JAX's float32 runs
    on the two meshes already differ at step 3 by about that tolerance,
    where Adam's first step has moved weights whose gradients lie at the
    float32 floor; parameters within 2 * lr * steps; both ranks' weights
    equal;
    train_semseg.run's losses on 2 ranks against one process's, rtol
    1e-4;
  * GPipe (float32): forward and stage gradients atol 1e-5 (as
    tests/test_pipeline.py holds JAX's pipeline to its sequential
    stack); three pipelined train-step losses rtol 1e-5.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pc_accumulation_lib_tpu.models import onnx_port as jport
from pc_accumulation_lib_tpu.models import train as jtrain
from pc_accumulation_lib_tpu.models.resnet_semseg import (
    ResNet50DilatedFCN as FlaxFCN)
from pc_accumulation_lib_tpu.parallel import pipeline as jpp
from pc_accumulation_lib_tpu_torch.runners import train_semseg as trun

import torch_mesh_worlds as w

GRAD_FLOOR = 5e-5
PP_STAGES = 4
# The rtol of train_semseg.run's three float32 losses on the (2, 2)
# DP+TP layout against one process's. Step 1 is held at 1e-5; by step 3
# Adam has moved weights whose gradients lie at the float32 floor, and the
# two differ by 1.1e-4 on these shards (JAX's own (2, 2) and one-device
# trainers by 6.4e-5 on train_batch's data), while in float64 the port's
# (2, 2) step matches one device's to the float32 logits' rounding. A
# wrong batch or layout moves a loss by 1e-2 or more.
RUN_TP_RTOL = 1e-3


def _shards(root):
    rng = np.random.default_rng(4)
    for s in range(2):
        labels = rng.integers(0, 19, (5, *w.TRAIN_HW)).astype(np.uint8)
        labels[0] = 255
        np.savez(os.path.join(root, f'shard{s}.npz'),
                 images=rng.integers(0, 256, (5, *w.TRAIN_HW, 3), np.uint8),
                 labels=labels)
    return os.path.join(root, 'shard*.npz')


def _jax_losses(dp):
    """Three steps' losses of JAX make_train_setup on a (dp, 1) mesh."""
    mesh = Mesh(np.array(jax.devices()[:dp]).reshape(dp, 1),
                ('data', 'model'))
    state, step = jtrain.make_train_setup(
        mesh, lr=w.TRAIN_LR, img_hw=w.TRAIN_HW, seed=0,
        stage_sizes=w.TRAIN_STAGES, dtype=jnp.float32)
    losses = []
    for i in range(w.TRAIN_STEPS):
        images, labels = w.train_batch(i)
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(loss))
    return losses


def _jax_dp():
    """JAX make_train_setup on a (2, 1) mesh: initial named tensors,
    step-1 named gradients, losses, named tensors after steps 1 and 3."""
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ('data', 'model'))
    state, step = jtrain.make_train_setup(
        mesh, lr=w.TRAIN_LR, img_hw=w.TRAIN_HW, seed=0,
        stage_sizes=w.TRAIN_STAGES, dtype=jnp.float32)
    model = FlaxFCN(stage_sizes=w.TRAIN_STAGES, dtype=jnp.float32)
    named = jport.export_named_tensors(state.variables)

    def loss_fn(params, batch_stats, images, labels):
        logits, _ = model.apply(
            {'params': params, 'batch_stats': batch_stats}, images,
            train=True, mutable=['batch_stats'])
        return jtrain.cross_entropy_loss(logits, labels)

    images, labels = w.train_batch(0)
    grads = jax.jit(jax.grad(loss_fn))(
        state.variables['params'], state.variables['batch_stats'],
        jnp.asarray(images), jnp.asarray(labels))
    grads = jport.export_named_tensors({'params': grads})
    losses, after = [], []
    for i in range(w.TRAIN_STEPS):
        images, labels = w.train_batch(i)
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        losses.append(float(loss))
        if i in (0, w.TRAIN_STEPS - 1):
            after.append(jport.export_named_tensors(state.variables))
    return named, grads, losses, after


class _Block(fnn.Module):
    """models/train.make_pipelined_train_setup's stage."""
    channels: int

    @fnn.compact
    def __call__(self, x):
        y = fnn.Conv(self.channels, (3, 3), padding='SAME', name='conv')(x)
        return x + fnn.relu(y)


def _jax_pp():
    """JAX's pipelined trainer on 4 stages: stacked params, gpipe_apply's
    forward and gradients, three train-step losses."""
    mesh = jpp.make_pipeline_mesh(PP_STAGES)
    state, step = jtrain.make_pipelined_train_setup(
        mesh, microbatch=w.PP_MB, hw=w.PP_HW, channels=w.PP_C, lr=1e-2,
        seed=0)
    stacked = state.variables['params']
    host = jax.tree_util.tree_map(np.asarray, stacked)
    block = _Block(w.PP_C)
    run = jpp.gpipe_apply(lambda p, x: block.apply({'params': p}, x), mesh)
    xs, ys = (jnp.asarray(a) for a in w.pipeline_batch())
    forward = np.asarray(jax.jit(run)(stacked, xs))
    grads = jax.jit(jax.grad(lambda p: jnp.mean((run(p, xs) - ys) ** 2)))(
        stacked)
    losses = []
    for _ in range(3):
        state, loss = step(state, xs, ys)
        losses.append(float(loss))
    return host, forward, jax.tree_util.tree_map(np.asarray, grads), losses


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('mesh_train')
    data_glob = _shards(str(base))
    named, jgrads, jlosses, jafter = _jax_dp()
    named_path = str(base / 'named.npz')
    np.savez(named_path, **named)
    host, jforward, jpgrads, jplosses = _jax_pp()
    stage_path = str(base / 'stages.npz')
    np.savez(stage_path, kernel=host['conv']['kernel'],
             bias=host['conv']['bias'])
    w.spawn_world('train_dp_cases', 2, base, named_path, data_glob)
    w.spawn_world('train_pp_cases', PP_STAGES, base, stage_path, data_glob)
    _, single = trun.run(data_glob, steps=3, batch_size=2,
                         ckpt_dir=str(base / 'ckpt_single'), ckpt_every=0,
                         stage_sizes=w.TRAIN_STAGES, log_every=3,
                         device='cpu')
    return dict(
        dp=[w.load(base, f'dp_r{r}') for r in range(2)],
        pp=[w.load(base, f'pp_r{r}') for r in range(PP_STAGES)],
        jgrads=jgrads, jlosses=jlosses, jlosses_1=_jax_losses(1),
        jafter=jafter, jforward=jforward,
        jpgrads=jpgrads, jplosses=jplosses, single=single, base=str(base))


def test_dp_first_step_matches_jax(runs):
    port = runs['dp'][0]
    np.testing.assert_allclose(port['losses'][0], runs['jlosses'][0],
                               rtol=1e-5)
    stats = [k for k in runs['jafter'][0] if 'running' in k]
    assert len(stats) == 2 * 20
    for k in stats:
        want = runs['jafter'][0][k]
        np.testing.assert_allclose(port['after'][0][k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert set(port['grads']) == set(runs['jgrads'])
    for k, g in runs['jgrads'].items():
        np.testing.assert_allclose(port['grads'][k], g, rtol=1e-4,
                                   atol=GRAD_FLOOR * np.abs(g).max(),
                                   err_msg=k)


def test_dp_three_steps_match_jax(runs):
    port = runs['dp'][0]
    np.testing.assert_allclose(port['losses'], runs['jlosses_1'], rtol=1e-4)
    jlosses, jlosses_1 = np.array(runs['jlosses']), np.array(
        runs['jlosses_1'])
    spread = np.max(np.abs(jlosses - jlosses_1) / np.abs(jlosses_1))
    np.testing.assert_allclose(port['losses'], jlosses,
                               rtol=max(1e-4, 2 * spread))
    for k in port['grads']:                   # the parameters
        diff = np.abs(port['after'][1][k] - runs['jafter'][1][k])
        assert diff.max() <= 2 * w.TRAIN_LR * w.TRAIN_STEPS, (k, diff.max())


def test_dp_ranks_agree(runs):
    """Every rank ends with the same weights and statistics, and reports
    the same global loss; a batch that does not split raises."""
    a, b = runs['dp']
    assert a['losses'] == b['losses']
    for k in a['after'][1]:
        np.testing.assert_array_equal(a['after'][1][k], b['after'][1][k],
                                      err_msg=k)
    assert 'divisible by the data-parallel size 2' in a['odd_batch']


def test_train_semseg_run_data_parallel(runs):
    """train_semseg.run on 2 ranks with dp=2 (the default would be (1,
    2) TP): the global losses of one process's run, one set of
    checkpoints."""
    a, b = runs['dp']
    assert a['run_step'] == 3 and a['run_losses'] == b['run_losses']
    np.testing.assert_allclose(a['run_losses'], runs['single'], rtol=1e-4)
    assert sorted(os.listdir(os.path.join(runs['base'], 'ckpt')),
                  key=int) == ['2', '3']


def test_dp_below_world_trains_tp(runs):
    """train_semseg.run with dp=2 on 4 ranks trains DP+TP on a (2, 2)
    mesh: every rank the same global losses, step 1 those of one
    process's run at rtol 1e-5, the three at RUN_TP_RTOL
    (tests/test_torch_tp.py holds the (2, 2) step to JAX's); a dp that
    does not divide the world raises."""
    first = runs['pp'][0]['dp_below_world']
    for r in range(PP_STAGES):
        got = runs['pp'][r]['dp_below_world']
        assert got['layout'] == (2, 2)
        assert got['losses'] == first['losses']
        assert got['dp_3'] == 'dp=3 does not divide the 4 ranks'
    np.testing.assert_allclose(first['losses'][0], runs['single'][0],
                               rtol=1e-5)
    np.testing.assert_allclose(first['losses'], runs['single'],
                               rtol=RUN_TP_RTOL)


def test_gpipe_matches_jax(runs):
    for r in range(PP_STAGES):
        port = runs['pp'][r]
        np.testing.assert_allclose(port['forward'], runs['jforward'],
                                   atol=1e-5)
        want = jpp_stage_grads(runs['jpgrads'])[r]
        np.testing.assert_allclose(port['grad']['weight'], want['weight'],
                                   atol=1e-5)
        np.testing.assert_allclose(port['grad']['bias'], want['bias'],
                                   atol=1e-5)


def jpp_stage_grads(grads):
    from pc_accumulation_lib_tpu_torch.parallel import pipeline as tpp
    return tpp.stage_weights_from_flax(grads['conv']['kernel'],
                                       grads['conv']['bias'])


def test_pipelined_train_step_matches_jax(runs):
    for r in range(PP_STAGES):
        np.testing.assert_allclose(runs['pp'][r]['losses'],
                                   runs['jplosses'], rtol=1e-5)
    assert runs['pp'][0]['losses'][-1] < runs['pp'][0]['losses'][0]
