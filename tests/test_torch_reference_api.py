"""The port's last reference-API surface against the JAX package's on the
same numpy-seeded inputs: the KITTI-360 accumulator's per-frame
obs2sem_vec_space, the semseg wrapper's pred / pred_batch, the weight
export export_named_tensors, heading_rot_ang and warp_points_xy.

Tolerances, as observed and held here:
  * obs2sem_vec_space: poses and T_new_prev within 1e-4 m (float32 ICP on
    both sides, as tests/test_torch_step.py, on its stream; a float64
    witness says why that draw), window start exact; against
    the port's own integrate([obs]) run: poses, T_new_prev, window and
    the device buffer identical;
  * pred / pred_batch: class maps equal, JAX's shapes and dtype;
  * export_named_tensors: a port -> port round trip bit-exact; the JAX
    model on the exported weights gives logits within 2e-3 of the port's
    (tests/test_torch_semseg.py's rule, argmax parity at least 99.8%);
  * heading_rot_ang: within 1e-6 rad (the JAX one computes in float32);
  * warp_points_xy: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum import kitti360 as jk3
from pc_accumulation_lib_tpu.models import onnx_port as jport
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.ops import geometry as jgeom
from pc_accumulation_lib_tpu.ops import icp as jicp
from pc_accumulation_lib_tpu.ops import warp as jwarp
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.accum.base import (
    SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models import onnx_port as tport
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)
from pc_accumulation_lib_tpu_torch.ops import geometry as tgeom
from pc_accumulation_lib_tpu_torch.ops import icp as ticp
from pc_accumulation_lib_tpu_torch.ops import warp as twarp

STAGES = (1, 1, 1, 1)
N_FRAMES = 4
HORIZON = 3.0     # the 4 frames, ~1.8 m apart, evict the first
ACCUM = dict(max_points_per_frame=8192, max_frames=10,
             max_painted_points_per_frame=8192, compact_cap=49152)
ICP = dict(max_downsampled=512, num_iters=8)


def _calib():
    _, H_velo_cam, P_cam_frame = tsyn.make_calib((tsyn.IMG_H, tsyn.IMG_W))
    return dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                p_velo_frame=P_cam_frame @ H_velo_cam)


def _accum(pkg, **kw):
    return pkg.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, dict(type='sem', view_size=40,
                                         pixel_size=64),
        accum_cfg=cfg.AccumConfig(**ACCUM), icp_cfg=cfg.ICPConfig(**ICP),
        seed=0, **kw)


def _stream(n_frames):
    """tests/test_torch_step.py's stream: drawn for 11 frames there, and
    for 4 in the float32 witness below (another scene)."""
    return tsyn.SyntheticKitti360Stream(n_frames=n_frames, step=2.0,
                                        lidar_range=25.0, seed=3,
                                        points_per_frame=3000)


@pytest.fixture(scope='module')
def obs_runs():
    stream = _stream(11)
    frames = [stream.frame(i) for i in range(N_FRAMES)]
    a_j, a_t, a_i = (_accum(jk3), _accum(tk3, device='cpu'),
                     _accum(tk3, device='cpu'))
    out = []
    for f in frames:
        rj = a_j.obs2sem_vec_space(*f)
        rt = a_t.obs2sem_vec_space(*f)
        a_i.integrate([f])
        out.append((rj, rt, a_j.window_start, a_t.window_start,
                    np.array(a_i.poses), a_i._T_new_prev_last.copy(),
                    a_i.window_start))
    return out, a_t, a_i


def test_obs2sem_vec_space_matches_jax(obs_runs):
    out, a_t, _ = obs_runs
    for rj, rt, ws_j, ws_t, *_ in out:
        assert len(rt) == len(rj) == 4
        assert rt[0] is None and rt[2] is None
        assert rj[0] is None and rj[2] is None
        np.testing.assert_allclose(np.asarray(rt[1]), np.asarray(rj[1]),
                                   atol=1e-4)
        assert np.asarray(rt[3]).shape == (4, 4)
        np.testing.assert_allclose(rt[3], np.asarray(rj[3]), atol=1e-4)
        assert ws_t == ws_j
    assert out[-1][3] > 0, 'no eviction in the run: config broken'
    assert rt[1] == a_t.poses[-1]


def test_obs2sem_vec_space_is_integrate(obs_runs):
    out, a_t, a_i = obs_runs
    for _, rt, _, ws_t, poses_i, T_i, ws_i in out:
        assert rt[1] == list(poses_i[-1])
        np.testing.assert_array_equal(rt[3], T_i)
        assert ws_t == ws_i
    assert a_t.poses == a_i.poses
    assert a_t.frame_count == a_i.frame_count == N_FRAMES
    for name in ('points', 'valid', 'frame_ids'):
        assert torch.equal(getattr(a_t.state, name),
                           getattr(a_i.state, name)), name


class _JnpFloat64:
    """``jnp`` with float32 read as float64, so the JAX ICP's casts keep a
    float64 run in float64 (as tests/test_torch_icp.py does)."""

    def __getattr__(self, name):
        return jnp.float64 if name == 'float32' else getattr(jnp, name)


def _icp_chain(frames, jax_side, dtype):
    """The accumulators' ICP at ICP's settings (512 points, 8 iterations,
    coarse to fine, warm start) on 8192-row padded clouds; the chained
    positions (frames, 3) in float64."""
    if jax_side:
        pre = jicp.make_preprocess_fn(None, ICP['max_downsampled'], 10)
        reg = jicp.make_coarse_to_fine_register_fn(ICP['num_iters'])
        arr, init = (lambda a: jnp.asarray(a, dtype)), jnp.eye(4, dtype=dtype)
    else:
        pre = ticp.make_preprocess_fn(ICP['max_downsampled'], 10)
        reg = ticp.make_coarse_to_fine_register_fn(ICP['num_iters'])
        arr, init = (lambda a: torch.as_tensor(a, dtype=dtype)), \
            torch.eye(4, dtype=dtype)
    T, prev, out = np.eye(4), None, []
    for pc in frames:
        pts = np.zeros((ACCUM['max_points_per_frame'], 3), np.float32)
        pts[:len(pc)] = pc[:, :3]
        valid = np.arange(len(pts)) < len(pc)
        cloud = pre(arr(pts), jnp.asarray(valid) if jax_side
                    else torch.as_tensor(valid))
        if prev is not None:
            init = reg(prev, cloud, init, 1e3)[0]
            T = T @ np.linalg.inv(np.asarray(init, np.float64))
        out.append(T[:3, 3].copy())
        prev = cloud
    return np.array(out)


def test_float32_chain_witness_on_four_frame_draw(monkeypatch):
    """Why obs_runs draws the stream for 11 frames. Drawn for 4, the
    scene is ill-conditioned for ICP (steps of 1.7, 4.5 and 3.2 m against
    the stream's 2 m): in float64 the two packages agree to 1e-9 m, but
    the port's float32 chain departs from it by 8.8e-4 m at frame 3 and
    the JAX package's by 2.2e-5 m, so the accumulators' float32 poses
    differ by more than the 1e-4 m rule (on the 11-frame draw the two
    stay within 1e-6 m of each other)."""
    stream = _stream(4)
    frames = [np.asarray(stream.frame(i)[1], np.float32)
              for i in range(N_FRAMES)]
    port64 = _icp_chain(frames, False, torch.float64)
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jicp, 'jnp', _JnpFloat64())
        jax64 = _icp_chain(frames, True, jnp.float64)
    np.testing.assert_allclose(jax64, port64, atol=1e-9)
    for jax_side, dtype in ((False, torch.float32), (True, jnp.float32)):
        np.testing.assert_allclose(_icp_chain(frames, jax_side, dtype),
                                   port64, atol=2e-3)


def test_base_hooks_are_abstract():
    base = object.__new__(SemanticPointCloudAccumulator)
    with pytest.raises(NotImplementedError):
        base.integrate([])
    with pytest.raises(NotImplementedError):
        base.obs2sem_vec_space(None, np.zeros((1, 4), np.float32))


@pytest.fixture(scope='module')
def semseg_pair():
    sem_j = SemSegTPU(seed=0, stage_sizes=STAGES, dtype=jnp.float32)
    sem_t = SemSegTorch('cpu', seed=1, stage_sizes=STAGES)
    load_named_tensors(sem_t, jport.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def test_pred_and_pred_batch_match_jax(semseg_pair):
    sem_j, sem_t = semseg_pair
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    want = sem_j.pred_batch(imgs)
    for batch in (imgs, imgs.astype(np.float32)):
        got = sem_t.pred_batch(batch)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape == (2, 64, 128)
        np.testing.assert_array_equal(got, want)
    rgba = np.concatenate([imgs[1], np.full((64, 128, 1), 7, np.uint8)], -1)
    got, want = sem_t.pred(rgba), sem_j.pred(rgba)
    assert got.shape == want.shape == (1, 1, 64, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sem_t(imgs[0]), want_0 := sem_j(imgs[0]))
    assert want_0.shape == (64, 128)


def _perturbed(model):
    """Random running statistics and batch-norm affines in place, so every
    tensor's name matters."""
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for k, v in model.model.state_dict().items():
            if k.endswith('running_mean') or k.endswith('.bias'):
                v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape)))
            elif k.endswith('running_var') or (k.endswith('.weight')
                                               and v.ndim == 1):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)))
    return model


def test_export_named_tensors_round_trips():
    src = _perturbed(SemSegTorch('cpu', seed=0, stage_sizes=STAGES))
    named = tport.export_named_tensors(src)
    state = src.model.state_dict()
    assert set(named) == {k for k in state
                          if not k.endswith('num_batches_tracked')}
    assert all(isinstance(v, np.ndarray) for v in named.values())
    dst = SemSegTorch('cpu', seed=1, stage_sizes=STAGES)
    load_named_tensors(dst.model, named)
    for k, v in dst.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    again = tport.export_named_tensors(dst.model)
    assert all(again[k].tobytes() == named[k].tobytes() for k in named)


def test_export_named_tensors_feeds_jax(semseg_pair):
    src = _perturbed(SemSegTorch('cpu', seed=2, stage_sizes=STAGES))
    model = semseg_pair[0].model
    variables = jport.convert_named_tensors(
        tport.export_named_tensors(src), model=model,
        variables=semseg_pair[0].variables)
    img = np.random.default_rng(6).integers(0, 256, (1, 64, 128, 3))
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(img, jnp.float32)))
    with torch.no_grad():
        got = src.model(torch.from_numpy(img.astype(np.float32))).numpy()
    assert got.shape == want.shape == (1, 64, 128, 19)
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.998
    # Every JAX leaf came from the export, none from the template's init.
    assert len(jax.tree_util.tree_leaves(variables)) == len(
        tport.export_named_tensors(src))


def test_heading_rot_ang_matches_jax():
    rng = np.random.default_rng(7)
    for n in (1, 2, 5):
        traj = rng.uniform(-20, 20, (n, 3))
        want = float(jgeom.heading_rot_ang(traj))
        got = tgeom.heading_rot_ang(traj)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert tgeom.heading_rot_ang(None) == tgeom.heading_rot_ang(
        np.zeros((0, 3))) == 0.5 * np.pi


def test_warp_points_xy_matches_jax():
    rng = np.random.default_rng(8)
    P = 64
    x, y = rng.uniform(-5, P + 5, 200), rng.uniform(-5, P + 5, 200)
    for i_w, j_w in ((20.0, 40.0), (P / 2, P / 2)):   # a warp, identity
        a1, a2 = twarp.cal_warp_params(i_w, P // 2, P - 1)
        b1, b2 = twarp.cal_warp_params(j_w, P // 2, P - 1)
        got = twarp.warp_points_xy(x, y, a1, a2, b1, b2, P, P)
        want = jwarp.warp_points_xy(x, y, a1, a2, b1, b2, P, P)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        pnts = np.stack([x, y, np.zeros_like(x)], -1)
        np.testing.assert_array_equal(
            twarp.warp_sparse_points(pnts, a1, a2, P // 2, j_w, P),
            jwarp.warp_sparse_points(pnts, a1, a2, P // 2, j_w, P))
