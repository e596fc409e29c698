"""The port's step() path as a whole against the JAX accumulator (prepped
raster, Pallas kernel in interpret mode) on the same frames and seeds.

Tolerances, as observed and held here:
  * poses: atol 1e-4 m. Both run float32 ICP; the transforms agree to
    ~1e-6 per frame.
  * window_start: exact (the eviction is an integer decision).
  * BEV maps: cell-mismatch fraction below 0.02 at 2e-2 (bench.py's
    step() parity rule: a pose difference at float32 rounding can move a
    point across a cell boundary).
  * trajectories: atol 1 px (pixel coords are floored).
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum import kitti360 as jk3
from pc_accumulation_lib_tpu.dataloaders import synthetic as jsyn
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)

N_STEPS = 10
HORIZON = 12.0
BEV = dict(type='sem', view_size=40, pixel_size=64, max_trans_radius=2.0,
           zoom_thresh=0.05, do_warp=True, int_scaler=20., int_sep_scaler=20.,
           int_mid_threshold=0.5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calib(img_hw=(tsyn.IMG_H, tsyn.IMG_W)):
    _, H_velo_cam, P_cam_frame = tsyn.make_calib(img_hw)
    return dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                p_velo_frame=P_cam_frame @ H_velo_cam)


def _accums(seed, semseg_pair=(None, None), img_hw=(tsyn.IMG_H, tsyn.IMG_W),
            **kw):
    args = dict(accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                          max_frames=10,
                                          max_painted_points_per_frame=8192,
                                          compact_cap=49152),
                icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8),
                seed=seed, **kw)
    gt = semseg_pair[0] is None
    a_j = jk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(img_hw), 1e3, semseg_pair[0],
        cfg.DEFAULT_SEMSEG_FILTERS, cfg.DEFAULT_SEM_IDXS, gt, BEV, **args)
    a_j.sem_bev_generator.use_prepped_raster = True
    a_j.sem_bev_generator._prep_interpret = True
    a_t = tk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(img_hw), 1e3, semseg_pair[1],
        cfg.DEFAULT_SEMSEG_FILTERS, cfg.DEFAULT_SEM_IDXS, gt, BEV,
        device='cpu', **args)
    return a_j, a_t


def _assert_bevs_match(bj, bt):
    assert len(bj) == len(bt)
    for sj, st in zip(bj, bt):
        assert set(sj) == set(st)
        for k in sj:
            if k.startswith('trajs'):
                assert len(sj[k]) == len(st[k])
                for tj, tt in zip(sj[k], st[k]):
                    np.testing.assert_allclose(tt, tj, atol=1.0, err_msg=k)
                continue
            assert st[k].dtype == np.float16 and st[k].shape == sj[k].shape
            mism = np.mean(np.abs(np.asarray(sj[k], np.float32)
                                  - st[k].astype(np.float32)) > 2e-2)
            assert mism < 0.02, (k, mism)


@pytest.fixture(scope='module')
def gt_run():
    stream = tsyn.SyntheticKitti360Stream(n_frames=N_STEPS + 1, step=2.0,
                                          lidar_range=25.0, seed=3,
                                          points_per_frame=3000)
    frames = [stream.frame(i) for i in range(N_STEPS + 1)]
    a_j, a_t = _accums(seed=7)
    a_j.integrate([frames[0]])
    a_t.integrate([frames[0]])
    out = []
    for f in frames[1:]:
        bj = a_j.step([f], bev_num=2, gen_future=True)
        bt = a_t.step([f], bev_num=2, gen_future=True)
        out.append((bj, bt, np.array(a_j.poses), np.array(a_t.poses),
                    a_j.window_start, a_t.window_start))
    return out, a_t


def test_step_poses_and_eviction_match(gt_run):
    out, a_t = gt_run
    for _, _, pj, pt, ws_j, ws_t in out:
        assert ws_t == ws_j
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert out[-1][5] > 0, 'no eviction in the run: config broken'
    assert 0 < a_t.max_live_rows <= 49152


def test_step_bevs_match(gt_run):
    out, _ = gt_run
    for bj, bt, *_ in out:
        assert len(bt) == 2
        _assert_bevs_match(bj, bt)


def test_camera_semseg_step_matches():
    """Camera paint with the reduced-depth semseg model, its weights
    carried over from the Flax init by name; uint8 image and 7 B/point
    cloud upload."""
    img_hw = (64, 256)
    stream = tsyn.SyntheticKitti360Stream(n_frames=3, step=2.0,
                                          lidar_range=25.0, seed=5,
                                          points_per_frame=3000,
                                          img_hw=img_hw)
    frames = [stream.frame(i) for i in range(3)]
    sem_j = SemSegTPU(seed=0, stage_sizes=(1, 1, 1, 1))
    sem_t = SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
    load_named_tensors(sem_t, onnx_port.export_named_tensors(sem_j.variables))
    img = frames[0][0]
    assert np.mean(sem_t(img) == sem_j(img)) >= 0.998
    a_j, a_t = _accums(seed=2, semseg_pair=(sem_j, sem_t), img_hw=img_hw,
                       transfer_dtype='quantized')
    a_j.integrate([frames[0]])
    a_t.integrate([frames[0]])
    for f in frames[1:]:
        bj = a_j.step([f], bev_num=1, gen_future=True)
        bt = a_t.step([f], bev_num=1, gen_future=True)
        assert a_t.window_start == a_j.window_start
        np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                                   atol=1e-4)
        _assert_bevs_match(bj, bt)


def test_synthetic_stream_byte_equal():
    kw = dict(n_frames=4, step=2.0, lidar_range=25.0, seed=11,
              points_per_frame=2000, yaw_rate=0.01)
    sj, st = jsyn.SyntheticKitti360Stream(**kw), tsyn.SyntheticKitti360Stream(**kw)
    for i in (0, 3):
        (ij, pj, gj), (it, pt, gt) = sj.frame(i), st.frame(i)
        assert pt.tobytes() == pj.tobytes() and gt.tobytes() == gj.tobytes()
        assert it.dtype == np.uint8 and it.tobytes() == np.asarray(ij).tobytes()
    for img_hw in ((64, 256), (376, 1408)):
        for a, b in zip(jsyn.make_calib(img_hw), tsyn.make_calib(img_hw)):
            np.testing.assert_array_equal(a, b)


def test_window_update_and_pose_vec_match_jax():
    """Random walks with eviction bursts and ring wrap-around: the port's
    window_update tracks the JAX one exactly; pose_params_vec agrees."""
    rng = np.random.default_rng(42)
    for trial in range(3):
        R = 12
        horizon = float(rng.uniform(5.0, 15.0))
        steps = rng.uniform(0.0, 2.5, size=(40, 3))
        steps[:, 2] *= 0.1
        poses = np.cumsum(steps, axis=0).astype(np.float32)
        ring_j, ws_j = jnp.zeros((R,), jnp.float32), jnp.int32(0)
        ring_t, ws_t = torch.zeros(R), torch.tensor(0, dtype=torch.int32)
        T_prev = np.eye(4, dtype=np.float32)
        T_prev[:3, 3] = poses[0]
        for fid in range(1, 40):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = [[np.cos(0.1 * fid), -np.sin(0.1 * fid), 0],
                         [np.sin(0.1 * fid), np.cos(0.1 * fid), 0], [0, 0, 1]]
            T[:3, 3] = poses[fid]
            ring_j, ws_j, path_j, ovf_j = jk3.window_update(
                ring_j, ws_j, jnp.asarray(T), jnp.asarray(T_prev),
                jnp.int32(fid), jnp.float32(horizon), False)
            ws_t, path_t, ovf_t = tk3.window_update(
                ring_t, ws_t, torch.from_numpy(T), torch.from_numpy(T_prev),
                fid, horizon, False)
            assert int(ws_t) == int(ws_j), (trial, fid)
            assert float(ovf_t) == float(ovf_j)
            np.testing.assert_allclose(float(path_t), float(path_j),
                                       rtol=1e-5)
            np.testing.assert_allclose(
                tk3.pose_params_vec(torch.from_numpy(T),
                                    torch.from_numpy(T_prev), ws_t,
                                    fid).numpy(),
                np.asarray(jk3.pose_params_vec(
                    jnp.asarray(T), jnp.asarray(T_prev), ws_j,
                    jnp.int32(fid))), rtol=1e-6, atol=1e-5)
            T_prev = T
    # A stationary stretch longer than the ring flags the overflow at the
    # first corrupting write, frame R + 1.
    R, ring, ws, flagged = 8, torch.zeros(8), torch.tensor(0), None
    T_prev = torch.eye(4)
    for fid in range(1, 2 * R + 2):
        T = torch.eye(4)
        T[0, 3] = 0.01 * fid
        ws, _, ovf = tk3.window_update(ring, ws, T, T_prev, fid, 100.0,
                                       False)
        T_prev = T
        if float(ovf) and flagged is None:
            flagged = fid
    assert flagged == R + 1


def test_compact_cap_overflow_raises():
    stream = tsyn.SyntheticKitti360Stream(n_frames=2, step=2.0,
                                          lidar_range=25.0, seed=3,
                                          points_per_frame=3000)
    a = tk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, BEV,
        accum_cfg=cfg.AccumConfig(max_points_per_frame=8192, max_frames=10,
                                  max_painted_points_per_frame=8192,
                                  compact_cap=64),
        icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8), seed=0,
        device='cpu')
    a.integrate([stream.frame(0)])
    with pytest.raises(RuntimeError, match='compact_cap'):
        a.step([stream.frame(1)], bev_num=1, gen_future=True)


def test_unset_compact_cap_raises():
    """step() with compact_cap unset rasters the whole flat buffer (every
    slot, masked by frame id), as the JAX accumulator does, and matches
    it: poses 1e-4 m, window start exact, maps under the step() rule.
    The name is kept from when the port refused an unset compact_cap."""
    stream = tsyn.SyntheticKitti360Stream(n_frames=5, step=2.0,
                                          lidar_range=25.0, seed=3,
                                          points_per_frame=3000)
    frames = [stream.frame(i) for i in range(5)]
    args = (HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
            cfg.DEFAULT_SEM_IDXS, True, BEV)
    kw = dict(accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                        max_frames=6),
              icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8),
              seed=1)
    a_j = jk3.Kitti360SemanticPointCloudAccumulator(*args, **kw)
    a_t = tk3.Kitti360SemanticPointCloudAccumulator(*args, device='cpu',
                                                    **kw)
    assert a_t.accum_cfg.compact_cap is None
    a_j.integrate([frames[0]])
    a_t.integrate([frames[0]])
    for f in frames[1:]:
        bj = a_j.step([f], bev_num=2, gen_future=True)
        bt = a_t.step([f], bev_num=2, gen_future=True)
        assert a_t.window_start == a_j.window_start
        np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                                   atol=1e-4)
        _assert_bevs_match(bj, bt)
    assert a_t.max_live_rows == 0     # no compaction ran


def test_port_imports_no_jax_flax_pil():
    """A fresh interpreter runs one tiny CPU step of the port and a tiny
    sampling_loop (integrate, generate_bev, make_raster_fn) without
    importing JAX, Flax or PIL."""
    script = textwrap.dedent("""
        import sys
        from pc_accumulation_lib_tpu_torch import config as cfg
        from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
            Kitti360SemanticPointCloudAccumulator)
        from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
            SyntheticKitti360Stream, make_calib)
        from pc_accumulation_lib_tpu_torch.models.semseg import SemSegTorch
        _, H, P = make_calib()
        a = Kitti360SemanticPointCloudAccumulator(
            12.0, dict(p_velo_frame=P @ H), 1e3, None,
            use_gt_sem=True,
            bev_params=dict(view_size=40, pixel_size=32,
                            max_trans_radius=2.0, zoom_thresh=0.05),
            accum_cfg=cfg.AccumConfig(max_points_per_frame=4096,
                                      max_frames=4, compact_cap=8192),
            icp_cfg=cfg.ICPConfig(max_downsampled=128, num_iters=2),
            seed=0, device='cpu')
        s = SyntheticKitti360Stream(n_frames=2, lidar_range=20.0,
                                    points_per_frame=1000)
        a.integrate([s.frame(0)])
        assert len(a.step([s.frame(1)], bev_num=1)) == 1
        SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
        # The classic path: sampling_loop -> integrate + generate_bev ->
        # make_raster_fn, on an accumulator without augmentation.
        import tempfile
        from pc_accumulation_lib_tpu_torch.runners.kitti360_bev_gen import (
            sampling_loop)
        b = Kitti360SemanticPointCloudAccumulator(
            12.0, dict(p_velo_frame=P @ H), 1e3, None, use_gt_sem=True,
            bev_params=dict(view_size=40, pixel_size=32),
            accum_cfg=cfg.AccumConfig(max_points_per_frame=4096,
                                      max_frames=8),
            icp_cfg=cfg.ICPConfig(max_downsampled=128, num_iters=2),
            device='cpu')
        with tempfile.TemporaryDirectory() as d:
            stats = sampling_loop(
                b, SyntheticKitti360Stream(n_frames=6, lidar_range=20.0,
                                           points_per_frame=1000),
                cfg.SamplingConfig(2.0, 0.0, 1),
                cfg.OutputConfig(d, viz_to_disk=False, async_io=False))
        assert stats['bevs'] > 0, stats
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'PIL')]
        assert not bad, bad
        print('ok')
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')
