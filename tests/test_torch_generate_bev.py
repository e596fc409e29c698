"""The port's classic BEV generation against the JAX package's: the
standalone SemBEVGenerator.generate / generate_rand_aug on numpy point
dicts, integrate() + generate_bev() on the accumulator, and step()
without augmentation, which falls back to integrate() + generate_bev().

Tolerances: generate / generate_rand_aug rasters the same points with the
same draws, so the float16 maps agree within 2e-3 max abs (the raster
parity gate) and the trajectories exactly. Through the accumulator the
poses come from float32 ICP on both sides (atol 1e-4 m); a pose
difference at float32 rounding can move a point across a cell boundary,
so the maps are held to bench.py's step() rule: a cell-mismatch fraction
below 0.02 at 2e-2. Trajectories: atol 1 px (pixel coordinates are
floored).
"""
import numpy as np
import pytest

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum import kitti360 as jk3
from pc_accumulation_lib_tpu.bev.sem_bev import SemBEVGenerator as JGen
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator as TGen
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn

HORIZON = 12.0
NO_AUG = dict(type='sem', view_size=40, pixel_size=64, int_scaler=20.,
              int_sep_scaler=20., int_mid_threshold=0.5)
GEN_ARGS = (cfg.DEFAULT_SEM_IDXS, 40.0, 64)


def _pcs_and_trajs(rng, n=5000, cols=9):
    def cloud(m):
        pc = np.zeros((m, cols), np.float32)
        pc[:, 0:2] = rng.uniform(-25, 25, size=(m, 2))
        pc[:, 2] = rng.uniform(-2, 5, size=m)
        pc[:, 3] = rng.uniform(0, 1, size=m)
        pc[:, 4:7] = rng.integers(0, 256, size=(m, 3))
        pc[:, 7] = rng.choice([0, 2, 8, 13, 14], size=m)
        if cols > 8:
            pc[:, cols - 1] = rng.uniform(size=m) < 0.05
        return pc
    pcs = {'pc_present': cloud(n), 'pc_future': cloud(n // 2)}
    path = np.cumsum(rng.uniform(0.5, 1.5, size=(12, 3)) * [1, 0.2, 0], 0)
    path -= path[6]
    trajs = {'ego_traj_present': path[:7], 'ego_traj_future': path[6:],
             'ego_traj_full': path, 'other_trajs_present': [path[:3] + 2],
             'other_trajs_future': [], 'other_trajs_full': [],
             'gt_lanes': [path + [0, 3, 0], np.zeros((0, 3))]}
    return pcs, trajs


def _assert_same_bev(bj, bt, atol_map=2e-3, atol_traj=0.0):
    assert set(bj) == set(bt)
    for k in bj:
        if k.startswith('trajs') or k == 'gt_lanes':
            assert len(bj[k]) == len(bt[k]), k
            for tj, tt in zip(bj[k], bt[k]):
                np.testing.assert_allclose(tt, tj, atol=atol_traj,
                                           err_msg=k)
            continue
        assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape, k
        err = np.abs(bt[k].astype(np.float32) - bj[k].astype(np.float32))
        assert err.max() <= atol_map, (k, err.max())


@pytest.mark.parametrize('cols', [8, 9, 10])
def test_generate_matches_jax(rng, cols):
    pcs, trajs = _pcs_and_trajs(rng, cols=cols)
    kw = dict(int_scaler=20., int_sep_scaler=20., height_filter=3.0,
              rgb_fill=4, seed=0)
    bj = JGen(*GEN_ARGS, **kw).generate(pcs, trajs)
    bt = TGen(*GEN_ARGS, **kw, device='cpu').generate(pcs, trajs)
    assert len(bt['gt_lanes']) == 1         # the empty lane is dropped
    _assert_same_bev(bj, bt)
    present_only = {'pc_present': pcs['pc_present']}
    _assert_same_bev(JGen(*GEN_ARGS, **kw).generate(present_only, trajs),
                     TGen(*GEN_ARGS, **kw, device='cpu').generate(
                         present_only, trajs))


def test_generate_rand_aug_and_multiproc_match_jax(rng):
    pcs, trajs = _pcs_and_trajs(rng)
    kw = dict(max_trans_radius=3.0, zoom_thresh=0.05, do_warp=True,
              int_scaler=20., int_sep_scaler=20., seed=11)
    gj, gt = JGen(*GEN_ARGS, **kw), TGen(*GEN_ARGS, **kw, device='cpu')
    for _ in range(2):
        _assert_same_bev(gj.generate_rand_aug(pcs, trajs),
                         gt.generate_rand_aug(pcs, trajs))
    _assert_same_bev(gj.generate_multiproc((pcs, trajs)),
                     gt.generate_multiproc((pcs, trajs)))


def test_elevation_partition_matches_jax(rng):
    pc = np.zeros((3000, 9))
    pc[:, :2] = rng.integers(0, 64, size=(3000, 2))
    pc[:, 2] = rng.normal(size=3000)
    outs = [g.static_obj_partitioning_by_elev(pc.copy(), 0.5)
            for g in (JGen(*GEN_ARGS), TGen(*GEN_ARGS, device='cpu'))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _calib():
    _, H_velo_cam, P_cam_frame = tsyn.make_calib()
    return dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                p_velo_frame=P_cam_frame @ H_velo_cam)


def _accums(bev, **accum_kw):
    args = dict(accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                          max_frames=12, **accum_kw),
                icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8),
                seed=4)
    a_j = jk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, bev, **args)
    a_t = tk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, bev, device='cpu', **args)
    return a_j, a_t


def _frames(n):
    stream = tsyn.SyntheticKitti360Stream(n_frames=n, step=2.0,
                                          lidar_range=25.0, seed=3,
                                          points_per_frame=3000,
                                          yaw_rate=0.02)
    return [stream.frame(i) for i in range(n)]


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


def test_integrate_generate_bev_matches_jax():
    frames = _frames(9)
    a_j, a_t = _accums(NO_AUG)
    for i, f in enumerate(frames):
        assert a_t.integrate([f]) == a_j.integrate([f])
        assert a_t.window_start == a_j.window_start
        np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                                   atol=1e-4)
        if i < 2:
            continue
        np.testing.assert_allclose(a_t.get_incremental_path_dists(),
                                   a_j.get_incremental_path_dists(),
                                   atol=1e-4)
        pi = len(a_t.poses) // 2
        for gen_future in (True, False):
            bj = a_j.generate_bev(pi, 2, gen_future=gen_future)
            bt = a_t.generate_bev(pi, 2, gen_future=gen_future)
            _assert_bevs_match(bj, bt)
    assert a_t.window_start > 0, 'no eviction in the run: config broken'
    np.testing.assert_allclose(a_t.get_pose(1), a_j.get_pose(1), atol=1e-4)
    assert a_t.get_rgb(0)[0] is not None and len(a_t.get_semseg()) == len(
        a_t.poses)
    # Newest pose as the present (present_idx=None), async fetch.
    _assert_bevs_match(a_j.generate_bev(None, 1, gen_future=False),
                       a_t.generate_bev(None, 1, async_fetch=True)())


def test_step_without_augmentation_falls_back_to_generate_bev():
    """step() with no augmentation is integrate() + generate_bev at
    present_idx = len(poses) - 2, as in JAX; the port's result equals a
    second generate_bev call at that index bit for bit."""
    frames = _frames(6)
    a_j, a_t = _accums(NO_AUG, compact_cap=30000)
    a_j.integrate([frames[0]])
    a_t.integrate([frames[0]])
    for f in frames[1:]:
        bj = a_j.step([f], bev_num=2, gen_future=True)
        bt = a_t.step([f], bev_num=2, gen_future=True)
        np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                                   atol=1e-4)
        _assert_bevs_match(bj, bt)
        again = a_t.generate_bev(present_idx=len(a_t.poses) - 2, bev_num=2,
                                 gen_future=True)
        for s, r in zip(bt, again):
            assert set(s) == set(r)
            for k in s:
                if k.startswith('trajs'):
                    for a, b in zip(s[k], r[k]):
                        np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_array_equal(s[k], r[k])
