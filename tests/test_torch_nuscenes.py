"""The port's NuScenes accumulators and their device pieces against the JAX
package on the same numpy inputs: paint_frame_multicam, set_instance_dyn,
the oracle-pose accumulator (tracking, 6-camera paint, the per-id dynamic
table) and the ICP-pose accumulator, on the synthetic NuScenes stream with
the reduced-depth semseg model, its weights carried over by name.

Tolerances, as observed and held here:
  * gathers, flags, class and instance ids, masks: exact;
  * transformed xyz and the intensity column (a float32 product and a
    division, rounded per side): 1e-5;
  * oracle poses and the dynamic table: exact (host float64 on both
    sides); trajectories and GT lanes: 1e-9 (pixel coordinates from the
    same float64 host math);
  * ICP poses: 1e-4 m (float32 ICP on both sides);
  * BEV maps: cell-mismatch fraction below 0.02 at 2e-2 (bench.py's step()
    parity rule).
"""
import contextlib
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.accum import buffer as jbuf
from pc_accumulation_lib_tpu.accum.nuscenes import (
    NuScenesSemanticPointCloudAccumulator as JIcp)
from pc_accumulation_lib_tpu.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as JOracle)
from pc_accumulation_lib_tpu.dataloaders import synthetic as jsyn
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.utils import ply as jply
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.accum import buffer as tbuf
from pc_accumulation_lib_tpu_torch.accum.nuscenes import (
    NuScenesSemanticPointCloudAccumulator as TIcp)
from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as TOracle, OracleDeviceObs)
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)

ACCUM = dict(max_points_per_frame=16384, max_frames=32,
             max_painted_points_per_frame=16384, max_instances=64)
BEV_PARAMS = dict(type='sem', view_size=40, pixel_size=64, int_scaler=1.,
                  int_sep_scaler=30., int_mid_threshold=0.12)
FILTERS = (10, 11, 12, 16, 18)
LANES = [np.stack([np.linspace(0, 100, 101), np.zeros(101), np.zeros(101)],
                  1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope='module')
def semseg_pair():
    """The reduced-depth model on both sides, the same weights."""
    sem_j = SemSegTPU(seed=0, stage_sizes=(1, 1, 1, 1))
    sem_t = SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
    load_named_tensors(sem_t, onnx_port.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _assert_maps_match(bj, bt, traj_atol=1e-9):
    assert set(bj) == set(bt)
    for k in bj:
        if k.startswith('trajs') or k == 'gt_lanes':
            assert len(bt[k]) == len(bj[k]), k
            for a, b in zip(bt[k], bj[k]):
                np.testing.assert_allclose(a, b, atol=traj_atol, err_msg=k)
            continue
        assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape
        mism = np.mean(np.abs(np.asarray(bj[k], np.float32)
                              - bt[k].astype(np.float32)) > 2e-2)
        assert mism < 0.02, (k, mism)


# ----------------------------------------------------------------------
# Device pieces
# ----------------------------------------------------------------------
def _multicam_inputs(rng, n=4000, C=6, H=24, W=40, K=9):
    pc = np.zeros((n, 7), np.float32)
    pc[:, :3] = rng.uniform(-60, 60, size=(n, 3))
    pc[:, 3] = rng.uniform(0, 255, n)
    # u, v in and around the image, with exact halves (round half to even).
    pc[:, 4] = np.round(rng.uniform(-3, W + 3, n) * 2) / 2
    pc[:, 5] = np.round(rng.uniform(-3, H + 3, n) * 2) / 2
    # Instance column: -1 (none), ids, fractions and values past the remap.
    pc[:, 6] = rng.choice([-1.0, -1.5, -0.5, 0.0, 1.0, 2.7, 6.0, 20.0, -3.0],
                          n)
    valid = rng.random(n) < 0.9
    cam_idx = rng.integers(-1, C, n).astype(np.int32)
    imgs = rng.integers(0, 256, size=(C, H, W, 3)).astype(np.float32)
    semsegs = rng.integers(0, 19, size=(C, H, W)).astype(np.int32)
    T = np.eye(4, dtype=np.float32)
    a = rng.uniform(-np.pi, np.pi)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = rng.uniform(-100, 100, 3)
    remap = rng.integers(0, 50, K).astype(np.int32)
    remap[0] = 0
    return pc, valid, cam_idx, imgs, semsegs, T, remap


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_paint_frame_multicam_matches_jax(seed):
    args = _multicam_inputs(np.random.default_rng(seed))
    pj, vj = jbuf.paint_frame_multicam(*(jnp.asarray(a) for a in args),
                                       filters=FILTERS)
    pt, vt = tbuf.paint_frame_multicam(*(_t(a) for a in args),
                                       filters=FILTERS)
    pj, pt = np.asarray(pj), pt.numpy()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.numpy().sum() > 0 and not vt.numpy().all()
    # Gathered colours, class, instance and dyn columns: exact.
    np.testing.assert_array_equal(pt[:, 4:], pj[:, 4:])
    np.testing.assert_allclose(pt[:, :4], pj[:, :4], rtol=1e-5, atol=1e-5)
    # The instance values reach remap slots 0 (none, and below -1), 1-3
    # (truncated toward zero, + 1), 7 and 8 (clipped to the last).
    assert set(np.unique(pt[:, 8]).astype(int)) == \
        set(args[-1][[0, 1, 2, 3, 7, 8]].tolist())


def test_set_instance_dyn_matches_jax():
    rng = np.random.default_rng(3)
    table = np.zeros(16, np.float32)
    table[[3, 7]] = 1.0
    state_j = jbuf.init_state(2, 8, 16)._replace(inst_dyn=jnp.asarray(table))
    state_t = tbuf.init_state(2, 8, 16, 'cpu')
    state_t.inst_dyn.copy_(_t(table))
    for _ in range(4):
        # Ids repeat; slot 0 is the padding no-op; flags 0 or 1.
        ids = rng.integers(0, 16, 64).astype(np.int32)
        ids[rng.random(64) < 0.5] = 0
        flags = (ids > 0).astype(np.float32) * (rng.random(64) < 0.7)
        state_j = jbuf.set_instance_dyn(state_j, jnp.asarray(ids),
                                        jnp.asarray(flags))
        tbuf.set_instance_dyn(state_t, _t(ids), _t(flags))
        np.testing.assert_array_equal(state_t.inst_dyn.numpy(),
                                      np.asarray(state_j.inst_dyn))
    assert state_t.inst_dyn[0] == 0.0 and state_t.inst_dyn.sum() > 2


def test_synthetic_nuscenes_stream_byte_equal():
    kw = dict(n_frames=5, step=2.0, lidar_range=20.0, seed=4,
              img_hw=(32, 48))
    sj, st = jsyn.SyntheticNuScenesStream(**kw), \
        tsyn.SyntheticNuScenesStream(**kw)
    for i in (0, 4):
        fj, ft = sj.frame(i), st.frame(i)
        assert set(fj) == set(ft)
        for k in ('pc', 'pc_cam_idx', 'ego_at_lidar_ts'):
            assert ft[k].dtype == fj[k].dtype
            assert ft[k].tobytes() == fj[k].tobytes(), k
        for a, b in zip(fj['images'], ft['images']):
            assert b.dtype == np.uint8 and b.tobytes() == np.asarray(a).tobytes()
        for k in ('inst_tokens', 'inst_cls', 'ego_global_x', 'ego_global_y',
                  'meta'):
            assert ft[k] == fj[k], k
        for a, b in zip(fj['inst_center'], ft['inst_center']):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# Oracle-pose accumulator
# ----------------------------------------------------------------------
def _oracles(semseg_pair, **kw):
    sem_j, sem_t = semseg_pair
    args = dict(bev_params=BEV_PARAMS, loc='synth-map', seed=0, **kw)
    a_j = JOracle(semseg_model=sem_j, accum_cfg=jcfg.AccumConfig(**ACCUM),
                  **args)
    a_t = TOracle(semseg_model=sem_t, accum_cfg=tcfg.AccumConfig(**ACCUM),
                  device='cpu', **args)
    return a_j, a_t


@pytest.fixture(scope='module')
def oracle_run(semseg_pair):
    """The JAX tests' oracle fixture (10 frames, seed 2, a lane) through
    both accumulators."""
    stream = tsyn.SyntheticNuScenesStream(n_frames=10, step=2.0,
                                          lidar_range=20.0, seed=2)
    a_j, a_t = _oracles(semseg_pair, get_gt_lanes=True,
                        gt_lane_poses=LANES)
    for obs in stream:
        _quiet(a_j.integrate, obs)
        _quiet(a_t.integrate, obs)
    bj = a_j.generate_bev(present_idx=5, bev_num=1, gen_future=True)[0]
    bt = a_t.generate_bev(present_idx=5, bev_num=1, gen_future=True)[0]
    return a_j, a_t, bj, bt


def test_oracle_state_matches(oracle_run):
    a_j, a_t, _, _ = oracle_run
    np.testing.assert_array_equal(np.array(a_t.poses), np.array(a_j.poses))
    np.testing.assert_array_equal(a_t.get_pose(), a_j.get_pose())
    assert a_t.seg_dists == a_j.seg_dists
    assert a_t.ego_global_xs == a_j.ego_global_xs
    np.testing.assert_array_equal(a_t.state.inst_dyn.numpy(),
                                  np.asarray(a_j.state.inst_dyn))
    tr_j, tr_t = a_j.tracker, a_t.tracker
    assert tr_t.token2global == tr_j.token2global
    assert tr_t.dyn_instances == tr_j.dyn_instances == ['car_moving']
    gid = tr_t.token2global['car_moving']
    assert float(a_t.state.inst_dyn[gid]) == 1.0
    assert float(a_t.state.inst_dyn[tr_t.token2global['car_parked']]) == 0.0
    np.testing.assert_array_equal(a_t.state.frame_ids.numpy(),
                                  np.asarray(a_j.state.frame_ids))
    vj = np.asarray(a_j.state.valid)
    np.testing.assert_array_equal(a_t.state.valid.numpy(), vj)
    pj, pt = np.asarray(a_j.state.points), a_t.state.points.numpy()
    np.testing.assert_allclose(pt[vj], pj[vj], rtol=0, atol=1e-5)
    # Colours, class, instance and dyn columns: exact.
    np.testing.assert_array_equal(pt[vj][:, 4:], pj[vj][:, 4:])
    # Both instances' points were painted with their global ids.
    assert {1.0, 2.0} <= set(np.unique(pt[vj][:, tcfg.PT_INST]).tolist())
    assert a_t.max_painted == int(a_t.state.valid.sum(1).max())


def test_oracle_bev_matches(oracle_run):
    a_j, a_t, bj, bt = oracle_run
    _assert_maps_match(bj, bt)
    assert len(bt['trajs_full']) >= 2 and len(bt['gt_lanes']) >= 1
    # dynamic_full carries observations (cells off the empty prior 0.5) on
    # both sides, and the dynamic table is folded in at raster time: with
    # the moving car's flag cleared its points join the static maps.
    for a, b in ((a_j, bj), (a_t, bt)):
        assert (np.asarray(b['dynamic_full'], np.float32) != 0.5).any()
    a_j.state = a_j.state._replace(
        inst_dyn=jnp.zeros_like(a_j.state.inst_dyn))
    flag_t = a_t.state.inst_dyn.clone()
    a_t.state.inst_dyn.zero_()
    try:
        uj = a_j.generate_bev(present_idx=5, bev_num=1, gen_future=True)[0]
        ut = a_t.generate_bev(present_idx=5, bev_num=1, gen_future=True)[0]
    finally:
        a_j.state = a_j.state._replace(inst_dyn=jnp.asarray(flag_t.numpy()))
        a_t.state.inst_dyn.copy_(flag_t)
    _assert_maps_match(uj, ut)
    changed = [np.sum(u['road_full'] != b['road_full'])
               for u, b in ((uj, bj), (ut, bt))]
    assert changed[0] == changed[1] > 0
    for xs, ys in zip(a_j._other_trajs(5, True), a_t._other_trajs(5, True)):
        assert len(xs) == len(ys) >= 1
        for x, y in zip(xs, ys):
            np.testing.assert_allclose(y, x, atol=1e-9)
    for split in (0, 5, 9):
        assert a_t.get_split_dyn_obj_trajs(split) == \
            a_j.get_split_dyn_obj_trajs(split)
    assert a_t.get_dyn_obj_trajs(2, 7, skip_ego_traj=False) == \
        a_j.get_dyn_obj_trajs(2, 7, skip_ego_traj=False)


def test_oracle_upload_obs_matches_raw(semseg_pair):
    """Pre-uploaded OracleDeviceObs give the same state and samples as raw
    observation dicts; upload_obs is idempotent and counts the bytes."""
    stream = tsyn.SyntheticNuScenesStream(n_frames=5, step=2.0,
                                          lidar_range=20.0, seed=5)
    _, a_raw = _oracles(semseg_pair)
    _, a_dev = _oracles(semseg_pair)
    for batch in stream:
        _quiet(a_raw.integrate, batch)
        dob = a_dev.upload_obs(batch[0])
        assert isinstance(dob, OracleDeviceObs)
        assert a_dev.upload_obs(dob) is dob
        _quiet(a_dev.integrate, [dob])
    assert a_dev.upload_frames == 5
    imgs = 6 * 64 * 128 * 3
    assert a_dev.upload_bytes_total == 5 * (16384 * (7 * 4 + 4 + 1) + imgs)
    assert a_raw.poses == a_dev.poses
    assert torch.equal(a_raw.state.points, a_dev.state.points)
    br = a_raw.generate_bev(present_idx=3, bev_num=1, gen_future=True)[0]
    bd = a_dev.generate_bev(present_idx=3, bev_num=1, gen_future=True)[0]
    for k in br:
        if not k.startswith('trajs'):
            np.testing.assert_array_equal(br[k], bd[k], err_msg=k)


def test_oracle_async_fetch_and_painted_overflow(semseg_pair):
    """async_fetch returns a callable yielding the samples; a frame that
    paints more points than the cap raises when the counts are read."""
    stream = tsyn.SyntheticNuScenesStream(n_frames=3, step=2.0,
                                          lidar_range=20.0, seed=5)
    frames = [stream.frame(i) for i in range(3)]
    _, a = _oracles(semseg_pair)
    for f in frames:
        _quiet(a.integrate, [f])
    handle = a.generate_bev(present_idx=1, bev_num=2, gen_future=True,
                            async_fetch=True)
    assert callable(handle) and len(handle()) == 2
    peak = a.max_painted
    assert 0 < peak <= ACCUM['max_painted_points_per_frame']
    sem_t = semseg_pair[1]
    small = TOracle(semseg_model=sem_t, bev_params=BEV_PARAMS,
                    accum_cfg=tcfg.AccumConfig(
                        **dict(ACCUM, max_painted_points_per_frame=peak // 4)),
                    device='cpu')
    _quiet(small.integrate, [frames[0]])
    with pytest.raises(RuntimeError, match='Painted-point overflow'):
        small.generate_bev(bev_num=1)


@pytest.mark.parametrize('wire, err', [
    (dict(img_transfer='yuv420'), NotImplementedError),
    (dict(img_transfer='yuv420h'), NotImplementedError),
    (dict(transfer_dtype='quantized'), NotImplementedError),
    (dict(img_transfer='jpeg'), ValueError),
    (dict(transfer_dtype='int8'), ValueError)])
@pytest.mark.parametrize('cls', ['oracle', 'icp'])
def test_unported_wires_raise(semseg_pair, wire, err, cls):
    """Unknown wire names raise ValueError. The yuv and quantized wires
    raised NotImplementedError until their codecs were ported: they now
    construct and keep their names (their parity with the JAX package is
    tests/test_torch_wire.py's)."""
    sem_t = semseg_pair[1]

    def make():
        if cls == 'oracle':
            return TOracle(semseg_model=sem_t, bev_params=BEV_PARAMS,
                           device='cpu', **wire)
        return TIcp(100.0, 1e3, semseg_model=sem_t, bev_params=BEV_PARAMS,
                    device='cpu', **wire)

    if err is NotImplementedError:
        a = make()
        for k, v in wire.items():
            assert getattr(a, k) == v
        return
    with pytest.raises(err):
        make()


def test_vector_space_export_matches_jax(oracle_run, tmp_path):
    a_j, a_t, _, _ = oracle_run
    np.testing.assert_allclose(a_t.get_vector_space(),
                               np.asarray(a_j.get_vector_space()), atol=1e-5)
    for color in ('dyn', 'rgb'):
        pj, pt = (str(tmp_path / f'{n}_{color}.ply') for n in ('j', 't'))
        assert a_t.viz_sem_vec_space(pt, color) == \
            a_j.viz_sem_vec_space(pj, color) > 0
        assert jply.read_ply_header(pt) == jply.read_ply_header(pj)
        tail_j = open(pj, 'rb').read()
        tail_t = open(pt, 'rb').read()
        if color == 'dyn':
            # Colours from the same flags: byte-identical files.
            n = jply.read_ply_header(pt)['n']
            rec = np.frombuffer(tail_t[-15 * n:], dtype=[
                ('xyz', '<f4', 3), ('rgb', 'u1', 3)])
            rec_j = np.frombuffer(tail_j[-15 * n:], dtype=rec.dtype)
            np.testing.assert_array_equal(rec['rgb'], rec_j['rgb'])
            # Yellow (dynamic) points: the moving car's.
            assert (rec['rgb'][:, 0] == 253).sum() > 0
        np.testing.assert_array_equal(np.loadtxt(pt + '.poses.txt'),
                                      np.loadtxt(pj + '.poses.txt'))


# ----------------------------------------------------------------------
# ICP-pose accumulator
# ----------------------------------------------------------------------
def test_icp_accumulator_matches_jax(semseg_pair):
    """The JAX tests' ICP stream (8 frames, seed 3) with eviction at a
    10 m horizon."""
    sem_j, sem_t = semseg_pair
    stream = tsyn.SyntheticNuScenesStream(n_frames=8, step=2.0,
                                          lidar_range=25.0, seed=3)
    kw = dict(bev_params=BEV_PARAMS, loc='synth-map', seed=0)
    icp = dict(max_downsampled=2048, num_iters=16)
    a_j = JIcp(10.0, 1e3, semseg_model=sem_j,
               accum_cfg=jcfg.AccumConfig(**ACCUM),
               icp_cfg=jcfg.ICPConfig(**icp), **kw)
    a_t = TIcp(10.0, 1e3, semseg_model=sem_t,
               accum_cfg=tcfg.AccumConfig(**ACCUM),
               icp_cfg=tcfg.ICPConfig(**icp), device='cpu', **kw)
    removed = []
    for obs in stream:
        rj = _quiet(a_j.integrate, obs)
        rt = _quiet(a_t.integrate, obs)
        assert rt == rj
        removed.append(rt)
        assert a_t.window_start == a_j.window_start
        np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                                   atol=1e-4)
    assert sum(removed) > 0, 'no eviction in the run'
    steps = np.linalg.norm(np.diff(a_t.get_pose(), axis=0), axis=1)
    np.testing.assert_allclose(steps, 2.0, atol=0.4)
    assert a_t.ego_global_xs == a_j.ego_global_xs
    # The image-list quirk: get_rgb(idx) is the frame's list itself.
    assert len(a_t.get_rgb(1)) == 6 and a_t.get_rgb(1) is a_t.rgbs[1]
    assert tuple(a_t.get_semseg(1).shape) == (6, 64, 128)
    for pi in (1, 3):
        bj = a_j.generate_bev(present_idx=pi, bev_num=1, gen_future=True)[0]
        bt = a_t.generate_bev(present_idx=pi, bev_num=1, gen_future=True)[0]
        _assert_maps_match(bj, bt, traj_atol=1.0)


def test_bev_ref_frame_world_is_identity(semseg_pair):
    """The oracle's bev_ref_frame='world' gives the identity reference
    transform; 'latest' inverts the newest pose."""
    _, a = _oracles(semseg_pair)
    assert a.bev_ref_frame == 'world'
    T = np.eye(4)
    T[:3, 3] = [5.0, -2.0, 1.0]
    a.T_world_velo = [np.eye(4), T]
    np.testing.assert_array_equal(a._ref_transform(), np.eye(4))
    a.bev_ref_frame = 'latest'
    np.testing.assert_array_equal(a._ref_transform(), np.linalg.inv(T))


def test_mesh_bev_param_raises(semseg_pair):
    """bev_params['mesh'] rasters point-sharded (tests/test_torch_mesh*.py);
    an accumulator built with it on a rank other than the points axis's
    rank 0, which only serves rasters, raises before any collective."""
    worker_rank = types.SimpleNamespace(get_local_rank=lambda axis: 1)
    with pytest.raises(ValueError, match='rank 0 of the points axis'):
        TOracle(semseg_model=semseg_pair[1],
                bev_params=dict(BEV_PARAMS, mesh=worker_rank), device='cpu')
