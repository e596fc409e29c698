"""The port's own copies of the JAX package's host modules against the
originals: config dataclasses and constants, ops/trajectory, utils/io,
utils/async_writer, the KITTI-360 dataloader, bev/viz, accum/tracking,
dataloaders/lanemap, parallel/manifest, utils/ply and the NuScenes
helpers of dataloaders/nuscenes_utils; and the port's entry points
defaulting to the card.

The copies are pure Python and numpy, so each comparison is exact: the
same fields and defaults, the same arrays from the same seeded numpy
inputs, files that either side reads back."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from fake_nusc import FakeNuScenes
from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.accum import tracking as jtrack
from pc_accumulation_lib_tpu.bev import viz as jviz
from pc_accumulation_lib_tpu.dataloaders import kitti360 as jk360
from pc_accumulation_lib_tpu.dataloaders import lanemap as jlane
from pc_accumulation_lib_tpu.dataloaders import nuscenes_utils as jnu
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    write_kitti360_layout)
from pc_accumulation_lib_tpu.ops import trajectory as jtraj
from pc_accumulation_lib_tpu.parallel import manifest as jman
from pc_accumulation_lib_tpu.utils import io as jio
from pc_accumulation_lib_tpu.utils import ply as jply
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.accum import base as tbase
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.accum import nuscenes as tnus
from pc_accumulation_lib_tpu_torch.accum import nuscenes_oracle as tora
from pc_accumulation_lib_tpu_torch.accum import tracking as ttrack
from pc_accumulation_lib_tpu_torch.bev import sem_bev as tsem
from pc_accumulation_lib_tpu_torch.bev import viz as tviz
from pc_accumulation_lib_tpu_torch.dataloaders import kitti360 as tk360
from pc_accumulation_lib_tpu_torch.dataloaders import lanemap as tlane
from pc_accumulation_lib_tpu_torch.dataloaders import nuscenes_utils as tnu
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models import semseg as tsemseg
from pc_accumulation_lib_tpu_torch.ops import trajectory as ttraj
from pc_accumulation_lib_tpu_torch.parallel import manifest as tman
from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as trun
from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as tnrun
from pc_accumulation_lib_tpu_torch.utils import io as tio
from pc_accumulation_lib_tpu_torch.utils import ply as tply
from pc_accumulation_lib_tpu_torch.utils.async_writer import (
    AsyncPickleWriter)

DATACLASSES = ('BEVConfig', 'AccumConfig', 'ICPConfig', 'SamplingConfig',
               'OutputConfig')


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize('name', DATACLASSES + ('constants',))
def test_config_matches_jax(name):
    if name == 'constants':
        names = sorted(n for n in vars(jcfg) if n.isupper())
        assert names == sorted(n for n in vars(tcfg) if n.isupper())
        for n in names:
            assert getattr(tcfg, n) == getattr(jcfg, n), n
        return
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert t is not j
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _defaults(t) == _defaults(j)
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen
    props = [n for n, v in vars(j).items() if isinstance(v, property)]
    for p in props:
        assert getattr(t(), p) == getattr(j(), p), p


def _trajs(rng):
    """Random walks that start inside a 40 m box and leave it."""
    out = []
    for n in (1, 2, 7, 40):
        steps = rng.normal(scale=6.0, size=(n, 3))
        out.append(np.cumsum(steps, axis=0) + rng.uniform(-5, 5, size=3))
    return out


@pytest.mark.parametrize('fn', ['crop_trajectory',
                                'geometric_transform_traj', 'pos2grid_traj',
                                '_box_intersection', 'point_in_box'])
def test_trajectory_matches_jax(fn):
    rng = np.random.default_rng(5)
    j, t = getattr(jtraj, fn), getattr(ttraj, fn)
    for traj in _trajs(rng):
        if fn == 'crop_trajectory':
            args = (traj, 40.0)
        elif fn == 'geometric_transform_traj':
            args = (traj, *rng.uniform(-3, 3, size=3), 40.0)
        elif fn == 'pos2grid_traj':
            args = (traj, 40.0, 128)
        elif fn == '_box_intersection':
            args = (0.5, -1.0, *(traj[-1, :2] * 10), (-20., -20., 20., 20.))
        else:
            args = (*traj[0, :2], -20., -20., 20., 20.)
        np.testing.assert_array_equal(np.asarray(t(*args)),
                                      np.asarray(j(*args)))


def _sample(rng):
    return {'road_present': rng.normal(size=(32, 32)).astype(np.float16),
            'trajs_present': [rng.normal(size=(5, 3))], 'idx': 3}


def _assert_same_sample(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(a['road_present'], b['road_present'])
    np.testing.assert_array_equal(a['trajs_present'][0],
                                  b['trajs_present'][0])
    assert a['idx'] == b['idx']


@pytest.mark.parametrize('writer, reader', [(jio, tio), (tio, jio)],
                         ids=['jax_writes', 'port_writes'])
def test_io_roundtrip_across_packages(tmp_path, writer, reader):
    obj = _sample(np.random.default_rng(1))
    for d, mod in (('w', writer), ('r', reader)):
        (tmp_path / d).mkdir()
        mod.write_compressed_pickle(obj, 'a.pkl', str(tmp_path / d))
    _assert_same_sample(reader.read_compressed_pickle(
        str(tmp_path / 'w' / 'a.pkl.gz')), obj)
    # mtime 0 on both sides: byte-identical files.
    assert (tmp_path / 'w' / 'a.pkl.gz').read_bytes() == \
        (tmp_path / 'r' / 'a.pkl.gz').read_bytes()


@pytest.mark.parametrize('force_python', [False, True],
                         ids=['native', 'python_gzip'])
def test_async_writer_reads_back(tmp_path, force_python):
    rng = np.random.default_rng(2)
    objs = [_sample(rng) for _ in range(4)]
    w = AsyncPickleWriter(n_threads=2, force_python=force_python)
    assert w.native == (not force_python)
    for i, obj in enumerate(objs):
        w.write(obj, f'bev_{i:03d}.pkl', str(tmp_path))
    w.wait()
    assert w.pending() == 0
    for i, obj in enumerate(objs):
        path = str(tmp_path / f'bev_{i:03d}.pkl.gz')
        _assert_same_sample(tio.read_compressed_pickle(path), obj)
        _assert_same_sample(jio.read_compressed_pickle(path), obj)


def test_kitti360_dataloader_matches_jax(tmp_path):
    seq = '2013_05_28_drive_0000_sync'
    root = str(tmp_path / 'kitti360')
    write_kitti360_layout(root, seq=seq, n_frames=3, step=2.0,
                          lidar_range=20.0, seed=4, points_per_frame=500)
    for fn in ('get_transf_matrices', 'get_camera_intrinsics'):
        np.testing.assert_array_equal(np.asarray(getattr(tk360, fn)(root)),
                                      np.asarray(getattr(jk360, fn)(root)))
    args = (root, 2, [seq], [0], [3])
    jl, tl = jk360.Kitti360Dataloader(*args), tk360.Kitti360Dataloader(*args)
    assert len(tl) == len(jl) == 3
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == 1      # the final partial batch is dropped
    for (ji, jp, js), (ti, tp, ts) in zip(jb[0], tb[0]):
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)


def test_viz_bev_matches_jax(tmp_path):
    import matplotlib.image as mpimg
    rng = np.random.default_rng(3)
    P = 32
    bev = {f'{k}_{s}': rng.uniform(size=(P, P)).astype(np.float16)
           for k in ('road', 'dynamic', 'intensity', 'elevation')
           for s in ('present', 'future', 'full')}
    bev.update({f'rgb_{s}': rng.uniform(size=(3, P, P)).astype(np.float16)
                for s in ('present', 'future', 'full')})
    bev.update({f'trajs_{s}': [rng.uniform(0, P, size=(4, 3))]
                for s in ('present', 'future', 'full')})
    bev['gt_lanes'] = [rng.uniform(0, P, size=(3, 3))]
    paths = [str(tmp_path / f'{n}.png') for n in ('jax', 'port')]
    jviz.viz_bev(bev, paths[0], P)
    tviz.viz_bev(bev, paths[1], P)
    a, b = (mpimg.imread(p) for p in paths)
    assert a.shape == b.shape and a.shape[0] > P
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('entry', [
    tsem.SemBEVGenerator.__init__, tbase.SemanticPointCloudAccumulator.__init__,
    tk3.Kitti360SemanticPointCloudAccumulator.__init__,
    tsemseg.SemSegTorch.__init__, trun.run,
    tora.NuScenesOracleSemanticPointCloudAccumulator.__init__,
    tnus.NuScenesSemanticPointCloudAccumulator.__init__, tnrun.run],
    ids=['SemBEVGenerator', 'SemanticPointCloudAccumulator',
         'Kitti360SemanticPointCloudAccumulator', 'SemSegTorch', 'run',
         'NuScenesOracleSemanticPointCloudAccumulator',
         'NuScenesSemanticPointCloudAccumulator', 'nuscenes_run'])
def test_entry_point_defaults_to_cuda(entry):
    assert inspect.signature(entry).parameters['device'].default == 'cuda'


def test_nuscenes_main_defaults_to_cuda(monkeypatch, tmp_path):
    """The NuScenes runner's CLI builds its model on the card unless
    --device says otherwise."""
    seen = {}
    monkeypatch.setattr(tsemseg, 'SemSegTorch',
                        lambda device, seed: seen.update(model=device))
    monkeypatch.setattr(tnrun, 'run',
                        lambda *a, **kw: seen.update(run=kw['device']))
    tnrun.main([str(tmp_path)])
    assert seen == {'model': 'cuda', 'run': 'cuda'}


# ----------------------------------------------------------------------
# NuScenes host modules
# ----------------------------------------------------------------------
def _tracker_sequences():
    """(name, tracker kwargs, [(ts, tokens, classes, centers)]): the JAX
    tests' flagging and trajectory-split sequences, and a random one with
    gaps, repeats, untracked classes and tokens that appear late."""
    c0 = np.zeros(3)
    flagging = [(ts, ['mov', 'park'], [0, 0], [c0 + [0.6 * ts, 0, 0], c0])
                for ts in range(4)] + [(5, ['tr'], [4], [c0])]
    split = [(ts, ['mov'], [0], [np.array([1.0 * ts, 0, 0])])
             for ts in range(6)]
    rng = np.random.default_rng(11)
    tokens = [f'obj{i}' for i in range(7)]
    start = rng.uniform(-20, 20, (7, 3))
    vel = rng.normal(0, 0.7, (7, 3)) * (rng.random((7, 1)) < 0.6)
    rand = []
    for ts in range(40):
        if rng.random() < 0.15:
            continue                      # a gap in time
        seen = [i for i in range(7) if rng.random() < 0.7]
        seen += list(rng.choice(seen, size=min(2, len(seen)))) if seen else []
        rand.append((ts, [tokens[i] for i in seen],
                     [int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7]))
                      for _ in seen],
                     [start[i] + vel[i] * ts + rng.normal(0, 0.05, 3)
                      for i in seen]))
    return [('flagging', dict(dyn_trans_thresh=1.0), flagging),
            ('split', dict(dyn_trans_thresh=0.5), split),
            ('random', {}, rand)]


@pytest.mark.parametrize('name, kw, seq', _tracker_sequences(),
                         ids=['flagging', 'split', 'random'])
def test_tracker_matches_jax(name, kw, seq):
    tj, tt = jtrack.InstanceTracker(**kw), ttrack.InstanceTracker(**kw)
    for ts, tokens, classes, centers in seq:
        assert tt.update(ts, tokens, classes, centers) == \
            tj.update(ts, tokens, classes, centers)
    assert tt.dyn_instances == tj.dyn_instances
    assert tt.token2global == tj.token2global
    assert tt._next_global == tj._next_global
    if name != 'split':
        assert tt.dyn_instances      # something was flagged
    last = seq[-1][0]
    for split_idx in range(0, last + 2, max(1, last // 8)):
        assert tt.get_split_dyn_obj_trajs(split_idx) == \
            tj.get_split_dyn_obj_trajs(split_idx)
    ego = [[float(i), 0.0, 1.0] for i in range(5)]
    for lo, hi in ((0, None), (3, 9), (last, None), (last + 5, None)):
        assert tt.get_dyn_obj_trajs(lo, hi, ego_poses=ego) == \
            tj.get_dyn_obj_trajs(lo, hi, ego_poses=ego)


@pytest.mark.parametrize('ts', [[0, 1, 2, 3, 4, 6, 8, 9, 10], [2, 3],
                                [0, 1, 3, 4, 5, 9], [7]])
def test_tracker_index_helpers_match_jax(ts):
    J, T = jtrack.InstanceTracker, ttrack.InstanceTracker
    assert T.parse_seq_into_coherent_seqs(ts) == \
        J.parse_seq_into_coherent_seqs(ts)
    for target in range(-1, ts[-1] + 3):
        for fn in ('find_nearest_ge_idx', 'find_nearest_le_idx'):
            try:
                want = getattr(J, fn)(ts, target)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(T, fn)(ts, target)
                continue
            assert getattr(T, fn)(ts, target) == want


def test_crop_centerline_poses_matches_jax():
    rng = np.random.default_rng(6)
    lanes = [np.cumsum(rng.normal(0, 3, (n, 3)), axis=0) for n in
             (1, 5, 40, 200)] + [np.zeros((0, 3))]
    for bbox in ((-10, -10, 10, 10), (0, -50, 50, 0), (100, 100, 200, 200)):
        got = tlane.crop_centerline_poses(lanes, bbox)
        want = jlane.crop_centerline_poses(lanes, bbox)
        assert len(got) == len(want) == len(lanes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert sum(len(a) for a in got) < sum(len(a) for a in lanes)


def test_manifest_matches_jax(tmp_path):
    units = [str(i) for i in range(11)]
    mans = {}
    for name, mod in (('jax', jman), ('port', tman)):
        m = mod.CompletionManifest(str(tmp_path / name / 'm.jsonl'))
        m.mark_done('0', bevs=3)
        m.mark_skipped('1', 'rain')
        m.mark_skipped('1', 'rain')         # repeat: not appended
        m.mark_skipped('2', 'idx_list')
        m.mark_done('2', bevs=0)
        m.mark_done('5', bevs=7)
        mans[name] = m
    lines = [(tmp_path / n / 'm.jsonl').read_text() for n in ('jax', 'port')]
    assert lines[0] == lines[1]
    for name, mod in (('jax', jman), ('port', tman)):
        # Reloaded from the file, each package reads either file the same.
        for src in ('jax', 'port'):
            r = mod.CompletionManifest(str(tmp_path / src / 'm.jsonl'))
            assert [r.is_done(u) for u in units] == \
                [mans['jax'].is_done(u) for u in units]
            assert [r.get(u) for u in units] == \
                [mans['jax'].get(u) for u in units]
            assert r.stats() == mans['jax'].stats()
    for shards in (1, 3):
        for idx in range(shards):
            for man in (None, 'file'):
                mj = man and jman.CompletionManifest(
                    str(tmp_path / 'jax' / 'm.jsonl'))
                mt = man and tman.CompletionManifest(
                    str(tmp_path / 'port' / 'm.jsonl'))
                assert tman.shard_units(units, idx, shards, mt) == \
                    jman.shard_units(units, idx, shards, mj)


@pytest.mark.parametrize('with_rgb', [True, False])
def test_ply_matches_jax(tmp_path, with_rgb):
    rng = np.random.default_rng(8)
    xyz = rng.normal(0, 20, (257, 3))
    rgb = rng.uniform(-20, 280, (257, 3)) if with_rgb else None
    paths = [str(tmp_path / f'{n}.ply') for n in ('jax', 'port')]
    jply.write_ply(paths[0], xyz, rgb)
    tply.write_ply(paths[1], xyz, rgb)
    assert open(paths[0], 'rb').read() == open(paths[1], 'rb').read()
    for p in paths:
        assert tply.read_ply_header(p) == jply.read_ply_header(p)
    assert tply.read_ply_header(paths[1])['n'] == 257


def _rig(rng, C=6):
    cam_from_pts, Ks, whs = [], [], []
    for c in range(C):
        yaw = 2 * np.pi * c / C
        T = jnu.tf([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.5],
                   [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        cam_from_pts.append(np.linalg.inv(T))
        Ks.append(np.array([[100., 0, 64], [0, 100., 48], [0, 0, 1]]))
        whs.append([128.0, 96.0])
    return np.stack(cam_from_pts), np.stack(Ks), np.asarray(whs)


def test_nuscenes_geometry_helpers_match_jax():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-20, 20, (700, 3))
    for _ in range(10):
        q = rng.normal(size=4)
        np.testing.assert_array_equal(tnu.quat_wxyz_to_matrix(q),
                                      jnu.quat_wxyz_to_matrix(q))
        t = rng.normal(size=3)
        for rot in (q, jnu.quat_wxyz_to_matrix(q)):
            np.testing.assert_array_equal(tnu.tf(t, rot), jnu.tf(t, rot))
    T = jnu.tf(rng.normal(size=3), rng.normal(size=4))
    np.testing.assert_array_equal(tnu.homo_transform(T, pts),
                                  jnu.homo_transform(T, pts))
    np.testing.assert_array_equal(tnu.apply_tf(T, pts), jnu.apply_tf(T, pts))
    a, b = pts.copy(), pts.copy()
    assert tnu.apply_tf(T, a, in_place=True) is None
    jnu.apply_tf(T, b, in_place=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnu.remove_ego_vehicle_points(pts, 8.0),
                                  jnu.remove_ego_vehicle_points(pts, 8.0))
    cam_from_pts, Ks, whs = _rig(rng)
    for got, want in zip(
            tnu.project_points_to_rig(pts, cam_from_pts, Ks, whs),
            jnu.project_points_to_rig(pts, cam_from_pts, Ks, whs)):
        np.testing.assert_array_equal(got, want)
    local = jnu.homo_transform(cam_from_pts[0], pts)
    for got, want in zip(tnu.project_pts3d(local, Ks[0], whs[0]),
                         jnu.project_pts3d(local, Ks[0], whs[0])):
        np.testing.assert_array_equal(got, want)
    boxes = np.stack([jnu.tf(rng.uniform(-15, 15, 3), rng.normal(size=4))
                      for _ in range(5)])
    sizes = rng.uniform(2, 9, (5, 3))
    inside = tnu.find_points_in_boxes(pts, boxes, sizes, 5e-2)
    np.testing.assert_array_equal(
        inside, jnu.find_points_in_boxes(pts, boxes, sizes, 5e-2))
    assert inside.any() and not inside.all()
    assert tnu.find_points_in_boxes(pts, boxes[:0], sizes[:0],
                                    0.0).shape == (700, 0)
    assert tnu.DETECTION_CLASSES == jnu.DETECTION_CLASSES
    assert tnu.map_name_from_general_to_detection == \
        jnu.map_name_from_general_to_detection


@pytest.fixture(scope='module')
def fake_nusc(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake_nusc_host')
    return FakeNuScenes(str(root), n_keyframes=3, sweeps_between=2,
                        step=2.0, seed=0)


def test_nuscenes_devkit_helpers_match_jax(fake_nusc):
    nusc = fake_nusc
    sd = 'sd_lidar_2_2'
    for n in (1, 2, 4, 9):          # 9: more than the chain holds
        for lag in (False, True):
            for idx in (False, True):
                assert tnu.get_sweeps_token(nusc, sd, n, lag, idx) == \
                    jnu.get_sweeps_token(nusc, sd, n, lag, idx)
    for tok in ('sd_lidar_0_2', sd, 'sd_cam3_1'):
        for fn in ('get_nuscenes_sensor_pose_in_ego_vehicle',
                   'get_nuscenes_sensor_pose_in_global'):
            np.testing.assert_array_equal(getattr(tnu, fn)(nusc, tok),
                                          getattr(jnu, fn)(nusc, tok))
    np.testing.assert_array_equal(
        tnu.get_sample_data_point_cloud(nusc, sd, 0.25, 3),
        jnu.get_sample_data_point_cloud(nusc, sd, 0.25, 3))
    rec = nusc.get('sample_data', 'sd_cam2_1')
    lt, lj = (m.NuScenesLidar(nusc, nusc.get('sample_data', sd))
              for m in (tnu, jnu))
    ct, cj = (m.NuScenesCamera(nusc, rec) for m in (tnu, jnu))
    for t, j in ((lt, lj), (ct, cj)):
        assert (t.token, t.channel) == (j.token, j.channel)
        for k in ('ego_from_self', 'glob_from_ego', 'glob_from_self'):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    np.testing.assert_array_equal(ct.cam_K, cj.cam_K)
    np.testing.assert_array_equal(np.asarray(ct.img), np.asarray(cj.img))
    pts = np.random.default_rng(1).uniform(-5, 30, (300, 3))
    for got, want in zip(ct.project_pts3d(pts), cj.project_pts3d(pts)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n_sweeps, last_box, pc_range', [
    (1, True, [-1000] * 3 + [1000] * 3),
    (3, True, [-1000] * 3 + [1000] * 3),
    (3, True, [-2, -30, -5, 4, 30, 5]),      # some boxes' centres out
    (5, False, [-1000] * 3 + [1000] * 3)])
def test_inst_centric_get_sweeps_matches_jax(fake_nusc, n_sweeps, last_box,
                                             pc_range):
    kw = dict(n_sweeps=n_sweeps, center_radius=2.0, in_box_tolerance=5e-2,
              return_instances_last_box=last_box, point_cloud_range=pc_range,
              detection_classes=jnu.DETECTION_CLASSES,
              map_point_feat2idx={'sweep_idx': 5, 'inst_idx': 6,
                                  'cls_idx': 7})
    for sample in ('sample0', 'sample2'):
        got = tnu.inst_centric_get_sweeps(fake_nusc, sample, **kw)
        want = jnu.inst_centric_get_sweeps(fake_nusc, sample, **kw)
        assert set(got) == set(want)
        assert got['instances_token'] == want['instances_token']
        for k in ('points', 'instances_center', 'instances_last_box',
                  'instances_name'):
            if k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), err_msg=k)
        assert (got['points'][:, 6] >= 0).any()


def test_sem_bev_generator_defaults_to_cuda_and_allocates_nothing():
    """Constructed without ``device`` it holds the card; on a machine
    without one (as here) construction still succeeds, since it allocates
    nothing and does not initialise CUDA."""
    gen = tsem.SemBEVGenerator(tcfg.DEFAULT_SEM_IDXS, 40.0, 64)
    assert gen.device == torch.device('cuda')
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()


def test_write_kitti360_layout_matches_jax(tmp_path):
    """The port's copy of write_kitti360_layout writes the JAX package's
    tree byte for byte (calibration, velodyne, PNG and label files)."""
    import os

    def read(path):
        with open(path, 'rb') as f:
            return f.read()

    trees = {}
    for name, write in (('jax', write_kitti360_layout),
                        ('torch', tsyn.write_kitti360_layout)):
        root = str(tmp_path / name)
        write(root, n_frames=2, step=2.0, lidar_range=15.0, seed=5,
              points_per_frame=500)
        trees[name] = {os.path.relpath(os.path.join(d, f), root):
                       read(os.path.join(d, f))
                       for d, _, names in os.walk(root) for f in names}
    assert len(trees['jax']) == 8
    assert trees['torch'] == trees['jax']
