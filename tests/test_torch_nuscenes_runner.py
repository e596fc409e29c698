"""The port's NuScenes dataloader and BEV runner against the JAX package's
on the devkit test double (tests/fake_nusc.py).

Checked: read_obs array by array and exactly, for 1 and 3 sweeps; run()
for both pose branches with the reduced-depth semseg model (weights
carried over by name): the same stats, file names and per-sample metadata,
maps under bench.py's step() rule (cell-mismatch fraction below 0.02 at
2e-2), the same number of trajectories per split within 1 px; a rerun on
the same manifest is a no-op.
"""
import os

import numpy as np
import pytest

from fake_nusc import FakeNuScenes
from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.dataloaders import nuscenes as jnusc
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.runners import nuscenes_bev_gen as jrun
from pc_accumulation_lib_tpu.utils.io import read_compressed_pickle
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.dataloaders import nuscenes as tnusc
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)
from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as trun
from pc_accumulation_lib_tpu_torch.runners import (
    nuscenes_oracle_bev_gen as toracle_run)

BEV_PARAMS = {'type': 'sem', 'view_size': 40, 'pixel_size': 64,
              'max_trans_radius': 0., 'zoom_thresh': 0., 'do_warp': False,
              'int_scaler': 1., 'int_sep_scaler': 30.,
              'int_mid_threshold': 0.12, 'height_filter': None}


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


@pytest.mark.parametrize('num_sweeps', [1, 3])
def test_read_obs_matches_jax(tmp_path, num_sweeps):
    nusc = FakeNuScenes(str(tmp_path / 'nusc'), n_keyframes=3,
                        sweeps_between=2, step=2.0, seed=0)
    jl = jnusc.NuScenesDataloader(nusc, [0], 1, num_sweeps)
    tl = tnusc.NuScenesDataloader(nusc, [0], 1, num_sweeps)
    assert tl.sample_tokens == jl.sample_tokens
    assert tnusc.keyframe_tokens(nusc, [0]) == jnusc.keyframe_tokens(nusc, [0])
    assert len(tl) == len(jl) == 3
    for idx in range(3):
        oj, ot = jl.read_obs(idx), tl.read_obs(idx)
        assert set(ot) == set(oj)
        for k in ('pc', 'pc_cam_idx', 'ego_at_lidar_ts'):
            assert ot[k].dtype == oj[k].dtype and ot[k].shape == oj[k].shape
            np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
        assert len(ot['images']) == 6
        for a, b in zip(oj['images'], ot['images']):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        for k in ('inst_tokens', 'inst_cls', 'ego_global_x', 'ego_global_y',
                  'meta'):
            assert ot[k] == oj[k], k
        assert len(ot['inst_center']) == len(oj['inst_center'])
        for a, b in zip(oj['inst_center'], ot['inst_center']):
            np.testing.assert_array_equal(b, a)
    # Multi-sweep clouds hold more rows than one sweep, and instances.
    assert (ot['pc'][:, 6] >= 0).any()
    assert len(ot['inst_tokens']) == 2 * min(num_sweeps, 3)


@pytest.fixture(scope='module')
def semseg_pair():
    sem_j = SemSegTPU(seed=0, stage_sizes=(1, 1, 1, 1))
    sem_t = SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
    load_named_tensors(sem_t, onnx_port.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def _kw(cfg, tmp, name, semseg_model, use_oracle_pose, nusc, horizon):
    return dict(
        semseg_model=semseg_model, use_oracle_pose=use_oracle_pose,
        end_scene_idx=1, bev_params=dict(BEV_PARAMS),
        sampling=cfg.SamplingConfig(bev_horizon_dist=horizon,
                                    bev_dist_between_samples=1.0,
                                    bevs_per_sample=1),
        output=cfg.OutputConfig(output_dir=str(tmp / name / 'bevs'),
                                viz_to_disk=False, async_io=False),
        accum_cfg=cfg.AccumConfig(max_points_per_frame=16384,
                                  max_frames=32,
                                  max_painted_points_per_frame=16384,
                                  max_instances=64),
        manifest_path=str(tmp / name / 'manifest.jsonl'), seed=0, nusc=nusc)


class BuiltFakeNuScenes(FakeNuScenes):
    """The devkit double with a static world that ICP can register: a road
    plane, planar walls along both road edges and facades facing the
    drive, in place of the double's own road and wall volumes (scattered
    points whose normals are random, so registration collapses to ~0 m
    steps on both packages and float32 noise decides the rest). On this
    world both packages recover the 2 m steps to ~4e-6 m. The cars are the
    double's."""

    def __init__(self, *args, **kw):
        rng = np.random.default_rng(7)
        n = 600
        road = np.stack([rng.uniform(-10, 45, n), rng.uniform(-6, 6, n),
                         np.full(n, 0.05)], 1)
        walls = np.stack([rng.uniform(-10, 45, n),
                          np.where(rng.random(n) < 0.5, -7.0, 7.0),
                          rng.uniform(0, 4, n)], 1)
        facades = []
        for x in np.sort(rng.uniform(-8, 43, 14)):
            side = rng.choice([-1.0, 1.0])
            facades.append(np.stack([np.full(40, x),
                                     side * rng.uniform(3.5, 6.5, 40),
                                     rng.uniform(0.2, 3.0, 40)], 1))
        self._static = np.concatenate([road, walls, *facades])
        super().__init__(*args, **kw)

    def _points_world(self, t):
        pts, inten = super()._points_world(t)
        cars = slice(self._world.shape[0], None)
        return (np.concatenate([self._static, pts[cars]]),
                np.concatenate([np.full(len(self._static), 0.4, np.float32),
                                inten[cars]]))


@pytest.fixture(scope='module', params=[True, False],
                ids=['oracle', 'icp'])
def runs(request, tmp_path_factory, semseg_pair):
    """run() of both packages on one fake scene: for the oracle branch the
    job test's (6 keyframes 4 m apart, 1 sweep between), for the ICP
    branch the built double with 6 keyframes 2 m apart and a 3 m sampling
    horizon: with the job test's 4 m a keyframe lies exactly on the
    horizon, and float32 ICP noise would decide whether it is sampled."""
    tmp = tmp_path_factory.mktemp('nusc_runner')
    root = str(tmp / 'nusc')
    oracle = request.param
    if oracle:
        nusc = FakeNuScenes(root, n_keyframes=6, sweeps_between=1, step=4.0,
                            seed=1)
    else:
        nusc = BuiltFakeNuScenes(root, n_keyframes=6, sweeps_between=1,
                                 step=2.0, seed=1)
    horizon = 4.0 if oracle else 3.0
    kw_j = _kw(jcfg, tmp, 'jax', semseg_pair[0], oracle, nusc, horizon)
    kw_t = _kw(tcfg, tmp, 'torch', semseg_pair[1], oracle, nusc, horizon)
    stats_j = jrun.run(root, **kw_j)
    stats_t = trun.run(root, device='cpu', **kw_t)
    return root, kw_j, kw_t, stats_j, stats_t


def test_run_writes_the_same_samples(runs):
    _, kw_j, kw_t, stats_j, stats_t = runs
    assert stats_t == stats_j
    assert stats_t['bevs'] >= 1 and stats_t['units'] == ['0']
    dj, dt = kw_j['output'].output_dir, kw_t['output'].output_dir
    files = _files(dt)
    assert files == _files(dj) and len(files) == stats_t['bevs']
    with open(kw_t['manifest_path']) as f:
        manifest_t = f.read()
    with open(kw_j['manifest_path']) as f:
        assert manifest_t == f.read()
    for name in files:
        bj = read_compressed_pickle(os.path.join(dj, name))
        bt = read_compressed_pickle(os.path.join(dt, name))
        assert set(bt) == set(bj), name
        for k in ('scene_idx', 'map', 'ego_global_x', 'ego_global_y'):
            assert bt[k] == bj[k] and type(bt[k]) is type(bj[k]), k
        assert bt['map'] == 'fake-location'
        for k, v in bt.items():
            if k.startswith('trajs'):
                assert len(v) == len(bj[k]), (name, k)
                for a, b in zip(v, bj[k]):
                    np.testing.assert_allclose(a, b, atol=1.0)
            elif isinstance(v, np.ndarray):
                assert v.dtype == np.float16 and v.shape == bj[k].shape
                mism = np.mean(np.abs(v.astype(np.float32)
                                      - bj[k].astype(np.float32)) > 2e-2)
                assert mism < 0.02, (name, k, mism)


def test_rerun_on_manifest_is_a_noop(runs):
    root, _, kw_t, _, stats_t = runs
    before = _files(kw_t['output'].output_dir)
    stats2 = trun.run(root, device='cpu', **kw_t)
    assert stats2 == {'bevs': 0, 'units': [], 'resumed_at': stats_t['bevs']}
    assert _files(kw_t['output'].output_dir) == before


def test_main_refuses_a_model_path(tmp_path):
    """main loads a model path (tests/test_torch_pc_accum.py); a malformed
    .onnx file is refused, never replaced by random weights."""
    bad = tmp_path / 'model.onnx'
    bad.write_bytes(bytes([0x3A, 0x7F, 0x01]))    # graph, 127 B declared
    with pytest.raises(ValueError, match='truncated'):
        trun.main([str(tmp_path), str(bad), '--device', 'cpu'])


def test_oracle_main_forces_oracle_pose(monkeypatch, tmp_path):
    """nuscenes_oracle_bev_gen.main passes --use_oracle_pose on; main
    builds the model on --device and hands run() the flags."""
    from pc_accumulation_lib_tpu_torch.models import semseg
    seen = {}
    monkeypatch.setattr(semseg, 'SemSegTorch',
                        lambda device, seed: ('model', device, seed))
    monkeypatch.setattr(trun, 'run', lambda *a, **kw: seen.update(a=a, kw=kw))
    toracle_run.main([str(tmp_path), '--device', 'cpu', '--num_sweeps', '2'])
    a, kw = seen['a'], seen['kw']
    assert a[0] == str(tmp_path) and a[1] == ('model', 'cpu', 0)
    assert a[3] is True and a[9] == 2 and kw['device'] == 'cpu'
    assert a[12] == dict(BEV_PARAMS, view_size=80.0, pixel_size=256)
    seen.clear()
    trun.main([str(tmp_path), '--device', 'cpu'])
    assert seen['a'][3] is False


def test_skip_filters_match_jax():
    attrs = ['night', 'rain', 'boston-seaport']
    for skip in ([], ['rain'], ['sing', 'boston'], ['day']):
        assert trun.should_skip_scene(attrs, skip) == \
            jrun.should_skip_scene(attrs, skip)
