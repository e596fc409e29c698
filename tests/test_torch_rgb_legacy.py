"""The port's RGB BEV generator, legacy functional pipeline and last host
helpers against the JAX package's on the same numpy inputs and seeds.

Checked:
  * RGBBEVGenerator on the standalone generate API, and bev_type 'rgb'
    through run() of both dataset runners on their synthetic trees: the
    same files and keys, the rgb maps exact, the poses within 1 px
    (pixel coordinates are floored from float32 ICP poses on the KITTI-360
    runner), viz_bev writes a PNG;
  * legacy gen_view / gen_aug_view at P = 32 and 64 (the same numpy
    generator draws on both sides): every map within 1e-5, the poses
    exact; viz_bev writes a PNG;
  * nuscenes_utils.pts_feat_from_img (bilinear and nearest) within 1e-6,
    render_ego_centric_map exact (the JAX copy reads its yaw from
    pyquaternion, which is given to it here as a stand-in module);
  * utils.profiling.device_trace writes a trace, and does nothing for
    None.
"""
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from fake_nusc import FakeNuScenes
from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.bev import legacy as jlegacy
from pc_accumulation_lib_tpu.bev.rgb_bev import RGBBEVGenerator as JRGB
from pc_accumulation_lib_tpu.dataloaders import nuscenes_utils as jnu
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    write_kitti360_layout)
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.runners import kitti360_bev_gen as jk_run
from pc_accumulation_lib_tpu.runners import nuscenes_bev_gen as jn_run
from pc_accumulation_lib_tpu.utils.io import read_compressed_pickle
from pc_accumulation_lib_tpu_torch import RGBBEVGenerator as TRGB
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.bev import legacy as tlegacy
from pc_accumulation_lib_tpu_torch.dataloaders import nuscenes_utils as tnu
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)
from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as tk_run
from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as tn_run
from pc_accumulation_lib_tpu_torch.utils.profiling import device_trace

RGB_KEYS = {'rgb_present', 'rgb_future', 'poses_present', 'poses_future'}
RGB_BEV = {'type': 'rgb', 'view_size': 40, 'pixel_size': 64}


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _rgb_samples_match(dj, dt):
    """Same files; each sample's keys, rgb maps exact, poses within 1 px."""
    files = _files(dt)
    assert files == _files(dj)
    pkl = [f for f in files if f.endswith('.pkl.gz')]
    assert pkl and len(files) == 2 * len(pkl)      # a PNG beside each
    for f in pkl:
        bj = read_compressed_pickle(os.path.join(dj, f))
        bt = read_compressed_pickle(os.path.join(dt, f))
        assert set(bt) == set(bj) and RGB_KEYS <= set(bt), f
        for k in ('rgb_present', 'rgb_future'):
            assert bt[k].dtype == np.float16 and bt[k].shape == (3, 64, 64)
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=(f, k))
        for k in ('poses_present', 'poses_future'):
            np.testing.assert_allclose(bt[k], bj[k], atol=1.0, err_msg=k)
    return len(pkl)


# ----------------------------------------------------------------------
# RGB generator
# ----------------------------------------------------------------------
def _clouds(seed, n=3000):
    rng = np.random.default_rng(seed)

    def make():
        pc = np.zeros((n, 8))
        pc[:, 0:2] = rng.uniform(-18, 18, size=(n, 2))
        pc[:, 2] = rng.uniform(-1.7, 2, size=n)
        pc[:, 3] = rng.uniform(0, 1, size=n)
        pc[:, 4:7] = rng.integers(0, 256, size=(n, 3))
        pc[:, 7] = rng.choice([0, 1, 2, 13], size=n)
        return pc
    poses = np.stack([np.linspace(-10, 10, 15), np.zeros(15),
                      np.zeros(15)], 1)
    return make(), make(), poses


def test_rgb_generator_matches_jax(tmp_path):
    pc_p, pc_f, poses = _clouds(0)
    pcs = {'pc_present': pc_p, 'pc_future': pc_f,
           'pc_full': np.concatenate([pc_p, pc_f])}
    trajs = {'ego_traj_present': poses[:8], 'ego_traj_future': poses[7:],
             'ego_traj_full': poses}
    kw = dict(max_trans_radius=2.0, zoom_thresh=0.05, do_warp=True, seed=3)
    gj, gt = JRGB(40.0, 64, **kw), TRGB(40.0, 64, device='cpu', **kw)
    for rot in (0.0, 0.7):
        bj = gj.generate(pcs, trajs, rot, 1.0, -0.5, 1.02, do_warping=True)
        bt = gt.generate(pcs, trajs, rot, 1.0, -0.5, 1.02, do_warping=True)
        assert set(bt) == set(bj) == RGB_KEYS
        for k in ('rgb_present', 'rgb_future'):
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
        for k in ('poses_present', 'poses_future'):
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    assert (bt['rgb_present'].astype(np.float32) > 0).mean() > 0.1
    gt.viz_bev(bt, str(tmp_path / 'rgb.png'))
    assert os.path.getsize(tmp_path / 'rgb.png') > 0


@pytest.fixture(scope='module')
def semseg_pair():
    sem_j = SemSegTPU(seed=0, stage_sizes=(1, 1, 1, 1))
    sem_t = SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
    load_named_tensors(sem_t, onnx_port.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def test_kitti360_runner_rgb_matches_jax(tmp_path):
    """test_torch_runner.py's synthetic tree and run() arguments with
    bev_type 'rgb' at 64 px, PNGs on."""
    seq, n = '2013_05_28_drive_0000_sync', 14
    data = str(tmp_path / 'kitti360')
    write_kitti360_layout(data, seq=seq, n_frames=n, step=2.0,
                          lidar_range=25.0, seed=3, points_per_frame=3000)
    kw = dict(use_gt_sem=True, sequences=[seq], start_idxs=[0],
              end_idxs=[n], accum_horizon_dist=30.0, bev_params=RGB_BEV,
              sampling=jcfg.SamplingConfig(8.0, 1.0, 2),
              accum_cfg=jcfg.AccumConfig(max_points_per_frame=8192,
                                         max_frames=24),
              icp_cfg=jcfg.ICPConfig(max_downsampled=512, num_iters=8),
              seed=0)
    out = {}
    for name, run, extra in (('jax', jk_run.run, {}),
                             ('torch', tk_run.run, dict(device='cpu'))):
        d = str(tmp_path / name)
        out[name] = (d, run(data, output=jcfg.OutputConfig(d), **kw,
                            **extra))
    assert out['torch'][1] == out['jax'][1]
    assert _rgb_samples_match(out['jax'][0], out['torch'][0]) >= 4


def test_nuscenes_runner_rgb_matches_jax(tmp_path, semseg_pair):
    """test_torch_nuscenes_runner.py's oracle scene with bev_type 'rgb'
    and PNGs on."""
    root = str(tmp_path / 'nusc')
    nusc = FakeNuScenes(root, n_keyframes=6, sweeps_between=1, step=4.0,
                        seed=1)
    dirs = {}
    for name, run, cfg_mod, sem, extra in (
            ('jax', jn_run.run, jcfg, semseg_pair[0], {}),
            ('torch', tn_run.run, tcfg, semseg_pair[1], dict(device='cpu'))):
        out_dir = str(tmp_path / name)
        run(root, semseg_model=sem, use_oracle_pose=True, end_scene_idx=1,
            bev_params=dict(RGB_BEV),
            sampling=cfg_mod.SamplingConfig(bev_horizon_dist=4.0,
                                            bev_dist_between_samples=1.0,
                                            bevs_per_sample=1),
            output=cfg_mod.OutputConfig(output_dir=out_dir, async_io=False),
            accum_cfg=cfg_mod.AccumConfig(
                max_points_per_frame=16384, max_frames=32,
                max_painted_points_per_frame=16384, max_instances=64),
            manifest_path=str(tmp_path / f'{name}.jsonl'), seed=0,
            nusc=nusc, **extra)
        dirs[name] = out_dir
    assert _rgb_samples_match(dirs['jax'], dirs['torch']) >= 1


# ----------------------------------------------------------------------
# Legacy pipeline
# ----------------------------------------------------------------------
def _legacy_match(bj, bt):
    assert set(bt) == set(bj) == set(tlegacy._KEYS) | {'poses_past',
                                                       'poses_future'}
    for k in tlegacy._KEYS:
        assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape
        np.testing.assert_allclose(bt[k].astype(np.float32),
                                   bj[k].astype(np.float32), atol=1e-5,
                                   err_msg=k)
    for k in ('poses_past', 'poses_future'):
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


@pytest.mark.parametrize('P', [32, 64])
def test_legacy_gen_view_matches_jax(P, tmp_path):
    pc_p, pc_f, poses = _clouds(P)
    args = (pc_p, pc_f, poses, poses.copy(), 0.3, 1.0, -1.0, 1.05, 40.0, P)
    bj = jlegacy.gen_view(*args, rng=np.random.default_rng(5))
    bt = tlegacy.gen_view(*args, rng=np.random.default_rng(5), device='cpu')
    _legacy_match(bj, bt)
    assert (bt['gridmap_past_sidewalk'].astype(np.float32) != 0.5).any()
    tlegacy.viz_bev(bt, str(tmp_path / 'legacy.png'))
    assert os.path.getsize(tmp_path / 'legacy.png') > 0


def test_legacy_gen_aug_view_matches_jax():
    pc_p, pc_f, poses = _clouds(7)
    inputs = {'pc_present': pc_p, 'pc_future': pc_f,
              'poses_present': poses, 'poses_future': poses.copy(),
              'max_translation_radius': 3.0, 'zoom_threshold': 0.1,
              'view_size': 40.0, 'pixel_size': 32}
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        bj = jlegacy.gen_aug_view(inputs, rng=rj)
        bt = tlegacy.gen_aug_view(inputs, rng=rt, device='cpu')
        _legacy_match(bj, bt)
    assert rt.random() == rj.random()       # the same number of draws


# ----------------------------------------------------------------------
# NuScenes helpers and the device trace
# ----------------------------------------------------------------------
@pytest.mark.parametrize('method', ['bilinear', 'nearest'])
def test_pts_feat_from_img_matches_jax(method):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    uv = np.stack([rng.uniform(1.01, 58.99, 500),
                   rng.uniform(1.01, 38.99, 500)], 1)
    want = jnu.pts_feat_from_img(uv, img, method)
    got = tnu.pts_feat_from_img(uv, img, method)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # A tensor input on its device, and a single-channel feature map.
    got1 = tnu.pts_feat_from_img(torch.from_numpy(uv),
                                 torch.from_numpy(img[..., 0]), method)
    np.testing.assert_allclose(got1.numpy(), want[:, 0], atol=1e-6)
    with pytest.raises(ValueError, match='inside'):
        tnu.pts_feat_from_img(np.array([[0.5, 5.0]]), img, method)
    with pytest.raises(ValueError, match='method'):
        tnu.pts_feat_from_img(uv, img, 'cubic')


class _MapMask:
    """The devkit MapMask's surface render_ego_centric_map reads."""
    resolution = 0.1
    foreground, background = 255, 0

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        m = (rng.random((200, 240)) < 0.3).astype(np.uint8) * 255
        m[80:120, :] = 255                     # a road across the map
        m[150:160, 30:40] = 7                  # neither colour: kept
        self._mask = m

    def mask(self):
        return self._mask

    def to_pixel_coords(self, x, y):
        return int(x / self.resolution), int(self._mask.shape[0]
                                              - y / self.resolution)


def _pyquaternion_stand_in():
    """yaw_pitch_roll as pyquaternion documents it (intrinsic z-y'-x'')."""
    class Quaternion:
        def __init__(self, q):
            self.q = np.asarray(q, np.float64) / np.linalg.norm(q)

        @property
        def yaw_pitch_roll(self):
            w, x, y, z = self.q
            return (math.atan2(2 * (w * z - x * y), 1 - 2 * (y * y + z * z)),
                    math.asin(2 * (w * y + z * x)),
                    math.atan2(2 * (w * x - y * z), 1 - 2 * (x * x + y * y)))
    return types.SimpleNamespace(Quaternion=Quaternion)


@pytest.mark.parametrize('yaw', [0.0, 0.6, -2.3])
def test_render_ego_centric_map_matches_jax(monkeypatch, yaw):
    monkeypatch.setitem(sys.modules, 'pyquaternion',
                        _pyquaternion_stand_in())
    half = yaw / 2
    pose = {'translation': [12.0, 10.5, 0.0],
            'rotation': [math.cos(half), 0.01, -0.02, math.sin(half)]}
    mm = _MapMask(1)
    want = jnu.render_ego_centric_map(mm, pose, axes_limit=4)
    got = tnu.render_ego_centric_map(mm, pose, axes_limit=4)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (80, 80)
    np.testing.assert_array_equal(got, want)
    assert {125, 255} <= set(np.unique(got).tolist())


def test_device_trace(tmp_path):
    with device_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    assert any(f.endswith('.json') for f in _files(tmp_path))
    with device_trace(None):
        pass
