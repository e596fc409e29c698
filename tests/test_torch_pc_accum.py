"""The port's point-cloud export runners against the JAX package's.

Checked:
  * KITTI-360: the port's run() on a synthetic KITTI-360 tree
    (dataloaders.synthetic.write_kitti360_layout) with GT semantics and a
    small AccumConfig, against the JAX runner's accumulator, integrate loop
    and export_vector_space: the same point count, points within 1e-4 m,
    colours equal, poses in ``.poses.txt`` within 1e-4 m;
  * NuScenes: the port's run() on the devkit double (tests/fake_nusc.py)
    with oracle poses, against the JAX runner's loop with the same
    reduced-depth semseg weights: points within 1e-5 m;
  * each runner main given an .onnx or a weight file hands run() the
    loaded model, not a random one.
"""
import functools

import numpy as np
import pytest
import torch

from fake_nusc import FakeNuScenes
from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.accum.kitti360 import (
    Kitti360SemanticPointCloudAccumulator as JKitti)
from pc_accumulation_lib_tpu.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as JOracle)
from pc_accumulation_lib_tpu.dataloaders.kitti360 import (
    Kitti360Dataloader as JKittiLoader)
from pc_accumulation_lib_tpu.dataloaders.nuscenes import (
    NuScenesDataloader as JNuscLoader)
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    write_kitti360_layout)
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.runners import kitti360_bev_gen as jkbev
from pc_accumulation_lib_tpu.runners import kitti360_pc_accum as jkpc
from pc_accumulation_lib_tpu.runners.nuscenes_bev_gen import NUSCENES_FILTERS
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.models import checkpoint as tckpt
from pc_accumulation_lib_tpu_torch.models import onnx_pb as tpb
from pc_accumulation_lib_tpu_torch.models import semseg as tsemseg
from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as tkbev
from pc_accumulation_lib_tpu_torch.runners import kitti360_pc_accum as tkpc
from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen as tnbev
from pc_accumulation_lib_tpu_torch.runners import (
    nuscenes_oracle_bev_gen as tnoracle)
from pc_accumulation_lib_tpu_torch.runners import nuscenes_pc_accum as tnpc
from pc_accumulation_lib_tpu_torch.utils.ply import read_ply

SEQ = '2013_05_28_drive_0000_sync'
N_FRAMES = 8
HORIZON = 6.0
STAGES = (1, 1, 1, 1)
KITTI_ACCUM = dict(max_points_per_frame=8192, max_frames=24)
KITTI_ICP = dict(max_downsampled=512, num_iters=8)
NUSC_ACCUM = dict(max_points_per_frame=16384, max_frames=32,
                  max_painted_points_per_frame=16384, max_instances=64)


def _quiet(fn, *a, **kw):
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


@pytest.fixture(scope='module')
def kitti_runs(tmp_path_factory):
    """Both packages' KITTI-360 export on one synthetic tree; the 6 m
    horizon evicts frames, so the export's window filter matters."""
    base = tmp_path_factory.mktemp('kitti360_pc_accum')
    data = str(base / 'kitti360')
    write_kitti360_layout(data, seq=SEQ, n_frames=N_FRAMES, step=2.0,
                          lidar_range=25.0, seed=3, points_per_frame=3000)
    out_j, out_t = str(base / 'jax.ply'), str(base / 'torch.ply')
    a_j = JKitti(HORIZON, jkbev.build_calib_params(data), 1e3, None,
                 jcfg.DEFAULT_SEMSEG_FILTERS, jcfg.DEFAULT_SEM_IDXS, True,
                 {'type': 'sem'}, accum_cfg=jcfg.AccumConfig(**KITTI_ACCUM),
                 icp_cfg=jcfg.ICPConfig(**KITTI_ICP))
    for obs in JKittiLoader(data, 1, [SEQ], [0], [N_FRAMES]):
        _quiet(a_j.integrate, obs)
    n_j = jkpc.export_vector_space(a_j, out_j)
    n_t = _quiet(tkpc.run, data, None, True, SEQ, 0, N_FRAMES, out_t,
                 HORIZON, 1e3, tcfg.AccumConfig(**KITTI_ACCUM),
                 tcfg.ICPConfig(**KITTI_ICP), device='cpu')
    return a_j, (n_j, out_j), (n_t, out_t)


def test_kitti360_export_matches_jax(kitti_runs):
    a_j, (n_j, out_j), (n_t, out_t) = kitti_runs
    assert a_j.window_start > 0 and n_t == n_j > 1000
    xyz_j, rgb_j = read_ply(out_j)
    xyz_t, rgb_t = read_ply(out_t)
    assert xyz_t.shape == (n_t, 3)
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    poses_t = np.loadtxt(out_t + '.poses.txt')
    assert poses_t.shape == (N_FRAMES - a_j.window_start, 3)
    np.testing.assert_allclose(poses_t, np.loadtxt(out_j + '.poses.txt'),
                               rtol=0, atol=1e-4)


@pytest.fixture(scope='module')
def semseg_pair():
    sem_j = SemSegTPU(seed=0, stage_sizes=STAGES)
    sem_t = tsemseg.SemSegTorch('cpu', stage_sizes=STAGES)
    tsemseg.load_named_tensors(sem_t,
                               onnx_port.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def test_nuscenes_export_matches_jax(tmp_path, semseg_pair):
    nusc = FakeNuScenes(str(tmp_path / 'nusc'), n_keyframes=4,
                        sweeps_between=1, step=2.0, seed=1)
    out_j, out_t = str(tmp_path / 'jax.ply'), str(tmp_path / 'torch.ply')
    log = nusc.get('log', nusc.scene[0]['log_token'])
    a_j = JOracle(semseg_pair[0], NUSCENES_FILTERS, jcfg.DEFAULT_SEM_IDXS,
                  False, {'type': 'sem'}, log['location'],
                  accum_cfg=jcfg.AccumConfig(**NUSC_ACCUM))
    for obs in JNuscLoader(nusc, [0], 1, 1):
        _quiet(a_j.integrate, obs)
    n_j = jkpc.export_vector_space(a_j, out_j)
    n_t = _quiet(tnpc.run, str(tmp_path / 'nusc'), semseg_pair[1],
                 num_sweeps=1, out=out_t,
                 accum_cfg=tcfg.AccumConfig(**NUSC_ACCUM), nusc=nusc,
                 device='cpu')
    assert n_t == n_j > 100
    xyz_j, rgb_j = read_ply(out_j)
    xyz_t, rgb_t = read_ply(out_t)
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    np.testing.assert_allclose(np.loadtxt(out_t + '.poses.txt'),
                               np.loadtxt(out_j + '.poses.txt'), atol=1e-5)


@pytest.fixture(scope='module')
def weight_files(tmp_path_factory):
    """A seed-5 reduced-depth model's weights as an .onnx file (names
    prefixed, as an exporter writes them) and as a weight file."""
    base = tmp_path_factory.mktemp('weights')
    src = tsemseg.SemSegTorch('cpu', seed=5, stage_sizes=STAGES)
    named = {'model.' + k: v.numpy() for k, v in
             src.model.state_dict().items() if 'num_batches' not in k}
    onnx_path, pt_path = str(base / 'w.onnx'), str(base / 'w.pt')
    tpb.write_initializers(onnx_path, named)
    tckpt.save_semseg_weights(src, pt_path)
    return src, {'onnx': onnx_path, 'pt': pt_path}


MAINS = {
    'kitti360_bev_gen': (tkbev, tkbev),
    'kitti360_pc_accum': (tkpc, tkpc),
    'nuscenes_bev_gen': (tnbev, tnbev),
    'nuscenes_oracle_bev_gen': (tnoracle, tnbev),
    'nuscenes_pc_accum': (tnpc, tnpc),
}


@pytest.mark.parametrize('kind', ['onnx', 'pt'])
@pytest.mark.parametrize('main', sorted(MAINS))
def test_main_loads_the_model_file(monkeypatch, tmp_path, weight_files,
                                   main, kind):
    src, paths = weight_files
    cli, runner = MAINS[main]
    monkeypatch.setattr(tsemseg, 'load_semseg_model', functools.partial(
        tsemseg.load_semseg_model, stage_sizes=STAGES))
    seen = {}
    monkeypatch.setattr(runner, 'run', lambda *a, **kw: seen.update(a=a) or 0)
    cli.main([str(tmp_path), paths[kind], '--device', 'cpu'])
    model = seen['a'][1]
    assert isinstance(model, tsemseg.SemSegTorch)
    assert model.device == torch.device('cpu')
    want = src.model.state_dict()
    got = model.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
