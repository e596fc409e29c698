"""The port's KITTI-360 BEV dataset runner against the JAX runner: run() on
the same synthetic KITTI-360 tree (dataloaders.synthetic
.write_kitti360_layout), at the runner's default BEV parameters (80 m /
256 px, no augmentation, no warp) and reduced buffer capacities.

Checked: the same sample files, each with the same keys; maps under
bench.py's step() rule (cell-mismatch fraction below 0.02 at 2e-2: both
sides estimate poses with float32 ICP, and a pose difference at float32
rounding can move a point across a cell boundary); the same number of
trajectories per split, within 1 px (pixel coordinates are floored).
"""
import os

import numpy as np
import pytest

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    write_kitti360_layout)
from pc_accumulation_lib_tpu.runners import kitti360_bev_gen as jrun
from pc_accumulation_lib_tpu.utils.io import read_compressed_pickle
from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as trun

SEQ = '2013_05_28_drive_0000_sync'
N_FRAMES = 14


def _sample_files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('kitti360_runner')
    data = str(base / 'kitti360')
    write_kitti360_layout(data, seq=SEQ, n_frames=N_FRAMES, step=2.0,
                          lidar_range=25.0, seed=3, points_per_frame=3000)
    kw = dict(use_gt_sem=True, sequences=[SEQ], start_idxs=[0],
              end_idxs=[N_FRAMES], accum_horizon_dist=30.0,
              sampling=cfg.SamplingConfig(8.0, 1.0, 2),
              accum_cfg=cfg.AccumConfig(max_points_per_frame=8192,
                                        max_frames=24),
              icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8),
              seed=0)
    out = {}
    for name, run, extra in (('jax', jrun.run, {}),
                             ('torch', trun.run, dict(device='cpu'))):
        d = str(base / name)
        stats = run(data, output=cfg.OutputConfig(d, viz_to_disk=False),
                    **kw, **extra)
        out[name] = (d, stats)
    return out


def test_runner_writes_the_same_samples(runs):
    (dj, sj), (dt, st) = runs['jax'], runs['torch']
    assert st == sj
    assert st['frames'] == N_FRAMES and st['bevs'] >= 4
    files = _sample_files(dt)
    assert files == _sample_files(dj)
    assert len(files) == st['bevs']
    assert files[0] == os.path.join('subdir000', 'bev_000.pkl.gz')


def test_runner_samples_match(runs):
    (dj, _), (dt, _) = runs['jax'], runs['torch']
    for f in _sample_files(dt):
        bj = read_compressed_pickle(os.path.join(dj, f))
        bt = read_compressed_pickle(os.path.join(dt, f))
        assert set(bt) == set(bj), f
        maps = [k for k in bt if not k.startswith('trajs')]
        assert len(maps) == 15
        for k in maps:
            assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape
            mism = np.mean(np.abs(bt[k].astype(np.float32)
                                  - bj[k].astype(np.float32)) > 2e-2)
            assert mism < 0.02, (f, k, mism)
        for k in bt:
            if k.startswith('trajs'):
                assert len(bt[k]) == len(bj[k]), (f, k)
                for a, b in zip(bt[k], bj[k]):
                    np.testing.assert_allclose(a, b, atol=1.0)
