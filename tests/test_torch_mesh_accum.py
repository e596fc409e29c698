"""The port's accumulator and runners on a mesh against the JAX
package's.

One gloo world of 4 spawned ranks (tests/torch_mesh_worlds.accum_cases):
rank 0 integrates, samples and writes, the other three serve its
point-sharded rasters. Checked against the JAX package on the same
frames and seeds:
  * step() (tuple-form tile rasters, the rows scattered once per step)
    and generate_bev() on a (1, 4) mesh against JAX's on a (1, 4) mesh
    of its CPU devices, at tests/test_sharding.py's sizes with the dense
    fetch;
  * run() on the mesh at the runner's default BEV parameters, and the
    scene-sharded job (run_sharded), against JAX's runs;
  * run_sharded's crash after the second unit's first sample, then the
    resume: exactly the pending units, byte-identical files; two shards
    partition the units; a TileRouteOverflow from close() leaves the unit
    pending.
Tolerances: poses atol 1e-4 m and window start exact; maps by bench.py's
step() rule (fraction of cells differing by more than 2e-2 below 0.02:
both sides run float32 ICP, and a pose difference at float32 rounding
can move a point across a cell boundary); trajectories atol 1 px.
"""
import glob
import os

import jax
import numpy as np
import pytest

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum.kitti360 import (
    Kitti360SemanticPointCloudAccumulator)
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    make_calib, write_kitti360_layout)
from pc_accumulation_lib_tpu.parallel import mesh as mesh_mod
from pc_accumulation_lib_tpu.parallel.manifest import CompletionManifest
from pc_accumulation_lib_tpu.runners import kitti360_bev_gen as jrun
from pc_accumulation_lib_tpu.utils.io import read_compressed_pickle

import torch_mesh_worlds as w

N = 4


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, '**', 'bev_*.pkl.gz'), recursive=True))


def _bevs_match(bj, bt):
    assert set(bj) == set(bt)
    for k in bj:
        if k.startswith('trajs'):
            assert len(bj[k]) == len(bt[k]), k
            for tj, tt in zip(bj[k], bt[k]):
                np.testing.assert_allclose(tt, tj, atol=1.0, err_msg=k)
            continue
        assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape
        mism = np.mean(np.abs(np.asarray(bj[k], np.float32)
                              - bt[k].astype(np.float32)) > 2e-2)
        assert mism < 0.02, (k, mism)


def _jax_accum(mesh, bev):
    _, H_velo_cam, P_cam_frame = make_calib()
    calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                 p_velo_frame=P_cam_frame @ H_velo_cam)
    return Kitti360SemanticPointCloudAccumulator(
        200., calib, 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, dict(bev, mesh=mesh),
        **w.accum_kwargs(cfg))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('mesh_accum')
    root = str(base / 'kitti360')
    for i, seq in enumerate(w.ACCUM_SEQS):
        write_kitti360_layout(root, seq=seq, n_frames=w.JOB_FRAMES,
                              step=2.0, lidar_range=20.0, seed=3 + i)
    runner_root = str(base / 'kitti360_runner')
    write_kitti360_layout(runner_root, seq=w.ACCUM_SEQS[0], n_frames=14,
                          step=2.0, lidar_range=25.0, seed=3,
                          points_per_frame=3000)
    port_dir = base / 'port'
    port_dir.mkdir()
    w.spawn_world('accum_cases', N, port_dir, root, runner_root)
    port = w.load(port_dir, 'accum')

    jx = {}
    mesh = mesh_mod.make_mesh((1, N), devices=jax.devices()[:N])
    frames = w.step_frames()
    a = _jax_accum(mesh, w.STEP_BEV)
    a.integrate([frames[0]])
    jx['step'] = []
    for f in frames[1:]:
        bevs = a.step([f], bev_num=2, gen_future=True)
        jx['step'].append((bevs, np.array(a.poses), a.window_start))
    a.sem_bev_generator.close()
    g = _jax_accum(mesh, w.CLASSIC_BEV)
    for f in frames:
        g.integrate([f])
    jx['generate_bev'] = g.generate_bev(present_idx=3, bev_num=1,
                                        gen_future=True)
    jx_runner = str(base / 'jax_runner')
    jx['run'] = jrun.run(runner_root, output=cfg.OutputConfig(
        jx_runner, viz_to_disk=False), **w.runner_kwargs(cfg))
    jx_job = str(base / 'jax_job')
    jx['job'] = jrun.run_sharded(
        root, bev_params=dict(w.JOB_BEV), **w.job_kwargs(
            cfg, jx_job, str(base / 'jax_job.jsonl')))
    dirs = dict(port=str(port_dir), jax_runner=jx_runner, jax_job=jx_job)
    return port, jx, dirs


def test_step_on_mesh_matches_jax(runs):
    port, jx, _ = runs
    assert len(port['step']) == len(jx['step']) == w.STEP_FRAMES - 1
    for (bt, pt, ws_t), (bj, pj, ws_j) in zip(port['step'], jx['step']):
        assert ws_t == ws_j
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        assert len(bt) == len(bj) == 2
        for st, sj in zip(bt, bj):
            _bevs_match(sj, st)


def test_generate_bev_on_mesh_matches_jax(runs):
    port, jx, _ = runs
    assert len(port['generate_bev']) == len(jx['generate_bev']) == 1
    _bevs_match(jx['generate_bev'][0], port['generate_bev'][0])


def test_runner_run_on_mesh_matches_jax(runs):
    port, jx, dirs = runs
    assert port['run'] == jx['run'] and port['run']['bevs'] >= 2
    pdir = os.path.join(dirs['port'], 'runner')
    assert _files(pdir) == _files(dirs['jax_runner'])
    for rel in _files(pdir):
        _bevs_match(read_compressed_pickle(os.path.join(
            dirs['jax_runner'], rel)),
            read_compressed_pickle(os.path.join(pdir, rel)))


def test_run_sharded_on_mesh_matches_jax(runs):
    port, jx, dirs = runs
    assert port['job'] == jx['job']
    assert port['job']['bevs'] >= 6
    assert port['job']['units'] == list(w.ACCUM_SEQS)
    pdir = os.path.join(dirs['port'], 'job')
    files = _files(pdir)
    assert files == _files(dirs['jax_job'])
    assert len({f.split(os.sep)[0] for f in files}) >= 2   # subdir rollover
    for rel in files:
        _bevs_match(read_compressed_pickle(os.path.join(dirs['jax_job'],
                                                        rel)),
                    read_compressed_pickle(os.path.join(pdir, rel)))


def test_run_sharded_crash_and_resume_byte_identical(runs):
    port, _, dirs = runs
    unit0 = port['job_unit0']
    assert port['crashed'] and port['crash_files'] == unit0 + 1
    assert port['resume']['units'] == list(w.ACCUM_SEQS[1:])
    assert port['resume']['resumed_at'] == unit0
    assert port['resume']['bevs'] == port['job']['bevs'] - unit0
    crash, job = (os.path.join(dirs['port'], d) for d in ('crash', 'job'))
    assert _files(crash) == _files(job)
    for rel in _files(job):
        with open(os.path.join(crash, rel), 'rb') as f:
            got = f.read()
        with open(os.path.join(job, rel), 'rb') as f:
            assert got == f.read(), rel


def test_run_sharded_shards_partition_units(runs):
    port, _, dirs = runs
    s0, s1 = port['shards']
    assert s0['units'] == [w.ACCUM_SEQS[0], w.ACCUM_SEQS[2]]
    assert s1['units'] == [w.ACCUM_SEQS[1]]
    man = CompletionManifest(os.path.join(dirs['port'], 'sharded.jsonl'))
    assert all(man.is_done(s) for s in w.ACCUM_SEQS)
    root = os.path.join(dirs['port'], 'sharded')
    assert sorted(os.listdir(root)) == ['shard00', 'shard01']
    assert s0['bevs'] + s1['bevs'] == port['job']['bevs']
    assert len(_files(root)) == port['job']['bevs']


def test_unit_stays_pending_when_close_raises(runs):
    port, _, dirs = runs
    assert port['overflow'] == 'simulated overflow'
    man = CompletionManifest(os.path.join(dirs['port'], 'overflow.jsonl'))
    assert not any(man.is_done(s) for s in w.ACCUM_SEQS)
