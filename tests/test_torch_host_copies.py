"""The port's own copies of the JAX package's host modules against the
originals: config dataclasses and constants, ops/trajectory, utils/io,
utils/async_writer, the KITTI-360 dataloader and bev/viz; and the port's
entry points defaulting to the card.

The copies are pure Python and numpy, so each comparison is exact: the
same fields and defaults, the same arrays from the same seeded numpy
inputs, files that either side reads back."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.bev import viz as jviz
from pc_accumulation_lib_tpu.dataloaders import kitti360 as jk360
from pc_accumulation_lib_tpu.dataloaders.synthetic import (
    write_kitti360_layout)
from pc_accumulation_lib_tpu.ops import trajectory as jtraj
from pc_accumulation_lib_tpu.utils import io as jio
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.accum import base as tbase
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.bev import sem_bev as tsem
from pc_accumulation_lib_tpu_torch.bev import viz as tviz
from pc_accumulation_lib_tpu_torch.dataloaders import kitti360 as tk360
from pc_accumulation_lib_tpu_torch.models import semseg as tsemseg
from pc_accumulation_lib_tpu_torch.ops import trajectory as ttraj
from pc_accumulation_lib_tpu_torch.runners import kitti360_bev_gen as trun
from pc_accumulation_lib_tpu_torch.utils import io as tio
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
    tsemseg.SemSegTorch.__init__, trun.run],
    ids=['SemBEVGenerator', 'SemanticPointCloudAccumulator',
         'Kitti360SemanticPointCloudAccumulator', 'SemSegTorch', 'run'])
def test_entry_point_defaults_to_cuda(entry):
    assert inspect.signature(entry).parameters['device'].default == 'cuda'


def test_sem_bev_generator_defaults_to_cuda_and_allocates_nothing():
    """Constructed without ``device`` it holds the card; on a machine
    without one (as here) construction still succeeds, since it allocates
    nothing and does not initialise CUDA."""
    gen = tsem.SemBEVGenerator(tcfg.DEFAULT_SEM_IDXS, 40.0, 64)
    assert gen.device == torch.device('cuda')
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()
