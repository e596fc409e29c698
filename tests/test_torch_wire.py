"""The port's upload wire codecs against the JAX package's on the same
numpy inputs: the yuv420 / yuv420h image codec (ops/imgcodec.py), the
13 B/point NuScenes point pack (accum/pointpack.py), and all three
accumulators on the non-rgb8 wires.

Tolerances, as observed and held here:
  * encoders and the point pack: bit-exact; range violations raise alike;
  * decoders: exact (the same float32 formula in the same order);
  * KITTI-360 step(): poses 1e-4 m (float32 ICP on both sides), window
    start exact, BEV maps by test_torch_step.py's rule (cell-mismatch
    fraction below 0.02 at 2e-2) and the rgb median maps exact;
  * NuScenes oracle: poses, painted counts, the buffer's valid rows,
    colours, classes and instances and the dynamic table exact, BEV maps
    by test_torch_nuscenes.py's rule with the rgb medians exact;
  * NuScenes ICP: poses 1e-4 m, painted counts exact, BEV maps as the
    oracle's.
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as jcfg
from pc_accumulation_lib_tpu.accum import kitti360 as jk3
from pc_accumulation_lib_tpu.accum import pointpack as jpack
from pc_accumulation_lib_tpu.accum.nuscenes import (
    NuScenesSemanticPointCloudAccumulator as JIcp)
from pc_accumulation_lib_tpu.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as JOracle)
from pc_accumulation_lib_tpu.models import onnx_port
from pc_accumulation_lib_tpu.models.semseg import SemSegTPU
from pc_accumulation_lib_tpu.ops import imgcodec as jcodec
from pc_accumulation_lib_tpu_torch import config as tcfg
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.accum import pointpack as tpack
from pc_accumulation_lib_tpu_torch.accum.nuscenes import (
    NuScenesSemanticPointCloudAccumulator as TIcp)
from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
    NuScenesOracleSemanticPointCloudAccumulator as TOracle)
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.models.semseg import (SemSegTorch,
                                                          load_named_tensors)
from pc_accumulation_lib_tpu_torch.ops import imgcodec as tcodec

# Two runs per accumulator cover every wire: (camera wire, point wire).
WIRE_PAIRS = (('yuv420', 'quantized'), ('yuv420h', 'float32'))


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


# ----------------------------------------------------------------------
# Image codec
# ----------------------------------------------------------------------
def _images(seed):
    """Random images, an edge crop of a larger one (a strided view whose
    sides are not multiples of 8), smooth content and a grayscale one."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (2, 60, 84, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:32, 0:48]
    smooth = np.stack([4 * xx, 5 * yy, 2 * (xx + yy)], -1).clip(0, 255)
    gray = np.repeat(rng.integers(0, 256, (40, 24, 1)), 3, -1)
    return {'random': big, 'edge_crop': big[:, -36:, -44:],
            'smooth': smooth.astype(np.uint8), 'gray': gray.astype(np.uint8)}


@pytest.mark.parametrize('kind', tcodec.WIRES)
def test_encoders_bit_exact(kind):
    for name, img in _images(0).items():
        want = jcodec.encode_wire(img, kind)
        got = tcodec.encode_wire(img, kind)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), (name, kind)


@pytest.mark.parametrize('kind, hw', [('yuv420', (7, 8)), ('yuv420', (8, 9)),
                                      ('yuv420h', (6, 8)),
                                      ('yuv420h', (8, 10))])
def test_encoders_reject_dims_as_jax(kind, hw):
    img = np.zeros(hw + (3,), np.uint8)
    for codec in (jcodec, tcodec):
        with pytest.raises(ValueError, match=kind):
            codec.encode_wire(img, kind)
    with pytest.raises(ValueError, match='unknown'):
        tcodec.encode_wire(img, 'jpeg')


@pytest.mark.parametrize('kind', tcodec.WIRES)
def test_decoders_exact_against_jax(kind):
    for name, img in _images(1).items():
        parts = jcodec.encode_wire(img, kind)
        want = np.asarray(jcodec.decode_wire(tuple(jnp.asarray(p)
                                                   for p in parts)))
        got = tcodec.decode_wire(tuple(torch.from_numpy(p) for p in parts))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if kind == 'yuv420':        # grayscale roundtrips bit-exactly
        gray = _images(1)['gray']
        out = tcodec.decode_wire(tuple(
            torch.from_numpy(p) for p in tcodec.encode_wire(gray, kind)))
        np.testing.assert_array_equal(out.numpy(), gray.astype(np.float32))


# ----------------------------------------------------------------------
# Point pack
# ----------------------------------------------------------------------
def _rows(rng, n):
    pc = np.zeros((n, 7), np.float32)
    pc[:, :3] = rng.uniform(-160, 160, (n, 3))
    pc[:, 3] = rng.uniform(0, 255, n)
    pc[:, 4:6] = rng.uniform(-40, 70000, (n, 2))   # clamps at both ends
    pc[:, 6] = rng.integers(-1, 4000, n)
    return pc


@pytest.mark.parametrize('n, n_pad', [(0, 8), (1000, 1000), (999, 1003)])
def test_pointpack_bytes_and_unpack_exact(n, n_pad):
    pc = _rows(np.random.default_rng(n), n)
    want = jpack.pack_points7_np(pc, n_pad)
    got = tpack.pack_points7_np(pc, n_pad)
    assert got.dtype == np.uint8 and got.size == n_pad * 13
    assert got.tobytes() == want.tobytes()
    uj = np.asarray(jpack.unpack_points7(jnp.asarray(want), n_pad))
    ut = tpack.unpack_points7(torch.from_numpy(got), n_pad)
    assert ut.dtype == torch.float32 and ut.shape == (n_pad, 7)
    np.testing.assert_array_equal(ut.numpy(), uj)


@pytest.mark.parametrize('col, value, match', [
    (0, 170.0, 'coordinate'), (2, -164.0, 'coordinate'),
    (3, 256.0, 'intensity'), (3, -0.6, 'intensity'),
    (6, -2.0, 'instance'), (6, 65535.0, 'instance'),
    (1, np.nan, 'non-finite'), (5, np.inf, 'non-finite')])
def test_pointpack_range_violations_raise(col, value, match):
    pc = _rows(np.random.default_rng(3), 16)
    pc[5, col] = value
    for pack in (jpack, tpack):
        with pytest.raises(ValueError, match=match):
            pack.pack_points7_np(pc, 16)
    with pytest.raises(ValueError, match='pad'):
        tpack.pack_points7_np(pc, 15)
    with pytest.raises(ValueError, match='N,7'):
        tpack.pack_points7_np(pc[:, :6], 16)


# ----------------------------------------------------------------------
# Accumulators on the wires
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def semseg_pair():
    """The reduced-depth model on both sides, the same weights."""
    sem_j = SemSegTPU(seed=0, stage_sizes=(1, 1, 1, 1))
    sem_t = SemSegTorch('cpu', stage_sizes=(1, 1, 1, 1))
    load_named_tensors(sem_t, onnx_port.export_named_tensors(sem_j.variables))
    return sem_j, sem_t


def _maps_match(bj, bt):
    """The maps under the step() rule, the rgb medians exact."""
    assert set(bj) == set(bt)
    for k in bj:
        if k.startswith('trajs') or k == 'gt_lanes':
            continue
        assert bt[k].dtype == np.float16 and bt[k].shape == bj[k].shape
        if k.startswith('rgb'):
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
        mism = np.mean(np.abs(np.asarray(bj[k], np.float32)
                              - bt[k].astype(np.float32)) > 2e-2)
        assert mism < 0.02, (k, mism)


K_HW = (64, 128)
K_BEV = dict(type='sem', view_size=40, pixel_size=64, max_trans_radius=2.0,
             zoom_thresh=0.05, do_warp=True, int_scaler=20.,
             int_sep_scaler=20., int_mid_threshold=0.5)


@pytest.fixture(scope='module')
def kitti_runs(semseg_pair):
    """step() on 4 camera frames at 64x128 through both accumulators, on
    each wire pair."""
    stream = tsyn.SyntheticKitti360Stream(n_frames=4, step=2.0,
                                          lidar_range=25.0, seed=5,
                                          points_per_frame=3000, img_hw=K_HW)
    frames = [stream.frame(i) for i in range(4)]
    _, H_velo_cam, P_cam_frame = tsyn.make_calib(K_HW)
    calib = dict(h_velo_cam=H_velo_cam, p_cam_frame=P_cam_frame,
                 p_velo_frame=P_cam_frame @ H_velo_cam)
    runs = {}
    for img_wire, pc_wire in WIRE_PAIRS:
        kw = dict(accum_cfg=jcfg.AccumConfig(
            max_points_per_frame=8192, max_frames=10,
            max_painted_points_per_frame=8192, compact_cap=49152),
            icp_cfg=jcfg.ICPConfig(max_downsampled=512, num_iters=8),
            seed=2, transfer_dtype=pc_wire, img_transfer=img_wire)
        a_j = jk3.Kitti360SemanticPointCloudAccumulator(
            12.0, calib, 1e3, semseg_pair[0], jcfg.DEFAULT_SEMSEG_FILTERS,
            jcfg.DEFAULT_SEM_IDXS, False, K_BEV, **kw)
        a_j.sem_bev_generator.use_prepped_raster = True
        a_j.sem_bev_generator._prep_interpret = True
        a_t = tk3.Kitti360SemanticPointCloudAccumulator(
            12.0, calib, 1e3, semseg_pair[1], jcfg.DEFAULT_SEMSEG_FILTERS,
            jcfg.DEFAULT_SEM_IDXS, False, K_BEV, device='cpu', **kw)
        _quiet(a_j.integrate, [frames[0]])
        _quiet(a_t.integrate, [frames[0]])
        steps = []
        for f in frames[1:]:
            bj = _quiet(a_j.step, [f], bev_num=1, gen_future=True)
            bt = _quiet(a_t.step, [f], bev_num=1, gen_future=True)
            steps.append((bj, bt, np.array(a_j.poses), np.array(a_t.poses),
                          a_j.window_start, a_t.window_start))
        runs[img_wire, pc_wire] = (a_j, a_t, steps)
    return runs


@pytest.mark.parametrize('wires', WIRE_PAIRS, ids='-'.join)
def test_kitti360_step_on_wire_matches_jax(kitti_runs, wires):
    a_j, a_t, steps = kitti_runs[wires]
    assert a_t.img_transfer == wires[0]
    for bj, bt, pj, pt, ws_j, ws_t in steps:
        assert ws_t == ws_j
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        assert len(bt) == 1
        _maps_match(bj[0], bt[0])
    # The same upload bytes per frame (the JAX counter adds the image
    # parts, the padded points and the validity bytes).
    assert a_t.upload_frames == a_j.upload_frames == 4
    assert a_t.upload_bytes_total == a_j.upload_bytes_total
    np.testing.assert_array_equal(a_t.state.valid.numpy(),
                                  np.asarray(a_j.state.valid))


N_ACCUM = dict(max_points_per_frame=16384, max_frames=32,
               max_painted_points_per_frame=16384, max_instances=64)
N_BEV = dict(type='sem', view_size=40, pixel_size=64, int_scaler=1.,
             int_sep_scaler=30., int_mid_threshold=0.12)


def _nuscenes_pair(cls_j, cls_t, semseg_pair, args, wires, j=None, t=None):
    kw = dict(bev_params=N_BEV, loc='synth-map', seed=0,
              img_transfer=wires[0], transfer_dtype=wires[1])
    a_j = cls_j(*args, semseg_model=semseg_pair[0],
                accum_cfg=jcfg.AccumConfig(**N_ACCUM),
                **kw, **({} if j is None else {'icp_cfg': j}))
    a_t = cls_t(*args, semseg_model=semseg_pair[1],
                accum_cfg=tcfg.AccumConfig(**N_ACCUM), device='cpu',
                **kw, **({} if t is None else {'icp_cfg': t}))
    return a_j, a_t


@pytest.fixture(scope='module')
def nuscenes_runs(semseg_pair):
    """The oracle and the ICP accumulators on the first 4 frames of
    test_torch_nuscenes.py's ICP stream (6 cameras of 64x128), one sample
    each, per wire pair."""
    stream = tsyn.SyntheticNuScenesStream(n_frames=8, step=2.0,
                                          lidar_range=25.0, seed=3)
    frames = [stream.frame(i) for i in range(4)]
    icp = dict(max_downsampled=2048, num_iters=16)
    runs = {}
    for wires in WIRE_PAIRS:
        for name, cls_j, cls_t, args, kw in (
                ('oracle', JOracle, TOracle, (), {}),
                ('icp', JIcp, TIcp, (100.0, 1e3),
                 dict(j=jcfg.ICPConfig(**icp), t=tcfg.ICPConfig(**icp)))):
            a_j, a_t = _nuscenes_pair(cls_j, cls_t, semseg_pair, args, wires,
                                      **kw)
            for f in frames:
                _quiet(a_j.integrate, [f])
                _quiet(a_t.integrate, [f])
            bj = a_j.generate_bev(present_idx=2, bev_num=1,
                                  gen_future=True)[0]
            bt = a_t.generate_bev(present_idx=2, bev_num=1,
                                  gen_future=True)[0]
            runs[name, wires] = (a_j, a_t, bj, bt)
    return runs


@pytest.mark.parametrize('wires', WIRE_PAIRS, ids='-'.join)
def test_oracle_on_wire_matches_jax(nuscenes_runs, wires):
    a_j, a_t, bj, bt = nuscenes_runs['oracle', wires]
    assert (a_t.img_transfer, a_t.transfer_dtype) == wires
    np.testing.assert_array_equal(np.array(a_t.poses), np.array(a_j.poses))
    np.testing.assert_array_equal(a_t.state.inst_dyn.numpy(),
                                  np.asarray(a_j.state.inst_dyn))
    assert a_t.tracker.dyn_instances == a_j.tracker.dyn_instances
    vj = np.asarray(a_j.state.valid)
    np.testing.assert_array_equal(a_t.state.valid.numpy(), vj)
    assert a_t.max_painted == int(vj.sum(1).max()) > 0
    pj, pt = np.asarray(a_j.state.points), a_t.state.points.numpy()
    np.testing.assert_allclose(pt[vj][:, :4], pj[vj][:, :4], atol=1e-5)
    np.testing.assert_array_equal(pt[vj][:, 4:], pj[vj][:, 4:])
    assert a_t.upload_bytes_total == a_j.upload_bytes_total
    _maps_match(bj, bt)


@pytest.mark.parametrize('wires', WIRE_PAIRS, ids='-'.join)
def test_icp_on_wire_matches_jax(nuscenes_runs, wires):
    a_j, a_t, bj, bt = nuscenes_runs['icp', wires]
    assert (a_t.img_transfer, a_t.transfer_dtype) == wires
    np.testing.assert_allclose(np.array(a_t.poses), np.array(a_j.poses),
                               atol=1e-4)
    np.testing.assert_array_equal(a_t.state.valid.numpy().sum(1),
                                  np.asarray(a_j.state.valid).sum(1))
    _maps_match(bj, bt)


def test_wire_upload_bytes():
    """Bytes per frame on each wire: the image at 3, 1.5 and 0.75 B/px,
    the NuScenes points at 13 B/point against 28."""
    img = np.zeros((6, 448, 800, 3), np.uint8)
    assert img.nbytes == 6_451_200
    for kind, want in (('yuv420', 3_225_600), ('yuv420h', 1_612_800)):
        assert sum(p.nbytes for p in tcodec.encode_wire(img, kind)) == want
    kitti = np.zeros((376, 1408, 3), np.uint8)
    assert sum(p.nbytes for p in tcodec.encode_wire(kitti, 'yuv420h')) == \
        397_056
    assert tpack.pack_points7_np(np.zeros((10, 7)), 65536).nbytes == \
        13 * 65536
