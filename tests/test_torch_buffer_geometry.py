"""Port's geometry and buffer ops vs the JAX package on the same numpy
inputs.

Tolerances: float32 products may round differently between XLA and
PyTorch on the CPU, so transformed coordinates compare at 1e-5 relative;
integer results (pixel coords, masks, cell ids, row order) must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum import buffer as jbuf
from pc_accumulation_lib_tpu.ops import geometry as jgeo
from pc_accumulation_lib_tpu_torch.accum import buffer as tbuf
from pc_accumulation_lib_tpu_torch.ops import geometry as tgeo

from pc_accumulation_lib_tpu.dataloaders.synthetic import make_calib


def _rigid(rng):
    a = rng.uniform(-np.pi, np.pi)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = rng.uniform(-100, 100, size=3)
    return T


def _P():
    _, H_velo_cam, P_cam_frame = make_calib((60, 200))
    return (P_cam_frame @ H_velo_cam).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_transforms_match(rng):
    T = _rigid(rng)
    pts = rng.uniform(-50, 50, size=(3000, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.rigid_inverse(_t(T)).numpy(),
                               np.asarray(jgeo.rigid_inverse(jnp.asarray(T))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        tgeo.homo_transform(_t(T), _t(pts)).numpy(),
        np.asarray(jgeo.homo_transform(jnp.asarray(T), jnp.asarray(pts))),
        rtol=1e-5, atol=1e-4)
    ang, dx, dy = np.float32(0.7), np.float32(1.5), np.float32(-2.0)
    got = tgeo.geometric_transform(_t(pts), torch.tensor(ang),
                                   torch.tensor(dx), torch.tensor(dy))
    want = jgeo.geometric_transform(jnp.asarray(pts), ang, dx, dy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    xy = pts[:, :2]
    for view in (40.0, np.float32(41.3)):
        np.testing.assert_array_equal(
            tgeo.crop_view_mask(_t(pts), view).numpy(),
            np.asarray(jgeo.crop_view_mask(jnp.asarray(pts), view)))
        g_t = tgeo.pos2grid(_t(xy), torch.tensor(view, dtype=torch.float32),
                            64)
        g_j = jgeo.pos2grid(jnp.asarray(xy), jnp.float32(view), 64)
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        # In-view pixel coords map to the same cell ids; wild rows (far
        # outside the view) are clamped before the cast and stay finite.
        m = np.asarray(jgeo.crop_view_mask(jnp.asarray(pts), view))
        c_t = tgeo.grid_cell_index(g_t[:, 0], g_t[:, 1], 64).numpy()
        c_j = np.asarray(jgeo.grid_cell_index(g_j[:, 0], g_j[:, 1], 64))
        np.testing.assert_array_equal(c_t[m], c_j[m])
    sem = rng.choice([0, 10, 11, 13, 255], size=500).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.semseg_filter_mask(_t(sem), cfg.DEFAULT_SEMSEG_FILTERS).numpy(),
        np.asarray(jgeo.semseg_filter_mask(jnp.asarray(sem),
                                           cfg.DEFAULT_SEMSEG_FILTERS)))


def test_projection_and_paint_match(rng):
    P = _P()
    pts = rng.uniform(-30, 30, size=(4000, 3)).astype(np.float32)
    pts[:3] = [[0.0, 1.0, 2.0], [0.0, -5.0, 0.5], [0.0, 0.0, 0.0]]  # depth 0
    feats = rng.uniform(0, 255, size=(60, 200, 4)).astype(np.float32)
    u_t, v_t, m_t = tgeo.project_to_image(_t(pts), _t(P), 60, 200)
    u_j, v_j, m_j = jgeo.project_to_image(jnp.asarray(pts), jnp.asarray(P),
                                          60, 200)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    m = m_t.numpy()
    assert m.sum() > 100
    np.testing.assert_array_equal(u_t.numpy()[m], np.asarray(u_j)[m])
    np.testing.assert_array_equal(v_t.numpy()[m], np.asarray(v_j)[m])
    f_t, pm_t = tgeo.paint_from_image(_t(pts), _t(P), _t(feats))
    f_j, pm_j = jgeo.paint_from_image(jnp.asarray(pts), jnp.asarray(P),
                                      jnp.asarray(feats))
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    np.testing.assert_array_equal(f_t.numpy()[m], np.asarray(f_j)[m])


def test_paint_paths_match(rng):
    n = 3000
    P, T = _P(), _rigid(rng)
    pc = np.concatenate([rng.uniform(-30, 30, size=(n, 3)),
                         rng.uniform(0, 1, size=(n, 1))], 1).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    rgb = rng.integers(0, 256, size=(60, 200, 3)).astype(np.float32)
    semseg = rng.integers(0, 19, size=(60, 200)).astype(np.int32)
    sem_gt = rng.choice([7, 8, 11, 255], size=n).astype(np.float32)
    filt = cfg.DEFAULT_SEMSEG_FILTERS
    outs = [
        (tbuf.paint_frame_camera(_t(pc), _t(valid), _t(rgb), _t(semseg),
                                 _t(P), _t(T), filt),
         jbuf.paint_frame_camera(jnp.asarray(pc), jnp.asarray(valid),
                                 jnp.asarray(rgb), jnp.asarray(semseg),
                                 jnp.asarray(P), jnp.asarray(T), filt)),
        (tbuf.paint_frame_gt(_t(pc), _t(valid), _t(sem_gt), _t(T), filt),
         jbuf.paint_frame_gt(jnp.asarray(pc), jnp.asarray(valid),
                             jnp.asarray(sem_gt), jnp.asarray(T), filt)),
    ]
    for (p_t, v_t), (p_j, v_j) in outs:
        v = v_t.numpy()
        np.testing.assert_array_equal(v, np.asarray(v_j))
        assert v.sum() > 50
        np.testing.assert_allclose(p_t.numpy()[v], np.asarray(p_j)[v],
                                   rtol=1e-5, atol=1e-4)


def test_compact_rows_and_insert_match(rng):
    n, cap = 2000, 1500
    painted = rng.normal(size=(n, 10)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.6
    p_t, v_t, n_t = tbuf.compact_rows(_t(painted), _t(valid), cap)
    p_j, v_j, n_j = jbuf.compact_rows(jnp.asarray(painted),
                                      jnp.asarray(valid), cap)
    assert int(n_t) == int(n_j) == valid.sum()
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    k = int(n_t)
    np.testing.assert_array_equal(p_t.numpy()[:k], np.asarray(p_j)[:k])
    np.testing.assert_array_equal(p_t.numpy()[:k], painted[valid])  # stable

    st_t = tbuf.init_state(4, cap, 8, 'cpu')
    st_j = jbuf.init_state(4, cap, 8)
    for fid in (0, 5, 6):
        tbuf.insert_frame(st_t, p_t, v_t, fid)
        st_j = jbuf.insert_frame(st_j, p_j, v_j, jnp.int32(fid))
    np.testing.assert_array_equal(st_t.frame_ids.numpy(),
                                  np.asarray(st_j.frame_ids))
    np.testing.assert_array_equal(st_t.valid.numpy(), np.asarray(st_j.valid))
    np.testing.assert_array_equal(st_t.points.numpy()[st_t.valid.numpy()],
                                  np.asarray(st_j.points)[st_t.valid.numpy()])


@pytest.mark.parametrize('cap', [32, 8])
def test_compact_window_matches(cap):
    """The masked prefix copy gives the JAX block copy's live rows in the
    same (slot) order; n_live counts every live row even past the cap."""
    F, N, D = 4, 16, 10
    rng = np.random.default_rng(0)
    pts = np.zeros((F, N, D), np.float32)
    valid = np.zeros((F, N), bool)
    counts = [5, 0, 7, 3]                      # slot 1 empty
    fids = np.asarray([4, -1, 5, 2], np.int32)  # slot 3 evicted (fid < ws)
    for f in range(F):
        pts[f, :counts[f]] = rng.normal(size=(counts[f], D))
        pts[f, counts[f]:] = np.nan            # padding must not leak
        valid[f, :counts[f]] = True
    st_j = jbuf.BufferState(points=jnp.asarray(pts), valid=jnp.asarray(valid),
                            frame_ids=jnp.asarray(fids),
                            inst_dyn=jnp.zeros((4,), jnp.float32))
    st_t = tbuf.BufferState(points=_t(pts), valid=_t(valid),
                            frame_ids=_t(fids), inst_dyn=torch.zeros(4))
    p_t, f_t, v_t, n_t = tbuf.compact_window(st_t, torch.tensor(3), cap)
    p_j, f_j, v_j, n_j = jbuf.compact_window(st_j, jnp.int32(3), cap)
    assert int(n_t) == int(n_j) == 12
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    k = min(12, cap)
    np.testing.assert_array_equal(p_t.numpy()[:k], np.asarray(p_j)[:k])
    np.testing.assert_array_equal(f_t.numpy()[:k], np.asarray(f_j)[:k])
    assert not np.isnan(p_t.numpy()).any()
