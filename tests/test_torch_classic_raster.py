"""The port's classic raster against the JAX package's: the stats stage
(split_stats_from_words_flat and sorted_split_stats, every route, rgb
medians from the kernel and from sorts) and the whole per-sample raster
(make_raster_fn, sort and scatter backends), on the same seeded inputs.

Routes of the stats stage, port <- JAX: the kernel route (use_kernel;
segmented_stats_words or, with words_kernel=False, segmented_stats on
unpacked rows) <- use_pallas with the Pallas kernels in interpret mode;
the pure-torch 2-key sort route <- the pure-XLA fallback.

Tolerances: counts, probabilities, medians and z-mins are functions of
integer counts, order-free mins and exact medians, so they are equal; the
intensity sums are taken in another order (rtol 1e-5). The float16 map
stacks of make_raster_fn agree within 2e-3 max abs (bench.py's raster
parity gate).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.bev import core as jcore
from pc_accumulation_lib_tpu.ops import rasterize as jras
from pc_accumulation_lib_tpu.ops import sort_raster as jsr
from pc_accumulation_lib_tpu_torch.bev import core as tcore
from pc_accumulation_lib_tpu_torch.ops import rasterize as tras
from pc_accumulation_lib_tpu_torch.ops import sort_raster as tsr

ROUTES = [  # (use_kernel, words_kernel, hist_medians)
    (True, True, True), (True, False, True), (True, True, False),
    (True, False, False), (False, True, False)]


def _assert_maps_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.shape == w.shape, k
        if k.startswith('intensity'):
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def _words_case(rng, n, sent):
    c2 = np.where(rng.uniform(size=n) < 0.9,
                  rng.integers(0, sent // 2, size=n), sent).astype(np.int32)
    road = (rng.uniform(size=n) < 0.5).astype(np.float32)
    dyn = (rng.uniform(size=n) < 0.2).astype(np.float32)
    rgb = rng.uniform(-20, 275, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32) * road
    z = (rng.normal(size=n) * 10.0).astype(np.float32)
    w1, w2 = jsr.pack_payload_words(*(jnp.asarray(a) for a in
                                      (road, dyn, rgb, inten, z)))
    return c2, np.array(w1), np.array(w2)


@pytest.mark.parametrize('gen_future', [True, False])
@pytest.mark.parametrize('use_kernel,words_kernel,hist_medians', ROUTES)
def test_split_stats_routes_match_jax(rng, gen_future, use_kernel,
                                      words_kernel, hist_medians):
    n_cells = 1024
    c2, w1, w2 = _words_case(rng, 5000, n_cells * (2 if gen_future else 1))
    want = jsr.split_stats_from_words_flat(
        jnp.asarray(c2), jnp.asarray(w1), jnp.asarray(w2), n_cells,
        gen_future, rgb_fill=5, use_pallas=use_kernel,
        pallas_interpret=True, hist_medians=hist_medians,
        words_kernel=words_kernel)
    got = tsr.split_stats_from_words_flat(
        torch.from_numpy(c2), torch.from_numpy(w1), torch.from_numpy(w2),
        n_cells, gen_future, rgb_fill=5, use_kernel=use_kernel,
        hist_medians=hist_medians, words_kernel=words_kernel)
    _assert_maps_equal(got, want)


def test_compact_groups_not_ported():
    """compact_groups needs the kernel route with hist_medians: elsewhere
    it raises (the JAX package drops it silently there); on that route it
    gives rank-indexed maps and cell_of_rank (tests/
    test_torch_compact_step.py holds them to the dense groups). The name
    is kept from when the port refused compact_groups."""
    c2 = torch.zeros(4, dtype=torch.int32)
    for kw in (dict(hist_medians=False), dict(use_kernel=False)):
        with pytest.raises(ValueError, match='compact_groups'):
            tsr.split_stats_from_words_flat(c2, c2, c2, 16, True,
                                            compact_groups=True, **kw)
    out = tsr.split_stats_from_words_flat(c2, c2, c2, 16, True,
                                          compact_groups=True)
    assert out['cell_of_rank'].tolist() == [0] + [16] * 15


def _point_features(rng, n, P):
    cells = rng.integers(0, P * P, size=n).astype(np.int32)
    static_m = rng.uniform(size=n) < 0.8
    is_future = rng.uniform(size=n) < 0.4
    z = (rng.normal(size=n) * 2.0).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.float32)
    sem = rng.choice([0, 2, 8, 13, 14, 15], size=n).astype(np.float32)
    return cells, static_m, is_future, z, inten, rgb, sem


@pytest.mark.parametrize('gen_future', [True, False])
@pytest.mark.parametrize('use_kernel,hist_medians',
                         [(True, True), (True, False), (False, False)])
def test_sorted_split_stats_matches_jax(rng, gen_future, use_kernel,
                                        hist_medians):
    P = 32
    feats = _point_features(rng, 4000, P)
    want = jsr.sorted_split_stats(
        *(jnp.asarray(a) for a in feats), cfg.DEFAULT_SEM_IDXS, P,
        gen_future, rgb_fill=9, use_pallas=use_kernel, pallas_interpret=True,
        hist_medians=hist_medians)
    got = tsr.sorted_split_stats(
        *(torch.from_numpy(a) for a in feats), cfg.DEFAULT_SEM_IDXS, P,
        gen_future, rgb_fill=9, use_kernel=use_kernel,
        hist_medians=hist_medians)
    _assert_maps_equal(got, want)


def _scatter_args(name, feats, P):
    cells, static_m, _, z, inten, rgb, sem = feats
    road = sem == 0
    return {'count_map': (cells, static_m, P),
            'sem_probmap': (cells, static_m, road, P),
            'intensity_map': (cells, static_m, inten, P),
            'elevation_map': (cells, static_m, z, P),
            'elevation_min_raw': (cells, static_m, z, P),
            'median_value_map': (cells, static_m, rgb[:, 1], P),
            'rgb_median_maps': (cells, static_m, rgb, P),
            'rgb_histograms': (cells, static_m, rgb, P),
            }[name]


@pytest.mark.parametrize('name', ['count_map', 'sem_probmap',
                                  'intensity_map', 'elevation_map',
                                  'elevation_min_raw', 'median_value_map',
                                  'rgb_median_maps', 'rgb_histograms'])
def test_scatter_spec_matches_jax(rng, name):
    """Each scatter-spec map of ops/rasterize: counts, probabilities,
    min-z and medians equal; weighted sums within rtol 1e-5."""
    P = 16
    feats = _point_features(rng, 3000, P)
    want = np.asarray(getattr(jras, name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in _scatter_args(name, feats, P))))
    got = getattr(tras, name)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in _scatter_args(name, feats, P))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_bev_split_channels_matches_jax(rng):
    P = 16
    cells, static_m, _, z, inten, rgb, sem = _point_features(rng, 3000, P)
    args = (cells, static_m, z, inten, rgb, sem)
    want = jras.bev_split_channels(*(jnp.asarray(a) for a in args),
                                   cfg.DEFAULT_SEM_IDXS, P, rgb_fill=3)
    got = tras.bev_split_channels(*(torch.from_numpy(a) for a in args),
                                  cfg.DEFAULT_SEM_IDXS, P, rgb_fill=3)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _raster_inputs(rng, n=8192):
    pts = np.zeros((n, 10), np.float32)
    pts[:, 0:2] = rng.uniform(-30, 30, size=(n, 2))
    pts[:, 2] = rng.uniform(-2, 6, size=n)
    pts[:, 3] = rng.uniform(0, 1, size=n)
    pts[:, 4:7] = rng.integers(0, 256, size=(n, 3))
    pts[:, 7] = rng.choice([0, 2, 13, 14, 15, 17], size=n)
    pts[:, 8] = rng.integers(0, 6, size=n)        # instance ids
    pts[:, 9] = (rng.uniform(size=n) < 0.05)      # point dyn flags
    inst_dyn = np.asarray([0, 1, 0, 0, 1, 0], np.float32)
    fids = rng.integers(0, 8, size=n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    a = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = [1.5, -2.0, 0.1]
    return pts, inst_dyn, fids, valid, T


PARAMS = [dict(), dict(rot_ang=2.1, trans_dx=1.2, trans_dy=-0.7, zoom=1.04,
                       warp_a1=1.1, warp_a2=-3e-4, warp_b1=0.9, warp_b2=4e-4,
                       height_thresh=2.0)]


@pytest.mark.parametrize('gen_future', [True, False])
@pytest.mark.parametrize('backend,use_kernel', [('sort', True),
                                                ('sort', False),
                                                ('scatter', None)])
def test_make_raster_fn_matches_jax(rng, gen_future, backend, use_kernel):
    P, view = 64, 40.0
    pts, inst_dyn, fids, valid, T = _raster_inputs(rng)
    # JAX's sort backend off the TPU is its pure-XLA route.
    jras = jcore.make_raster_fn(view, P, cfg.DEFAULT_SEM_IDXS, 20., 20.,
                                0.5, backend=backend, use_pallas=False)
    tras = tcore.make_raster_fn(view, P, cfg.DEFAULT_SEM_IDXS, 20., 20.,
                                0.5, backend=backend, use_kernel=use_kernel)
    for extra in PARAMS:
        params = jcore.identity_params(
            T_ref_world=T, bev_coords=np.asarray([0.5, -0.3, 0.0]),
            window=(1, 7), present_frame=5)._replace(**extra)
        want = np.asarray(jras(jnp.asarray(pts), jnp.asarray(valid),
                               jnp.asarray(fids), jnp.asarray(inst_dyn),
                               params.pack(), gen_future))
        tparams = tcore.identity_params(
            T_ref_world=T, bev_coords=np.asarray([0.5, -0.3, 0.0]),
            window=(1, 7), present_frame=5)._replace(**extra)
        np.testing.assert_array_equal(tparams.pack(), params.pack())
        got = tras(torch.from_numpy(pts), torch.from_numpy(valid),
                   torch.from_numpy(fids), torch.from_numpy(inst_dyn),
                   torch.from_numpy(tparams.pack()), gen_future).numpy()
        assert got.dtype == np.float16
        assert got.shape == want.shape == (21 if gen_future else 7, P, P)
        err = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert err.max() <= 2e-3, err.max()


def test_make_raster_fn_rejects_sparse_pack():
    """pack='sparse' is the sort backend's (as in the JAX package): the
    scatter backend and unknown packs raise; the sort backend returns the
    (sparse, fallback) uint8 pair (tests/test_torch_fetch.py holds its
    bytes to the JAX package's). The name is kept from when the port
    refused the sparse pack."""
    args = (40.0, 64, cfg.DEFAULT_SEM_IDXS, 20., 20., 0.5)
    with pytest.raises(ValueError, match='sparse'):
        tcore.make_raster_fn(*args, backend='scatter', pack='sparse')
    with pytest.raises(ValueError, match='pack'):
        tcore.make_raster_fn(*args, pack='dense')
    pts = torch.zeros((8, 10))
    sp, fb = tcore.make_raster_fn(*args, pack='sparse', sparse_cap=256)(
        pts, torch.ones(8, dtype=torch.bool), torch.zeros(8, dtype=torch.int32),
        torch.zeros(1), torch.from_numpy(tcore.identity_params(
            window=(0, 1), present_frame=1).pack()), True)
    assert sp.dtype == fb.dtype == torch.uint8
    assert (sp.numel(), fb.numel()) == tcore.sparse_buffer_bytes(64, True,
                                                                 256)
