"""The rank-compacted stats groups, the grouped sparse dispatch, the
compact-rung ladder and step(async_fetch=True), against the port's own
plain forms and the JAX package's.

  * compact_groups (ops/sort_raster): on both kernel routes' plain
    versions, rank i's statistics equal the dense groups' at the i-th
    occupied cell, bit for bit, the dead ranks the empty-cell values;
    cell_of_rank lists the occupied cells. Against the JAX package's
    compacted stats (Pallas in interpret mode): equal, intensity rtol
    1e-5 (float32 sums in another order, as test_torch_classic_raster).
  * The sparse prepped raster with and without compact_groups: the same
    used wire bytes, the same fallback decode; against the JAX package's
    compacted raster the same header (masks, counts) and the decoded
    maps equal, intensity within 2e-3 + 1/255 (its float16 maps within
    2e-3, test_torch_raster, then one u8 step).
  * The group raster (make_prepped_raster_group_fn) is the per-sample
    raster row by row, bit for bit.
  * step() at the JAX bench's fetch form (sparse, per-split caps, rungs,
    fetch groups, 'exact' sizing, compact groups, async_fetch drained a
    step behind on a worker thread, prewarm_rungs first) equals a plain
    sparse step() (one cap, per-sample dispatch, 'hint' sizing, no
    compaction, sync) bit for bit, and the JAX package's step() on the
    same fetch by test_torch_step's rule (poses 1e-4 m, window start
    exact, cell-mismatch fraction < 0.02 at 2e-2).
  * prewarm_rungs leaves every state tensor, the RNG and every counter
    as they were.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.accum import kitti360 as jk3
from pc_accumulation_lib_tpu.bev import core as jcore
from pc_accumulation_lib_tpu.ops import sort_raster as jsr
from pc_accumulation_lib_tpu_torch.accum import kitti360 as tk3
from pc_accumulation_lib_tpu_torch.bev import core as tcore
from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
from pc_accumulation_lib_tpu_torch.ops import sort_raster as tsr
from pc_accumulation_lib_tpu_torch.utils import profiling

from test_torch_raster import _inputs
from test_torch_step import _assert_bevs_match, _calib

P, VIEW = 64, 40.0
INT_TOL = 2e-3 + 1.0 / 255


def _words_case(rng, n, n_cells, nsplit, occupied_frac):
    sent = n_cells * nsplit
    hi = max(2, int(sent * occupied_frac))
    lo = int(sent * 0.4) if occupied_frac < 1.0 else 0
    c2 = np.where(rng.uniform(size=n) < 0.9,
                  rng.integers(lo, min(sent, lo + hi), size=n),
                  sent).astype(np.int32)
    road = (rng.uniform(size=n) < 0.5).astype(np.float32)
    dyn = (rng.uniform(size=n) < 0.2).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32) * road
    z = (rng.normal(size=n) * 3.0).astype(np.float32)
    w1, w2 = tsr.pack_payload_words(*(torch.from_numpy(a) for a in
                                      (road, dyn, rgb, inten, z)))
    return torch.from_numpy(c2), w1, w2


@pytest.mark.parametrize('occupied_frac', [1.0, 0.02])
@pytest.mark.parametrize('words_kernel', [True, False])
@pytest.mark.parametrize('gen_future', [True, False])
def test_compact_stats_equal_dense(rng, gen_future, words_kernel,
                                   occupied_frac):
    n_cells, nsplit = 1024, 2 if gen_future else 1
    c2, w1, w2 = _words_case(rng, 5000, n_cells, nsplit, occupied_frac)
    kw = dict(rgb_fill=3, words_kernel=words_kernel)
    dense = tsr.split_stats_from_words_flat(c2, w1, w2, n_cells, gen_future,
                                            **kw)
    comp = tsr.split_stats_from_words_flat(c2, w1, w2, n_cells, gen_future,
                                           compact_groups=True, **kw)
    cor = comp.pop('cell_of_rank').numpy()
    keyed = c2.numpy()[c2.numpy() < n_cells * nsplit]
    occ = np.unique(keyed // nsplit)
    np.testing.assert_array_equal(cor[:occ.size], occ)
    assert (cor[occ.size:] == n_cells).all()
    dead = np.setdiff1d(np.arange(n_cells), occ)
    assert set(comp) == set(dense)
    for k, d in dense.items():
        d, c = d.numpy(), comp[k].numpy()
        np.testing.assert_array_equal(c[..., :occ.size], d[..., occ],
                                      err_msg=k)
        np.testing.assert_array_equal(c[..., occ.size:], d[..., dead],
                                      err_msg=k)
    if gen_future and occupied_frac < 1.0:
        want = jsr.split_stats_from_words_flat(
            *(jnp.asarray(t.numpy()) for t in (c2, w1, w2)), n_cells,
            gen_future, rgb_fill=3, use_pallas=True, pallas_interpret=True,
            words_kernel=words_kernel, compact_groups=True)
        np.testing.assert_array_equal(cor, np.asarray(want['cell_of_rank']))
        for k, v in comp.items():
            w = np.asarray(want[k])
            if k.startswith('intensity'):
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-5,
                                           atol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def _prepped(rng, gen_future, caps):
    pts, inst_dyn, fids, valid, pose_vec = _inputs(rng)
    t = [torch.from_numpy(a) for a in (pts, inst_dyn, fids, valid, pose_vec)]
    ref, pk, pk2 = tcore.make_prep_fn(cfg.DEFAULT_SEM_IDXS)(t[0], t[1], t[4])
    aug9s = torch.tensor([[2.1, 1.2, -0.7, 1.04, 1.1, -3e-4, 0.9, 4e-4, 2.0],
                          [0.4, -0.5, 0.3, 0.97, 1.0, 0.0, 1.0, 0.0,
                           np.inf]], dtype=torch.float32)
    return (pts, inst_dyn, fids, valid, pose_vec), (ref, t[3], t[2], pk,
                                                     pk2), t[4], aug9s


def _make(compact, caps, grouped=False):
    make = (tcore.make_prepped_raster_group_fn if grouped
            else tcore.make_prepped_raster_fn)
    return make(VIEW, P, 20., 20., 0.5, pack='sparse', sparse_cap=caps,
                compact_groups=compact)


@pytest.mark.parametrize('gen_future', [True, False])
def test_compact_sparse_raster_wire_identical(rng, gen_future):
    caps = (2560, 1536, 1024)
    host, args, pose_vec, aug9s = _prepped(rng, gen_future, caps)
    ctrl, comp = _make(False, caps), _make(True, caps)
    ev = tcore.sparse_empty_values(20., 20., 0.5)
    jras = jcore.make_prepped_raster_fn(VIEW, P, 20., 20., 0.5,
                                        pack='sparse', sparse_cap=caps,
                                        pallas_interpret=True,
                                        compact_groups=True)
    jref, jpk, jpk2 = jcore.make_prep_fn(cfg.DEFAULT_SEM_IDXS)(
        *(jnp.asarray(host[i]) for i in (0, 1, 4)))
    hdr = tcore.sparse_header_bytes(P, gen_future)
    for i, aug9 in enumerate(aug9s):
        sp_a, dn_a = (x.numpy() for x in ctrl(*args, (pose_vec, aug9),
                                              gen_future))
        sp_b, dn_b = (x.numpy() for x in comp(*args, (pose_vec, aug9),
                                              gen_future))
        used = tcore.sparse_used_bytes(sp_a, P, gen_future)
        assert used == tcore.sparse_used_bytes(sp_b, P, gen_future) > hdr
        np.testing.assert_array_equal(sp_a[:used], sp_b[:used])
        assert dn_b.size == dn_a.size + 4 * P * P
        np.testing.assert_array_equal(
            tcore.decode_dense_words(dn_a, gen_future, P),
            tcore.decode_dense_words(dn_b, gen_future, P))
        if i:
            continue
        sp_j, _ = jras(jref, jnp.asarray(host[3]), jnp.asarray(host[2]),
                       jpk, jpk2, (jnp.asarray(host[4]),
                                   jnp.asarray(aug9.numpy())), gen_future)
        sp_j = np.asarray(sp_j)
        np.testing.assert_array_equal(sp_j[:hdr], sp_b[:hdr])
        got = tcore.decode_sparse_stack(sp_b, gen_future, P, caps, ev)
        want = jcore.decode_sparse_stack(sp_j, gen_future, P, caps, ev)
        for c in range(got.shape[0]):
            d = np.abs(got[c].astype(np.float64) - want[c]).max()
            assert d <= (INT_TOL if c % 7 == 1 else 0.0), (c, d)


@pytest.mark.parametrize('compact', [True, False])
def test_group_raster_equals_per_sample(rng, compact):
    caps = (2560, 1536, 1024)
    _, args, pose_vec, aug9s = _prepped(rng, True, caps)
    sp, dn = _make(compact, caps, grouped=True)(*args, pose_vec, aug9s,
                                                True)
    one = _make(compact, caps)
    for i in range(aug9s.shape[0]):
        sp_i, dn_i = one(*args, (pose_vec, aug9s[i]), True)
        assert torch.equal(sp[i], sp_i) and torch.equal(dn[i], dn_i)
    dense = tcore.make_prepped_raster_group_fn(VIEW, P, 20., 20., 0.5)(
        *args, pose_vec, aug9s, False)
    assert dense.shape == (2, 7, P, P) and dense.dtype == torch.float16


N_STEPS, BEV_NUM, HORIZON = 8, 4, 12.0
CAPS = (3072, 2048, 2048)
RUNGS = (8192, 16384, 32768)
BEV = dict(type='sem', view_size=40, pixel_size=P, max_trans_radius=2.0,
           zoom_thresh=0.05, do_warp=True, int_scaler=20., int_sep_scaler=20.,
           int_mid_threshold=0.5, fetch_dtype='sparse')


def _cfg(rungs):
    return dict(accum_cfg=cfg.AccumConfig(
        max_points_per_frame=8192, max_frames=10,
        max_painted_points_per_frame=8192, compact_cap=49152,
        compact_rungs=rungs),
        icp_cfg=cfg.ICPConfig(max_downsampled=512, num_iters=8), seed=7)


def _port(rungs, **bev):
    return tk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, dict(BEV, **bev), device='cpu',
        **_cfg(rungs))


def _snapshot(a):
    g = a.sem_bev_generator
    s = a.state
    return dict(
        state=[t.clone() for t in (s.points, s.valid, s.frame_ids,
                                   s.inst_dyn)],
        rng=repr(g._rng.bit_generator.state),
        counters=repr([a.rungs_used, a._live_ub, a._cum_growth,
                       a.max_live_rows, a.frame_count, a.window_start,
                       g.sparse_overflows, g.max_occupied,
                       g.max_occupied_split, g.sum_occupied_split,
                       g.n_occupied_obs, g.sparse_short_fetches,
                       g._fetch_hint_bytes, g._step_used_max,
                       g._pending_fetches, profiling.snapshot()['counters']]))


def _same_snapshot(a, b):
    assert a['rng'] == b['rng'] and a['counters'] == b['counters']
    for x, y in zip(a['state'], b['state']):
        assert torch.equal(x, y)


@pytest.fixture(scope='module')
def step_runs():
    stream = tsyn.SyntheticKitti360Stream(n_frames=N_STEPS + 1, step=2.0,
                                          lidar_range=25.0, seed=3,
                                          points_per_frame=3000)
    frames = [stream.frame(i) for i in range(N_STEPS + 1)]
    prod = _port(RUNGS, sparse_cap=CAPS, fetch_group=2)
    plain = _port(None, sparse_cap=max(CAPS))
    g = plain.sem_bev_generator
    g._force_ungrouped_dispatch, g.fetch_sizing = True, 'hint'
    g.raster_compact = False
    jx = jk3.Kitti360SemanticPointCloudAccumulator(
        HORIZON, _calib(), 1e3, None, cfg.DEFAULT_SEMSEG_FILTERS,
        cfg.DEFAULT_SEM_IDXS, True, dict(BEV, sparse_cap=CAPS,
                                         fetch_group=2), **_cfg(RUNGS))
    jx.sem_bev_generator.use_prepped_raster = True
    jx.sem_bev_generator._prep_interpret = True
    profiling.reset()
    tracing = profiling.enable()
    for a in (prod, plain, jx):
        a.integrate([frames[0]])
    before = _snapshot(prod)
    prod.prewarm_rungs()
    prewarm = (before, _snapshot(prod))
    out, futs = [], []
    with ThreadPoolExecutor(max_workers=1) as ex, tracing:
        for i, f in enumerate(frames[1:]):
            if i == N_STEPS - 2:   # read at every dispatch, not just once
                prod.sem_bev_generator.raster_compact = False
            futs.append(ex.submit(prod.step([f], bev_num=BEV_NUM,
                                            async_fetch=True)))
            out.append([plain.step([f], bev_num=BEV_NUM),
                        jx.step([f], bev_num=BEV_NUM),
                        np.array(plain.poses), np.array(jx.poses),
                        plain.window_start, jx.window_start])
            if len(futs) > 1:
                out[-2].insert(0, futs[-2].result())
        out[-1].insert(0, futs[-1].result())
    prod.sem_bev_generator.close()
    traced = profiling.snapshot()
    profiling.reset()
    return out, prod, plain, prewarm, traced


def test_step_sparse_grouped_async_matches_plain(step_runs):
    out, prod, plain, _, traced = step_runs
    for bp, bq, *_ in out:
        assert len(bp) == len(bq) == BEV_NUM
        for sp, sq in zip(bp, bq):
            assert set(sp) == set(sq)
            for k in sp:
                if k.startswith('trajs'):
                    assert len(sp[k]) == len(sq[k])
                    for tp, tq in zip(sp[k], sq[k]):
                        np.testing.assert_array_equal(tp, tq)
                else:
                    np.testing.assert_array_equal(sp[k], sq[k], err_msg=k)
    g, h = prod.sem_bev_generator, plain.sem_bev_generator
    assert len(prod.rungs_used) >= 2, prod.rungs_used
    assert sum(prod.rungs_used.values()) == N_STEPS
    assert max(prod.rungs_used) <= 49152 and prod.max_live_rows <= 49152
    assert g.sparse_overflows == h.sparse_overflows == 0
    assert g.max_occupied_split == h.max_occupied_split
    assert g.n_occupied_obs == N_STEPS * BEV_NUM
    # Both accumulators' harvests: wire bytes, where each fetch set was
    # sized, the decode of every sample on the pool.
    counters, spans = traced['counters'], traced['spans']
    assert counters['fetch.bytes'] > 0
    resolved = {k: v for k, v in counters.items()
                if k.startswith('fetch.resolved_by.')}
    assert set(resolved) <= {'fetch.resolved_by.dispatch',
                             'fetch.resolved_by.finalize'}
    assert sum(resolved.values()) == spans['harvest']['n'] == 2 * N_STEPS
    assert spans['harvest.decode']['n'] == 2 * N_STEPS * BEV_NUM
    assert {k[1] for k in g._prepped_fns} == {True, False}


def test_step_sparse_matches_jax(step_runs):
    out, *_ = step_runs
    for bp, _, bj, pt, pj, ws_t, ws_j in out:
        assert ws_t == ws_j
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        _assert_bevs_match(bj, bp)
    assert out[-1][-1] > 0, 'no eviction in the run'


def test_prewarm_rungs_changes_no_state(step_runs):
    _, prod, _, (before, after), _ = step_runs
    _same_snapshot(before, after)
    assert prod._rungs == RUNGS + (49152,)
