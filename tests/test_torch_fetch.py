"""The port's fetch encodings and their decoders against the JAX
package's, on the same seeded stacks and clouds.

  * The device encoders (bev/core _pack_channel_words, sparse_outputs with
    _pack_sparse, quantize_stack_batch) give the JAX package's bytes
    exactly, the whole buffers, cap padding included: gen_future on and
    off, one cap and per-split caps, overflowing caps, rank-indexed
    inputs with cell_of_rank.
  * The host decoders agree bit for bit both ways (the port's bytes
    through the JAX decoders, the JAX bytes through the port's), and
    raise as JAX's do: SparseOverflow, SparseShortFetch, ValueError below
    the header.
  * The native decoder (native/bevdec.cpp, built into build/host/) is
    bit-equal to the numpy decode + warp_dense_maps_np; a failed build
    raises with the compiler's output.
  * generate() on the 'quantized' and 'sparse' fetch against the float16
    fetch: elevation exact, the u8 channels within 1/510 + 1e-3 (the JAX
    tests' tolerance); against the JAX package's generate() on the same
    fetch the same, but intensity within 2e-3 + 1/255 (the two rasters'
    float16 intensity maps differ by up to 2e-3, test_torch_classic_raster,
    so a code may round one u8 step apart); the overflow fallback and a
    truncated fetch give the same maps and are counted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.bev import core as jcore
from pc_accumulation_lib_tpu.bev.sem_bev import SemBEVGenerator as JGen
from pc_accumulation_lib_tpu.ops import warp as jwarp
from pc_accumulation_lib_tpu_torch.bev import core as tcore
from pc_accumulation_lib_tpu_torch.bev import native_decode
from pc_accumulation_lib_tpu_torch.bev.sem_bev import SemBEVGenerator as TGen
from pc_accumulation_lib_tpu_torch.ops import warp as twarp

P = 32
QUANT_TOL = 1.0 / 510 + 1e-3
EMPTY = tcore.sparse_empty_values(20., 20., 0.5, 0)


def _stack_and_counts(rng, S, P, occ=0.3, n_cells=None):
    """A finalized (S*7, P, P) float16 stack and (S, P, P) float32
    counts: zero counts where a cell is empty (its channels then hold the
    empty constants), full split counts = present + future."""
    n = P * P
    stack = rng.uniform(0, 1, (S, 7, n)).astype(np.float16)
    stack[:, 6] = rng.uniform(-40, 40, (S, n)).astype(np.float16)
    counts = np.zeros((S, n), np.float32)
    counts[0] = np.where(rng.uniform(size=n) < occ,
                         rng.integers(1, 9, size=n), 0)
    if S == 3:
        counts[1] = np.where(rng.uniform(size=n) < occ / 2,
                             rng.integers(1, 9, size=n), 0)
        counts[2] = counts[0] + counts[1]
    empty = np.asarray(EMPTY + (0.0,), np.float16)[:, None]
    for s in range(S):
        stack[s] = np.where(counts[s] > 0, stack[s], empty)
    return stack.reshape(S * 7, P, P), counts.reshape(S, P, P)


def _rank_indexed(stack, counts, P):
    """The same stack and counts rank-indexed (occupied cells first, in
    ascending order; dead ranks hold the empty row and zero counts) and
    the cell_of_rank table (P*P for dead ranks)."""
    S = counts.shape[0]
    n = P * P
    occ = (counts.reshape(S, n)[:min(S, 2)] > 0).any(0)
    cells = np.flatnonzero(occ)
    cor = np.full(n, n, np.int32)
    cor[:cells.size] = cells
    st = stack.reshape(S, 7, n)
    empty = np.asarray(EMPTY + (0.0,), np.float16)
    rst = np.broadcast_to(empty[None, :, None], st.shape).copy()
    rst[:, :, :cells.size] = st[:, :, cells]
    rct = np.zeros((S, n), np.float32)
    rct[:, :cells.size] = counts.reshape(S, n)[:, cells]
    return rst.reshape(S * 7, P, P), rct.reshape(S, P, P), cor


def _encode(stack, counts, cap, S, cor=None):
    """(JAX (sparse, fallback), port (sparse, fallback)) as numpy."""
    j = jcore.sparse_outputs(jnp.asarray(stack), jnp.asarray(counts), P,
                             cap, S, cell_of_rank=None if cor is None
                             else jnp.asarray(cor))
    t = tcore.sparse_outputs(torch.from_numpy(stack),
                             torch.from_numpy(counts), P, cap, S,
                             cell_of_rank=None if cor is None
                             else torch.from_numpy(cor))
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize('cor', [False, True], ids=['cells', 'ranks'])
@pytest.mark.parametrize('cap', [400, (320, 160, 96), (64, 64, 64)],
                         ids=['int', 'per_split', 'overflow'])
@pytest.mark.parametrize('gen_future', [True, False])
def test_sparse_bytes_match_jax(rng, gen_future, cap, cor):
    S = 3 if gen_future else 1
    stack, counts = _stack_and_counts(rng, S, P)
    table = None
    if cor:
        stack, counts, table = _rank_indexed(stack, counts, P)
    np.testing.assert_array_equal(
        tcore._pack_channel_words(torch.from_numpy(stack), S,
                                  P * P).numpy(),
        np.asarray(jcore._pack_channel_words(jnp.asarray(stack), S, P * P)))
    (j_sp, j_fb), (t_sp, t_fb) = _encode(stack, counts, cap, S, table)
    assert t_sp.dtype == t_fb.dtype == np.uint8
    np.testing.assert_array_equal(t_sp, j_sp)
    np.testing.assert_array_equal(t_fb, j_fb)
    assert (t_sp.size, t_fb.size) == tcore.sparse_buffer_bytes(
        P, gen_future, cap, cor)
    # The out= form (a row of a group's stacked buffers) writes the same.
    sp, dn = tcore.empty_sparse_group(2, P, gen_future, cap, cor, 'cpu')
    tcore.sparse_outputs(torch.from_numpy(stack), torch.from_numpy(counts),
                         P, cap, S, None if table is None
                         else torch.from_numpy(table), out=(sp[1], dn[1]))
    np.testing.assert_array_equal(sp[1].numpy(), j_sp)
    np.testing.assert_array_equal(dn[1].numpy(), j_fb)


def test_quantize_bytes_match_jax_and_roundtrip(rng):
    B, S = 2, 3
    stack = rng.uniform(-0.1, 1.1, (B, S * 7, P, P)).astype(np.float16)
    for s in range(S):
        stack[:, s * 7 + 6] = rng.uniform(-40, 40, (B, P, P))
    t = tcore.quantize_stack_batch(torch.from_numpy(stack)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(jcore.quantize_stack_batch(jnp.asarray(stack))))
    np.testing.assert_array_equal(
        tcore.quantize_stack(torch.from_numpy(stack[1])).numpy(), t[1])
    rec = tcore.dequantize_stack_batch(t, True, P)
    np.testing.assert_array_equal(rec, jcore.dequantize_stack_batch(t, True,
                                                                    P))
    for s in range(S):
        np.testing.assert_array_equal(rec[:, s * 7 + 6], stack[:, s * 7 + 6])
        err = np.abs(rec[:, s * 7:s * 7 + 6].astype(np.float64)
                     - np.clip(stack[:, s * 7:s * 7 + 6], 0, 1))
        assert err.max() <= QUANT_TOL


def _decoders(raw, gen_future, cap):
    """Each decoder's result on ``raw``, or the exception class it
    raised: JAX numpy, port numpy, port native (no warp)."""
    out = []
    for fn in (jcore.decode_sparse_stack, tcore.decode_sparse_stack,
               native_decode.decode_sparse_warp):
        try:
            out.append(fn(raw, gen_future, P, cap, EMPTY))
        except (jcore.SparseOverflow, tcore.SparseOverflow,
                jcore.SparseShortFetch, tcore.SparseShortFetch,
                ValueError) as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize('case', ['decoded', 'overflow', 'short', 'header',
                                  'ranks'])
@pytest.mark.parametrize('gen_future', [True, False])
def test_decoders_match_jax_both_ways(rng, gen_future, case):
    """Each package's bytes through every decoder: the same stack, or the
    same exception; the fallback bytes decode alike (cell and rank
    layouts)."""
    S = 3 if gen_future else 1
    cap = (64, 64, 64) if case == 'overflow' else (400, 240, 160)
    stack, counts = _stack_and_counts(rng, S, P)
    table = None
    if case == 'ranks':
        stack, counts, table = _rank_indexed(stack, counts, P)
    (j_sp, j_fb), (t_sp, t_fb) = _encode(stack, counts, cap, S, table)
    for sp in (j_sp, t_sp):
        if case == 'short':
            sp = sp[:jcore.sparse_used_bytes(sp, P, gen_future) - 8]
        elif case == 'header':
            sp = sp[:jcore.sparse_header_bytes(P, gen_future) - 1]
        got = _decoders(sp, gen_future, cap)
        if case in ('decoded', 'ranks'):
            for g in got:
                assert isinstance(g, np.ndarray), got
                np.testing.assert_array_equal(g.view(np.uint16),
                                              got[0].view(np.uint16))
        else:
            want = {'overflow': 'SparseOverflow', 'short': 'SparseShortFetch',
                    'header': 'ValueError'}[case]
            assert got == [want] * 3, got
    dense = [fn(fb, gen_future, P) for fn in (jcore.decode_dense_words,
                                               tcore.decode_dense_words)
             for fb in (j_fb, t_fb)]
    for d in dense[1:]:
        np.testing.assert_array_equal(d.view(np.uint16),
                                      dense[0].view(np.uint16))
    if case in ('decoded', 'overflow'):
        # The fallback is the cell-space stack, quantized.
        np.testing.assert_array_equal(dense[0][6::7], stack[6::7])


def _random_buffer(rng, P, S, caps):
    occ_p = rng.random(P * P) < 0.10
    occ_f = rng.random(P * P) < 0.05
    if S == 3:
        masks = [np.packbits(occ_p.astype(np.uint8)),
                 np.packbits(occ_f.astype(np.uint8))]
        n_occ = np.array([occ_p.sum(), occ_f.sum(), (occ_p & occ_f).sum()],
                         np.int32)
    else:
        masks = [np.packbits(occ_p.astype(np.uint8))]
        n_occ = np.array([occ_p.sum()], np.int32)
    vals = [rng.integers(0, 256, (n, 8), dtype=np.uint8).reshape(-1)
            for n in n_occ]
    return np.concatenate(masks + [n_occ.view(np.uint8),
                                   np.zeros(16 - 4 * S, np.uint8)] + vals)


@pytest.mark.parametrize('P_,gen_future,warp_on', [
    (64, True, True), (64, True, False), (64, False, True),
    (256, True, True)])
def test_native_decode_matches_numpy(rng, P_, gen_future, warp_on):
    S = 3 if gen_future else 1
    caps = (P_ * P_ // 8, P_ * P_ // 16, P_ * P_ // 8)
    raw = _random_buffer(rng, P_, S, caps)
    w = dict(a1=1., a2=0., b1=1., b2=0., active=False)
    if warp_on:
        a1, a2 = twarp.cal_warp_params(P_ // 2 + 10, P_ // 2, P_ - 1)
        b1, b2 = twarp.cal_warp_params(P_ // 2 - 8, P_ // 2, P_ - 1)
        w = dict(a1=a1, a2=a2, b1=b1, b2=b2, active=True)
    ref = tcore.decode_sparse_stack(raw, gen_future, P_, caps, EMPTY)
    if warp_on:
        ref = twarp.warp_dense_maps_np(ref, w['a1'], w['a2'], w['b1'],
                                       w['b2'])
        np.testing.assert_array_equal(
            ref, jwarp.warp_dense_maps_np(
                tcore.decode_sparse_stack(raw, gen_future, P_, caps, EMPTY),
                w['a1'], w['a2'], w['b1'], w['b2']))
    got = native_decode.decode_sparse_warp(raw, gen_future, P_, caps, EMPTY,
                                           w)
    np.testing.assert_array_equal(got.view(np.uint16), ref.view(np.uint16))
    assert native_decode._LIBRARY.exists()
    # A mask popcount that disagrees with the header count is malformed.
    bad = raw.copy()
    bad[0] ^= 0x80
    with pytest.raises(ValueError):
        native_decode.decode_sparse_warp(bad, gen_future, P_, caps, EMPTY, w)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    src = tmp_path / 'broken.cpp'
    src.write_text('this is not C++\n')
    monkeypatch.setattr(native_decode, '_SOURCE', src)
    monkeypatch.setattr(native_decode, '_LIBRARY', tmp_path / 'lib.so')
    monkeypatch.setattr(native_decode, '_lib', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native_decode.load_library()
    assert not (tmp_path / 'lib.so').exists()


def _cloud(rng, n=4096):
    pc = np.zeros((n, 10), np.float32)
    pc[:, 0:2] = rng.uniform(-30, 30, size=(n, 2))
    pc[:, 2] = rng.uniform(-2, 5, size=n)
    pc[:, 3] = rng.uniform(0, 1, size=n)
    pc[:, 4:7] = rng.integers(0, 256, size=(n, 3))
    pc[:, 7] = rng.choice([0, 2, 13, 15], size=n)
    return pc


def _gen(cls, fetch_dtype, **kw):
    extra = {} if cls is JGen else {'device': 'cpu'}
    return cls(cfg.DEFAULT_SEM_IDXS, 80, 64, int_scaler=20.,
               int_sep_scaler=20., int_mid_threshold=0.5, seed=7,
               fetch_dtype=fetch_dtype, **kw, **extra)


def _close(a, b, intensity_tol=QUANT_TOL):
    assert set(a) == set(b)
    for k in a:
        if k.startswith('trajs'):
            continue
        d = np.abs(np.asarray(a[k], np.float64)
                   - np.asarray(b[k], np.float64)).max()
        tol = (0.0 if k.startswith('elevation') else intensity_tol
               if k.startswith('intensity') else QUANT_TOL)
        assert d <= tol, (k, d)


AUG = dict(max_trans_radius=3.0, zoom_thresh=0.05, do_warp=True)


@pytest.mark.parametrize('fetch_dtype,cap,aug', [
    ('quantized', None, False), ('sparse', 4096, False),
    ('sparse', 4096, True), ('sparse', 128, False)],
    ids=['quantized', 'sparse', 'sparse_warp', 'sparse_overflow'])
def test_generate_fetch_matches_float16_and_jax(rng, fetch_dtype, cap, aug):
    pcs = {'pc_present': _cloud(rng), 'pc_future': _cloud(rng)}
    trajs = {'ego_traj_present': np.array([[0., 0, 0], [1, 0, 0]])}
    kw = dict(AUG) if aug else {}
    call = dict(rot_ang=0.7, trans_dx=1.0, trans_dy=-2.0, zoom_scalar=1.03,
                do_warping=True) if aug else {}
    if cap is not None:
        kw['sparse_cap'] = cap
    ref = _gen(TGen, 'float16', **(AUG if aug else {})).generate(pcs, trajs,
                                                                 **call)
    gen = _gen(TGen, fetch_dtype, **kw)
    got = gen.generate(pcs, trajs, **call)
    _close(ref, got)
    # Against the JAX package's encoded maps: its CPU raster sums float
    # intensities where the port's sums the u16 payload, so the float16
    # intensity maps differ by up to 2e-3 (test_torch_classic_raster) and
    # their u8 codes by one step more.
    _close(_gen(JGen, fetch_dtype, **kw).generate(pcs, trajs, **call), got,
           intensity_tol=2e-3 + 1.0 / 255)
    if fetch_dtype == 'sparse':
        assert gen.sparse_overflows == (1 if cap == 128 else 0)
        assert gen.n_occupied_obs == 1 and gen.max_occupied > 0


def test_truncated_fetch_refetches(rng):
    """A hint below a sample's used bytes (and one below the header)
    refetches the whole buffer: same maps, counted; hints are kept per
    split count."""
    pcs = {'pc_present': _cloud(rng), 'pc_future': _cloud(rng)}
    trajs = {'ego_traj_present': np.array([[0., 0, 0], [1, 0, 0]])}
    ref = _gen(TGen, 'float16').generate(pcs, trajs)
    gen = _gen(TGen, 'sparse', sparse_cap=4096)
    gen.generate({'pc_present': _cloud(rng)}, trajs)
    assert set(gen._fetch_hint_bytes) == {1}
    _close(ref, gen.generate(pcs, trajs))
    assert gen.sparse_short_fetches == 0 and 3 in gen._fetch_hint_bytes
    for hint in (tcore.sparse_header_bytes(64, True) + 64, 8):
        gen._fetch_hint_bytes[3] = hint
        before = gen.sparse_short_fetches
        _close(ref, gen.generate(pcs, trajs))
        assert gen.sparse_short_fetches == before + 1


def test_fetch_dtype_checked():
    with pytest.raises(ValueError, match='fetch_dtype'):
        _gen(TGen, 'bfloat16')
