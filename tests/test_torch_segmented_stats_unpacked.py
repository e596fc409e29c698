"""Kernel 2 of the port (segmented_stats on unpacked rows) against the JAX
Pallas kernel (pallas_stats.segmented_stats in interpret mode) on the same
sorted rows, for 1 to 4 weight rows, 0 to 3 value rows and med_nsplit 0,
1 and 2; and the words route against the unpacked route of the port's
split_stats_from_words_flat.

Tolerances: z-mins and the medians of non-empty groups are order-free and
must be equal. The float weight sums differ in summation order (the JAX
kernel sums float32 products per chunk, the port sums in float64 and
rounds once): rtol 1e-5, atol 1e-5. The JAX kernel leaves garbage in the
medians of empty groups and at the odd positions of the pair medians; the
port writes 0 there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.ops import pallas_stats
from pc_accumulation_lib_tpu.ops import sort_raster as jsr
from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss
from pc_accumulation_lib_tpu_torch.ops import sort_raster as tsr

G = 512
# Zeros of both signs, the smallest normal float32, tiny and huge
# magnitudes. (XLA on the CPU flushes float32 subnormals, so they are held
# against the plain version on the card instead.)
TRICKY_Z = [0.0, -0.0, 1e-30, -1e-30, 1.17549435e-38, -3.5, 1e30, -1e30]


def _rows(rng, n):
    keys = np.where(rng.uniform(size=n) < 0.9,
                    rng.integers(G // 4, 3 * G // 4, size=n), G)
    keys[:6] = np.arange(6) * 4 + 1          # isolated single-row groups
    keys = np.sort(keys).astype(np.int32)
    weights = [np.ones(n, np.float32),
               (rng.uniform(size=n) < 0.5).astype(np.float32),
               rng.normal(size=n).astype(np.float32) * 3.0,
               rng.uniform(size=n).astype(np.float32)]
    z = (rng.normal(size=n) * 5.0).astype(np.float32)
    z[::7] = np.resize(np.asarray(TRICKY_Z, np.float32), z[::7].shape)
    values = [rng.integers(0, 256, size=n).astype(np.float32)
              for _ in range(3)]
    return keys, weights, z, values


CASES = [(1, 0, 1), (4, 3, 2), (4, 3, 1), (4, 3, 0), (2, 1, 2), (3, 2, 0),
         (1, 3, 1), (4, 0, 2)]


@pytest.mark.parametrize('n_w,n_v,med_nsplit', CASES)
def test_plain_version_matches_pallas_kernel(rng, n_w, n_v, med_nsplit):
    keys, weights, z, values = _rows(rng, 3000)
    want = pallas_stats.segmented_stats(
        jnp.asarray(keys), [jnp.asarray(w) for w in weights[:n_w]],
        jnp.asarray(z), G, interpret=True,
        value_rows=[jnp.asarray(v) for v in values[:n_v]],
        med_nsplit=med_nsplit)
    got = ss.segmented_stats(
        torch.from_numpy(keys), [torch.from_numpy(w) for w in weights[:n_w]],
        torch.from_numpy(z), G,
        value_rows=[torch.from_numpy(v) for v in values[:n_v]],
        med_nsplit=med_nsplit)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert ss.segmented_stats.launches == 0
    assert len(got) == len(want) == (3 if n_v else 2)
    sums, zmin = got[0].numpy(), got[1].numpy()
    assert sums.shape == (G, n_w)
    np.testing.assert_allclose(sums, np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(zmin, np.asarray(want[1]))
    if not n_v:
        return
    cnt = np.bincount(np.minimum(keys, G), minlength=G + 1)[:G]
    assert (cnt == 0).sum() > G // 4 and (cnt == 1).sum() >= 6
    meds, meds_j = got[2].numpy(), np.asarray(want[2])
    assert meds.shape == (n_v, 2, G)
    live = cnt > 0
    np.testing.assert_array_equal(meds[:, 0, live], meds_j[:, 0, live])
    assert np.all(meds[:, 0, ~live] == 0)
    if med_nsplit == 2:
        pair = cnt.reshape(-1, 2).sum(1) > 0
        np.testing.assert_array_equal(meds[:, 1, 0::2][:, pair],
                                      meds_j[:, 1, 0::2][:, pair])
        assert np.all(meds[:, 1, 1::2] == 0)
    else:
        np.testing.assert_array_equal(meds[:, 1], meds_j[:, 1])
        assert np.all(meds[:, 1] == 0)


def test_plain_version_large_group_and_all_sentinel(rng):
    """A group of more than 65,535 rows against numpy, and all rows
    sentinel (every group empty)."""
    n = 70000
    keys = np.full(n, 3, np.int32)
    keys[-50:] = 5
    w = rng.normal(size=n).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    v = rng.integers(0, 256, size=n).astype(np.float32)
    sums, zmin, meds = (t.numpy() for t in ss.segmented_stats(
        torch.from_numpy(keys), [torch.ones(n), torch.from_numpy(w)],
        torch.from_numpy(z), 8, value_rows=[torch.from_numpy(v)],
        med_nsplit=2))
    for g in (3, 5):
        m = keys == g
        assert sums[g, 0] == m.sum()
        np.testing.assert_allclose(sums[g, 1], w[m].astype(np.float64).sum(),
                                   rtol=1e-6)
        assert zmin[g] == z[m].min() and meds[0, 0, g] == np.median(v[m])
    assert meds[0, 1, 2] == np.median(v[keys == 3])     # pair (2, 3)
    empty = ss.segmented_stats(torch.full((40,), 8, dtype=torch.int32),
                               [torch.ones(40)], torch.zeros(40), 8,
                               value_rows=[torch.zeros(40)])
    assert float(empty[0].abs().sum()) == 0.0
    assert bool(torch.isinf(empty[1]).all())
    assert float(empty[2].abs().sum()) == 0.0


def test_segmented_stats_rejects_bad_inputs():
    k = torch.zeros(4, dtype=torch.int32)
    ones = torch.ones(4)
    with pytest.raises(ValueError, match='at most 4'):
        ss.segmented_stats(k, [ones] * 5, ones, 8)
    with pytest.raises(ValueError, match='payload rows'):
        ss.segmented_stats(k, [ones] * 4, ones, 8, value_rows=[ones] * 4)
    with pytest.raises(ValueError, match='even'):
        ss.segmented_stats(k, [ones], ones, 7, value_rows=[ones],
                           med_nsplit=2)
    with pytest.raises(ValueError, match='int32'):
        ss.segmented_stats(k.long(), [ones], ones, 8)
    with pytest.raises(ValueError, match='shape'):
        ss.segmented_stats(k, [ones[:3]], ones, 8)


def _words(rng, n, sent):
    c2 = np.where(rng.uniform(size=n) < 0.85,
                  rng.integers(0, sent // 2, size=n), sent).astype(np.int32)
    road = (rng.uniform(size=n) < 0.5).astype(np.float32)
    dyn = (rng.uniform(size=n) < 0.2).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32) * road
    z = (rng.normal(size=n) * 3.0).astype(np.float32)
    w1, w2 = jsr.pack_payload_words(*(jnp.asarray(a) for a in
                                      (road, dyn, rgb, inten, z)))
    return c2, np.array(w1), np.array(w2)


@pytest.mark.parametrize('gen_future', [True, False])
@pytest.mark.parametrize('hist_medians', [True, False])
def test_words_route_equals_unpacked_route(rng, gen_future, hist_medians):
    """The port's split_stats_from_words_flat gives the same maps through
    kernel 1 (words) and kernel 2 (unpacked rows): exact except the
    intensity sums (rtol 1e-5)."""
    n_cells = 1024
    c2, w1, w2 = (torch.from_numpy(a) for a in
                  _words(rng, 6000, n_cells * (2 if gen_future else 1)))
    outs = [tsr.split_stats_from_words_flat(
        c2, w1, w2, n_cells, gen_future, rgb_fill=7,
        hist_medians=hist_medians, words_kernel=wk) for wk in (True, False)]
    assert set(outs[0]) == set(outs[1])
    for k, v in outs[0].items():
        if k.startswith('intensity'):
            np.testing.assert_allclose(outs[1][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            assert torch.equal(outs[1][k], v), k
