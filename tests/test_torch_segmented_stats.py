"""Port's segmented-stats plain version vs the JAX Pallas kernel
(pallas_stats.segmented_stats_words in interpret mode) on the same sorted
rows, plus a numpy oracle for a group larger than 65,535 rows.

Tolerances: counts, road and dyn sums, the f16 z-min and the medians of
non-empty groups are integer or order-free results and must be equal.
The intensity sum is taken in another order (the JAX kernel sums float32
products, the port rounds the exact integer sum once), so it may differ
by float32 rounding: rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.ops import pallas_stats
from pc_accumulation_lib_tpu.ops import sort_raster as jsr
from pc_accumulation_lib_tpu_torch.ops import segmented_stats as ss

# Heights whose f16 bits exercise the decode: zeros of both signs,
# subnormals, the smallest normal, the largest finite, fractions.
TRICKY_Z = [0.0, -0.0, 1.0, -1.0, 5.9604645e-08, -5.9604645e-08,
            6.0975552e-05, -6.0975552e-05, 3.0517578e-05, 65504.0,
            -65504.0, 0.333251953125, -2.5, 1e-4, -1e-4, 1234.5]


def _sorted_case(rng, n, num_groups, nsplit):
    """Sorted (c2, w1, w2) with ~10% sentinel rows, empty groups (only the
    middle half of the key range is used), single-row groups and tricky
    f16 heights."""
    lo, hi = num_groups // 4, 3 * num_groups // 4
    c2 = np.where(rng.uniform(size=n) < 0.9, rng.integers(lo, hi, size=n),
                  num_groups)
    c2[:8] = np.arange(8) * 2 * nsplit + 1     # isolated single-row groups
    road = (rng.uniform(size=n) < 0.5).astype(np.float32)
    dyn = (rng.uniform(size=n) < 0.2).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(size=n).astype(np.float32) * road
    z = (rng.normal(size=n) * 3.0).astype(np.float32)
    z[::5] = np.resize(np.asarray(TRICKY_Z, np.float32), z[::5].shape)
    w1, w2 = jsr.pack_payload_words(jnp.asarray(road), jnp.asarray(dyn),
                                    jnp.asarray(rgb), jnp.asarray(inten),
                                    jnp.asarray(z))
    order = np.argsort(c2, kind='stable')
    return (c2[order].astype(np.int32), np.asarray(w1)[order],
            np.asarray(w2)[order])


@pytest.mark.parametrize('nsplit', [1, 2])
def test_reference_matches_pallas_kernel(rng, nsplit):
    G = 1024
    c2, w1, w2 = _sorted_case(rng, 6000, G, nsplit)
    want = pallas_stats.segmented_stats_words(
        jnp.asarray(c2), jnp.asarray(w1), jnp.asarray(w2), G,
        interpret=True, hist_medians=True, med_nsplit=nsplit)
    sums_j, zmin_j, meds_j = (np.asarray(a) for a in want)
    got = ss.segmented_stats_words(torch.from_numpy(c2),
                                   torch.from_numpy(w1),
                                   torch.from_numpy(w2), G,
                                   med_nsplit=nsplit)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert ss.segmented_stats_words.launches == 0
    sums, zmin, meds = (t.numpy() for t in got)

    np.testing.assert_array_equal(sums[:, :3], sums_j[:, :3])
    np.testing.assert_allclose(sums[:, 3], sums_j[:, 3], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(zmin, zmin_j)
    cnt = sums[:, 0]
    assert (cnt == 1).sum() >= 8 and (cnt == 0).sum() > G // 4
    live = cnt > 0
    np.testing.assert_array_equal(meds[:, 0, live], meds_j[:, 0, live])
    assert np.all(meds[:, 0, ~live] == 0)
    if nsplit == 2:
        pair = cnt.reshape(-1, 2).sum(1) > 0
        np.testing.assert_array_equal(meds[:, 1, 0::2][:, pair],
                                      meds_j[:, 1, 0::2][:, pair])
        assert np.all(meds[:, 1, 1::2] == 0)
    else:
        assert np.all(meds[:, 1] == 0)


def test_reference_large_group_matches_numpy(rng):
    """One group of more than 65,535 rows (u16 would overflow its count)
    against a numpy oracle."""
    n, G = 70000, 8
    c2 = np.full(n, 3, np.int32)
    c2[-100:] = 5
    w1 = rng.integers(0, 2 ** 26, size=n, dtype=np.int32)
    z16 = np.float16(rng.normal(size=n)).view(np.uint16).astype(np.int32)
    w2 = (z16 << 16) | rng.integers(0, 65536, size=n, dtype=np.int32)
    sums, zmin, meds = (t.numpy() for t in ss.segmented_stats_words(
        torch.from_numpy(c2), torch.from_numpy(w1), torch.from_numpy(w2),
        G, med_nsplit=2))
    for g in (3, 5):
        m = c2 == g
        assert sums[g, 0] == m.sum()
        assert sums[g, 1] == ((w1[m] >> 25) & 1).sum()
        assert sums[g, 2] == ((w1[m] >> 24) & 1).sum()
        np.testing.assert_allclose(sums[g, 3], (w2[m] & 0xFFFF).sum() / 65535,
                                   rtol=1e-7)
        assert zmin[g] == ((w2[m] >> 16) & 0xFFFF).astype(np.uint16).view(
            np.float16).astype(np.float32).min()
        for c, shift in enumerate((16, 8, 0)):
            assert meds[c, 0, g] == np.median((w1[m] >> shift) & 255)
    both = (c2 == 2) | (c2 == 3)     # pair (2, 3): group 2 is empty
    assert meds[0, 1, 2] == np.median((w1[both] >> 16) & 255)
    assert np.isinf(zmin[0]) and sums[0].sum() == 0 and meds[:, :, 0].sum() == 0


def test_wrapper_rejects_bad_inputs():
    c2 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match='int32'):
        ss.segmented_stats_words(c2.long(), c2, c2, 8)
    with pytest.raises(ValueError, match='shape'):
        ss.segmented_stats_words(c2, c2[:3], c2, 8)
    with pytest.raises(ValueError, match='med_nsplit'):
        ss.segmented_stats_words(c2, c2, c2, 7, med_nsplit=2)
