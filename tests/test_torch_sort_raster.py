"""Port's sort_raster vs the JAX package's: the payload words bit for bit,
and the split stats against the JAX kernel path (use_pallas=True,
pallas_interpret=True) on the same keys and words.

Tolerances: every channel is a function of integer counts, order-free
mins and exact medians, so it must be equal, except the intensity map,
whose per-cell sum is taken in another order (rtol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.ops import sort_raster as jsr
from pc_accumulation_lib_tpu_torch.ops import sort_raster as tsr


def _features(rng, n):
    road = (rng.uniform(size=n) < 0.5).astype(np.float32)
    dyn = (rng.uniform(size=n) < 0.2).astype(np.float32)
    # Out-of-range colours clip; fractional ones truncate.
    rgb = rng.uniform(-20, 275, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(-0.1, 1.1, size=n).astype(np.float32) * road
    inten[:4] = [0.5 / 65535, 1.5 / 65535, 2.5 / 65535, 1.0]  # round halves
    z = (rng.normal(size=n) * 30.0).astype(np.float32)
    z[:6] = [0.0, -0.0, 5.9604645e-08, 65504.0, 70000.0, -1e-8]
    return road, dyn, rgb, inten, z


def test_pack_payload_words_bit_exact(rng):
    feats = _features(rng, 4000)
    w1_j, w2_j = jsr.pack_payload_words(*(jnp.asarray(f) for f in feats))
    w1_t, w2_t = tsr.pack_payload_words(*(torch.from_numpy(f) for f in feats))
    np.testing.assert_array_equal(w1_t.numpy(), np.asarray(w1_j))
    np.testing.assert_array_equal(w2_t.numpy(), np.asarray(w2_j))


@pytest.mark.parametrize('gen_future', [True, False])
def test_split_stats_match_jax_kernel_path(rng, gen_future):
    n_cells, n = 1024, 5000
    nsplit = 2 if gen_future else 1
    sent = n_cells * nsplit
    c2 = np.where(rng.uniform(size=n) < 0.9,
                  rng.integers(0, sent // 2, size=n), sent).astype(np.int32)
    w1, w2 = jsr.pack_payload_words(
        *(jnp.asarray(f) for f in _features(rng, n)))
    w1, w2 = np.array(w1), np.array(w2)   # writable copies for torch
    want = jsr.split_stats_from_words_flat(
        jnp.asarray(c2), jnp.asarray(w1), jnp.asarray(w2), n_cells,
        gen_future, rgb_fill=3, use_pallas=True, pallas_interpret=True)
    got = tsr.split_stats_from_words_flat(
        torch.from_numpy(c2), torch.from_numpy(w1), torch.from_numpy(w2),
        n_cells, gen_future, rgb_fill=3)
    # The same key set, the per-split count maps included.
    assert set(got) == set(want)
    assert {'count_present'} <= set(got)
    for k, v in got.items():
        if k.startswith('intensity'):
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                          err_msg=k)
