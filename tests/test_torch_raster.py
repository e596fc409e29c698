"""Port's step() raster (make_prep_fn + prepped raster) vs the JAX pair
(core.make_prep_fn + make_prepped_raster_fn with the Pallas kernel in
interpret mode) on the same points, pose vector and augmentation draws.

Tolerance: the float16 map stacks agree within 2e-3 max abs (bench.py's
raster parity gate): counts, medians and z-mins are exact, the intensity
sums differ by float32 summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu import config as cfg
from pc_accumulation_lib_tpu.bev import core as jcore
from pc_accumulation_lib_tpu_torch.bev import core as tcore

P, VIEW = 64, 40.0


def _inputs(rng, n=8192):
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
    pose_vec = np.concatenate([T.reshape(-1), [0.5, -0.3, 0.0],
                               [1, 7, 5]]).astype(np.float32)
    return pts, inst_dyn, fids, valid, pose_vec


@pytest.mark.parametrize('gen_future', [True, False])
def test_prepped_raster_matches_jax(rng, gen_future):
    pts, inst_dyn, fids, valid, pose_vec = _inputs(rng)
    jprep = jcore.make_prep_fn(cfg.DEFAULT_SEM_IDXS)
    jras = jcore.make_prepped_raster_fn(VIEW, P, 20., 20., 0.5,
                                        pallas_interpret=True)
    tprep = tcore.make_prep_fn(cfg.DEFAULT_SEM_IDXS)
    tras = tcore.make_prepped_raster_fn(VIEW, P, 20., 20., 0.5)
    ref_j, pk_j, pk2_j = jprep(jnp.asarray(pts), jnp.asarray(inst_dyn),
                               jnp.asarray(pose_vec))
    t = [torch.from_numpy(a) for a in (pts, inst_dyn, fids, valid, pose_vec)]
    ref_t, pk_t, pk2_t = tprep(t[0], t[1], t[4])
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))
    np.testing.assert_array_equal(pk2_t.numpy(), np.asarray(pk2_j))
    for aug9 in ([0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0, np.inf],
                 [2.1, 1.2, -0.7, 1.04, 1.1, -3e-4, 0.9, 4e-4, 2.0]):
        aug9 = np.asarray(aug9, np.float32)
        want = np.asarray(jras(ref_j, jnp.asarray(valid), jnp.asarray(fids),
                               pk_j, pk2_j,
                               (jnp.asarray(pose_vec), aug9), gen_future))
        got = tras(ref_t, t[3], t[2], pk_t, pk2_t,
                   (t[4], torch.from_numpy(aug9)), gen_future).numpy()
        assert got.dtype == np.float16
        assert got.shape == want.shape == (21 if gen_future else 7, P, P)
        err = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert err.max() <= 2e-3, err.max()
