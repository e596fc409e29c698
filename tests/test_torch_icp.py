"""Port's ICP vs the JAX package's on synthetic frames at
max_downsampled=512.

Tolerances: the subsample is an index pick and must be equal. Normals are
defined up to sign and come from float32 closed-form eigenvectors, which
round differently in the two frameworks: |cos| >= 0.9999 between the two
and 2e-3 max abs difference after sign alignment. The registered
transform agrees to 1e-4 (float32 Gauss-Newton over 26 steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pc_accumulation_lib_tpu.ops import icp as jicp
from pc_accumulation_lib_tpu_torch.dataloaders.synthetic import (
    SyntheticKitti360Stream)
from pc_accumulation_lib_tpu_torch.ops import icp as ticp

N_CAP, M = 8192, 512


@pytest.fixture(scope='module')
def clouds():
    stream = SyntheticKitti360Stream(n_frames=4, step=2.0, lidar_range=25.0,
                                     seed=3, points_per_frame=3000)
    jpre = jicp.make_preprocess_fn(0.25, M, 10)
    tpre = ticp.make_preprocess_fn(M, 10)
    out = []
    for i in (0, 1):
        pc = stream.frame(i)[1]
        pts = np.zeros((N_CAP, 3), np.float32)
        pts[:len(pc)] = pc[:, :3]
        valid = np.arange(N_CAP) < len(pc)
        out.append((jpre(jnp.asarray(pts), jnp.asarray(valid)),
                    tpre(torch.from_numpy(pts), torch.from_numpy(valid))))
    return out


def test_preprocess_matches(clouds):
    for cj, ct in clouds:
        np.testing.assert_array_equal(ct.points.numpy(),
                                      np.asarray(cj.points))
        np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
        nj, nt = np.asarray(cj.normals), ct.normals.numpy()
        assert np.abs((nj * nt).sum(1)).min() >= 0.9999
        sign = np.sign((nj * nt).sum(1))[:, None]
        np.testing.assert_allclose(nt * sign, nj, atol=2e-3)


@pytest.mark.parametrize('coarse_to_fine', [True, False])
def test_register_matches(clouds, coarse_to_fine):
    (src_j, src_t), (tgt_j, tgt_t) = clouds
    if coarse_to_fine:
        fj = jicp.make_coarse_to_fine_register_fn(16)
        ft = ticp.make_coarse_to_fine_register_fn(16)
    else:
        fj, ft = jicp.make_register_fn(8), ticp.make_register_fn(8)
    Tj, rmse_j, n_j = fj(src_j, tgt_j, jnp.eye(4), jnp.float32(1e3))
    Tt, rmse_t, n_t = ft(src_t, tgt_t, torch.eye(4), 1e3)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    assert float(n_t) == float(n_j)
    np.testing.assert_allclose(float(rmse_t), float(rmse_j), rtol=1e-3)


def test_se3_exp_matches(rng):
    for scale in (1e-8, 1e-3, 0.5):
        d = (rng.normal(size=6) * scale).astype(np.float32)
        np.testing.assert_allclose(
            ticp.se3_exp(torch.from_numpy(d)).numpy(),
            np.asarray(jicp.se3_exp(jnp.asarray(d))), rtol=1e-6, atol=1e-6)
