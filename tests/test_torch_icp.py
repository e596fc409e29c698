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


class _JnpFloat64:
    """``jnp`` with float32 read as float64: the JAX ICP's two casts to
    float32 then keep a float64 run in float64 (the JAX package's module
    is not edited; the port's ICP follows its inputs' dtype)."""

    def __getattr__(self, name):
        return jnp.float64 if name == 'float32' else getattr(jnp, name)


def _icp_chain(frames, jax_side, dtype):
    """Both accumulators' ICP on a NuScenes stream's frames: each frame's
    16,384-row padded cloud preprocessed to 2048 points and registered
    coarse-to-fine against the previous one from the identity; returns the
    chained positions (frames, 3) in float64."""
    if jax_side:
        pre = jicp.make_preprocess_fn(None, 2048, 10)
        reg = jicp.make_coarse_to_fine_register_fn(16)
        arr, eye = (lambda a: jnp.asarray(a, dtype)), jnp.eye(4, dtype=dtype)
    else:
        pre = ticp.make_preprocess_fn(2048, 10)
        reg = ticp.make_coarse_to_fine_register_fn(16)
        arr, eye = (lambda a: torch.as_tensor(a, dtype=dtype)), \
            torch.eye(4, dtype=dtype)
    T, prev, out = np.eye(4), None, []
    for pc in frames:
        pts = np.zeros((16384, 3), np.float32)
        pts[:len(pc)] = pc[:, :3]
        valid = np.arange(16384) < len(pc)
        cloud = pre(arr(pts), jnp.asarray(valid) if jax_side
                    else torch.as_tensor(valid))
        if prev is not None:
            Tn = np.asarray(reg(prev, cloud, eye, 1e3)[0], np.float64)
            T = T @ np.linalg.inv(Tn)
        out.append(T[:3, 3].copy())
        prev = cloud
    return np.array(out)


@pytest.mark.parametrize('n_frames', [4, 8], ids=['four_frame_stream',
                                                  'eight_frame_stream'])
def test_float32_chain_against_float64(n_frames, monkeypatch):
    """A float64 witness for the two packages' float32 ICP chains on the
    first 4 frames of test_torch_nuscenes.py's ICP stream (seed 3) and of
    the same stream drawn with 4 frames (another scene). In float64 the
    two packages agree to 1e-9 m, and the port's float32 chain stays
    within 1e-5 m of it (1.4e-6 m observed). JAX's float32 chain is held
    within 1e-3 m: on the 4-frame stream it departs by 5.2e-4 m at frame
    2 (2.7e-7 m on the 8-frame one), which is why the accumulators' wire
    test runs the 8-frame stream's first frames (PERF.md, open
    questions)."""
    import jax

    from pc_accumulation_lib_tpu_torch.dataloaders import synthetic as tsyn
    stream = tsyn.SyntheticNuScenesStream(n_frames=n_frames, step=2.0,
                                          lidar_range=25.0, seed=3)
    frames = [np.asarray(stream.frame(i)['pc'], np.float32)
              for i in range(4)]
    port32 = _icp_chain(frames, False, torch.float32)
    port64 = _icp_chain(frames, False, torch.float64)
    jax32 = _icp_chain(frames, True, jnp.float32)
    with jax.enable_x64(True):
        monkeypatch.setattr(jicp, 'jnp', _JnpFloat64())
        jax64 = _icp_chain(frames, True, jnp.float64)
    np.testing.assert_allclose(jax64, port64, atol=1e-9)
    np.testing.assert_allclose(port32, port64, atol=1e-5)
    np.testing.assert_allclose(jax32, port64, atol=1e-3)
