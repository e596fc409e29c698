"""The port's point-sharded rasters (parallel/sharded.py) against the JAX
package's, on 4 ranks.

One gloo world of 4 spawned ranks (tests/torch_mesh_worlds.mesh_cases)
runs every port case on the same seeded rows as the JAX side, which runs
on 4 of the conftest's 8 CPU devices: a (1, 4) ('data', 'points') mesh,
and (2, 2) for multi-stream. Tolerances, as the JAX package's own
tests/test_sharding.py holds its mesh rasters:
  * psum engine and multi-stream: float16 stacks within 1e-3 (intensity
    2e-3: float32 sums in another order);
  * tile engine: 1e-3 (intensity 4e-3: it rides the u16 payload);
  * every rank's output equal to rank 0's; the tuple-form parameters
    give the packed form's stack exactly; the routing counters, the
    overflow message and the calibrated factor equal JAX's exactly.

A second world of 2 ranks (tests/torch_mesh_worlds.sparse_mesh_cases)
runs the sparse pack: the tile engine's (sparse, fallback) buffers are
byte-equal to the one-device raster's, per raster and through ``group``
(directly and through MeshRasterClient's request to the worker); the
psum engine's carry the same header and decode within the psum
tolerance; a sparse step() on the mesh (grouped, rungs, async) gives the
one-device sparse step()'s maps exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pc_accumulation_lib_tpu.bev import core
from pc_accumulation_lib_tpu.bev.sem_bev import SemBEVGenerator
from pc_accumulation_lib_tpu.parallel import mesh as mesh_mod
from pc_accumulation_lib_tpu.parallel import sharded
from pc_accumulation_lib_tpu_torch.parallel import dryrun
from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh

import torch_mesh_worlds as w

N = 4


def _tol(key, tile=False):
    if key.startswith('intensity'):
        return 4e-3 if tile else 2e-3
    return 1e-3


def _jax_params(stream=0):
    p = core.identity_params(window=(0, 9), present_frame=5 + stream)
    return p._replace(rot_ang=0.3 * stream, trans_dx=0.5 * stream)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh')
    w.spawn_world('mesh_cases', N, tmp)
    port = [w.load(tmp, f'mesh_r{r}') for r in range(N)]

    mesh = mesh_mod.make_mesh((1, N), devices=jax.devices()[:N])
    # JAX's P('points') cuts contiguous blocks; given the rows in the
    # port's dealt order, each device holds the port rank's rows, so the
    # routing counters compare exactly.
    pts, valid, fids = (jnp.asarray(w.dealt(a, N))
                        for a in w.make_points(0))
    sp, sv, sf = sharded.shard_points_to_mesh(mesh, pts, valid, fids)
    inst = jnp.zeros(4, jnp.float32)
    params = _jax_params()
    jx = {}
    psum = sharded.make_sharded_raster_fn(mesh, 40.0, w.P, w.SEM_IDXS, 20.,
                                          20., 0.5)
    for gf in (True, False):
        jx[f'psum_{gf}'] = np.asarray(psum(sp, sv, sf, inst, params, gf),
                                      np.float32)
    tile = sharded.make_tile_sharded_raster_fn(mesh, 40.0, w.P, w.SEM_IDXS,
                                               20., 20., 0.5)
    jx['tile'] = np.asarray(tile(sp, sv, sf, inst, params, True), np.float32)
    tile.drain()
    jx['tile_route'] = (tile.route_peak_rows, tile.route_cap)
    gen = SemBEVGenerator(w.SEM_IDXS, 40.0, 31, int_scaler=20.,
                          int_sep_scaler=20., int_mid_threshold=0.5,
                          mesh=mesh)
    jx['auto_31'] = np.asarray(gen._raster(sp, sv, sf, inst, params, True),
                               np.float32)
    over = sharded.make_tile_sharded_raster_fn(
        mesh, 40.0, w.P, w.SEM_IDXS, 20., 20., 0.5, dest_cap_factor=0.02,
        calibrate_dest_cap=0)
    over(sp, sv, sf, inst, params, True)
    with pytest.raises(sharded.TileRouteOverflow) as e:
        over.drain()
    jx['overflow'] = (str(e.value), over.route_peak_rows, over.route_cap)
    cal = sharded.make_tile_sharded_raster_fn(
        mesh, 40.0, w.P, w.SEM_IDXS, 20., 20., 0.5, dest_cap_factor=4.0,
        calibrate_dest_cap=2.0)
    seq = []
    for _ in range(w.CALIB_CALLS):
        cal(sp, sv, sf, inst, params, True)
        seq.append((cal.dest_cap_factor, cal.route_cap, cal.route_peak_rows))
    cal.drain()
    seq.append((cal.dest_cap_factor, cal.route_cap, cal.route_peak_rows))
    jx['calib'] = seq

    mesh2 = mesh_mod.make_mesh((2, 2), devices=jax.devices()[:N])
    from jax.sharding import NamedSharding, PartitionSpec as PS
    streams = [w.make_points(10 + s) for s in range(2)]

    def put(a, spec):
        return jax.device_put(np.stack(a), NamedSharding(mesh2, spec))

    rows = PS('data', 'points')
    ms = sharded.make_multistream_raster_fn(mesh2, 40.0, w.P, w.SEM_IDXS,
                                            20., 20., 0.5)
    jx['multistream'] = np.asarray(ms(
        put([s[0] for s in streams], rows), put([s[1] for s in streams], rows),
        put([s[2] for s in streams], rows),
        put([np.zeros(4, np.float32)] * 2, PS('data')),
        put([_jax_params(s).pack() for s in range(2)], PS('data')), True),
        np.float32)
    return port, jx


def _maps_close(got, want, gen_future, tile=False):
    g = core.unpack_maps(got, gen_future)
    e = core.unpack_maps(want, gen_future)
    assert set(g) == set(e)
    for k in e:
        np.testing.assert_allclose(g[k], e[k], atol=_tol(k, tile),
                                   err_msg=k)


@pytest.mark.parametrize('gen_future', [True, False])
def test_psum_engine_matches_jax(runs, gen_future):
    port, jx = runs
    _maps_close(port[0][f'psum_{gen_future}'], jx[f'psum_{gen_future}'],
                gen_future)
    for r in range(1, N):
        np.testing.assert_array_equal(port[r][f'psum_{gen_future}'],
                                      port[0][f'psum_{gen_future}'])


def test_tile_engine_matches_jax(runs):
    port, jx = runs
    _maps_close(port[0]['tile'], jx['tile'], True, tile=True)
    assert port[0]['tile_route'] == jx['tile_route']
    assert 0 < port[0]['tile_route'][0] <= port[0]['tile_route'][1]
    for r in range(1, N):
        np.testing.assert_array_equal(port[r]['tile'], port[0]['tile'])


def test_tile_tuple_form_equals_packed(runs):
    port, _ = runs
    for r in range(N):
        np.testing.assert_array_equal(port[r]['tile_tuple'],
                                      port[r]['tile'])
    assert port[0]['tile_packed'].shape == (7, w.P, w.P)


def test_auto_falls_back_to_psum(runs):
    """961 cells do not stripe over 4 ranks: 'auto' takes the psum
    engine (the tile engine's is a class), an explicit 'tile' raises."""
    port, jx = runs
    assert port[0]['auto_engine'] == 'function'
    _maps_close(port[0]['auto_31'], jx['auto_31'], True)
    assert 'divisible' in port[0]['tile_31']


def test_tile_overflow_raises_as_jax(runs):
    port, jx = runs
    msg, peak, cap = port[0]['overflow']
    assert 'set dest_cap_factor >= ' in msg
    assert peak > cap
    assert port[0]['overflow'] == jx['overflow']
    for r in range(1, N):                 # every rank reads the same counts
        assert port[r]['overflow'] == port[0]['overflow']


def test_calibration_moves_as_jax(runs):
    """The factor and the capacity change on the same calls as JAX's
    (counts read three calls behind), to JAX's calibrated factor; the
    outputs stay within the tile tolerance."""
    port, jx = runs
    assert port[0]['calib'] == jx['calib']
    final_factor, final_cap, peak = port[0]['calib'][-1]
    assert 1.0 <= final_factor < 4.0
    assert 0 < peak <= final_cap < port[0]['calib'][3][1]
    first, last = port[0]['calib_stacks']
    _maps_close(last, first, True, tile=True)


def test_multistream_matches_jax(runs):
    port, jx = runs
    for r in range(N):
        d, stack = port[r]['multistream']
        assert stack.shape == (1, 21, w.P, w.P)
        _maps_close(stack[0], jx['multistream'][d], True)


def test_shard_points_to_mesh(runs):
    port, _ = runs
    pts, valid, fids = w.make_points(0)
    for r in range(N):
        sp, sv, sf = port[r]['shard']
        np.testing.assert_array_equal(sp, pts[r::N])       # row i -> i % N
        np.testing.assert_array_equal(sv, valid[r::N])
        np.testing.assert_array_equal(sf, fids[r::N])


@pytest.mark.parametrize('case', sorted(w.GROWTH))
def test_step_window_growth_fits_4_ranks(runs, case):
    """step()'s compacted buffer holds its live rows at the front. A
    first tile raster on a small window calibrates the route; the grown
    window ('full': every row live) must still fit it, since the rows are
    dealt strided over the 4 ranks and the factor covers a full window.
    Its maps equal the one-device raster's."""
    port, _ = runs
    err, stack, one, factor, (peak, cap) = port[0]['growth'][case]
    assert err is None, err
    assert 1.0 <= factor < 4.0 and 0 < peak <= cap
    _maps_close(stack, one, True)
    for r in range(1, N):
        np.testing.assert_array_equal(port[r]['growth'][case][1], stack)


def test_dryrun_multichip_4():
    """Step 1 trains DP+TP with the JAX dryrun's tp rule (the largest
    power of two dividing 4, at most 4: a (1, 4) mesh)."""
    summary = dryrun.dryrun_multichip(4, device='cpu')
    assert summary['tp'] == 4 and np.isfinite(summary['train_loss'])
    assert summary['job_bevs'] >= 2 and summary['mesh_step_bevs'] == 4
    assert summary['streams'] == 2 and summary['tile_vs_psum'] <= 4e-3


def test_initialize_multihost_unconfigured_is_noop():
    import torch.distributed as dist
    pmesh.initialize_multihost(None)
    assert not dist.is_initialized()


@pytest.fixture(scope='module')
def sparse_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh_sparse')
    w.spawn_world('sparse_mesh_cases', 2, tmp)
    return [w.load(tmp, f'sparse_r{r}') for r in range(2)]


def _decoded(buf, gen_future):
    from pc_accumulation_lib_tpu_torch.bev import core as tcore
    return tcore.decode_sparse_stack(
        buf, gen_future, w.P, w.SPARSE_KW['sparse_cap'],
        tcore.sparse_empty_values(20., 20., 0.5))


@pytest.mark.parametrize('gen_future', [True, False])
def test_sparse_pack_on_mesh_byte_equal(sparse_runs, gen_future):
    one = sparse_runs[0][f'one_{gen_future}']
    for r in range(2):
        for got, want in zip(sparse_runs[r][f'tile_{gen_future}'], one):
            np.testing.assert_array_equal(got, want)
        sp = sparse_runs[r][f'psum_{gen_future}'][0]
        hdr = core.sparse_header_bytes(w.P, gen_future)
        np.testing.assert_array_equal(sp[:hdr], one[0][:hdr])
        _maps_close(_decoded(sp, gen_future), _decoded(one[0], gen_future),
                    gen_future)


def test_tile_group_byte_equal(sparse_runs):
    """group and MeshRasterClient.group: row i is the one-device raster
    of draw i, both buffers, byte for byte."""
    one = sparse_runs[0]['one_group']
    for got in (sparse_runs[0]['group'], sparse_runs[1]['group'],
                sparse_runs[0]['client_group']):
        assert got[0].shape[0] == got[1].shape[0] == len(one)
        for i, (sp, dn) in enumerate(one):
            np.testing.assert_array_equal(got[0][i], sp)
            np.testing.assert_array_equal(got[1][i], dn)


def test_sparse_step_on_mesh_matches_one_device(sparse_runs):
    out = sparse_runs[0]
    assert len(out['step']) == len(out['step_one']) == w.SPARSE_STEPS
    assert sum(out['step_rungs'].values()) == w.SPARSE_STEPS
    for mesh_bevs, one_bevs in zip(out['step'], out['step_one']):
        assert len(mesh_bevs) == 4
        for a, b in zip(mesh_bevs, one_bevs):
            assert set(a) == set(b)
            for k in a:
                if not k.startswith('trajs'):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
