"""Launching the port on several processes: initialize_multihost from
torchrun's variables, the train_semseg CLI under torchrun against the JAX
runner, and a failing rank ending its world.

The CLI runs as a user runs it, ``python -m torch.distributed.run
--standalone --nproc-per-node 2 -m
pc_accumulation_lib_tpu_torch.runners.train_semseg <shard> --device
cpu``; a sitecustomize.py on the workers' path
(torch_mesh_worlds.hook_train_cli) starts its model from the JAX
runner's initial weights, carried by name, and records its losses. The
JAX side is runners/train_semseg.run on 2 of the conftest's CPU devices,
the (1, 2) ('data', 'model') mesh of a host of 2 chips, and on one
device. Both train the full-depth model at 16x32, batch 2, in float32.
Tolerances, those of tests/test_torch_tp.py against JAX's trainer on the
same mesh: the step-1 loss rtol 1e-5; both losses within twice the
distance between JAX's own one-device and mesh losses, at least 1e-4
(its _float32_floor: Adam's first step turns gradients at the float32
floor into different weights on two layouts; at full depth JAX's two
step-2 losses differ by ~6e-3).
"""
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pc_accumulation_lib_tpu.models import onnx_port as jport
from pc_accumulation_lib_tpu.models import train as jtrain
from pc_accumulation_lib_tpu.runners import train_semseg as jrun
from pc_accumulation_lib_tpu_torch.models import checkpoint as tckpt
from pc_accumulation_lib_tpu_torch.models import train as ttrain
from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh

import torch_mesh_worlds as w

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CLI = 'pc_accumulation_lib_tpu_torch.runners.train_semseg'
HW, BATCH, STEPS, LR = (16, 32), 2, 2, 1e-3
FAULT_LIMIT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _shard(root):
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 19, (4, *HW)).astype(np.uint8)
    labels[1, :4] = 255
    np.savez(os.path.join(root, 'shard0.npz'),
             images=rng.integers(0, 256, (4, *HW, 3), np.uint8),
             labels=labels)
    return os.path.join(root, 'shard*.npz')


def _torchrun(tmp, args, hook_args):
    """The CLI under torchrun on 2 processes, the hook on their path;
    returns the finished process and its wall seconds."""
    hook = tmp / 'hook'
    hook.mkdir(exist_ok=True)
    (hook / 'sitecustomize.py').write_text(
        'import os\n'
        "if 'LOCAL_RANK' in os.environ:\n"
        '    import torch_mesh_worlds\n'
        f'    torch_mesh_worlds.hook_train_cli(*{hook_args!r})\n')
    env = dict(os.environ, OMP_NUM_THREADS='2', PYTHONPATH=os.pathsep.join(
        (str(hook), TESTS, ROOT)))
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', '2', '-m', CLI, *args], cwd=str(tmp), env=env,
        capture_output=True, text=True, timeout=300)
    return proc, time.perf_counter() - t0


@pytest.fixture(scope='module')
def cli(tmp_path_factory):
    """The JAX runner on 2 devices, then the port's CLI under torchrun
    from the JAX runner's initial weights."""
    tmp = tmp_path_factory.mktemp('launch')
    data_glob = _shard(str(tmp))
    devices = jax.devices()[:2]
    make = jtrain.make_train_setup
    named = {}

    def spy(*args, **kwargs):
        state, step = make(*args, **kwargs)
        named.update(jport.export_named_tensors(state.variables))
        return state, step

    def jax_run(n):
        mp = pytest.MonkeyPatch()
        mp.setattr(jax, 'devices', lambda *a: devices[:n])
        mp.setattr(jtrain, 'make_train_setup', spy)
        try:
            return jrun.run(data_glob, steps=STEPS, batch_size=BATCH, lr=LR,
                            ckpt_dir=str(tmp / 'jckpt'), ckpt_every=0,
                            log_every=STEPS)
        finally:
            mp.undo()

    _, jlosses_one = jax_run(1)
    jstate, jlosses = jax_run(2)
    named_path = str(tmp / 'named.npz')
    np.savez(named_path, **named)
    out = tmp / 'losses'
    out.mkdir()
    ckpt_dir = tmp / 'ckpt'
    proc, _ = _torchrun(
        tmp, [data_glob, '--device', 'cpu', '--steps', str(STEPS),
              '--batch_size', str(BATCH), '--lr', str(LR),
              '--ckpt_dir', str(ckpt_dir)], (str(out), named_path))
    return dict(proc=proc, jlosses=jlosses,
                jlosses_one=jlosses_one,
                jafter=jport.export_named_tensors(jstate.variables),
                out=out, ckpt_dir=ckpt_dir)


def test_torchrun_cli_exits_0(cli):
    proc = cli['proc']
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_torchrun_cli_matches_jax_runner(cli):
    """Every rank reports the same global losses, held to the JAX
    runner's on the same layout (the module docstring's tolerances)."""
    import json
    got = [json.loads((cli['out'] / f'losses_r{r}.json').read_text())
           for r in range(2)]
    assert got[0] == got[1] and len(got[0]) == STEPS
    np.testing.assert_allclose(got[0][0], cli['jlosses'][0], rtol=1e-5)
    j1, jm = np.array(cli['jlosses_one']), np.array(cli['jlosses'])
    floor = max(1e-4, 2 * np.max(np.abs(jm - j1) / np.abs(j1)))
    np.testing.assert_allclose(got[0], jm, rtol=floor)


def test_torchrun_checkpoint_restores_on_one_process(cli):
    """The (1, 2) run's checkpoint at its last step loads into a
    one-process model; its weights lie within 2 * lr * steps of the JAX
    runner's (tests/test_torch_tp.py's bound: Adam moves a weight by
    about lr per step)."""
    assert sorted(os.listdir(cli['ckpt_dir'])) == [str(STEPS)]
    state, _ = ttrain.make_train_setup(lr=LR, device='cpu')
    state = tckpt.restore_train_state(str(cli['ckpt_dir']), state)
    assert state.step == STEPS
    params = dict(state.model.named_parameters())
    want = {k: v for k, v in cli['jafter'].items() if k in params}
    assert len(want) == len(params)
    for k, v in want.items():
        diff = np.abs(params[k].detach().numpy() - v).max()
        assert diff <= 2 * LR * STEPS, (k, diff)


def test_initialize_multihost_joins_from_torchrun_env(tmp_path):
    """Two spawned processes with torchrun's variables and no group:
    initialize_multihost() joins them by env:// with the rank and world
    size of the variables, and an NCCL join takes card LOCAL_RANK."""
    import torch.multiprocessing as tmp_mp
    n = 2
    tmp_mp.spawn(w.env_join_cases, args=(n, str(tmp_path), _free_port()),
                 nprocs=n, join=True)
    for r in range(n):
        got = w.load(tmp_path, f'env_r{r}')
        assert got['cards'] == [n - 1 - r]
        assert (got['rank'], got['world']) == (r, n)
        assert got['asked'] == 'nccl' and got['init_method'] == 'env://'
        assert got['backend'] == 'gloo' and got['gathered'] == [0, 1]


@pytest.mark.parametrize('local_rank, card', [('1', 1), (None, 6 % 4)])
def test_nccl_card_is_local_rank(monkeypatch, local_rank, card):
    """A process of global rank 6 on a host of 4 cards takes card
    LOCAL_RANK when it is set, else rank % 4."""
    got = {}
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: got.setdefault('card', d))
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: got.update(kw, backend=backend))
    for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    if local_rank is None:
        monkeypatch.delenv('LOCAL_RANK', raising=False)
    else:
        monkeypatch.setenv('LOCAL_RANK', local_rank)
    pmesh.initialize_multihost('host:1234', 8, 6, backend='nccl')
    assert got == dict(card=card, backend='nccl',
                       init_method='tcp://host:1234', world_size=8, rank=6,
                       timeout=pmesh.COLLECTIVE_TIMEOUT)


@pytest.mark.parametrize('missing', ['process_id', 'num_processes'])
def test_explicit_address_needs_ids(monkeypatch, missing):
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda *a, **kw: pytest.fail('joined'))
    kwargs = dict(num_processes=2, process_id=0)
    kwargs[missing] = None
    with pytest.raises(ValueError, match=missing):
        pmesh.initialize_multihost('localhost:1234', backend='gloo',
                                   **kwargs)
    assert not dist.is_initialized()


def test_unconfigured_without_torchrun_env_is_noop(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    pmesh.initialize_multihost()
    assert not dist.is_initialized()


@pytest.mark.parametrize('launcher', ['spawn', 'torchrun'])
def test_failing_rank_ends_world(tmp_path, launcher):
    """Rank 1 raises while rank 0 waits in a collective: the launch ends
    with a non-zero code within FAULT_LIMIT_S, whichever rank's exit its
    launcher sees first (torch.multiprocessing.spawn over a gloo world,
    as chip_smoke.py's mesh worlds; torchrun over the CLI, rank 1 raising
    at its first step)."""
    if launcher == 'spawn':
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', 'import torch_mesh_worlds as w; '
             f"w.spawn_world('fault_cases', 2, {str(tmp_path)!r})"],
            cwd=TESTS, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                (TESTS, ROOT))), capture_output=True, text=True,
            timeout=2 * FAULT_LIMIT_S)
        seconds = time.perf_counter() - t0
    else:
        proc, seconds = _torchrun(
            tmp_path, [_shard(str(tmp_path)), '--device', 'cpu', '--steps',
                       '1', '--batch_size', '2',
                       '--ckpt_dir', str(tmp_path / 'ckpt')],
            (str(tmp_path), None, 1))
    assert proc.returncode != 0
    assert 'rank 1 fails' in proc.stderr, proc.stderr[-4000:]
    assert seconds < FAULT_LIMIT_S, seconds
