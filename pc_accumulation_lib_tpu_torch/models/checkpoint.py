"""Semseg weight files and train-state checkpoints.

Counterpart of models/checkpoint.py. Weight files are a ``torch.save`` of
the model's state dict (read by models/semseg.load_semseg_model).
Train-state checkpoints take orbax CheckpointManager's layout: one
directory per step, ``<ckpt_dir>/<step>/``, here holding ``state.pt``
with the model's and the optimizer's state dicts and the step. A
checkpoint is written under a temporary name and renamed into place, so
a crash leaves no half-written step behind.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from pc_accumulation_lib_tpu_torch.models.train import TrainState

_STATE_FILE = 'state.pt'


def save_semseg_weights(model, path: str) -> None:
    """Write a SemSegTorch's (or a ResNet50DilatedFCN's) state dict;
    load_semseg_model(path) restores it."""
    module = getattr(model, 'model', model)
    torch.save(module.state_dict(), path)


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())


def save_train_state(ckpt_dir: str, step: int, state: TrainState) -> None:
    """Write ``state`` as ``<ckpt_dir>/<step>/``; raises FileExistsError
    when that step is already saved."""
    final = os.path.join(ckpt_dir, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f'checkpoint {final!r} exists')
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f'.{int(step)}.', dir=ckpt_dir)
    try:
        torch.save({'model': state.model.state_dict(),
                    'optimizer': state.optimizer.state_dict(),
                    'step': int(step)}, os.path.join(tmp, _STATE_FILE))
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_train_state(ckpt_dir: str, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Load the latest (or the given) step into ``state``'s model and
    optimizer, in place, and return the state at that step. Raises
    FileNotFoundError when there is no such checkpoint."""
    steps = _steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir!r}')
        step = steps[-1]
    path = os.path.join(ckpt_dir, str(int(step)), _STATE_FILE)
    # On the host first: load_state_dict moves each tensor to its
    # parameter's device and keeps Adam's step counters on the host.
    saved = torch.load(path, map_location='cpu', weights_only=True)
    state.model.load_state_dict(saved['model'])
    state.optimizer.load_state_dict(saved['optimizer'])
    return state._replace(step=saved['step'])
