"""Semseg weight files and train-state checkpoints.

Counterpart of models/checkpoint.py. Weight files are a ``torch.save`` of
the model's state dict (read by models/semseg.load_semseg_model).
Train-state checkpoints take orbax CheckpointManager's layout: one
directory per step, ``<ckpt_dir>/<step>/``, here holding ``state.pt``
with the model's and the optimizer's state dicts and the step. A
checkpoint is written under a temporary name and renamed into place, so
a crash leaves no half-written step behind.

Both are layout-free, as orbax's global arrays are: a model cut over a
'model' axis (models/train.shard_variables) is saved as full tensors,
its sharded parameters, running statistics and Adam moments gathered
over the axis, and a checkpoint restores into any layout by slicing.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from pc_accumulation_lib_tpu_torch.models.train import (
    TrainState, gather_named, shard_named)

_STATE_FILE = 'state.pt'
_MOMENTS = ('exp_avg', 'exp_avg_sq')


def _writes(model) -> bool:
    """Whether this rank writes the model's files: on a model with a
    mesh (make_train_setup's, or the one shard_variables cut it over)
    the rank at coordinate 0 on every axis; otherwise any rank."""
    return model.mesh is None or not any(model.mesh.get_coordinate())


def save_semseg_weights(model, path: str) -> None:
    """Write a SemSegTorch's (or a ResNet50DilatedFCN's) state dict as
    full tensors; load_semseg_model(path) restores it. Every rank of
    the model's mesh calls this (a cut model gathers over its axis); one
    writes."""
    module = getattr(model, 'model', model)
    state = gather_named(module, module.state_dict())
    if _writes(module):
        torch.save(state, path)


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())


def _param_names(state: TrainState):
    """The optimizer's parameter indices' names."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g['params']]


def _moments(state: TrainState, opt, layout):
    """``opt`` (an optimizer state dict) with each Adam moment passed, by
    parameter name, through ``layout`` (gather_named or shard_named)."""
    names = _param_names(state)
    per_param = opt['state']
    for m in _MOMENTS:
        moved = layout(state.model, {names[i]: s[m]
                                     for i, s in per_param.items()})
        per_param = {i: dict(s, **{m: moved[names[i]]})
                     for i, s in per_param.items()}
    return dict(opt, state=per_param)


def save_train_state(ckpt_dir: str, step: int, state: TrainState) -> None:
    """Write ``state`` as ``<ckpt_dir>/<step>/``, in full tensors; raises
    FileExistsError when that step is already saved. Every rank of the
    model's mesh calls this (a cut model gathers over its axis); one
    writes."""
    model_state = gather_named(state.model, state.model.state_dict())
    opt = _moments(state, state.optimizer.state_dict(), gather_named)
    if not _writes(state.model):
        return
    final = os.path.join(ckpt_dir, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f'checkpoint {final!r} exists')
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f'.{int(step)}.', dir=ckpt_dir)
    try:
        torch.save({'model': model_state, 'optimizer': opt,
                    'step': int(step)}, os.path.join(tmp, _STATE_FILE))
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_train_state(ckpt_dir: str, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Load the latest (or the given) step into ``state``'s model and
    optimizer, in place, in the model's layout (a cut model takes its
    slices), and return the state at that step. Raises FileNotFoundError
    when there is no such checkpoint."""
    steps = _steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir!r}')
        step = steps[-1]
    path = os.path.join(ckpt_dir, str(int(step)), _STATE_FILE)
    # On the host first: load_state_dict moves each tensor to its
    # parameter's device and keeps Adam's step counters on the host.
    saved = torch.load(path, map_location='cpu', weights_only=True)
    state.model.load_state_dict(shard_named(state.model, saved['model']))
    state.optimizer.load_state_dict(
        _moments(state, saved['optimizer'], shard_named))
    return state._replace(step=saved['step'])
