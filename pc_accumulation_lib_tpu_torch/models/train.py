"""Semseg training: one device, a data-parallel mesh, or a GPipe pipeline.

Counterpart of models/train.py: the ResNet-50 dilated FCN in train mode
(batch statistics updated as flax does, models/resnet_semseg._BN),
per-pixel cross entropy with the Cityscapes ignore label, Adam with
optax's defaults on the parameters only. Convolutions compute in bfloat16
on the card and in float32 on the CPU; weights, their gradients, the
optimizer state and the batch norms are float32.

On a ('data', 'model') mesh (parallel/mesh.make_mesh) the step is data
and tensor parallel, as the JAX trainer's is with its batch on P('data')
and its parameters placed by param_spec: every rank takes its data
rank's slice of the global batch; with a 'model' axis above 1 the wide
layers are cut over it (shard_variables) and the forward is tensor
parallel (parallel/tensor_parallel.py); batch norms take the statistics
of the global batch over the data axis; the gradients are summed over
the data axis, so Adam moves every data rank's weights alike.
make_pipelined_train_setup is the GPipe trainer over a ('pp',) mesh
(parallel/pipeline.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    _BN, ResNet50DilatedFCN, init_params)

IGNORE_LABEL = 255


class TrainState(NamedTuple):
    model: ResNet50DilatedFCN
    optimizer: torch.optim.Adam
    step: int


def cross_entropy_loss(logits, labels):
    """Mean per-pixel cross entropy over the pixels whose label is not
    IGNORE_LABEL; 0 when every pixel is ignored (the JAX package divides
    by max(valid, 1), where a mean would give NaN).

    logits: (B,H,W,C) float32; labels: (B,H,W) int in [0, C) or 255."""
    labels = labels.to(torch.int64)
    nll = F.cross_entropy(logits.permute(0, 3, 1, 2), labels,
                          ignore_index=IGNORE_LABEL, reduction='sum')
    return nll / (labels != IGNORE_LABEL).sum().clamp(min=1)


# param_spec's width: a conv with this many output channels or more, and
# its batch norm, are sharded over 'model'.
TP_MIN_CHANNELS = 256


def param_spec(name: str, tensor) -> tuple:
    """The JAX package's TP rule in torch layout: a 4-D conv weight (O,
    I, kh, kw) with O >= 256 is sharded over 'model' on dim 0 (JAX shards
    the last dim of (kh, kw, I, O)), a 1-D tensor of at least 256 (batch
    norm scales, shifts and running statistics) on dim 0; the rest is
    replicated. Returns the PartitionSpec-like tuple of axis names per
    dim, () when replicated."""
    del name
    if tensor.ndim == 4 and tensor.shape[0] >= TP_MIN_CHANNELS:
        return ('model', None, None, None)
    if tensor.ndim == 1 and tensor.shape[0] >= TP_MIN_CHANNELS:
        return ('model',)
    return ()


def shard_variables(model, mesh):
    """Keep, in place, this rank's slice of every tensor that param_spec
    shards (parameters and running statistics): rows [r*O/tp,
    (r+1)*O/tp) for model rank r of tp. The Parameter objects stay the
    same, so an optimizer built over them before stays valid. Sets
    ``model.model_axis`` and ``model.mesh``; the forward is then tensor
    parallel. Raises
    ValueError when tp does not divide a sharded dim. Returns the
    model."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel.tensor_parallel import (
        ModelAxis)
    tp = pmesh.axis_size(mesh, 'model')
    named = model.state_dict(keep_vars=True)
    sharded = [k for k, v in named.items() if param_spec(k, v)]
    bad = [k for k in sharded if named[k].shape[0] % tp]
    if bad:
        raise ValueError(
            f"a 'model' axis of {tp} does not divide {bad[:3]}: param_spec "
            f'shards conv weights with at least {TP_MIN_CHANNELS} output '
            f'channels and 1-D tensors of at least {TP_MIN_CHANNELS} on '
            'dim 0 (multiples of 256 in this model)')
    r = pmesh.axis_rank(mesh, 'model')
    for k in sharded:
        t = named[k]
        n = t.shape[0] // tp
        t.data = t.data[r * n:(r + 1) * n].clone()
    model.model_axis = ModelAxis(mesh, 'model', frozenset(sharded))
    model.mesh = mesh
    return model


def shard_named(model, named):
    """This rank's slices of full named tensors ({state-dict or parameter
    name: tensor}) for a model cut by shard_variables; replicated ones,
    and every one of a model that is not cut, as they are."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    ax = model.model_axis
    if ax is None:
        return dict(named)
    tp = pmesh.axis_size(ax.mesh, ax.axis)
    r = pmesh.axis_rank(ax.mesh, ax.axis)
    out = dict(named)
    for k in named.keys() & ax.sharded:
        n = named[k].shape[0] // tp
        out[k] = named[k][r * n:(r + 1) * n].clone()
    return out


def gather_named(model, named):
    """Full tensors of a model cut by shard_variables from this rank's
    named ones ({state-dict or parameter name: tensor}, e.g. its state
    dict, gradients or Adam moments): the sharded ones gathered over the
    model axis in one collective, which every rank of the axis must
    join; replicated ones, and every one of a model that is not cut, as
    they are."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    ax = model.model_axis
    out = dict(named)
    keys = sorted(named.keys() & ax.sharded) if ax is not None else []
    if not keys:
        return out
    rows = pmesh.all_gather(torch.cat([named[k].reshape(-1) for k in keys]),
                            ax.mesh, ax.axis)
    at = 0
    for k in keys:
        t = named[k]
        out[k] = rows[:, at:at + t.numel()].reshape(-1, *t.shape[1:])
        at += t.numel()
    return out


def make_train_setup(lr: float = 1e-3, img_hw=(64, 128), seed: int = 0,
                     stage_sizes: Optional[Sequence[int]] = None,
                     compute_dtype: Optional[torch.dtype] = None, *,
                     device='cuda', mesh=None):
    """Build (state, train_step) on ``device`` (the card unless the
    caller passes 'cpu'; raises when the card is asked for and missing).

    train_step(state, images (B,H,W,3) float in [0,255], labels (B,H,W)
    int) -> (state, loss 0-d tensor): one Adam step on the mean loss;
    the step's gradients stay in the parameters' ``.grad`` until the next
    step. ``img_hw`` is accepted for the JAX signature: the parameter
    shapes do not depend on it. Weights are initialized from ``seed``
    (models/resnet_semseg.init_params).

    ``mesh``: a ('data', 'model') DeviceMesh. Every rank then passes the
    same global batch (B divisible by the data size, else ValueError);
    a data rank trains on its slice of it, the model ranks of one data
    rank on the same slice. A 'model' axis above 1 cuts the model
    (shard_variables: ValueError when it does not divide a sharded dim;
    full weights load into it through shard_named). Batch norms take
    the statistics of the global batch over the data axis. The loss is
    the global one (the data ranks' NLL sums over the global valid
    count, clamped at 1), computed on every model rank from the
    replicated logits; the gradients are summed over the data axis only,
    and the replicated tensors' gradients and the loss are then taken
    from model rank 0, so they stay bit-equal across model ranks where
    cuDNN's backward is not deterministic. The returned loss is the same
    on every rank."""
    del img_hw
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('make_train_setup: no CUDA device')
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16 if device.type == 'cuda'
                         else torch.float32)
    kwargs = {} if stage_sizes is None else {'stage_sizes': stage_sizes}
    model = ResNet50DilatedFCN(compute_dtype=compute_dtype, **kwargs)
    init_params(model, torch.Generator().manual_seed(seed))
    dp = tp = 1
    if mesh is not None:
        from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
        dp = pmesh.axis_size(mesh, 'data')
        if 'model' in mesh.mesh_dim_names:
            tp = pmesh.axis_size(mesh, 'model')
        if tp > 1:
            shard_variables(model, mesh)
        model.mesh = mesh
    model.to(device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)
    state = TrainState(model=model, optimizer=optimizer, step=0)

    if mesh is None:
        def train_step(state: TrainState, images, labels):
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(state.model(images), labels)
            loss.backward()
            state.optimizer.step()
            return state._replace(step=state.step + 1), loss.detach()

        return state, train_step

    for m in model.modules():
        if isinstance(m, _BN):
            m.data_axis = (mesh, 'data')
    r = pmesh.axis_rank(mesh, 'data')
    replicated = ([p for k, p in model.named_parameters()
                   if k not in model.model_axis.sharded] if tp > 1 else [])

    def mesh_train_step(state: TrainState, images, labels):
        if images.shape[0] % dp:
            raise ValueError(f'global batch {images.shape[0]} must be '
                             f'divisible by the data-parallel size {dp}')
        b = images.shape[0] // dp
        images, labels = images[r * b:(r + 1) * b], labels[r * b:(r + 1) * b]
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        labels = labels.to(torch.int64)
        logits = state.model(images)
        nll = F.cross_entropy(logits.permute(0, 3, 1, 2), labels,
                              ignore_index=IGNORE_LABEL, reduction='sum')
        n_valid = pmesh.psum((labels != IGNORE_LABEL).sum(), mesh, 'data')
        loss = nll / n_valid.clamp(min=1)
        loss.backward()
        loss = loss.detach()
        grads = [p.grad for p in state.model.parameters()] + [loss]
        _copy_flat(grads, pmesh.psum(_flat(grads), mesh, 'data'))
        if tp > 1:
            grads = [p.grad for p in replicated] + [loss]
            _copy_flat(grads, pmesh.broadcast(_flat(grads), mesh, 'model'))
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss

    return state, mesh_train_step


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _copy_flat(tensors, flat):
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_pipelined_train_setup(mesh, microbatch: int = 2, hw=(8, 16),
                               channels: int = 16, lr: float = 1e-2,
                               seed: int = 0, stage_weights=None, *,
                               device='cuda'):
    """GPipe trainer over the mesh's 'pp' axis: a stack of S residual
    blocks x + relu(conv3x3(x)), one per pp rank (rank s holds stage s's
    conv and its Adam state), MSE loss (parallel/pipeline.py).

    ``stage_weights``: per-stage {'weight', 'bias'} arrays to start from
    (pipeline.stage_weights_from_flax carries the JAX trainer's);
    otherwise stage s is initialized from ``seed + s`` (LeCun normal,
    zero bias). Returns (state, train_step) with train_step(state, xs
    (M, mb, H, W, C), ys like xs) -> (state, loss), the same loss on
    every rank; M is xs.shape[0]. ``microbatch`` and ``hw`` are accepted
    for the JAX signature: no shape depends on them here."""
    import torch.nn as nn

    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    from pc_accumulation_lib_tpu_torch.parallel import pipeline as pp

    del microbatch, hw
    device = torch.device(device)
    s = pmesh.axis_rank(mesh, 'pp')
    conv = nn.Conv2d(channels, channels, 3, padding=1)
    with torch.no_grad():
        if stage_weights is None:
            g = torch.Generator().manual_seed(seed + s)
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5,
                                generator=g)
            conv.bias.zero_()
        else:
            conv.weight.copy_(torch.as_tensor(stage_weights[s]['weight']))
            conv.bias.copy_(torch.as_tensor(stage_weights[s]['bias']))
    conv.to(device)

    def stage_fn(stage, x):
        y = stage(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + torch.relu(y)

    run = pp.gpipe_apply(stage_fn, mesh)
    optimizer = torch.optim.Adam(conv.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    state = TrainState(model=conv, optimizer=optimizer, step=0)

    def train_step(state: TrainState, xs, ys):
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((run(state.model, xs) - ys) ** 2)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return state, train_step
