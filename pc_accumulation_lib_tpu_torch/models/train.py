"""Semseg training: one device, a data-parallel mesh, or a GPipe pipeline.

Counterpart of models/train.py: the ResNet-50 dilated FCN in train mode
(batch statistics updated as flax does, models/resnet_semseg._BN),
per-pixel cross entropy with the Cityscapes ignore label, Adam with
optax's defaults on the parameters only. Convolutions compute in bfloat16
on the card and in float32 on the CPU; weights, their gradients, the
optimizer state and the batch norms are float32.

On a ('data', 'model') mesh (parallel/mesh.make_mesh) the step is data
parallel, as the JAX trainer's is with its batch on P('data'): every rank
holds the whole model, takes its slice of the global batch, normalizes
with the global batch's statistics, and its gradients are summed over the
data axis, so Adam moves every rank's weights alike. Tensor parallelism
(the JAX package's param_spec / shard_variables over 'model') is not
ported (ROADMAP queue 1 item 2). make_pipelined_train_setup is the GPipe
trainer over a ('pp',) mesh (parallel/pipeline.py).
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


def _data_axis(mesh):
    """The data-parallel width of a ('data', 'model') mesh; a 'model'
    axis above 1 asks for tensor parallelism, which is not ported."""
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    names = tuple(mesh.mesh_dim_names)
    if 'model' in names and pmesh.axis_size(mesh, 'model') > 1:
        raise NotImplementedError(
            f"a 'model' axis of {pmesh.axis_size(mesh, 'model')}: tensor "
            'parallelism (TP: param_spec, shard_variables) is not ported '
            '(ROADMAP queue 1 item 2); use a (data, 1) mesh')
    return pmesh.axis_size(mesh, 'data')


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

    ``mesh``: a ('data', 'model') DeviceMesh with a 'model' axis of 1.
    Every rank then passes the same global batch (B divisible by the
    data size, else ValueError) and trains on its slice; the loss is the
    global one (the ranks' NLL sums over the global valid count, clamped
    at 1), the gradients are summed over the data axis, and the returned
    loss is the same on every rank."""
    del img_hw
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('make_train_setup: no CUDA device')
    dp = 1 if mesh is None else _data_axis(mesh)
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16 if device.type == 'cuda'
                         else torch.float32)
    kwargs = {} if stage_sizes is None else {'stage_sizes': stage_sizes}
    model = ResNet50DilatedFCN(compute_dtype=compute_dtype, **kwargs)
    init_params(model, torch.Generator().manual_seed(seed))
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

    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
    for m in model.modules():
        if isinstance(m, _BN):
            m.data_axis = (mesh, 'data')
    r = pmesh.axis_rank(mesh, 'data')

    def dp_train_step(state: TrainState, images, labels):
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
        grads = [p.grad for p in state.model.parameters()]
        flat = pmesh.psum(torch.cat([g.reshape(-1) for g in grads]), mesh,
                          'data')
        for g, summed in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(summed.view_as(g))
        state.optimizer.step()
        return (state._replace(step=state.step + 1),
                pmesh.psum(loss.detach(), mesh, 'data'))

    return state, dp_train_step


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
