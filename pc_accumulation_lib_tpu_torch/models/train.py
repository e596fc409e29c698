"""Semseg training step on one device.

Counterpart of models/train.py's ``make_train_setup`` without its mesh:
the ResNet-50 dilated FCN in train mode (batch statistics updated as flax
does, models/resnet_semseg._BN), per-pixel cross entropy with the
Cityscapes ignore label, Adam with optax's defaults on the parameters
only. Convolutions compute in bfloat16 on the card and in float32 on the
CPU; weights, their gradients, the optimizer state and the batch norms
are float32. Data- and tensor-parallel training over a mesh waits for the
mesh slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    ResNet50DilatedFCN, init_params)

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


def make_train_setup(lr: float = 1e-3, img_hw=(64, 128), seed: int = 0,
                     stage_sizes: Optional[Sequence[int]] = None,
                     compute_dtype: Optional[torch.dtype] = None, *,
                     device='cuda'):
    """Build (state, train_step) on ``device`` (the card unless the
    caller passes 'cpu'; raises when the card is asked for and missing).

    train_step(state, images (B,H,W,3) float in [0,255], labels (B,H,W)
    int) -> (state, loss 0-d tensor): one Adam step on the mean loss;
    the step's gradients stay in the parameters' ``.grad`` until the next
    step. ``img_hw`` is accepted for the JAX signature: the parameter
    shapes do not depend on it. Weights are initialized from ``seed``
    (models/resnet_semseg.init_params)."""
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
    model.to(device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)
    state = TrainState(model=model, optimizer=optimizer, step=0)

    def train_step(state: TrainState, images, labels):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(state.model(images), labels)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    return state, train_step
