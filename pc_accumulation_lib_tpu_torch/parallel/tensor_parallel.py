"""Tensor-parallel layers of the ResNet-50 dilated FCN over one mesh axis.

Counterpart of what XLA's SPMD partitioner builds for the JAX trainer
from models/train.param_spec. models/resnet_semseg.py's blocks and head
call the helpers below with the model's ModelAxis, or with None for a
model that is not cut, where each of them is the plain layer.

A conv whose output channels are sharded over the axis
(models/train.shard_variables) computes its slice from the full input;
its batch norm, the ReLU and the residual add are per channel, so they
run on the slice; the slices are gathered once, before the next consumer
that reads every channel (the next block's conv1 and downsample, a
sharded conv2 or conv3 inside layer3 and layer4, the head conv, the
replicated classifier). The input of a sharded conv passes through
parallel/mesh.copy_to_axis, so its gradient is the psum of the ranks'
contributions; a replicated layer's input does not, because every rank
computes the same gradient for it. So every replicated tensor's gradient
is the same on every rank of the axis, and every sharded tensor's
gradient is the rank's slice of the full gradient.

A conv keeps its full ``in_channels`` and ``out_channels``; a sharded
one holds a weight of out_channels / n rows, and an activation with
fewer channels than a conv reads is a slice. The logits come out
replicated on every rank of the axis.
"""
from __future__ import annotations

from typing import Any, FrozenSet, NamedTuple

from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh


class ModelAxis(NamedTuple):
    """Where a model's sharded tensors live: the mesh, its axis, and the
    state-dict names of the tensors cut on dim 0 over it."""
    mesh: Any
    axis: str
    sharded: FrozenSet[str]


def sharded(conv) -> bool:
    return conv.weight.shape[0] < conv.out_channels


def full(x, conv, ax):
    """``x`` with every channel ``conv`` reads: a slice is gathered."""
    if x.shape[1] == conv.in_channels:
        return x
    return pmesh.gather_channels(x, ax.mesh, ax.axis)


def copy_in(x, ax):
    """``x`` as sharded convs read it: through copy_to_axis on a cut
    model."""
    return x if ax is None else pmesh.copy_to_axis(x, ax.mesh, ax.axis)


def apply(conv, x, into):
    """``conv`` of its full input ``x``, read as ``into`` (copy_in of
    ``x``, shared by the input's sharded readers so that its gradient is
    reduced once) when the conv is sharded."""
    return conv(into if sharded(conv) else x)


def conv(conv, x, ax):
    """``conv`` of ``x``, a slice or the full input."""
    x = full(x, conv, ax)
    return apply(conv, x, copy_in(x, ax))
