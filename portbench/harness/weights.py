"""The semseg model's weights, made on the device from the seed.

The rule is the port's ``init_params``: every convolution weight from
N(0, 1/fan_in), the classifier's bias 0, batch norms at identity (scale
1, shift 0, running mean 0, running variance 1), with one change: the
classifier's bias is -1.5 for the classes the configuration filters out
of the point cloud (sky, person, rider, train, bicycle). The logits of
such a model spread by 0.14-0.22 over an image, and its most frequent
class differs from seed to seed; where that class was a filtered one,
almost no point was painted and the run did a small part of the work of
another seed's. With the bias, as with trained weights, lidar points are
seldom painted as those classes, so every seed paints about what the
camera sees.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.fcn import param_shapes

SUPPRESSED_BIAS = -1.5
CLASSIFIER_BIAS = 'decode_head.conv_seg.bias'


def fcn_weights(seed: int, device, stage_sizes=(3, 4, 6, 3),
                num_classes: int = 19,
                suppressed=()) -> Dict[str, torch.Tensor]:
    """{state-dict name: float32 tensor on ``device``} of a seeded model;
    ``suppressed``: the filtered class ids (ids past the classes are
    ignored). The names and shapes are the reference's
    (reference/fcn.param_shapes); the draws are one call of a
    ``torch.Generator`` on the device for all convolution weights
    together, in the state dict's order."""
    shapes = param_shapes(tuple(stage_sizes), num_classes)
    convs = [(k, v) for k, v in shapes.items() if len(v) == 4]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(v) for _, v in convs), generator=gen,
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, v in convs:
        n = math.prod(v)
        fan_in = math.prod(v[1:])
        out[k] = flat[off:off + n].view(v).mul_(fan_in ** -0.5)
        off += n
    for k, v in shapes.items():
        if k in out:
            continue
        if k.endswith('running_var') or (k.endswith('.weight')
                                         and len(v) == 1):
            out[k] = torch.ones(v, device=device)
        else:
            out[k] = torch.zeros(v, device=device)
    ids = [c for c in suppressed if 0 <= c < num_classes]
    out[CLASSIFIER_BIAS][ids] = SUPPRESSED_BIAS
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``module`` (the same names; batch-norm step
    counters keep their values)."""
    state = module.state_dict()
    missing = [k for k in state if k not in weights
               and not k.endswith('num_batches_tracked')]
    extra = [k for k in weights if k not in state]
    if missing or extra:
        raise KeyError(f'weights do not fit the model: missing {missing[:5]}'
                       f', extra {extra[:5]}')
    with torch.no_grad():
        for k, v in state.items():
            if k in weights:
                v.copy_(weights[k])
