"""A plain functional FCN-R50-D8 (mmsegmentation's ``fcn_r50-d8`` with a
ResNet-50 V1c backbone), written from the published architecture: the
reference's semseg.

Backbone: a deep stem of three 3x3 convolutions (3->32 stride 2, 32->32,
32->64), each with a batch norm and a ReLU, a 3x3 max pool of stride 2,
then four stages of bottlenecks (1x1, 3x3, 1x1 by 4, a 1x1 projection on
the first block of a stage) of 3, 4, 6 and 3 blocks and widths 64, 128,
256 and 512; stage 2 strides by 2, stages 3 and 4 are dilated by 2 and 4,
so the output stride is 8. Head: one 3x3 convolution 2048->512 with a
batch norm and a ReLU, a 1x1 classifier with a bias, and a bilinear
upsample (half-pixel centres) to the input size. Input: (B, H, W, 3)
images in [0, 255], normalised by the ImageNet mean and deviation.
Batch norms use their running statistics (inference).

Parameters are a dict by mmsegmentation's state-dict names
(``param_shapes``). Every convolution goes through ``conv`` (F.conv2d's
signature), so the control swaps in a lower-precision convolution and a
test counts FLOPs, without another copy of the network.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STEM = ((3, 32, 2), (32, 32, 1), (32, 64, 1))    # (in, out, stride)
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
EXPANSION = 4
HEAD = 512
BN_EPS = 1e-5


def _bn_shapes(prefix, c):
    return [(f'{prefix}.weight', (c,)), (f'{prefix}.bias', (c,)),
            (f'{prefix}.running_mean', (c,)), (f'{prefix}.running_var', (c,))]


def param_shapes(stage_sizes=(3, 4, 6, 3), num_classes=19):
    """OrderedDict {name: shape} of every parameter and running statistic,
    in the order a state dict of the network lists them."""
    out = []
    for i, (cin, cout, _) in enumerate(STEM):
        out.append((f'backbone.stem.{3 * i}.weight', (cout, cin, 3, 3)))
        out += _bn_shapes(f'backbone.stem.{3 * i + 1}', cout)
    cin = 64
    for si, n in enumerate(stage_sizes):
        w = WIDTHS[si]
        for b in range(n):
            p = f'backbone.layer{si + 1}.{b}'
            out.append((f'{p}.conv1.weight', (w, cin, 1, 1)))
            out += _bn_shapes(f'{p}.bn1', w)
            out.append((f'{p}.conv2.weight', (w, w, 3, 3)))
            out += _bn_shapes(f'{p}.bn2', w)
            out.append((f'{p}.conv3.weight', (w * EXPANSION, w, 1, 1)))
            out += _bn_shapes(f'{p}.bn3', w * EXPANSION)
            if b == 0:
                out.append((f'{p}.downsample.0.weight',
                            (w * EXPANSION, cin, 1, 1)))
                out += _bn_shapes(f'{p}.downsample.1', w * EXPANSION)
            cin = w * EXPANSION
    out.append(('decode_head.convs.0.conv.weight', (HEAD, cin, 3, 3)))
    out += _bn_shapes('decode_head.convs.0.bn', HEAD)
    out.append(('decode_head.conv_seg.weight', (num_classes, HEAD, 1, 1)))
    out.append(('decode_head.conv_seg.bias', (num_classes,)))
    return OrderedDict(out)


def _bn(x, p, name):
    return F.batch_norm(x, p[f'{name}.running_mean'],
                        p[f'{name}.running_var'], p[f'{name}.weight'],
                        p[f'{name}.bias'], training=False, eps=BN_EPS)


def forward(p, images, stage_sizes=(3, 4, 6, 3), conv=F.conv2d):
    """(B, H, W, 3) images in [0, 255] -> (B, H, W, classes) logits."""
    dt = p['decode_head.conv_seg.weight'].dtype
    mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=dt, device=images.device)
    x = ((images.to(dt) / 255.0 - mean) / std).permute(0, 3, 1, 2)
    for i, (_, _, s) in enumerate(STEM):
        x = conv(x, p[f'backbone.stem.{3 * i}.weight'], None, s, 1)
        x = F.relu(_bn(x, p, f'backbone.stem.{3 * i + 1}'))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for si, n in enumerate(stage_sizes):
        d = DILATIONS[si]
        for b in range(n):
            pre = f'backbone.layer{si + 1}.{b}'
            s = STRIDES[si] if b == 0 else 1
            y = F.relu(_bn(conv(x, p[f'{pre}.conv1.weight']), p,
                           f'{pre}.bn1'))
            y = F.relu(_bn(conv(y, p[f'{pre}.conv2.weight'], None, s, d, d),
                           p, f'{pre}.bn2'))
            y = _bn(conv(y, p[f'{pre}.conv3.weight']), p, f'{pre}.bn3')
            if b == 0:
                x = _bn(conv(x, p[f'{pre}.downsample.0.weight'], None, s), p,
                        f'{pre}.downsample.1')
            x = F.relu(y + x)
    x = F.relu(_bn(conv(x, p['decode_head.convs.0.conv.weight'], None, 1, 1),
                   p, 'decode_head.convs.0.bn'))
    x = conv(x, p['decode_head.conv_seg.weight'],
             p['decode_head.conv_seg.bias'])
    x = F.interpolate(x, size=tuple(images.shape[1:3]), mode='bilinear',
                      align_corners=False)
    return x.permute(0, 2, 3, 1)
