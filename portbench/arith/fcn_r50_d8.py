"""Forward FLOPs of the FCN-R50-D8 semantic segmentation model, from the
published layer table at a given image size.

The network (mmsegmentation configs/_base_/models/fcn_r50-d8.py with
ResNetV1c): a deep stem of three 3x3 convolutions (3->32 stride 2,
32->32, 32->64), a 3x3 max pool of stride 2, then four stages of
bottlenecks (1x1 reduce, 3x3, 1x1 expand by 4; the first block of each
stage has a 1x1 projection shortcut) with 3, 4, 6 and 3 blocks of widths
64, 128, 256 and 512; stage 2 strides by 2, stages 3 and 4 are dilated
(2, 4) at stride 1, so the output stride is 8. The decode head as the
port has it: one 3x3 convolution 2048->512 and a 1x1 classifier to 19
classes (mmsegmentation's FCNHead has two 3x3 convolutions and concats
the input; the port's head has one and no concat, so these counts follow
the port's head: the configuration file lists that under ``assumed``).

A multiply-add counts 2 FLOPs; a bias adds one FLOP per output element
(only the classifier has one). Batch norms, ReLUs, the pool, the
residual adds and the bilinear upsample are not counted: they are
elementwise and under 1% of the total.
"""
from __future__ import annotations

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 1, 1)
EXPANSION = 4
HEAD_CHANNELS = 512
NUM_CLASSES = 19


def _out(n, k, s, p, d=1):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_layers(h: int, w: int, stage_blocks=STAGE_BLOCKS,
                num_classes: int = NUM_CLASSES):
    """[(name, c_in, c_out, k, out_h, out_w, bias)] of every convolution
    of one forward at image size (h, w)."""
    layers = []

    def conv(name, cin, cout, k, s, p, d=1, bias=False):
        nonlocal h, w
        h, w = _out(h, k, s, p, d), _out(w, k, s, p, d)
        layers.append((name, cin, cout, k, h, w, bias))

    conv('stem.0', 3, 32, 3, 2, 1)
    conv('stem.3', 32, 32, 3, 1, 1)
    conv('stem.6', 32, 64, 3, 1, 1)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)          # max pool
    cin = 64
    dilation = (1, 1, 2, 4)
    for si, (nb, width, stride) in enumerate(zip(stage_blocks, STAGE_WIDTHS,
                                                 STAGE_STRIDES)):
        d = dilation[si]
        for b in range(nb):
            s = stride if b == 0 else 1
            name = f'layer{si + 1}.{b}'
            h_in, w_in = h, w
            conv(name + '.conv1', cin, width, 1, 1, 0)
            conv(name + '.conv2', width, width, 3, s, d, d)
            conv(name + '.conv3', width, width * EXPANSION, 1, 1, 0)
            if b == 0:
                ho, wo = h, w
                h, w = h_in, w_in
                conv(name + '.downsample', cin, width * EXPANSION, 1, s, 0)
                h, w = ho, wo
            cin = width * EXPANSION
    conv('head.convs.0', cin, HEAD_CHANNELS, 3, 1, 1)
    conv('head.conv_seg', HEAD_CHANNELS, num_classes, 1, 1, 0, bias=True)
    return layers


def forward_flops(h: int, w: int, stage_blocks=STAGE_BLOCKS,
                  num_classes: int = NUM_CLASSES) -> int:
    """Forward FLOPs of one (h, w) image."""
    total = 0
    for _, cin, cout, k, oh, ow, bias in conv_layers(h, w, stage_blocks,
                                                     num_classes):
        total += 2 * cin * k * k * cout * oh * ow + (cout * oh * ow
                                                     if bias else 0)
    return total
