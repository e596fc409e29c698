"""ResNet-50 dilated FCN semantic segmentation model (nn.Module).

Counterpart of models/resnet_semseg.py: dilated ResNet-50 v1c backbone
(deep stem, output stride 8: stage 3 dilation 2, stage 4 dilation 4), FCN
head 3x3x512 + 1x1 classifier, bilinear upsample to the input size.
Public contract as in the JAX package: NHWC images in [0,255] in, NHWC
float32 logits out. Module names give the mmsegmentation state-dict names
(backbone.stem.0.weight, backbone.layer1.0.conv1.weight, ...,
decode_head.convs.0.conv.weight, decode_head.conv_seg.weight), which is
what pc_accumulation_lib_tpu.models.onnx_port.export_named_tensors emits.

``compute_dtype`` sets the convolution precision (bfloat16 on the GPU);
batch norms, ReLUs, residual adds and the classifier run in float32, as
the JAX model does. Weights stay float32, so their gradients are float32
too (models/train.py).

Inference of a bfloat16 model (eval mode, grad disabled, no model axis:
all observable in the forward) takes the batch-norm epilogue route: after
each convolution one ops/bn_epilogue pass computes the batch norm, the
residual add and the ReLU in float32 and writes bf16 where only a
convolution reads the result, float32 where a residual add or the
classifier does, or both. The precision is the same as on the other
route; only the float32 order of the affine differs. Training, the
tensor-parallel forward, anything under enable_grad and a float32 model
run the modules' forwards as written (``_BN``'s flax statistics
included). Each epilogue counts ``semseg.bn_epilogues`` while tracing is
on (utils/profiling.py): 56 a forward of the full-depth model.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pc_accumulation_lib_tpu_torch.ops.bn_epilogue import bn_epilogue
from pc_accumulation_lib_tpu_torch.parallel import tensor_parallel as tp
from pc_accumulation_lib_tpu_torch.utils import profiling

NUM_CLASSES = 19
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _Conv(nn.Conv2d):
    """Conv2d whose forward casts input and weight to a compute dtype."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class _BN(nn.BatchNorm2d):
    """Batch norm in its parameters' dtype (float32), with flax's
    train-mode statistics.

    Eval mode normalizes with the running statistics. Train mode
    normalizes with the batch's mean and biased variance and updates the
    running ones as flax's BatchNorm(momentum=0.9) does: r = 0.9 r + 0.1
    batch, with the biased variance also for ``running_var`` (torch's own
    train mode stores the unbiased n/(n-1) one). Torch's momentum 0.1 is
    flax's 0.9.

    ``data_axis``: None, or (mesh, axis name) of a data-parallel mesh
    (models/train.py sets it). Train mode then takes the statistics of
    the whole batch over the axis's ranks, as the JAX trainer's batch
    norms do under a batch laid out on P('data'): the sum, then the sum of
    squared deviations from the global mean (two passes: E[x^2] - E[x]^2
    cancels on channels whose mean dwarfs their spread), each summed over
    the axis with a gradient that flows back to every rank."""

    data_axis = None

    def forward(self, x):
        x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        if self.data_axis is not None:
            return self._global_batch_norm(x, *self.data_axis)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)

    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _global_batch_norm(self, x, mesh, axis):
        from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh
        n = x.numel() // x.shape[1] * pmesh.axis_size(mesh, axis)
        mean = pmesh.psum_per_rank_loss(x.sum((0, 2, 3)), mesh, axis) / n
        d = x - mean[None, :, None, None]
        var = pmesh.psum_per_rank_loss((d * d).sum((0, 2, 3)), mesh,
                                       axis) / n
        with torch.no_grad():
            self._update_running(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return d * scale[None, :, None, None] + self.bias[None, :, None, None]


def _epilogue_route(module, conv, ax) -> bool:
    """True where ``module``'s forward takes the batch-norm epilogue
    route (module docstring): eval mode, grad disabled, no model axis, and
    ``conv`` computes in bfloat16."""
    return (ax is None and not module.training
            and not torch.is_grad_enabled()
            and conv.compute_dtype == torch.bfloat16)


def _conv_bn(conv, bn, x, residual=None, relu=True, bf16=True, f32=False):
    """``conv`` then ``bn`` as one batch-norm epilogue, with the residual
    add and the ReLU: (bf16, float32) channels-last outputs, None where
    not asked for."""
    y = conv(x).contiguous(memory_format=torch.channels_last)
    profiling.count('semseg.bn_epilogues')
    return bn_epilogue(y, bn.weight, bn.bias, bn.running_mean,
                       bn.running_var, bn.eps, residual=residual, relu=relu,
                       bf16_out=bf16, f32_out=f32)


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck with optional stride/dilation. The forward's
    ``ax`` is the model's ModelAxis when it is cut, else None
    (parallel/tensor_parallel.py)."""

    def __init__(self, in_ch, features, stride, dilation, downsample, dt):
        super().__init__()
        self.conv1 = _Conv(in_ch, features, 1, bias=False, compute_dtype=dt)
        self.bn1 = _BN(features)
        self.conv2 = _Conv(features, features, 3, stride=stride,
                           padding=dilation, dilation=dilation, bias=False,
                           compute_dtype=dt)
        self.bn2 = _BN(features)
        self.conv3 = _Conv(features, features * 4, 1, bias=False,
                           compute_dtype=dt)
        self.bn3 = _BN(features * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _Conv(in_ch, features * 4, 1, stride=stride, bias=False,
                      compute_dtype=dt),
                _BN(features * 4))

    def forward(self, x, ax=None):
        full = tp.full(x, self.conv1, ax)
        into = tp.copy_in(full, ax)
        y = F.relu(self.bn1(tp.apply(self.conv1, full, into)))
        y = F.relu(self.bn2(tp.conv(self.conv2, y, ax)))
        y = self.bn3(tp.conv(self.conv3, y, ax))
        if self.downsample is None:
            # The block input as it came, on a cut model the rank's own
            # slice: slicing the gathered copy would give a gradient that
            # differs between ranks.
            residual = x
        else:
            conv, bn = self.downsample
            residual = bn(tp.apply(conv, full, into))
        return F.relu(y + residual)

    def forward_epilogue(self, xb, xf, f32_out: bool):
        """The block on the epilogue route: ``xb`` its input in bf16,
        ``xf`` in float32 (None where the downsample makes the residual).
        Returns the output in bf16 and, with ``f32_out``, in float32 (for
        the next block's residual add), else None."""
        y = _conv_bn(self.conv1, self.bn1, xb)[0]
        y = _conv_bn(self.conv2, self.bn2, y)[0]
        if self.downsample is None:
            residual = xf
        else:
            conv, bn = self.downsample
            residual = _conv_bn(conv, bn, xb, relu=False, bf16=False,
                                f32=True)[1]
        return _conv_bn(self.conv3, self.bn3, y, residual=residual,
                        f32=f32_out)


class _Backbone(nn.Module):
    def __init__(self, stage_sizes, dt):
        super().__init__()
        stem = []
        in_ch = 3
        for f, s in ((32, 2), (32, 1), (64, 1)):
            stem += [_Conv(in_ch, f, 3, stride=s, padding=1, bias=False,
                           compute_dtype=dt), _BN(f), nn.ReLU()]
            in_ch = f
        self.stem = nn.Sequential(*stem)
        in_ch = 64
        stage_cfg = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
        for si, (feats, stride, dil) in enumerate(stage_cfg):
            blocks = []
            for bi in range(stage_sizes[si]):
                blocks.append(Bottleneck(in_ch, feats,
                                         stride if bi == 0 else 1, dil,
                                         bi == 0, dt))
                in_ch = feats * 4
            setattr(self, f'layer{si + 1}', nn.Sequential(*blocks))

    def forward(self, x, ax=None):
        """The backbone's features: float32, or bf16 on the epilogue route
        (what the head's convolution reads)."""
        if _epilogue_route(self, self.stem[0], ax):
            return self._forward_epilogue(x)
        x = F.max_pool2d(self.stem(x), 3, stride=2, padding=1)
        for si in range(4):
            for block in getattr(self, f'layer{si + 1}'):
                x = block(x, ax)
        return x

    def _forward_epilogue(self, x):
        for i in range(0, len(self.stem), 3):
            x = _conv_bn(self.stem[i], self.stem[i + 1], x)[0]
        # Pooling the bf16 copy equals casting the pooled float32 one:
        # rounding is monotonic.
        xb, xf = F.max_pool2d(x, 3, stride=2, padding=1), None
        blocks = [b for si in range(4)
                  for b in getattr(self, f'layer{si + 1}')]
        for block, nxt in zip(blocks, blocks[1:] + [None]):
            xb, xf = block.forward_epilogue(
                xb, xf, f32_out=nxt is not None and nxt.downsample is None)
        return xb


class _ConvModule(nn.Module):
    def __init__(self, in_ch, out_ch, dt):
        super().__init__()
        self.conv = _Conv(in_ch, out_ch, 3, padding=1, bias=False,
                          compute_dtype=dt)
        self.bn = _BN(out_ch)

    def forward(self, x, ax=None):
        if _epilogue_route(self, self.conv, ax):
            # float32 out: the classifier computes in float32.
            return _conv_bn(self.conv, self.bn, x, bf16=False, f32=True)[1]
        return F.relu(self.bn(tp.conv(self.conv, x, ax)))


class _FCNHead(nn.Module):
    def __init__(self, num_classes, dt):
        super().__init__()
        self.convs = nn.Sequential(_ConvModule(2048, 512, dt))
        self.conv_seg = _Conv(512, num_classes, 1,
                              compute_dtype=torch.float32)

    def forward(self, x, ax=None):
        for module in self.convs:
            x = module(x, ax)
        return tp.conv(self.conv_seg, x, ax)


class ResNet50DilatedFCN(nn.Module):
    """Dilated ResNet-50 v1c backbone + FCN head, output stride 8.

    ``model_axis``: None, or the parallel/tensor_parallel.ModelAxis that
    models/train.shard_variables sets when it cuts the wide layers over a
    mesh axis; the forward is then tensor parallel
    (parallel/tensor_parallel.py). ``mesh``: None, or the ('data',
    'model') mesh that models/train.make_train_setup trains it on; the
    rank at its coordinate 0 writes its files (models/checkpoint.py).

    Inference of a bfloat16 model (eval, grad disabled, no model axis)
    runs one batch-norm epilogue (ops/bn_epilogue.py) after each
    convolution; everything else runs the modules' float32 batch norms,
    ReLUs and residual adds (module docstring)."""

    model_axis = None
    mesh = None

    def __init__(self, num_classes: int = NUM_CLASSES,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 compute_dtype=torch.float32):
        super().__init__()
        self.backbone = _Backbone(tuple(stage_sizes), compute_dtype)
        self.decode_head = _FCNHead(num_classes, compute_dtype)
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images):
        """images: (B,H,W,3) in [0,255]. Returns (B,H,W,num_classes)
        float32 logits at the input resolution."""
        x = (images.to(torch.float32) / 255.0 - self.mean) / self.std
        x = x.permute(0, 3, 1, 2)
        ax = self.model_axis
        logits = self.decode_head(self.backbone(x, ax), ax).to(torch.float32)
        logits = F.interpolate(logits, size=images.shape[1:3],
                               mode='bilinear', align_corners=False)
        return logits.permute(0, 2, 3, 1)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: conv weights N(0, 1/fan_in) (LeCun), classifier
    bias 0, batch norms at identity (scale 1, shift 0, mean 0, var 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
