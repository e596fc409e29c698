"""The reference's semseg: the plain FCN of reference/fcn.py with the
benchmark's weights, in float32 with TF32 off, or in the control's lower
precision (fp8 convolution operands).

``judge`` runs it over one frame's camera images and reads, for each
judged run's class map of that frame, the widest gap by which the judged
class lies below the reference's best logit at any pixel, in units of
the standard deviation of the reference's logits over the frame (so that
it reads alike at any depth and size), and the share of pixels whose
class differs. That is the semseg's compared number.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import fcn

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def _fp8(t):
    """``t`` rounded to float8 e4m3 under one per-tensor scale, returned
    in bfloat16: the operand precision of an fp8 convolution."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((t / scale).to(torch.float8_e4m3fn).to(torch.bfloat16)
            * scale.to(torch.bfloat16))


def fp8_conv(x, w, bias=None, stride=1, padding=0, dilation=1):
    out = F.conv2d(_fp8(x), _fp8(w),
                   None if bias is None else bias.to(torch.bfloat16),
                   stride, padding, dilation)
    return out.to(torch.float32)


class RefSemseg:
    """``precision``: 'float32' (the reference) or 'fp8' (the control:
    fp8 operands in every convolution, one step below the configuration's
    bfloat16). ``block``: cameras per forward."""

    def __init__(self, weights, stage_sizes, device, precision='float32',
                 block=1):
        if precision not in ('float32', 'fp8'):
            raise ValueError(f'precision={precision!r}')
        self.params = {k: v.to(device, torch.float32)
                       for k, v in weights.items()}
        self.stage_sizes = tuple(stage_sizes)
        self.conv = fp8_conv if precision == 'fp8' else F.conv2d
        self.block = block

    def logits(self, images):
        return fcn.forward(self.params, images, self.stage_sizes, self.conv)

    @torch.no_grad()
    def predict(self, images):
        """(cams, H, W, 3) -> (cams, H, W) int32 class maps."""
        return torch.cat([
            torch.argmax(self.logits(images[i:i + self.block]), -1)
            .to(torch.int32) for i in range(0, images.shape[0], self.block)])

    @torch.no_grad()
    def judge(self, images, judged: dict) -> dict:
        """{name: (widest gap in logit deviations, share of pixels whose
        class differs)} of each judged (cams, H, W) class map."""
        gap = {n: None for n in judged}
        differ = {n: 0 for n in judged}
        s1 = s2 = 0.0
        for i in range(0, images.shape[0], self.block):
            logits = self.logits(images[i:i + self.block])
            s1 += float(logits.sum(dtype=torch.float64))
            s2 += float(logits.square().sum(dtype=torch.float64))
            best, lab = logits.max(-1)
            for n, theirs in judged.items():
                p = theirs[i:i + self.block].to(logits.device, torch.int64)
                g = (best - logits.gather(-1, p[..., None])[..., 0]).max()
                gap[n] = g if gap[n] is None else torch.maximum(gap[n], g)
                differ[n] += int((lab != p).sum())
            del logits, best, lab
        n_logits = images[..., 0].numel() * self.params[
            'decode_head.conv_seg.bias'].numel()
        mean = s1 / n_logits
        std = max(s2 / n_logits - mean * mean, 1e-30) ** 0.5
        return {n: (float(gap[n]) / std, differ[n] / judged[n].numel())
                for n in judged}
