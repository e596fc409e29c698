"""The frozen arithmetic: FLOPs from the published layer table against a
count by conv hooks on the reference's own model; the stats bound; the
peaks."""
from __future__ import annotations

import pytest
import torch

from portbench.arith import fcn_r50_d8, peaks, stats_bytes
from portbench.harness.weights import fcn_weights
from portbench.reference import fcn


def _counted_flops(stages, hw):
    """FLOPs of every convolution of one forward of the reference's own
    FCN, counted at each call of its convolution."""
    flops = []

    def conv(x, w, bias=None, *a):
        out = torch.nn.functional.conv2d(x, w, bias, *a)
        flops.append(2 * w[0].numel() * out[0].numel()
                     + (out[0].numel() if bias is not None else 0))
        return out

    with torch.no_grad():
        fcn.forward(fcn_weights(0, 'cpu', stages), torch.zeros((1, *hw, 3)),
                    stages, conv)
    return sum(flops), len(flops)


@pytest.mark.parametrize('hw,stages', [((64, 96), (3, 4, 6, 3)),
                                       ((47, 130), (1, 1, 1, 1))])
def test_forward_flops_match_a_count_at_each_convolution(hw, stages):
    flops, n = _counted_flops(stages, hw)
    assert fcn_r50_d8.forward_flops(*hw, stages) == flops
    assert len(fcn_r50_d8.conv_layers(*hw, stages)) == n


def test_published_sizes():
    # 376x1408: 0.564 TFLOP; six 900x1600 cameras: 9.24 TFLOP.
    assert fcn_r50_d8.forward_flops(376, 1408) == pytest.approx(
        0.5639e12, rel=1e-3)
    assert 6 * fcn_r50_d8.forward_flops(900, 1600) == pytest.approx(
        9.242e12, rel=1e-3)


def test_stats_bound_is_the_smoke_scripts_rule():
    b = stats_bytes.words_bound(keyed_rows=800_000, groups=131_072)
    assert b['bytes'] == 800_000 * 12 + 131_072 * 4 * (4 + 1 + 6)
    assert b['ops'] == 800_000 * 8
    assert b['bound_s'] == pytest.approx(b['bytes'] / 3.35e12)
    assert b['bound_by'] == 'bytes'


def test_peaks():
    assert peaks.BF16_FLOPS == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
