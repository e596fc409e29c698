"""The batch-norm epilogue (ops/bn_epilogue.py) and the semseg model's
inference route through it, on the CPU (the plain version; the CUDA
kernel is held to it on the card by chip_smoke.py's bn_epilogue phase).

Each variant is held to the chain the model runs off the route: ``_BN``
in eval mode on the bf16 convolution output (a float32 copy, the float32
batch norm), then ``+ residual`` and ``F.relu`` in float32, then the cast
to bf16. float32 outputs agree to float32 rounding (the affine is folded
into a scale and a shift: a few ulp); a bf16 output may round the other
way where the float32 values straddle a bf16 midpoint, so it is held to
one bf16 step (at most 2^-7 of the value) and equal elsewhere.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    _BN, ResNet50DilatedFCN, init_params)
from pc_accumulation_lib_tpu_torch.ops.bn_epilogue import (
    bn_epilogue, bn_epilogue_reference)
from pc_accumulation_lib_tpu_torch.utils import profiling

CL = torch.channels_last
F32_RTOL, F32_ATOL = 4e-6, 1e-6
BF16_STEP = 2.0 ** -7          # a bf16 step at most, relative to the value
BF16_EQUAL_SHARE = 0.99        # elements whose bf16 rounding agrees
# The model's route against the float32 chain, on a reduced-depth model:
# bf16 rounding flips inside the network carry through later
# convolutions, so logits differ by a few bf16 steps of their scale.
MODEL_ATOL, MODEL_ARGMAX = 1e-2, 0.99

VARIANTS = {
    # name: (residual, relu, bf16_out, f32_out)
    'relu_bf16': (False, True, True, False),        # conv1, conv2, stem
    'relu_f32': (False, True, False, True),         # the head
    'affine_f32': (False, False, False, True),      # the downsample
    'affine_bf16': (False, False, True, False),
    'affine_both': (False, False, True, True),
    'residual_relu_bf16': (True, True, True, False),  # conv3, stage end
    'residual_relu_f32': (True, True, False, True),
    'residual_relu_both': (True, True, True, True),   # conv3, mid-stage
}


def _bn(C, rng):
    """An eval-mode _BN with non-trivial statistics and affine."""
    bn = _BN(C).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, C)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.2, 3.0, C)))
    return bn


def _inputs(rng, shape=(2, 24, 5, 7)):
    x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
    res = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return (x.to(torch.bfloat16).contiguous(memory_format=CL),
            res.contiguous(memory_format=CL))


def _chain(bn, x, residual, relu):
    """The model's chain off the epilogue route, in float32."""
    y = bn(x)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def _args(bn):
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_epilogue_matches_the_float32_chain(variant):
    use_res, relu, bf16_out, f32_out = VARIANTS[variant]
    rng = np.random.default_rng(sorted(VARIANTS).index(variant))
    x, res = _inputs(rng)
    bn = _bn(x.shape[1], rng)
    residual = res if use_res else None
    with torch.no_grad():
        want = _chain(bn, x, residual, relu)
        got_b, got_f = bn_epilogue(x, *_args(bn), residual=residual,
                                   relu=relu, bf16_out=bf16_out,
                                   f32_out=f32_out)
    assert (got_b is None) != bf16_out and (got_f is None) != f32_out
    if f32_out:
        assert got_f.dtype == torch.float32 and got_f.shape == x.shape
        assert got_f.is_contiguous(memory_format=CL)
        torch.testing.assert_close(got_f, want, rtol=F32_RTOL,
                                   atol=F32_ATOL)
    if bf16_out:
        assert got_b.dtype == torch.bfloat16 and got_b.shape == x.shape
        assert got_b.is_contiguous(memory_format=CL)
        got, ref = got_b.float(), want.to(torch.bfloat16).float()
        assert torch.all((got - ref).abs()
                         <= BF16_STEP * want.abs() + F32_ATOL)
        assert (got == ref).float().mean() >= BF16_EQUAL_SHARE
    if relu:
        for out in (got_b, got_f):
            assert out is None or out.min() >= 0
    if bf16_out and f32_out:   # both outputs are one computation
        assert torch.equal(got_b, got_f.to(torch.bfloat16))


def test_epilogue_keeps_nan_through_relu():
    rng = np.random.default_rng(7)
    x, _ = _inputs(rng, (1, 8, 2, 2))
    x[0, 3, 1, 1] = float('nan')
    bn = _bn(8, rng)
    got = bn_epilogue(x, *_args(bn), relu=True, bf16_out=False,
                      f32_out=True)[1]
    want = _chain(bn, x, None, True).detach()
    assert torch.isnan(got[0, 3, 1, 1]) and torch.isnan(want[0, 3, 1, 1])
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def _bad_cases():
    rng = np.random.default_rng(3)
    x, res = _inputs(rng)
    bn = _bn(x.shape[1], rng)
    params = _args(bn)[:4]
    return {
        'not_channels_last': (x.contiguous(), params, {}),
        'float32_input': (x.float(), params, {}),
        'float16_input': (x.half(), params, {}),
        '3d_input': (x[0], params, {}),
        'bf16_residual': (x, params, dict(residual=res.to(torch.bfloat16))),
        'residual_not_channels_last': (x, params,
                                       dict(residual=res.contiguous())),
        'residual_shape': (x, params, dict(residual=res[:1])),
        'param_length': (x, (params[0][:-1],) + params[1:], {}),
        'param_dtype': (x, (params[0].double(),) + params[1:], {}),
        'no_output': (x, params, dict(bf16_out=False, f32_out=False)),
    }


@pytest.mark.parametrize('case', sorted(_bad_cases()))
@pytest.mark.parametrize('fn', [bn_epilogue, bn_epilogue_reference])
def test_epilogue_raises_on_what_it_does_not_take(case, fn):
    x, params, kw = _bad_cases()[case]
    with pytest.raises(ValueError, match='bn_epilogue'):
        fn(x, *params, 1e-5, **kw)


def _model(stage_sizes=(1, 1, 1, 1), dtype=torch.bfloat16):
    """A seeded model with random batch-norm statistics and affines."""
    model = ResNet50DilatedFCN(stage_sizes=stage_sizes, compute_dtype=dtype)
    init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                fresh = _bn(m.num_features, rng)
                m.load_state_dict(fresh.state_dict())
    return model.eval()


def _n_bn(model):
    return sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def _images(shape=(2, 48, 80)):
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, 256, (*shape, 3)).astype(
        np.float32))


def _counted(fn):
    """(fn's result, the semseg.bn_epilogues count it made)."""
    with profiling.enable():
        before = profiling.snapshot()['counters'].get(
            'semseg.bn_epilogues', 0)
        out = fn()
        after = profiling.snapshot()['counters'].get(
            'semseg.bn_epilogues', 0)
    return out, after - before


def test_inference_route_matches_the_float32_chain():
    model, img = _model(), _images()
    with torch.enable_grad():          # eval mode, grad on: the chain
        want, n_chain = _counted(lambda: model(img).detach())
    with torch.no_grad():              # eval mode, grad off: the epilogue
        got, n_route = _counted(lambda: model(img))
    assert n_chain == 0 and n_route == _n_bn(model) == 20
    assert got.shape == want.shape == (2, 48, 80, 19)
    torch.testing.assert_close(got, want, rtol=0, atol=MODEL_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= MODEL_ARGMAX


def test_full_depth_forward_counts_56_epilogues():
    model, img = _model(stage_sizes=(3, 4, 6, 3)), _images((1, 16, 16))
    with torch.no_grad():
        out, n = _counted(lambda: (model(img), model(img)))
    assert _n_bn(model) == 56 and n == 2 * 56
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_counter_is_silent_while_tracing_is_off():
    model, img = _model(), _images((1, 16, 16))
    profiling.reset()
    with torch.no_grad():
        model(img)
    assert 'semseg.bn_epilogues' not in profiling.snapshot()['counters']


@pytest.mark.parametrize('route', ['train_step', 'train_mode_no_grad',
                                   'eval_enable_grad', 'float32_model'])
def test_other_routes_run_no_epilogue(route):
    """Training, grad and a float32 model keep the modules' own forwards:
    no epilogue is counted."""
    model = _model(dtype=torch.float32 if route == 'float32_model'
                   else torch.bfloat16)
    img = _images((2, 32, 48))

    def run():
        if route == 'train_step':
            model.train()
            loss = model(img).float().square().mean()
            loss.backward()
            return loss.detach()
        if route == 'train_mode_no_grad':
            model.train()
            with torch.no_grad():
                return model(img)
        if route == 'eval_enable_grad':
            with torch.enable_grad():
                return model(img).detach()
        with torch.no_grad():
            return model(img)

    _, n = _counted(run)
    assert n == 0
    assert route != 'train_step' or all(
        p.grad is not None for p in model.parameters())
