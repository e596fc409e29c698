"""Batch-norm epilogue of a bf16 convolution, in inference: the batch
norm's affine, an optional float32 residual add and an optional ReLU in
float32, in one pass, written as bf16, float32 or both.

The semseg model (models/resnet_semseg.py) runs it after each bfloat16
convolution on its inference route. It replaces no TPU kernel: the JAX
package leaves these operations to XLA, which fuses them on the TPU. One
CUDA C++ kernel for sm_90a (csrc/bn_epilogue.cu, which says what bounds
it), built with nvcc at first use into ``build/torch_kernels/`` under the
repository root and bound with ctypes. A tensor on the CPU goes through
the plain version; a CUDA tensor always goes through the kernel, one
launch per call, and a failed build or launch raises.
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import torch

from pc_accumulation_lib_tpu_torch.utils import native

_SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'bn_epilogue.cu'
MAX_CHANNELS = 6144   # scale and shift in the kernel's 48 KB of shared memory

_lib = None


def build_library() -> Path:
    """Build the kernel library (utils/native.build_cuda_library)."""
    return native.build_cuda_library(_SOURCE)


def load_library():
    """Build (if needed) and load the kernel library once per process.
    Loaded as a ``PyDLL``: a launch keeps the GIL (it only enqueues), so
    the semseg forward's dispatch thread does not give the GIL to the
    upload and drain threads 56 times a forward and wait to take it
    back."""
    global _lib
    if _lib is None:
        lib = ctypes.PyDLL(str(build_library()))
        ptr = ctypes.c_void_p
        fn = lib.bn_epilogue_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_float, ptr, ptr,
                       ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_PARAMS = ('weight', 'bias', 'running_mean', 'running_var')


def _check(x, params, residual, bf16_out, f32_out):
    if not (bf16_out or f32_out):
        raise ValueError('bn_epilogue: ask for a bf16 or a float32 output')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'bn_epilogue: unsupported device {x.device}')
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f'bn_epilogue: x must be a 4-D bfloat16 tensor, '
                         f'got {x.dtype} {tuple(x.shape)}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f'bn_epilogue: x must be channels-last contiguous, '
                         f'got stride {x.stride()}')
    C = x.shape[1]
    for name, t in zip(_PARAMS, params):
        if (t.dtype != torch.float32 or t.shape != (C,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f'bn_epilogue: {name} must be a contiguous '
                             f'float32 ({C},) tensor on {x.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if residual is not None and (
            residual.dtype != torch.float32 or residual.shape != x.shape
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f'bn_epilogue: residual must be a channels-last '
                         f'float32 tensor of x\'s shape {tuple(x.shape)} on '
                         f'{x.device}, got {residual.dtype} '
                         f'{tuple(residual.shape)} on {residual.device}')


def _check_kernel(x, residual):
    C = x.shape[1]
    if C % 8 or C > MAX_CHANNELS:
        raise ValueError(f'bn_epilogue: on CUDA the channels must be a '
                         f'multiple of 8 up to {MAX_CHANNELS}, got {C}')
    for name, t in (('x', x), ('residual', residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f'bn_epilogue: {name} must be 16-byte aligned')


def bn_epilogue(x, weight, bias, running_mean, running_var, eps: float,
                residual=None, relu: bool = False, bf16_out: bool = True,
                f32_out: bool = False):
    """Eval-mode batch norm of a bf16 convolution output, then the
    residual add and the ReLU, in float32 in one pass.

    Args:
      x: (N, C, H, W) bfloat16, channels-last contiguous (a convolution's
        output); on CUDA C is a multiple of 8 up to MAX_CHANNELS.
      weight, bias, running_mean, running_var: (C,) float32, the batch
        norm's own tensors; scale = weight / sqrt(running_var + eps) and
        shift = bias - running_mean * scale are formed per call.
      residual: None, or (N, C, H, W) float32, channels-last, added after
        the affine.
      relu: max(y, 0) last (NaN stays NaN, as in F.relu).
      bf16_out / f32_out: which outputs to write (at least one).

    Returns (bf16 or None, float32 or None), channels-last tensors of x's
    shape on x's device. Raises ValueError on any other input.

    The semseg forward's dispatch thread calls this 56 times a frame, so
    the CUDA route keeps its host work small: no device switch when x
    lies on the current device, the raw current stream."""
    params = (weight, bias, running_mean, running_var)
    _check(x, params, residual, bf16_out, f32_out)
    if x.device.type == 'cpu':
        return _reference(x, params, eps, residual, relu, bf16_out, f32_out)
    _check_kernel(x, residual)
    # x is channels-last contiguous, so empty_like keeps its layout.
    out_b = torch.empty_like(x) if bf16_out else None
    out_f = torch.empty_like(x, dtype=torch.float32) if f32_out else None
    idx = x.device.index
    with (contextlib.nullcontext() if idx == torch.cuda.current_device()
          else torch.cuda.device(idx)):
        rc = load_library().bn_epilogue_launch(
            x.data_ptr(), *(t.data_ptr() for t in params), eps,
            None if residual is None else residual.data_ptr(),
            None if out_b is None else out_b.data_ptr(),
            None if out_f is None else out_f.data_ptr(), x.numel(),
            x.shape[1], relu, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f'bn_epilogue kernel launch failed: CUDA error '
                           f'{rc}')
    bn_epilogue.launches += 1
    return out_b, out_f


bn_epilogue.launches = 0   # kernel launches (CUDA inputs only)


def bn_epilogue_reference(x, weight, bias, running_mean, running_var,
                          eps: float, residual=None, relu: bool = False,
                          bf16_out: bool = True, f32_out: bool = False):
    """Plain PyTorch version of bn_epilogue (same contract and
    arithmetic, in float32)."""
    params = (weight, bias, running_mean, running_var)
    _check(x, params, residual, bf16_out, f32_out)
    return _reference(x, params, eps, residual, relu, bf16_out, f32_out)


def _reference(x, params, eps, residual, relu, bf16_out, f32_out):
    weight, bias, running_mean, running_var = params
    scale = weight / torch.sqrt(running_var + eps)
    shift = bias - running_mean * scale
    y = torch.addcmul(shift[:, None, None], x.to(torch.float32),
                      scale[:, None, None])
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    cl = torch.channels_last
    return (y.to(torch.bfloat16).contiguous(memory_format=cl)
            if bf16_out else None,
            y.contiguous(memory_format=cl) if f32_out else None)
