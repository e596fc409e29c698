"""Segmented statistics over rows sorted by group key: the raster's stats
kernel and its plain PyTorch version.

Counterpart of ops/pallas_stats.py:segmented_stats_words (the Pallas
kernel ``_kernel_words``). The kernel is CUDA C++ for sm_90a
(csrc/segmented_stats.cu), built with nvcc at first use into
``build/torch_kernels/`` under the repository root and bound with ctypes.
A tensor on the CPU goes through the plain version; a CUDA tensor always
goes through the kernel, and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'segmented_stats.cu'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lib = None


def build_library() -> Path:
    """Compile the kernel library with nvcc unless this source's build
    exists (the file name carries a hash of the source and the flags, so
    an edit rebuilds). The compiler's report (registers, shared memory,
    spills) is kept beside it as ``.log``. Raises if nvcc is missing or
    fails."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(' '.join(_NVCC_FLAGS).encode())
    out = _BUILD_DIR / f'segmented_stats_{h.hexdigest()[:16]}.so'
    if out.exists():
        return out
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA '
                           'toolkit to build the segmented-stats kernel')
    nvcc = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, '-o', tmp, str(_SOURCE)],
                              capture_output=True, text=True)
        out.with_suffix('.log').write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.segmented_stats_words_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_inputs(sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit):
    if med_nsplit not in (1, 2) or num_groups % med_nsplit:
        raise ValueError(f'med_nsplit={med_nsplit} must be 1 or 2 and divide '
                         f'num_groups={num_groups}')
    for name, t in (('sorted_c2', sorted_c2), ('sorted_w1', sorted_w1),
                    ('sorted_w2', sorted_w2)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f'{name} must be a 1-D int32 tensor, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if t.shape != sorted_c2.shape or t.device != sorted_c2.device:
            raise ValueError(f'{name} must match sorted_c2 in shape and '
                             'device')


def segmented_stats_words(sorted_c2, sorted_w1, sorted_w2, num_groups: int,
                          med_nsplit: int = 1):
    """Per-group stats of the sorted raster rows.

    Args:
      sorted_c2: (N,) int32 group keys, ascending; keys >= num_groups
        (sentinels) are ignored.
      sorted_w1/sorted_w2: (N,) int32 payload words in the layout of
        ops/sort_raster.pack_payload_words, in the same order.
      num_groups: group count G.
      med_nsplit: 2 when groups interleave present/future, which adds the
        pair ('full') medians at even positions.

    Returns (sums (G,4) [count, road, dyn, intensity], zmin (G,), meds
    (3,2,G)), float32. Empty groups: sums 0, zmin +inf, medians 0.
    """
    _check_inputs(sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit)
    dev = sorted_c2.device
    if dev.type == 'cpu':
        return segmented_stats_words_reference(sorted_c2, sorted_w1,
                                               sorted_w2, num_groups,
                                               med_nsplit)
    if dev.type != 'cuda':
        raise ValueError(f'segmented_stats_words: unsupported device {dev}')
    c2, w1, w2 = (t.contiguous() for t in (sorted_c2, sorted_w1, sorted_w2))
    lib = load_library()
    q = torch.arange(num_groups + 1, device=dev, dtype=torch.int32)
    bounds = torch.searchsorted(c2, q, out_int32=True)
    sums = torch.empty((num_groups, 4), device=dev, dtype=torch.float32)
    zmin = torch.empty((num_groups,), device=dev, dtype=torch.float32)
    meds = torch.empty((3, 2, num_groups), device=dev, dtype=torch.float32)
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(dev):
        rc = lib.segmented_stats_words_launch(
            bounds.data_ptr(), w1.data_ptr(), w2.data_ptr(), num_groups,
            med_nsplit, sums.data_ptr(), zmin.data_ptr(), meds.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'segmented_stats kernel launch failed: CUDA '
                           f'error {rc}')
    segmented_stats_words.launches += 1
    return sums, zmin, meds


segmented_stats_words.launches = 0   # kernel launches (CUDA inputs only)


def _decode_z(w2):
    """float16 bits in w2's high half -> float32 (exact)."""
    bits = (w2 >> 16) & 0xFFFF
    signed = bits - ((bits >> 15) << 16)        # u16 -> i16 two's complement
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def _group_medians(keys, vals, lens):
    """Exact median of each group's u8 values: sort (key*256 + value) and
    read the order statistics (n-1)//2 and n//2 at each group's offset.
    ``lens`` (G,) int64 group sizes of the (ascending) keys. Empty
    groups -> 0."""
    if keys.numel() == 0:
        return torch.zeros(lens.shape, dtype=torch.float32,
                           device=lens.device)
    packed = torch.sort(keys.to(torch.int64) * 256 + vals).values
    starts = torch.cumsum(lens, 0) - lens
    last = packed.numel() - 1
    p1 = (starts + torch.div(lens - 1, 2, rounding_mode='floor')).clamp(0, last)
    p2 = (starts + lens // 2).clamp(0, last)
    med = 0.5 * ((packed[p1] % 256).to(torch.float32)
                 + (packed[p2] % 256).to(torch.float32))
    return torch.where(lens > 0, med, torch.zeros_like(med))


def segmented_stats_words_reference(sorted_c2, sorted_w1, sorted_w2,
                                    num_groups: int, med_nsplit: int = 1):
    """Plain PyTorch version of segmented_stats_words (same contract,
    exact): index_add_ sums over integer payloads, scatter_reduce('amin')
    for the z-min, and sorted (key*256 + value) order statistics for the
    medians. Rows need not be sorted."""
    _check_inputs(sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit)
    dev = sorted_c2.device
    keep = (sorted_c2 >= 0) & (sorted_c2 < num_groups)
    keys = torch.where(keep, sorted_c2, num_groups).to(torch.int64)
    w1, w2 = sorted_w1, sorted_w2
    G1 = num_groups + 1                          # slot G takes sentinels
    ints = torch.stack([torch.ones_like(w1), (w1 >> 25) & 1, (w1 >> 24) & 1,
                        w2 & 0xFFFF], dim=1).to(torch.int64)
    isum = torch.zeros((G1, 4), dtype=torch.int64, device=dev)
    isum.index_add_(0, keys, ints)
    isum = isum[:num_groups]
    sums = isum[:, :3].to(torch.float32)
    inten = (isum[:, 3].to(torch.float64) * (1.0 / 65535.0)).to(torch.float32)
    sums = torch.cat([sums, inten[:, None]], dim=1)
    zmin = torch.full((G1,), float('inf'), dtype=torch.float32, device=dev)
    zmin.scatter_reduce_(0, keys, _decode_z(w2), reduce='amin')
    zmin = zmin[:num_groups]

    lens = isum[:, 0]
    kk = keys[keep]
    meds = torch.zeros((3, 2, num_groups), dtype=torch.float32, device=dev)
    for c, shift in enumerate((16, 8, 0)):
        vals = ((w1[keep] >> shift) & 255).to(torch.int64)
        meds[c, 0] = _group_medians(kk, vals, lens)
        if med_nsplit == 2:
            pair_lens = lens.view(-1, 2).sum(1)
            meds[c, 1, 0::2] = _group_medians(
                torch.div(kk, 2, rounding_mode='floor'), vals, pair_lens)
    return sums, zmin, meds
