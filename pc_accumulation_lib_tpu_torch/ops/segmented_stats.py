"""Segmented statistics over rows sorted by group key: the raster's stats
kernels and their plain PyTorch versions.

Counterparts of the two Pallas kernels of ops/pallas_stats.py:
``segmented_stats_words`` (kernel ``_kernel_words``: rows are the two
packed payload words) and ``segmented_stats`` (kernel ``_kernel`` through
``window_stats``: rows arrive unpacked as float32 weight, z and value
rows). Both run one CUDA C++ kernel body for sm_90a with a row loader each
(csrc/segmented_stats.cu), built with nvcc at first use into
``build/torch_kernels/`` under the repository root and bound with ctypes.
A tensor on the CPU goes through the plain version; a CUDA tensor always
goes through the kernel, one launch per call, and a failed build or
launch raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from pc_accumulation_lib_tpu_torch.utils import native

_SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'segmented_stats.cu'

_lib = None


def build_library() -> Path:
    """Build the kernel library (utils/native.build_cuda_library)."""
    return native.build_cuda_library(_SOURCE)


def load_library():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.segmented_stats_words_launch
        fn.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, ptr, ptr]
        fn.restype = i32
        fn = lib.segmented_stats_rows_launch
        fn.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, ptr, ptr]
        fn.restype = i32
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


def _device_of(keys, name):
    dev = keys.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {dev}')
    if keys.shape[0] >= 2 ** 31:
        raise ValueError(f'{name}: {keys.shape[0]} rows exceed int32')
    return dev.type


def _outputs(keys, num_groups, n_weights, n_values):
    """One float32 allocation on the keys' device and its (sums, zmin,
    meds) views, as the kernel lays them out."""
    G = num_groups
    buf = torch.empty(G * (n_weights + 1 + 2 * n_values),
                      dtype=torch.float32, device=keys.device)
    return buf, (buf[:G * n_weights].view(G, n_weights),
                 buf[G * n_weights:G * (n_weights + 1)],
                 buf[G * (n_weights + 1):].view(n_values, 2, G))


def _run(launch_fn, keys, *args):
    """Launch on the keys' device and current stream; ``args`` follow the
    keys in the C function's order, up to the output buffer."""
    dev = keys.device
    with torch.cuda.device(dev):
        rc = launch_fn(keys.data_ptr(), keys.shape[0], *args,
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'segmented_stats kernel launch failed: CUDA '
                           f'error {rc}')


def _launch_words(c2, w1, w2, num_groups, nsplit, n_values, buf):
    """Kernel 1 alone into ``buf`` (the layout of ``_outputs``)."""
    _run(load_library().segmented_stats_words_launch, c2, w1.data_ptr(),
         w2.data_ptr(), num_groups, nsplit, n_values, buf.data_ptr())


def segmented_stats_words(sorted_c2, sorted_w1, sorted_w2, num_groups: int,
                          med_nsplit: int = 1, hist_medians: bool = True):
    """Per-group stats of the sorted raster rows.

    Args:
      sorted_c2: (N,) int32 group keys, ascending; keys >= num_groups
        (sentinels) are ignored.
      sorted_w1/sorted_w2: (N,) int32 payload words in the layout of
        ops/sort_raster.pack_payload_words, in the same order.
      num_groups: group count G.
      med_nsplit: 2 when groups interleave present/future, which adds the
        pair ('full') medians at even positions.
      hist_medians: also compute the exact rgb medians; False skips the
        histograms and returns the sums and z-mins only.

    Returns (sums (G,4) [count, road, dyn, intensity], zmin (G,)[, meds
    (3,2,G) with hist_medians]), float32. Empty groups: sums 0, zmin +inf,
    medians 0. On CUDA tensors the three are views of one allocation.
    """
    _check_inputs(sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit)
    if _device_of(sorted_c2, 'segmented_stats_words') == 'cpu':
        return segmented_stats_words_reference(
            sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit,
            hist_medians)
    c2, w1, w2 = (t.contiguous() for t in (sorted_c2, sorted_w1, sorted_w2))
    n_values = 3 if hist_medians else 0
    buf, out = _outputs(c2, num_groups, 4, n_values)
    _launch_words(c2, w1, w2, num_groups, med_nsplit, n_values, buf)
    segmented_stats_words.launches += 1
    return out if hist_medians else out[:2]


segmented_stats_words.launches = 0   # kernel launches (CUDA inputs only)


def _check_rows(sorted_keys, weight_rows, z_sorted, num_groups, value_rows,
                med_nsplit):
    if len(weight_rows) > 4:
        raise ValueError(f'at most 4 summed weight rows, got '
                         f'{len(weight_rows)}')
    if len(weight_rows) + len(value_rows) > 7:
        raise ValueError(f'{len(weight_rows)} weight + {len(value_rows)} '
                         'value rows exceed the 7 payload rows')
    if med_nsplit not in (0, 1, 2):
        raise ValueError(f'med_nsplit={med_nsplit} must be 0, 1 or 2')
    if value_rows and med_nsplit == 2 and num_groups % 2:
        raise ValueError(f'med_nsplit=2 needs an even num_groups, got '
                         f'{num_groups}')
    if sorted_keys.dtype != torch.int32 or sorted_keys.dim() != 1:
        raise ValueError(f'sorted_keys must be a 1-D int32 tensor, got '
                         f'{sorted_keys.dtype} {tuple(sorted_keys.shape)}')
    for name, t in ([('z_sorted', z_sorted)]
                    + [('weight_rows', r) for r in weight_rows]
                    + [('value_rows', r) for r in value_rows]):
        if t.shape != sorted_keys.shape or t.device != sorted_keys.device:
            raise ValueError(f'{name} must match sorted_keys in shape and '
                             'device')


def _launch_rows(keys, weight_rows, z_sorted, value_rows, num_groups,
                 nsplit, buf):
    """Kernel 2 alone into ``buf`` (the layout of ``_outputs``): the rows
    are read where they lie, so each must be a contiguous float32 array."""
    for t in (*weight_rows, z_sorted, *value_rows):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('segmented_stats: on CUDA every weight, z and '
                             'value row must be a contiguous float32 '
                             f'tensor, got {t.dtype} with stride '
                             f'{t.stride()}')
    ptrs = [0] * 8
    for k, t in enumerate(weight_rows):
        ptrs[k] = t.data_ptr()
    ptrs[4] = z_sorted.data_ptr()
    for c, t in enumerate(value_rows):
        ptrs[5 + c] = t.data_ptr()
    _run(load_library().segmented_stats_rows_launch, keys,
         (ctypes.c_void_p * 8)(*ptrs), len(weight_rows), len(value_rows),
         num_groups, nsplit, buf.data_ptr())


def segmented_stats(sorted_keys, weight_rows, z_sorted, num_groups: int,
                    value_rows=(), med_nsplit: int = 1):
    """Per-group sums of each weight row, z-min and (optionally) the exact
    median of each u8-valued row, over rows sorted by group key.

    Args:
      sorted_keys: (N,) int32 group keys, ascending; keys >= num_groups
        (sentinels) are ignored.
      weight_rows: up to 4 (N,) float32 rows to sum per group; row 0 is
        the all-ones count row when ``value_rows`` is given.
      z_sorted: (N,) float32, min-reduced per group.
      value_rows: up to 3 (N,) rows of values in [0, 256), truncated to
        integers; at most 7 weight and value rows in all.
      med_nsplit: 2 when groups interleave present/future, which adds the
        pair ('full') medians at even positions; 0 or 1 leave [:, 1] at 0.

    On CUDA the kernel reads every weight, z and value row where it lies:
    each must be a contiguous float32 tensor (a ValueError otherwise).

    Returns (sums (G, len(weight_rows)), zmin (G,)[, meds
    (len(value_rows), 2, G) when value_rows is given]), float32. Sums are
    taken in float64 and rounded once. Empty groups: sums 0, zmin +inf,
    medians 0. On CUDA tensors the three are views of one allocation.
    """
    weight_rows, value_rows = list(weight_rows), list(value_rows)
    _check_rows(sorted_keys, weight_rows, z_sorted, num_groups, value_rows,
                med_nsplit)
    if _device_of(sorted_keys, 'segmented_stats') == 'cpu':
        return segmented_stats_reference(sorted_keys, weight_rows, z_sorted,
                                         num_groups, value_rows, med_nsplit)
    keys = sorted_keys.contiguous()
    nsplit = 2 if value_rows and med_nsplit == 2 else 1
    buf, out = _outputs(keys, num_groups, len(weight_rows), len(value_rows))
    _launch_rows(keys, weight_rows, z_sorted, value_rows, num_groups, nsplit,
                 buf)
    segmented_stats.launches += 1
    return out if value_rows else out[:2]


segmented_stats.launches = 0   # kernel launches (CUDA inputs only)


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


def _medians(keys, keep, value_rows, lens, med_nsplit):
    """(len(value_rows), 2, G) medians of the kept rows: [:, 0] per group,
    [:, 1] per group pair at even positions when med_nsplit is 2."""
    G = lens.shape[0]
    kk = keys[keep]
    meds = torch.zeros((len(value_rows), 2, G), dtype=torch.float32,
                       device=lens.device)
    for c, vals in enumerate(value_rows):
        vals = vals[keep].to(torch.int64)
        meds[c, 0] = _group_medians(kk, vals, lens)
        if med_nsplit == 2:
            meds[c, 1, 0::2] = _group_medians(
                torch.div(kk, 2, rounding_mode='floor'), vals,
                lens.view(-1, 2).sum(1))
    return meds


def _keys_and_keep(sorted_c2, num_groups):
    """int64 keys with out-of-range keys sent to slot num_groups, and the
    mask of in-range rows."""
    keep = (sorted_c2 >= 0) & (sorted_c2 < num_groups)
    return torch.where(keep, sorted_c2, num_groups).to(torch.int64), keep


def segmented_stats_words_reference(sorted_c2, sorted_w1, sorted_w2,
                                    num_groups: int, med_nsplit: int = 1,
                                    hist_medians: bool = True):
    """Plain PyTorch version of segmented_stats_words (same contract,
    exact): index_add_ sums over integer payloads, scatter_reduce('amin')
    for the z-min, and sorted (key*256 + value) order statistics for the
    medians. Rows need not be sorted."""
    _check_inputs(sorted_c2, sorted_w1, sorted_w2, num_groups, med_nsplit)
    dev = sorted_c2.device
    keys, keep = _keys_and_keep(sorted_c2, num_groups)
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
    if not hist_medians:
        return sums, zmin
    vals = [(w1 >> shift) & 255 for shift in (16, 8, 0)]
    return sums, zmin, _medians(keys, keep, vals, isum[:, 0], med_nsplit)


def segmented_stats_reference(sorted_keys, weight_rows, z_sorted,
                              num_groups: int, value_rows=(),
                              med_nsplit: int = 1):
    """Plain PyTorch version of segmented_stats (same contract): float64
    index_add_ sums rounded once, scatter_reduce('amin') for the z-min,
    and sorted (key*256 + value) order statistics for the medians. Rows
    need not be sorted."""
    weight_rows, value_rows = list(weight_rows), list(value_rows)
    _check_rows(sorted_keys, weight_rows, z_sorted, num_groups, value_rows,
                med_nsplit)
    dev = sorted_keys.device
    keys, keep = _keys_and_keep(sorted_keys, num_groups)
    G1 = num_groups + 1                          # slot G takes sentinels
    sums = torch.zeros((G1, len(weight_rows)), dtype=torch.float64,
                       device=dev)
    if weight_rows:
        sums.index_add_(0, keys, torch.stack(
            [r.to(torch.float64) for r in weight_rows], dim=1))
    sums = sums[:num_groups].to(torch.float32)
    zmin = torch.full((G1,), float('inf'), dtype=torch.float32, device=dev)
    zmin.scatter_reduce_(0, keys, z_sorted.to(torch.float32), reduce='amin')
    zmin = zmin[:num_groups]
    if not value_rows:
        return sums, zmin
    lens = torch.bincount(keys, minlength=G1)[:num_groups]
    vals = [v.to(torch.float32).to(torch.int64) for v in value_rows]
    return sums, zmin, _medians(keys, keep, vals, lens, med_nsplit)
