"""Fused sparse decode + warp on the host: a ctypes binding of
``native/bevdec.cpp``.

The port's copy of bev/native_decode.py. The sparse fetch ships each BEV
sample as a packed buffer (bev/core._pack_sparse) before the warp; the
harvest decodes it to the (S*7, P, P) float16 stack and applies the
sample's polynomial warp, one pass over the output pixels with the GIL
released. The dequantization table, the empty-cell constants and the warp
index maps come from the same numpy code as the spec
(core.decode_sparse_stack + ops/warp.warp_dense_maps_np), so the two agree
bit for bit.

The library is built with g++ at first use into ``build/host/`` under the
repository root (atomic rename; never into ``native/``). A failed build
raises with the compiler's output: there is no silent switch to numpy.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from pc_accumulation_lib_tpu_torch.bev import core
from pc_accumulation_lib_tpu_torch.ops import warp as warp_ops
from pc_accumulation_lib_tpu_torch.utils import native

_SOURCE = native.SOURCE_DIR / 'bevdec.cpp'
_LIBRARY = native.BUILD_DIR / 'libbevdec.so'
_lock = threading.Lock()
_lib = None


def build_library() -> Path:
    """Compile native/bevdec.cpp unless the build is newer than the
    source. Raises RuntimeError with g++'s output if it fails."""
    return native.build_shared_library(_SOURCE, _LIBRARY)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the decoder once per process."""
    global _lib
    if _lib is not None:      # lock-free: runs per sample on the harvest
        return _lib           # pool's threads
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.bevdec_decode.argtypes = [p, ctypes.c_long, i, i, i, i, i,
                                          p, p, p, p, p]
            lib.bevdec_decode.restype = i
            _lib = lib
    return _lib


def _warp_maps(P: int, w):
    """(row, column) source-index maps of warp ``w`` (identity when
    ``w`` is None or inactive), int32."""
    if w is None or not w['active']:
        ident = np.arange(P, dtype=np.int32)
        return ident, ident
    return warp_ops.warp_index_maps_np(w['a1'], w['a2'], w['b1'], w['b2'],
                                       P, P)


def decode_sparse_warp(raw: np.ndarray, gen_future: bool, pixel_size: int,
                       cap, empty_vals, w=None) -> np.ndarray:
    """core.decode_sparse_stack followed by warp_dense_maps_np (warp
    ``w``, a SemBEVGenerator warp draw), fused. The decoder's return code
    ``rc``: 0 decoded; split + 1 when that split exceeds its cap
    (SparseOverflow); -2 truncated below the used bytes
    (SparseShortFetch); -1 malformed (ValueError: shorter than the
    header, or a mask popcount that disagrees with the header). Each
    decoded buffer adds one to ``decode_sparse_warp.decoded``."""
    lib = load_library()
    P = pixel_size
    S = 3 if gen_future else 1
    caps = core.resolve_sparse_caps(cap)[:S]
    lut = core._DEQUANT_LUT.view(np.uint16)
    empty = np.asarray(list(empty_vals) + [0.0],
                       np.float16).view(np.uint16)
    row_src, col_src = _warp_maps(P, w)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty((S * 7, P, P), np.float16)
    rc = lib.bevdec_decode(
        raw.ctypes.data, raw.nbytes, P, S, int(caps[0]),
        int(caps[1]) if S == 3 else 0, int(caps[2]) if S == 3 else 0,
        lut.ctypes.data, empty.ctypes.data, row_src.ctypes.data,
        col_src.ctypes.data, out.ctypes.data)
    if rc == 0:
        with _lock:
            decode_sparse_warp.decoded += 1
        return out
    if rc > 0:
        raise core.SparseOverflow(
            f'split {rc - 1}: occupied cells > sparse cap (native decode)')
    if rc == -2:
        raise core.SparseShortFetch(
            f'truncated fetch shipped {raw.nbytes} B < used (native decode)')
    raise ValueError(f'bevdec: malformed sparse buffer (len {raw.nbytes})')


decode_sparse_warp.decoded = 0   # buffers decoded (the harvest's threads)
