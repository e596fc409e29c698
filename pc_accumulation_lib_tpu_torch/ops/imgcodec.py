"""YUV 4:2:0 wire codecs for the host -> device camera-image upload.

Counterpart of ops/imgcodec.py. Two wires beside uint8 RGB ('rgb8',
3 B/pixel):

  * 'yuv420': BT.601 full-range luma at full resolution plus U, V as 2x2
    box means, 1.5 B/pixel;
  * 'yuv420h': luma as a 2x2 integer Haar transform (the mean at uint8,
    the three details quantized to 4 bits and packed two per byte) and
    chroma as 4x4 box means, 0.75 B/pixel.

The host encoders run in C++ (``native/imgenc.cpp``, built with g++ at
first use into ``build/host/``, utils/native.py) through ctypes, which
releases the GIL for the call: the encode runs on the upload worker
thread. The integer numpy encoders (8.8 fixed point) are their
specification, bit-identical to the JAX package's; the native code
matches them bit for bit. There is no numpy fallback: a failed build
raises. The decoders are
torch ops that run on the device at the head of the accumulators' frame
step: nearest chroma upsample (repeat-interleave), the Haar inverse for
'yuv420h', three multiply-adds per pixel, then a clamp to [0, 255]. They
compute the JAX decode's formula in its order, so on the CPU they agree
with it exactly; grayscale roundtrips 'yuv420' bit-exactly.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.utils import native

# Inverse BT.601 full range: R = Y + 1.402 V', G = Y - 0.344136 U' -
# 0.714136 V', B = Y + 1.772 U' (U' = U - 128, V' = V - 128).
_VR = 1.402
_UG = 0.344136
_VG = 0.714136
_UB = 1.772

_HQ_SHIFT = 4   # Haar detail quantizer step = 1 << _HQ_SHIFT (2x scale)

WIRES = ('yuv420', 'yuv420h')

_SOURCE = native.SOURCE_DIR / 'imgenc.cpp'
_LIBRARY = native.BUILD_DIR / 'libimgenc.so'
_lock = threading.Lock()
_lib = None


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the encoder once per process. A
    ctypes.CDLL call releases the GIL for its duration."""
    global _lib
    if _lib is not None:      # lock-free: runs per frame on upload threads
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_shared_library(_SOURCE,
                                                              _LIBRARY)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.imgenc_yuv420.argtypes = [p, ctypes.c_long, i, i, p, p]
            lib.imgenc_yuv420.restype = i
            lib.imgenc_yuv420h.argtypes = [p, ctypes.c_long, i, i, p, p, p]
            lib.imgenc_yuv420h.restype = i
            _lib = lib
    return _lib


def _yuv16(rgb: np.ndarray):
    """8.8 fixed-point Y, U, V (int32) of an RGB uint8 array."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return (77 * r + 150 * g + 29 * b,
            -43 * r - 85 * g + 128 * b + (128 << 8),
            128 * r - 107 * g - 21 * b + (128 << 8))


def _box_chroma(u16, v16, k: int, shift: int) -> np.ndarray:
    """k x k box means of the 8.8 chroma planes, rounded, as uint8
    (..., H/k, W/k, 2)."""
    h, w = u16.shape[-2], u16.shape[-1]
    sh = u16.shape[:-2] + (h // k, k, w // k, k)
    bias = 1 << (shift - 1)
    planes = [(p.reshape(sh).sum(axis=(-3, -1)) + bias) >> shift
              for p in (u16, v16)]
    return np.clip(np.stack(planes, axis=-1), 0, 255).astype(np.uint8)


def encode_yuv420_np(rgb: np.ndarray):
    """RGB uint8 (..., H, W, 3) -> (y uint8 (..., H, W), uv uint8
    (..., H/2, W/2, 2)). H and W must be even."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[-3], rgb.shape[-2]
    if h % 2 or w % 2:
        raise ValueError(f'yuv420 needs even image dims, got {h}x{w}')
    y16, u16, v16 = _yuv16(rgb)
    y8 = ((y16 + 128) >> 8).astype(np.uint8)
    return y8, _box_chroma(u16, v16, 2, 10)


def encode_yuv420h_np(rgb: np.ndarray):
    """RGB uint8 (..., H, W, 3) -> (ll uint8 (..., H/2, W/2), det uint8
    (..., 3, H/2, W/4): the horizontal, vertical and diagonal Haar details
    quantized to [-8, 7], biased by 8 and packed [even column << 4 | odd
    column], uv uint8 (..., H/4, W/4, 2)). H and W must be multiples of
    4."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[-3], rgb.shape[-2]
    if h % 4 or w % 4:
        raise ValueError(f'yuv420h needs H,W % 4 == 0, got {h}x{w}')
    y16, u16, v16 = _yuv16(rgb)
    y8 = (y16 + 128) >> 8
    blk = y8.reshape(y8.shape[:-2] + (h // 2, 2, w // 2, 2))
    y00, y01 = blk[..., 0, :, 0], blk[..., 0, :, 1]
    y10, y11 = blk[..., 1, :, 0], blk[..., 1, :, 1]
    ll = ((y00 + y01 + y10 + y11 + 2) >> 2).astype(np.uint8)
    d = np.stack([y00 + y10 - y01 - y11,          # left - right
                  y00 + y01 - y10 - y11,          # top - bottom
                  y00 - y01 - y10 + y11], axis=-3)  # diagonal
    q = np.clip((d + (1 << (_HQ_SHIFT - 1))) >> _HQ_SHIFT, -8, 7) + 8
    det = ((q[..., 0::2] << 4) | q[..., 1::2]).astype(np.uint8)
    return ll, det, _box_chroma(u16, v16, 4, 12)


# Each wire's block side and the spec's words when a dim is not a multiple.
_BLOCK = {'yuv420': (2, 'even image dims'), 'yuv420h': (4, 'H,W % 4 == 0')}


def _native_input(rgb, kind: str):
    """The (n, H, W, 3) C-contiguous uint8 stack the native encoder reads,
    its leading shape, H and W. Refuses what the spec refuses (dims not
    multiples of the wire's block, with its ValueError) and any dtype but
    uint8 (TypeError)."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[-3], rgb.shape[-2]
    k, rule = _BLOCK[kind]
    if h % k or w % k:
        raise ValueError(f'{kind} needs {rule}, got {h}x{w}')
    if rgb.dtype != np.uint8:
        raise TypeError(f'{kind} encodes uint8 RGB, got {rgb.dtype}')
    lead = rgb.shape[:-3]
    n = int(np.prod(lead, dtype=np.int64))
    # Channels past the third are not read, as in the spec.
    return np.ascontiguousarray(rgb[..., :3]).reshape(n, h, w, 3), lead, h, w


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{fn} failed (rc={rc})')


def encode_yuv420(rgb: np.ndarray):
    """encode_yuv420_np in native code: RGB uint8 (..., H, W, >=3) ->
    (y (..., H, W), uv (..., H/2, W/2, 2)), bit-identical."""
    src, lead, h, w = _native_input(rgb, 'yuv420')
    lib = load_library()
    y = np.empty((src.shape[0], h, w), np.uint8)
    uv = np.empty((src.shape[0], h // 2, w // 2, 2), np.uint8)
    _check(lib.imgenc_yuv420(src.ctypes.data, src.shape[0], h, w,
                             y.ctypes.data, uv.ctypes.data), 'imgenc_yuv420')
    return y.reshape(lead + y.shape[1:]), uv.reshape(lead + uv.shape[1:])


def encode_yuv420h(rgb: np.ndarray):
    """encode_yuv420h_np in native code: RGB uint8 (..., H, W, >=3) ->
    (ll (..., H/2, W/2), det (..., 3, H/2, W/4), uv (..., H/4, W/4, 2)),
    bit-identical."""
    src, lead, h, w = _native_input(rgb, 'yuv420h')
    lib = load_library()
    n = src.shape[0]
    ll = np.empty((n, h // 2, w // 2), np.uint8)
    det = np.empty((n, 3, h // 2, w // 4), np.uint8)
    uv = np.empty((n, h // 4, w // 4, 2), np.uint8)
    _check(lib.imgenc_yuv420h(src.ctypes.data, n, h, w, ll.ctypes.data,
                              det.ctypes.data, uv.ctypes.data),
           'imgenc_yuv420h')
    return tuple(a.reshape(lead + a.shape[1:]) for a in (ll, det, uv))


def encode_wire(rgb: np.ndarray, kind: str):
    """Encode an RGB uint8 stack for the wire ``kind`` (native encoder):
    'yuv420' gives (y, uv), 'yuv420h' (ll, det, uv); decode_wire tells
    them apart by the tuple's length."""
    if kind == 'yuv420':
        return encode_yuv420(rgb)
    if kind == 'yuv420h':
        return encode_yuv420h(rgb)
    raise ValueError(f'unknown image wire encoding {kind!r}')


def _upsample(plane: torch.Tensor, k: int) -> torch.Tensor:
    """Nearest k x k upsample of (..., h, w)."""
    return plane.repeat_interleave(k, dim=-1).repeat_interleave(k, dim=-2)


def _yuv_to_rgb(y: torch.Tensor, uv: torch.Tensor, k: int) -> torch.Tensor:
    u = _upsample(uv[..., 0].to(torch.float32) - 128.0, k)
    v = _upsample(uv[..., 1].to(torch.float32) - 128.0, k)
    r = y + _VR * v
    g = y - _UG * u - _VG * v
    b = y + _UB * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def decode_yuv420(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(y, uv) uint8 -> RGB float32 (..., H, W, 3) in [0, 255], on their
    device: the image input of the frame step."""
    return _yuv_to_rgb(y.to(torch.float32), uv, 2)


def decode_yuv420h(ll: torch.Tensor, det: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """(ll, det, uv) uint8 -> RGB float32 (..., H, W, 3) in [0, 255]."""
    h2, w2 = ll.shape[-2], ll.shape[-1]
    llf = ll.to(torch.float32)
    di = det.to(torch.int32)
    nib = torch.stack([(di >> 4) & 15, di & 15], dim=-1)
    d = ((nib.reshape(det.shape[:-1] + (w2,)) - 8).to(torch.float32)
         * float(1 << _HQ_SHIFT))
    dh, dv, dd = d[..., 0, :, :], d[..., 1, :, :], d[..., 2, :, :]
    q00 = llf + 0.25 * (dh + dv + dd)
    q01 = llf + 0.25 * (-dh + dv - dd)
    q10 = llf + 0.25 * (dh - dv - dd)
    q11 = llf + 0.25 * (-dh - dv + dd)
    # (..., h2, 2 rows, w2, 2 cols) -> (..., 2 h2, 2 w2)
    blk = torch.stack([torch.stack([q00, q01], dim=-1),
                       torch.stack([q10, q11], dim=-1)], dim=-3)
    y = blk.reshape(ll.shape[:-2] + (2 * h2, 2 * w2)).clamp(0.0, 255.0)
    return _yuv_to_rgb(y, uv, 4)


def decode_wire(parts) -> torch.Tensor:
    """Decode an encode_wire tuple (on the device) -> RGB float32."""
    if len(parts) == 2:
        return decode_yuv420(*parts)
    if len(parts) == 3:
        return decode_yuv420h(*parts)
    raise ValueError(f'unknown image wire tuple of arity {len(parts)}')
