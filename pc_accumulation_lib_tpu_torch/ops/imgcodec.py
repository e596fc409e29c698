"""YUV 4:2:0 wire codecs for the host -> device camera-image upload.

Counterpart of ops/imgcodec.py. Two wires beside uint8 RGB ('rgb8',
3 B/pixel):

  * 'yuv420': BT.601 full-range luma at full resolution plus U, V as 2x2
    box means, 1.5 B/pixel;
  * 'yuv420h': luma as a 2x2 integer Haar transform (the mean at uint8,
    the three details quantized to 4 bits and packed two per byte) and
    chroma as 4x4 box means, 0.75 B/pixel.

The host encoders are integer numpy (8.8 fixed point): they are the
specification, bit-identical to the JAX package's. The decoders are
torch ops that run on the device at the head of the accumulators' frame
step: nearest chroma upsample (repeat-interleave), the Haar inverse for
'yuv420h', three multiply-adds per pixel, then a clamp to [0, 255]. They
compute the JAX decode's formula in its order, so on the CPU they agree
with it exactly; grayscale roundtrips 'yuv420' bit-exactly.
"""
from __future__ import annotations

import numpy as np
import torch

# Inverse BT.601 full range: R = Y + 1.402 V', G = Y - 0.344136 U' -
# 0.714136 V', B = Y + 1.772 U' (U' = U - 128, V' = V - 128).
_VR = 1.402
_UG = 0.344136
_VG = 0.714136
_UB = 1.772

_HQ_SHIFT = 4   # Haar detail quantizer step = 1 << _HQ_SHIFT (2x scale)

WIRES = ('yuv420', 'yuv420h')


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


def encode_wire(rgb: np.ndarray, kind: str):
    """Encode an RGB uint8 stack for the wire ``kind``: 'yuv420' gives
    (y, uv), 'yuv420h' (ll, det, uv); decode_wire tells them apart by the
    tuple's length."""
    if kind == 'yuv420':
        return encode_yuv420_np(rgb)
    if kind == 'yuv420h':
        return encode_yuv420h_np(rgb)
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
