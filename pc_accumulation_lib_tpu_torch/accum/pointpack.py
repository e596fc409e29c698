"""Quantized wire for the NuScenes 7-column point rows.

Counterpart of accum/pointpack.py. A row is [x, y, z (ego frame, m),
intensity (0..255), u, v (pixel), inst (first-appearance index, -1 =
none)]. Packed, column blocks one after another:

  xyz   int16 at 5 mm fixed point (+-163.84 m)   6 B
  int   uint8, rounded                             1 B
  u, v  uint16, rounded, clamped to [0, 65535]     4 B (the paint rounds
        to the nearest pixel anyway, and rows outside every image carry
        cam_idx -1)
  inst  uint16, biased by +1 (-1 packs as 0)       2 B

= 13 B/point against float32's 28. Values outside these ranges raise;
such data takes transfer_dtype='float32'.
"""
from __future__ import annotations

import numpy as np
import torch

BYTES_PER_POINT = 13


def pack_points7_np(pc: np.ndarray, n_pad: int) -> np.ndarray:
    """(N, 7) float rows -> (n_pad * 13,) uint8 wire buffer (N <= n_pad)."""
    pc = np.asarray(pc, np.float32)
    if pc.ndim != 2 or pc.shape[1] != 7:
        raise ValueError(f'expected (N,7) rows, got {pc.shape}')
    n = pc.shape[0]
    if n > n_pad:
        raise ValueError(f'{n} points > pad {n_pad}')
    # NaN passes every range comparison below: check it first.
    if n and not np.isfinite(pc).all():
        bad = np.argwhere(~np.isfinite(pc))[0]
        raise ValueError(
            f'quantized upload: non-finite value at row {bad[0]} '
            f'col {bad[1]} ({pc[bad[0], bad[1]]!r}) — quantization would '
            f'be undefined; use transfer_dtype="float32" or clean the '
            f'input')
    xyz_scaled = np.round(pc[:, :3] * 200.0)
    if n and (xyz_scaled.min() < -32768 or xyz_scaled.max() > 32767):
        raise ValueError(
            f'quantized upload: coordinate range '
            f'[{pc[:, :3].min():.4g}, {pc[:, :3].max():.4g}] m outside '
            f'the i16-representable +-163.84 m')
    inten = np.round(pc[:, 3])
    if n and (inten.min() < 0 or inten.max() > 255):
        raise ValueError(
            f'quantized upload: intensity range '
            f'[{pc[:, 3].min():.4g}, {pc[:, 3].max():.4g}] outside u8 '
            f'(expected the sensor 0..255 scale)')
    inst = np.round(pc[:, 6]) + 1.0
    if n and (inst.min() < 0 or inst.max() > 65535):
        raise ValueError(
            f'quantized upload: instance index range '
            f'[{pc[:, 6].min():.4g}, {pc[:, 6].max():.4g}] outside u16-1')
    out = np.zeros(n_pad * BYTES_PER_POINT, np.uint8)
    xyz = out[:6 * n_pad].view(np.int16).reshape(n_pad, 3)
    xyz[:n] = xyz_scaled
    out[6 * n_pad:6 * n_pad + n] = inten
    uv = out[7 * n_pad:11 * n_pad].view(np.uint16).reshape(n_pad, 2)
    uv[:n] = np.clip(np.round(pc[:, 4:6]), 0, 65535)
    out[11 * n_pad:].view(np.uint16)[:n] = inst
    return out


def unpack_points7(buf: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Device inverse of pack_points7_np: (n_pad * 13,) uint8 ->
    (n_pad, 7) float32 on ``buf``'s device."""
    def u16(start, cols):
        # Little-endian byte pairs; no view, so any offset is aligned.
        b = buf[start:start + 2 * cols * n_pad].reshape(n_pad, cols, 2).to(
            torch.int32)
        return b[..., 0] | (b[..., 1] << 8)

    xyz = u16(0, 3)
    xyz = (xyz - ((xyz >> 15) << 16)).to(torch.float32)      # as int16
    inten = buf[6 * n_pad:7 * n_pad].to(torch.float32)[:, None]
    uv = u16(7 * n_pad, 2).to(torch.float32)
    inst = u16(11 * n_pad, 1).to(torch.float32) - 1.0
    return torch.cat([xyz * (1.0 / 200.0), inten, uv, inst], dim=1)
