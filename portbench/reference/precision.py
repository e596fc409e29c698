"""Full float32 for the reference's semseg: TF32 off in cuBLAS and cuDNN
(cuDNN's convolutions take TF32 by default)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
