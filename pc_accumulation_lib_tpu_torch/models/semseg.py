"""Semantic-segmentation inference wrapper and weight loader.

Counterpart of models/semseg.py (SemSegTPU): a callable mapping an RGB
image to a class-index map, on a device (the card unless the caller
passes 'cpu'). On a CUDA device the
convolutions compute in bfloat16 with batch norms in float32, as the JAX
model does on the TPU; on the CPU everything is float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    ResNet50DilatedFCN, init_params)


class SemSegTorch:
    """__call__(rgb (H,W,3)) -> (H,W) int32 class map (numpy);
    predict(images (B,H,W,3) tensor) -> (B,H,W) int32 tensor on the
    device; the accumulator calls predict on device images."""

    def __init__(self, device='cuda', seed: int = 0,
                 stage_sizes: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if self.device.type == 'cuda'
                             else torch.float32)
        kwargs = {} if stage_sizes is None else {'stage_sizes': stage_sizes}
        self.model = ResNet50DilatedFCN(compute_dtype=compute_dtype,
                                        **kwargs)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def predict(self, images):
        return torch.argmax(self.model(images), dim=-1).to(torch.int32)

    def __call__(self, rgb) -> np.ndarray:
        arr = torch.from_numpy(np.ascontiguousarray(np.asarray(rgb)[..., :3]))
        return self.predict(arr[None].to(self.device))[0].cpu().numpy()


def load_named_tensors(model, named: Dict[str, np.ndarray]) -> None:
    """Load mmsegmentation-named tensors ({name: OIHW / 1-D array}, as
    pc_accumulation_lib_tpu.models.onnx_port.export_named_tensors emits)
    into a ResNet50DilatedFCN (or the SemSegTorch holding one) with
    ``strict=True``. Every parameter and running statistic must be given;
    batch-norm step counters keep their values."""
    module = model.model if isinstance(model, SemSegTorch) else model
    current = module.state_dict()
    missing = [k for k in current
               if k not in named and not k.endswith('num_batches_tracked')]
    extra = [k for k in named if k not in current]
    if missing or extra:
        raise KeyError(f'named tensors do not match the model: missing '
                       f'{missing[:5]}, unexpected {extra[:5]}')
    state = {}
    for k, v in current.items():
        if k.endswith('num_batches_tracked'):
            state[k] = v
            continue
        src = torch.tensor(np.asarray(named[k], np.float32))
        if src.shape != v.shape:
            raise ValueError(f'shape mismatch for {k}: {tuple(src.shape)} '
                             f'vs {tuple(v.shape)}')
        state[k] = src
    module.load_state_dict(state, strict=True)
