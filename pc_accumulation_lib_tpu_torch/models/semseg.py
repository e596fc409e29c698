"""Semantic-segmentation inference wrapper and weight loaders.

Counterpart of models/semseg.py (SemSegTPU, load_semseg_model): a
callable mapping an RGB image to a class-index map, on a device (the card
unless the caller passes 'cpu'). On a CUDA device the
convolutions compute in bfloat16 with batch norms in float32, as the JAX
model does on the TPU; on the CPU everything is float32.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.models.resnet_semseg import (
    ResNet50DilatedFCN, init_params)


class SemSegTorch:
    """pred(rgb) -> (1,1,H,W) int32 class map, the reference API's shape;
    __call__(rgb (H,W,3)) -> (H,W); pred_batch(images (B,H,W,3)) ->
    (B,H,W) for multi-camera frames (all numpy); predict(images
    (B,H,W,3) tensor) -> (B,H,W) int32 tensor on the device; the
    accumulator calls predict on device images."""

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

    def pred_batch(self, images) -> np.ndarray:
        """(B,H,W,3) host array, uint8 or float in [0, 255] -> (B,H,W)
        int32 class maps: one forward on the device for all cameras."""
        arr = torch.from_numpy(np.ascontiguousarray(np.asarray(images)))
        return self.predict(arr.to(self.device)).cpu().numpy()

    def __call__(self, rgb) -> np.ndarray:
        return self.pred_batch(np.asarray(rgb)[..., :3][None])[0]

    def pred(self, rgb) -> np.ndarray:
        """(1,1,H,W): the reference API's shape, its callers index
        [0, 0]."""
        return self(rgb)[None, None]


def load_named_tensors(model, named: Dict[str, np.ndarray], *,
                       ignore_unused: bool = False) -> None:
    """Load mmsegmentation-named tensors ({name: OIHW / 1-D array}, as
    onnx_port.export_named_tensors here or in the JAX package emits them,
    or an ONNX file's initializers) into a ResNet50DilatedFCN (or the
    SemSegTorch holding one).

    Each parameter and running statistic is found under its own name or,
    when an exporter prefixed the names (``model.backbone...``), under
    the one name ending in it. Raises KeyError naming the parameters with
    no source tensor or more than one, and the given tensors no parameter
    took (unless ``ignore_unused``: an ONNX graph also holds constants);
    ValueError on a shape mismatch: shape is checked, never used to match.
    The model is changed only when every tensor was found; batch-norm step
    counters keep their values."""
    module = model.model if isinstance(model, SemSegTorch) else model
    current = module.state_dict()
    state, used, missing, ambiguous = {}, set(), [], []
    for k, v in current.items():
        if k.endswith('num_batches_tracked'):
            state[k] = v
            continue
        hits = [k] if k in named else [n for n in named if n.endswith(k)]
        if len(hits) != 1:
            (missing if not hits else ambiguous).append(k)
            continue
        used.add(hits[0])
        src = torch.tensor(np.asarray(named[hits[0]], np.float32))
        if src.shape != v.shape:
            raise ValueError(f'shape mismatch for {k} <- {hits[0]}: '
                             f'{tuple(src.shape)} vs {tuple(v.shape)}')
        state[k] = src
    unused = [] if ignore_unused else [n for n in named if n not in used]
    if missing or ambiguous or unused:
        raise KeyError(f'named tensors do not match the model: no source '
                       f'for {missing[:5]}, several for {ambiguous[:5]}, '
                       f'unexpected {unused[:5]}')
    module.load_state_dict(state, strict=True)


def load_semseg_model(path: Optional[str] = None, seed: int = 0,
                      stage_sizes: Optional[Sequence[int]] = None, *,
                      device='cuda') -> SemSegTorch:
    """Load a semseg model on ``device`` (the card unless the caller
    passes 'cpu').

    * ``path`` ending in .onnx: its initializers, by name or by graph
      structure (models/onnx_port.load_onnx_weights); a malformed file
      raises.
    * any other existing file: a weight file of
      models/checkpoint.save_semseg_weights (a state dict, read with
      ``weights_only``).
    * a path that does not exist: a warning and random weights (seed
      ``seed``), as the JAX package does; no path: random weights.

    The JAX package's flax msgpack files are not read: its trained
    variables reach the port as an .onnx file of its
    onnx_port.export_named_tensors written by onnx_pb.write_initializers.
    ``stage_sizes`` builds a reduced-depth model (tests)."""
    kwargs = {} if stage_sizes is None else {'stage_sizes': stage_sizes}
    model = SemSegTorch(device=device, seed=seed, **kwargs)
    if path and os.path.exists(path):
        if path.endswith('.onnx'):
            from pc_accumulation_lib_tpu_torch.models.onnx_port import (
                load_onnx_weights)
            load_onnx_weights(path, model.model)
        else:
            model.model.load_state_dict(torch.load(
                path, map_location=model.device, weights_only=True))
    elif path:
        print(f'WARNING: semseg checkpoint {path!r} not found; '
              'using randomly initialized weights.')
    return model
