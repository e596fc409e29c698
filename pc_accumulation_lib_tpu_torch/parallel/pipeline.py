"""Pipeline parallelism: the GPipe microbatch schedule over a 'pp' axis.

Counterpart of parallel/pipeline.py. Rank s of the ('pp',) mesh holds
stage s. Every tick, stage 0 takes the next microbatch, every stage
applies its function to what it holds, the last stage's output is kept,
and the activations move one rank along the ring (ppermute), whose
gradient takes the reverse ring, so the backward pass pipelines too.
M microbatches through S stages take M + S - 1 ticks (bubble fraction
(S - 1) / (M + S - 1)).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh


def stack_stage_params(per_stage: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """S structurally identical stage dicts -> one dict whose tensors
    have a leading stage axis."""
    return {k: torch.stack([p[k] for p in per_stage]) for k in per_stage[0]}


def place_stage_params(stacked: Dict[str, torch.Tensor], mesh,
                       axis: str = 'pp') -> Dict[str, torch.Tensor]:
    """This rank's stage of stage-stacked params (rank s keeps stage s)."""
    s = pmesh.axis_rank(mesh, axis)
    return {k: v[s].clone() for k, v in stacked.items()}


def gpipe_apply(stage_fn: Callable, mesh, axis: str = 'pp'):
    """Build the pipelined forward ``run(stage_params, xs) -> ys``.

    ``stage_fn(stage_params, x) -> y`` keeps x's shape and dtype (the
    GPipe requirement). Every rank of ``axis`` calls ``run`` with its own
    stage's params and the same microbatches ``xs`` (M, ...); every rank
    gets the (M, ...) outputs of stage S-1(... stage 0(x)). The result is
    replicated: a loss computed from it on every rank counts once, and
    each rank's params get their gradient from it."""
    S = pmesh.axis_size(mesh, axis)
    rank = pmesh.axis_rank(mesh, axis)

    def run(stage_params, xs):
        M = xs.shape[0]
        first = torch.tensor(rank == 0, device=xs.device)
        last = torch.tensor(rank == S - 1, device=xs.device)
        act = torch.zeros_like(xs[0])
        outs = []
        for t in range(M + S - 1):
            # Stage 0 takes microbatch t; the others what the ring brought
            # (both enter the graph, so every rank runs every ring's
            # backward).
            cur = torch.where(first, xs[min(t, M - 1)], act)
            y = stage_fn(stage_params, cur)
            # Stage S-1's output at tick t is microbatch t - (S - 1).
            outs.append(torch.where(last, y, torch.zeros_like(y)))
            if t < M + S - 2:
                act = pmesh.ppermute(y, mesh, axis, 1)
        outs = pmesh.psum_replicated(torch.stack(outs), mesh, axis)
        return outs[S - 1:]

    return run


def make_pipeline_mesh(n_stages: int, device_type: str = 'cuda'):
    """1-D ('pp',) mesh of ``n_stages`` ranks (the whole world)."""
    return pmesh.make_mesh((n_stages,), ('pp',), device_type)


def stage_weights_from_flax(kernel, bias) -> List[Dict[str, np.ndarray]]:
    """JAX stage-stacked conv params (flax ``kernel`` (S, kh, kw, Cin,
    Cout), ``bias`` (S, Cout)) -> per stage {'weight' (Cout, Cin, kh, kw),
    'bias' (Cout,)} in torch's conv layout."""
    kernel, bias = np.asarray(kernel), np.asarray(bias)
    return [{'weight': np.ascontiguousarray(kernel[s].transpose(3, 2, 0, 1)),
             'bias': np.ascontiguousarray(bias[s])}
            for s in range(kernel.shape[0])]
