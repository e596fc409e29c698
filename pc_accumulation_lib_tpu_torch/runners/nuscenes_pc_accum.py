"""NuScenes accumulation demo: accumulate one scene with oracle poses and
export the semantic vector space as PLY.

Counterpart of runners/nuscenes_pc_accum.py. Library use: run(...) with a
devkit object or a test double as ``nusc``, or build_accumulator(...)
around any stream of observation batches; CLI: python -m
pc_accumulation_lib_tpu_torch.runners.nuscenes_pc_accum <dataroot>
[<semseg_model>] [--device cuda].
"""
from __future__ import annotations

import argparse
from typing import Optional

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.runners.kitti360_pc_accum import (
    export_vector_space)
from pc_accumulation_lib_tpu_torch.runners.nuscenes_bev_gen import (
    NUSCENES_FILTERS)


def build_accumulator(semseg_model, loc: str,
                      accum_cfg: Optional[cfg.AccumConfig] = None, *,
                      device='cuda'):
    """The oracle-pose accumulator run() integrates into, on ``device``."""
    from pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle import (
        NuScenesOracleSemanticPointCloudAccumulator)
    return NuScenesOracleSemanticPointCloudAccumulator(
        semseg_model, NUSCENES_FILTERS, cfg.DEFAULT_SEM_IDXS, False,
        {'type': 'sem'}, loc, accum_cfg=accum_cfg, device=device)


def run(nuscenes_path: str, semseg_model,
        version: str = 'v1.0-mini', scene_idx: int = 0,
        num_sweeps: int = 1, out: str = 'sem_vec_space.ply',
        accum_cfg: Optional[cfg.AccumConfig] = None, nusc=None, *,
        device='cuda') -> int:
    """Integrate NuScenes scene ``scene_idx`` with oracle poses on
    ``device`` (the card unless the caller passes 'cpu') and export the
    cloud to ``out``; ``semseg_model`` is a models.semseg.SemSegTorch on
    the same device. ``nusc`` injects a devkit object or a test double;
    without it the nuscenes-devkit loads ``nuscenes_path``. Returns the
    point count."""
    from pc_accumulation_lib_tpu_torch.dataloaders.nuscenes import (
        NuScenesDataloader)
    if nusc is None:
        from nuscenes.nuscenes import NuScenes
        nusc = NuScenes(dataroot=nuscenes_path, version=version)
    log = nusc.get('log', nusc.scene[scene_idx]['log_token'])
    accum = build_accumulator(semseg_model, log['location'], accum_cfg,
                              device=device)
    for observations in NuScenesDataloader(nusc, [scene_idx], 1,
                                           num_sweeps):
        accum.integrate(observations)
    return export_vector_space(accum, out)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('nuscenes_path', type=str)
    parser.add_argument('semseg_model_path', type=str, nargs='?', default='')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--nuscenes_version', type=str, default='v1.0-mini')
    parser.add_argument('--scene_idx', type=int, default=0)
    parser.add_argument('--num_sweeps', type=int, default=1)
    parser.add_argument('--out', type=str, default='sem_vec_space.ply')
    args = parser.parse_args(argv)

    from pc_accumulation_lib_tpu_torch.models.semseg import load_semseg_model
    semseg_model = load_semseg_model(args.semseg_model_path,
                                     device=args.device)
    n = run(args.nuscenes_path, semseg_model, args.nuscenes_version,
            args.scene_idx, args.num_sweeps, args.out, device=args.device)
    print(f'Wrote {n} points to {args.out}')


if __name__ == '__main__':
    main()
