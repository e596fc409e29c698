"""KITTI-360 accumulation demo: integrate a clip and export the semantic
vector space.

Counterpart of runners/kitti360_pc_accum.py: accumulates one clip's
observations and writes the in-window cloud as a PLY point cloud plus
its pose path (offscreen, no viewer window).

Library use: run(...) on a KITTI-360 tree, or build_accumulator(...) and
export_vector_space(...) around any stream of observation batches; CLI:
python -m pc_accumulation_lib_tpu_torch.runners.kitti360_pc_accum <root>
[<semseg_model>] [--use_gt_sem] [--device cuda].
"""
from __future__ import annotations

import argparse
from typing import Optional

from pc_accumulation_lib_tpu_torch import config as cfg
from pc_accumulation_lib_tpu_torch.runners.kitti360_bev_gen import (
    build_calib_params)


def export_vector_space(accum, out_path: str) -> int:
    """Write the accumulated world-frame cloud (the valid rows of the
    in-window frames) as PLY with its RGB, and the ego positions as
    ``out_path``.poses.txt. Returns the point count."""
    return accum.viz_sem_vec_space(out_path, color='rgb')


def build_accumulator(calib_params: dict, semseg_model=None,
                      use_gt_sem: bool = False,
                      accum_horizon_dist: float = 200.0,
                      icp_threshold: float = 1e3,
                      accum_cfg: Optional[cfg.AccumConfig] = None,
                      icp_cfg: Optional[cfg.ICPConfig] = None, *,
                      device='cuda'):
    """The accumulator run() integrates into, on ``device``."""
    from pc_accumulation_lib_tpu_torch.accum.kitti360 import (
        Kitti360SemanticPointCloudAccumulator)
    return Kitti360SemanticPointCloudAccumulator(
        accum_horizon_dist, calib_params, icp_threshold, semseg_model,
        cfg.DEFAULT_SEMSEG_FILTERS, cfg.DEFAULT_SEM_IDXS, use_gt_sem,
        {'type': 'sem'}, accum_cfg=accum_cfg, icp_cfg=icp_cfg,
        device=device)


def run(kitti360_path: str, semseg_model=None, use_gt_sem: bool = False,
        sequence: str = '2013_05_28_drive_0000_sync', start_idx: int = 130,
        num_frames: int = 20, out: str = 'sem_vec_space.ply',
        accum_horizon_dist: float = 200.0, icp_threshold: float = 1e3,
        accum_cfg: Optional[cfg.AccumConfig] = None,
        icp_cfg: Optional[cfg.ICPConfig] = None, *, device='cuda') -> int:
    """Integrate frames [start_idx, start_idx + num_frames) of
    ``sequence`` on ``device`` (the card unless the caller passes 'cpu')
    and export the cloud to ``out``; ``semseg_model`` is a
    models.semseg.SemSegTorch on the same device (or None with
    ``use_gt_sem``). Returns the point count."""
    from pc_accumulation_lib_tpu_torch.dataloaders.kitti360 import (
        Kitti360Dataloader)
    accum = build_accumulator(
        build_calib_params(kitti360_path), semseg_model, use_gt_sem,
        accum_horizon_dist, icp_threshold, accum_cfg, icp_cfg,
        device=device)
    dataloader = Kitti360Dataloader(kitti360_path, 1, [sequence],
                                    [start_idx], [start_idx + num_frames])
    for observations in dataloader:
        accum.integrate(observations)
    return export_vector_space(accum, out)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('kitti360_path', type=str)
    parser.add_argument('semseg_model_path', type=str, nargs='?', default='')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--accum_horizon_dist', type=float, default=200)
    parser.add_argument('--icp_threshold', type=float, default=1e3)
    parser.add_argument('--use_gt_sem', action='store_true')
    parser.add_argument('--num_frames', type=int, default=20)
    parser.add_argument('--sequence', type=str,
                        default='2013_05_28_drive_0000_sync')
    parser.add_argument('--start_idx', type=int, default=130)
    parser.add_argument('--out', type=str, default='sem_vec_space.ply')
    args = parser.parse_args(argv)

    semseg_model = None
    if not args.use_gt_sem:
        from pc_accumulation_lib_tpu_torch.models.semseg import (
            load_semseg_model)
        semseg_model = load_semseg_model(args.semseg_model_path,
                                         device=args.device)
    n = run(args.kitti360_path, semseg_model, args.use_gt_sem,
            args.sequence, args.start_idx, args.num_frames, args.out,
            args.accum_horizon_dist, args.icp_threshold, device=args.device)
    print(f'Wrote {n} points to {args.out}')


if __name__ == '__main__':
    main()
