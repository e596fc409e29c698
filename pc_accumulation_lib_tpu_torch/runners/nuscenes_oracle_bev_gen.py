"""NuScenes oracle-pose BEV generation: runners/nuscenes_bev_gen.main with
--use_oracle_pose forced.

CLI: python -m pc_accumulation_lib_tpu_torch.runners.nuscenes_oracle_bev_gen
<dataroot> [<semseg_model>] [--device cuda] (the other flags as
nuscenes_bev_gen's).
"""
from __future__ import annotations

import sys

from pc_accumulation_lib_tpu_torch.runners import nuscenes_bev_gen


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if '--use_oracle_pose' not in argv:
        argv.append('--use_oracle_pose')
    nuscenes_bev_gen.main(argv)


if __name__ == '__main__':
    main()
