"""pc_accumulation_lib_tpu_torch: the PyTorch + CUDA port of
pc_accumulation_lib_tpu for NVIDIA Hopper GPUs.

Same layout as the JAX package (accum/, bev/, ops/, models/,
dataloaders/); the raster's segmented-stats kernel is CUDA C++ in csrc/.
Imports torch and numpy, never JAX.
"""


def __getattr__(name):
    # The entry classes, imported at first use so that importing the
    # package stays cheap.
    import importlib
    lazy = {
        'Kitti360SemanticPointCloudAccumulator':
            'pc_accumulation_lib_tpu_torch.accum.kitti360',
        'NuScenesSemanticPointCloudAccumulator':
            'pc_accumulation_lib_tpu_torch.accum.nuscenes',
        'NuScenesOracleSemanticPointCloudAccumulator':
            'pc_accumulation_lib_tpu_torch.accum.nuscenes_oracle',
        'SemBEVGenerator': 'pc_accumulation_lib_tpu_torch.bev.sem_bev',
        'RGBBEVGenerator': 'pc_accumulation_lib_tpu_torch.bev.rgb_bev',
        'Kitti360Dataloader':
            'pc_accumulation_lib_tpu_torch.dataloaders.kitti360',
        'NuScenesDataloader':
            'pc_accumulation_lib_tpu_torch.dataloaders.nuscenes',
        'SemSegTorch': 'pc_accumulation_lib_tpu_torch.models.semseg',
        'load_semseg_model': 'pc_accumulation_lib_tpu_torch.models.semseg',
    }
    if name in lazy:
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(name)
