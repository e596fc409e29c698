"""pc_accumulation_lib_tpu_torch: the PyTorch + CUDA port of
pc_accumulation_lib_tpu for NVIDIA Hopper GPUs.

Same layout as the JAX package (accum/, bev/, ops/, models/,
dataloaders/); the raster's segmented-stats kernel is CUDA C++ in csrc/.
Imports torch and numpy, never JAX.
"""
