"""Configuration: the JAX package's dataclasses and constants, re-exported
(pc_accumulation_lib_tpu.config is pure Python and imports no JAX)."""
from pc_accumulation_lib_tpu.config import *  # noqa: F401,F403
