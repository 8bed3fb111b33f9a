"""blaze-tpu on PyTorch and CUDA: the port of the `blaze_tpu` engine.

A second package beside the JAX one, mirroring its layout module by
module. Device code that `blaze_tpu` leaves to XLA is PyTorch tensor
code here, run eagerly; each TPU (Pallas) kernel on a ported path is a
CUDA kernel written by hand for Hopper (`csrc/`, built with nvcc for
sm_90a at first use into `build/blaze_tpu_torch/`). Entry points run on
"cuda" unless the caller asks for the CPU (`EngineConfig.device`,
`ExecContext(device=...)`).

This package imports torch and never jax, and nothing of `blaze_tpu`.
"""

from blaze_tpu_torch.config import EngineConfig, get_config, set_config
from blaze_tpu_torch.types import DataType, Field, Schema
from blaze_tpu_torch.batch import Column, ColumnBatch

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "get_config",
    "set_config",
    "DataType",
    "Field",
    "Schema",
    "Column",
    "ColumnBatch",
]
