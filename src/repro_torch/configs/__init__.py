"""Architecture configs: the shared dataclasses and the registry (copies
of the JAX package's `configs/base.py` and `configs/registry.py`)."""
from .base import (LONG_500K, DECODE_32K, PREFILL_32K, SHAPES, TRAIN_4K,
                   AudioConfig, MLAConfig, ModelConfig, MoEConfig, RunConfig,
                   ShapeConfig, SSMConfig, VisionConfig, reduced)
from .registry import ARCHS, get

__all__ = ["ARCHS", "get", "ModelConfig", "ShapeConfig", "RunConfig",
           "MoEConfig", "MLAConfig", "SSMConfig", "VisionConfig", "AudioConfig",
           "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "reduced"]
