"""Deterministic sharded data pipeline for the training loop.

`DataIterator` yields batches that are a pure function of (config,
step), so a restarted or re-sharded job replays exactly the same token
stream; `batch_at_step` reconstructs any batch without iterating from
zero (the JAX package's `data/` under the same names)."""
from .pipeline import DataConfig, DataIterator, batch_at_step, data_config_for

__all__ = ["DataConfig", "DataIterator", "batch_at_step", "data_config_for"]
