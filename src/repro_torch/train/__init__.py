"""Training substrate: the train step and loop, checkpointing (in the
JAX package's on-disk format) and the fault-tolerance runtime."""
from . import checkpoint, fault_tolerance, loop
from .loop import TrainResult, make_train_step, train

__all__ = ["checkpoint", "fault_tolerance", "loop", "train",
           "make_train_step", "TrainResult"]
