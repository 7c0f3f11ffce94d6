"""Optimizers on torch tensor trees (no torch.optim dependency), the JAX
package's `optim/` under the same names: AdamW, Adafactor, the factory
and the warmup-cosine schedule, plus `grad_compress` (the int8-coded
all-reduce with error feedback, over a process group).  The updates run
in place, slice by slice, under `torch.no_grad`."""
from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update
from .api import make_optimizer
from .schedule import linear_warmup_cosine

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_optimizer", "linear_warmup_cosine"]
