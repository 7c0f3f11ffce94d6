"""Optimizer factory: (init_fn, update_fn) pairs keyed by RunConfig, as
in the JAX package's `optim/api.py`."""
from __future__ import annotations

from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update


def make_optimizer(name: str, weight_decay: float = 0.1):
    """update_fn(params, grads, state, lr, grad_scale=None) updates in
    place and returns (params, state).  Adafactor runs without weight
    decay, as in the JAX package."""
    if name == "adamw":
        def update(p, g, s, lr, grad_scale=None):
            return adamw_update(p, g, s, lr, weight_decay=weight_decay,
                                grad_scale=grad_scale)
        return adamw_init, update
    if name == "adafactor":
        def update(p, g, s, lr, grad_scale=None):
            return adafactor_update(p, g, s, lr,
                                    weight_decay=weight_decay * 0.0,
                                    grad_scale=grad_scale)
        return adafactor_init, update
    raise ValueError(f"unknown optimizer {name}")
