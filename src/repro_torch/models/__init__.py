"""The dense decoder LM: layers, attention, the prefill forward and the
decode step."""
from . import attention, layers, model
from .layers import linear, route_trace
from .model import (decode_step, forward, init, init_cache, n_periods,
                    period_slots)

__all__ = ["init", "forward", "decode_step", "init_cache", "period_slots",
           "n_periods", "linear", "route_trace", "attention", "layers",
           "model"]
