"""The dense decoder LM: layers, decode attention and the decode step."""
from . import attention, layers, model
from .layers import linear, route_trace
from .model import decode_step, init, init_cache, n_periods, period_slots

__all__ = ["init", "decode_step", "init_cache", "period_slots", "n_periods",
           "linear", "route_trace", "attention", "layers", "model"]
