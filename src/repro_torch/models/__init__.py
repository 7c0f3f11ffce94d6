"""The decoder LM of every family (dense, moe, ssm, hybrid, vlm, audio):
layers, attention (and the vlm's cross attention), the MoE FFN, the
mamba2 mixer, the forward (train and prefill) with its loss, and the
decode step over a contiguous or a paged KV cache."""
from . import attention, layers, mamba2, model, moe
from .layers import linear, route_trace
from .model import (clone_cache, decode_step, forward, init, init_cache,
                    init_paged_cache, loss_fn, n_periods, period_slots)

__all__ = ["init", "forward", "loss_fn", "decode_step", "init_cache",
           "init_paged_cache", "clone_cache", "period_slots",
           "n_periods", "linear", "route_trace", "attention", "layers",
           "mamba2", "model", "moe"]
