"""Learning-rate schedules, computed on tensors so a train step reads no
step number on the host.

`linear_warmup_cosine` is the production default: a linear ramp over
`warmup` steps, then cosine decay to `min_frac * base_lr` by `total`
(the JAX package's `optim/schedule.py`, op for op in f32)."""
from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, base_lr: float, warmup: int, total: int,
                         min_frac: float = 0.1, device=None):
    """The rate at `step` (an int or an integer tensor) as a 0-d f32
    tensor on `device` (the step tensor's device when `device` is None,
    else the CPU)."""
    t = torch.as_tensor(step, device=device).to(torch.float32)
    warm = base_lr * torch.clamp(t / max(1.0, float(warmup)), max=1.0)
    prog = torch.clamp((t - warmup) / max(1.0, float(total - warmup)),
                       0.0, 1.0)
    # cos in f64, rounded once to f32: near prog = 1, 1 + cos magnifies
    # one ulp of cos into several of the rate, and the JAX package's f32
    # cos on the CPU (libm's cosf) is correctly rounded where torch's
    # vectorized f32 cos is not always
    c = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + c))
    return torch.where(t < warmup, warm, cos)
