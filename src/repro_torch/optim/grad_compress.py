"""INT8-quantized gradient all-reduce with error feedback, on
`torch.distributed` (the port of the JAX package's
`optim/grad_compress.py`).

Each worker quantizes its local gradient (plus the residual it carried
from the last step) against a per-tensor scale, the workers agree on the
largest scale (an all-reduce MAX of one f32), requantize against it, sum
the codes (an all-reduce SUM) and dequantize; the quantization residual
is carried into the next step (error feedback keeps the compression
unbiased over time).

What crosses the wire: the codes lie in [-127, 127], but a sum of n of
them does not fit int8, so they are summed as **int32** — 4 bytes per
element, as many as an f32 all-reduce — plus one f32 scale per leaf.
So it saves no bytes over an f32 all-reduce (the JAX package's
docstring claims 8x fewer); it only limits what crosses to 8-bit codes.
The JAX package's function also all-reduces the first-scale
codes into a sum it then overwrites; XLA removes that dead collective,
an eager all-reduce would not, so it is not issued here: exactly two
collectives per leaf.

Bits: every division is a true f32 division, as the JAX function's own
eager form (and its test) computes it.  Under `jax.jit`, XLA rewrites
the division by the constant 127 into a multiply by its f32 reciprocal,
which differs by one ulp in a few percent of the scales; and CUDA
torch rewrites a division by a Python scalar the same way, so the
divisors here are tensors on the data's device, which keeps the card
bit for bit equal to the CPU.

Nothing in the package calls it (`RunConfig.grad_compress` has no
reader in either package): it is the building block for a pod-level
data-parallel reduction.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import map_tree, rebuild, zip_leaves


def init_error_state(params):
    """f32 zeros shaped like each leaf, on the leaf's device."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _div_(x, d: float):
    """x /= d in place, a true f32 division on every device (see the
    module docstring)."""
    return x.div_(torch.tensor(d, dtype=torch.float32, device=x.device))


def _scale(g32):
    """max|g32| / 127 + 1e-12, the per-tensor quantization scale."""
    return _div_(torch.linalg.vector_norm(g32, float("inf")), 127.0) + 1e-12


def _quant(g):
    """(int8 codes, f32 scale) of one tensor: scale = max|g| / 127."""
    g = g.to(torch.float32)
    scale = _scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def _one(g, e, group, n: int):
    """One leaf: `e` becomes the new residual in place; returns the
    reduced f32 mean.  Temporaries: one f32 tensor (which becomes the
    result) and the int32 codes."""
    g32 = e.add_(g)                     # g + e, in e's storage
    scale = _scale(g32)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    t = torch.div(g32, scale).round_().clamp_(-127, 127)
    q = t.to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    g32.sub_(t.mul_(scale))             # new residual: g32 - q * smax
    return _div_(t.copy_(q).mul_(scale), float(n))


def compressed_psum(grads, errors, group=None):
    """All-reduce `grads` over `group` (default: the whole default group)
    in int8 codes with error feedback.

    Returns (reduced, errors): `reduced` is the f32 mean over the group's
    ranks of each leaf's dequantized codes, and `errors` (a tree shaped
    like `grads`, from `init_error_state`) is updated IN PLACE to the new
    residuals and returned.  Every rank of the group must call it on the
    same tree."""
    n = dist.get_world_size(group)
    pairs = list(zip_leaves(grads, errors))
    return (rebuild(grads, (_one(g, e, group, n) for g, e in pairs)),
            errors)
