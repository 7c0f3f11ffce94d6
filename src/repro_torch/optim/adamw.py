"""AdamW with decoupled weight decay; f32 moments whatever the parameter
dtype (mixed-precision training), as in the JAX package's
`optim/adamw.py`.

The update runs in place under `torch.no_grad`, one leading-axis slice
of a leaf at a time (`leaf_slices`), so its f32 temporaries never exceed
one slice: a stacked layer leaf of qwen2-7b, (28, 3584, 18944), would
need 7.6 GB for each f32 temporary taken over the whole leaf."""
from __future__ import annotations

import torch

from ..tree import leaves, map_tree, zip_leaves

# f32 elements of one slice's temporaries; leaves above it are updated
# in slices along their leading axis
SLICE_ELEMS = 1 << 26


def leaf_slices(*ts, min_dim: int = 2):
    """Matching views of tensors that share their leading axis: the whole
    tensors when ts[0] is small or has fewer than `min_dim` axes, else
    runs of whole rows t[i] along the leading axis, of at most
    SLICE_ELEMS elements of ts[0] where a row is smaller than that."""
    t = ts[0]
    if t.dim() < min_dim or t.numel() <= SLICE_ELEMS:
        yield ts
        return
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(leaves(params)).device)}


@torch.no_grad()
def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_scale=None):
    """Updates `params` and `state` in place and returns them.  `lr` is a
    float or a 0-d f32 tensor; `grad_scale` (a 0-d f32 tensor or None)
    multiplies each gradient after its cast to f32 (the train step's
    global-norm clip, applied where the JAX package applies it: to the
    gradient before the optimizer's f32 cast, which is exact for the f32
    product of a bf16 gradient)."""
    state["step"] += 1
    t = state["step"].to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for p, g, m, v in zip_leaves(params, grads, state["m"], state["v"]):
        for ps, gs, ms, vs in leaf_slices(p, g, m, v):
            g32 = gs.to(torch.float32)
            if grad_scale is not None:
                g32 = g32 * grad_scale
            ms.mul_(b1).add_((1 - b1) * g32)
            vs.mul_(b2).add_((1 - b2) * torch.square(g32))
            p32 = ps.to(torch.float32)
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + eps) \
                + weight_decay * p32
            ps.copy_(p32 - lr * delta)
    return params, state
