"""Adafactor (factored second moment): O(n + m) optimizer state for an
(n, m) matrix, for the very large archs (jamba-398B,
llama-3.2-vision-90B) where full Adam moments would not fit, as in the
JAX package's `optim/adafactor.py`.

The update runs in place under `torch.no_grad`, one leading-axis slice
of a leaf at a time (a stacked leaf's periods; a factored leaf is never
cut inside its last two axes, over which its statistics run).  The
update's RMS clip is taken over the whole leaf, as in the JAX package, so
each leaf takes two passes: the first advances the second moments and
sums the update's squares, the second recomputes the update from the new
moments and applies it clipped."""
from __future__ import annotations

import torch

from ..tree import leaves, map_tree, zip_leaves
from .adamw import leaf_slices


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params):
    def st(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"v": map_tree(st, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(leaves(params)).device)}


def _update(g, stats, beta2, eps, grad_scale, advance: bool):
    """The unclipped update of one slice from its second-moment stats
    ((vr, vc) or (v,)), which are advanced in place first when
    `advance`."""
    g32 = g.to(torch.float32)
    if grad_scale is not None:
        g32 = g32 * grad_scale
    if len(stats) == 2:
        vr, vc = stats
        if advance:
            g2 = torch.square(g32) + eps
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(vr.mean(dim=-1, keepdim=True),
                               min=eps)[..., None])
        return g32 * torch.rsqrt(denom + eps)
    v, = stats
    if advance:
        v.copy_(beta2 * v + (1 - beta2) * (torch.square(g32) + eps))
    return g32 * torch.rsqrt(v + eps)


@torch.no_grad()
def adafactor_update(params, grads, state, lr, *, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0, grad_scale=None):
    """Updates `params` and `state` in place and returns them.  `lr` and
    `grad_scale` as in `adamw_update`."""
    state["step"] += 1
    t = state["step"].to(torch.float32)
    beta2 = 1.0 - t ** (-decay)
    for p, g, v in zip_leaves(params, grads, state["v"]):
        fac = _factored(p)
        views = (p, g, v["vr"], v["vc"]) if fac else (p, g, v["v"])
        min_dim = 3 if fac else 2
        # summed out of place: the dry run's DTensors take no in-place
        # add into a plain zero
        sq = 0.0
        for _, gs, *stats in leaf_slices(*views, min_dim=min_dim):
            u = _update(gs, stats, beta2, eps, grad_scale, advance=True)
            sq = sq + torch.sum(torch.square(u))
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(sq / p.numel() + eps)
        div = torch.clamp(rms / clip_threshold, min=1.0)
        for ps, gs, *stats in leaf_slices(*views, min_dim=min_dim):
            u = _update(gs, stats, beta2, eps, grad_scale,
                        advance=False) / div
            p32 = ps.to(torch.float32)
            if weight_decay:
                u = u + weight_decay * p32
            ps.copy_(p32 - lr * u)
    return params, state
