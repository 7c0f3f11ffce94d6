"""What the plain references share: each architecture's reference
(`chipbench/archs/<arch>.py`: `final_hidden`, `head`) is a decoder LM in
float32 PyTorch (TF32 off), written from the architecture and imported
from nothing of the program, built from these pieces.

It takes the benchmark's own bf16 weights (`weights.make`) and works its
quantized weights out itself, with a copy of the per-output-channel
symmetric arithmetic: scale = max|w| / qmax + 1e-12 over each column of
each (K, N) matrix, codes round(w / scale) (half to even) clipped to
[-qmax, qmax], weight = codes * scale; qmax 127 for INT8 (the
configurations' precision) and 7 for INT4 (the control).

A reference runs one layer at a time over all sequences, with that
layer's weights dequantized to float32 and freed after it, so a model
larger than the card in float32 fits.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def dequantize(w, bits: int):
    """float32 weight of the (..., K, N) leaf w after the round trip
    through `bits`-bit per-output-channel symmetric codes."""
    qmax = {8: 127.0, 4: 7.0}[bits]
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / qmax + 1e-12
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def routed_experts(h, ids, vals, leaves: dict, bits: int, n_experts: int):
    """sum over k of vals[:, k] * expert ids[:, k] (a SwiGLU of the
    stacked leaves `w_gate`, `w_up`, `w_down` of `leaves`) for the tokens
    h (T, d), one expert at a time over the tokens routed to it."""
    y = torch.zeros_like(h)
    for e in range(n_experts):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (dequantize(leaves[k][e], bits)
                      for k in ("w_gate", "w_up", "w_down"))
        out = swiglu(h[rows], wg, wu, wd) * vals[rows, slot][:, None]
        y.index_add_(0, rows, out)
    return y


def layer(tree, i: int):
    """Layer i of a tree of leaves stacked over the layers."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def logits(h, w_head, chunk: int = 1024):
    """Yields (start, logits of rows start .. start + chunk) of h @ w_head,
    float32, TF32 off."""
    with no_tf32(), torch.inference_mode():
        for a in range(0, h.shape[0], chunk):
            yield a, h[a:a + chunk] @ w_head
