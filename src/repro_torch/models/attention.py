"""Decode attention over a KV cache, in plain torch (the JAX package also
computes it outside any kernel)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_expand(k, n_heads: int):
    """(b, s, kv, d) -> (b, s, H, d) by repeating kv heads."""
    kv = k.shape[2]
    return k if kv == n_heads else k.repeat_interleave(n_heads // kv, dim=2)


def decode_attend(q, k_cache, v_cache, cache_len, window: int = 0,
                  grouped: bool = False):
    """Single-token decode attention over a (b, S, KV, d) cache.

    cache_len: (b,) valid lengths.  q: (b, 1, H, d).  Linear in S.
    grouped=True uses grouped-query einsums that never materialize the
    GQA-expanded cache."""
    b, _, nh, d = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                          device=q.device))
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < cache_len[:, None]
    if window:
        valid &= pos >= (cache_len[:, None] - window)
    if grouped:
        rep = nh // kv
        qg = q.reshape(b, 1, kv, rep, d).float()
        s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k_cache.float()) * scale
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrqs,bsgd->bqgrd", p, v_cache.float())
        return out.reshape(b, 1, nh, d).to(q.dtype)
    k = _gqa_expand(k_cache, nh)
    v = _gqa_expand(v_cache, nh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
