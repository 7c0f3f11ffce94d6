"""Attention implementations in torch: naive, chunked online-softmax
("flash_jnp", the JAX package's pure-jnp flash), block-causal chunking,
and the `attend` switch that selects one of them or the hand-written
flash-attention kernel (`impl="pallas"`).  Decode over a KV cache
(`decode_attend`) and latent attention (`latent_attend`) are the plain
versions of the paged decode kernels and live beside them in `kernels/`;
they are imported here under their names.

Each function has the contract of its namesake in the JAX package's
`models/attention.py`, less the `unroll` knob of the JAX scans (a Python
loop has nothing to unroll).  Where the JAX code asks for f32
accumulation of bf16 operands (`preferred_element_type`), the port
upcasts the operands to f32 first: the products of bf16 values are exact
in f32, so both sum the same f32 terms.
"""
from __future__ import annotations

import functools

import torch

from ..kernels import ops as kops
from ..kernels.decode_attention import (NEG_INF, decode_attend,  # noqa: F401
                                        gqa_expand as _gqa_expand,
                                        inv_sqrt_f32 as _scale)
from ..kernels.mla_decode import latent_attend  # noqa: F401
from ..sharding.constraints import einsum, is_dtensor, on_local_shards


def naive_causal(q, k, v, positions_q=None, positions_k=None,
                 window: int = 0):
    """Reference attention.  q: (b, sq, H, d); k/v: (b, sk, KV, d);
    positions default to queries at the tail of the kv sequence."""
    b, sq, nh, d = q.shape
    k = _gqa_expand(k, nh)
    v = _gqa_expand(v, nh)
    sk = k.shape[1]
    logits = einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(d)
    pos_q = (positions_q if positions_q is not None
             else torch.arange(sq, device=q.device)[None, :] + (sk - sq))
    pos_k = (positions_k if positions_k is not None
             else torch.arange(sk, device=q.device)[None, :])
    mask = pos_q[:, None, :, None] >= pos_k[:, None, None, :]
    if window:
        mask &= pos_q[:, None, :, None] - pos_k[:, None, None, :] < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_jnp(q, k, v, chunk: int = 1024, window: int = 0):
    """Chunked online-softmax causal attention (the JAX package's pure-jnp
    flash): streams KV chunks carrying the (m, l, acc) state.  p is cast
    to v's dtype before the PV product, as in the JAX code."""
    b, sq, nh, d = q.shape
    k = _gqa_expand(k, nh)
    v = _gqa_expand(v, nh)
    sk = k.shape[1]
    n_chunks = sk // chunk
    if n_chunks * chunk != sk:
        raise ValueError(f"sk={sk} is not a multiple of chunk={chunk}")
    scale = _scale(d)
    pos_q = torch.arange(sq, device=q.device) + (sk - sq)
    qf = q.float()
    # the running state, allocated like q (so a DTensor q gives DTensor
    # state of its placements) in the contiguous layout of torch.zeros
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    m = torch.full_like(q[..., 0].transpose(1, 2), NEG_INF, **f32)
    l = torch.zeros_like(q[..., 0].transpose(1, 2), **f32)
    acc = torch.zeros_like(q.transpose(1, 2), **f32)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        pos_k = j * chunk + torch.arange(chunk, device=q.device)
        s = einsum("bqhd,bkhd->bhqk", qf, kj.float()) * scale
        mask = pos_q[None, None, :, None] >= pos_k[None, None, None, :]
        if window:
            mask &= (pos_q[None, None, :, None]
                     - pos_k[None, None, None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum(
            "bhqk,bkhd->bhqd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)          # (b, sq, H, d)


def flash_block_causal(q, k, v, q_chunk: int = 4096, kv_chunk: int = 1024,
                       window: int = 0):
    """Block-causal chunked attention: queries in chunks, each visiting
    only the KV chunks at or below its diagonal (and, under a window, not
    the far past).  Falls back to `flash_jnp` when sq is one chunk or not
    a multiple of q_chunk, as the JAX code does."""
    b, sq, nh, d = q.shape
    sk = k.shape[1]
    if sq != sk:
        raise ValueError("block-causal path expects self-attention "
                         f"(sq={sq}, sk={sk})")
    nq = sq // q_chunk
    if nq * q_chunk != sq or nq <= 1:
        return flash_jnp(q, k, v, chunk=kv_chunk, window=window)
    outs = []
    for qi in range(nq):
        qs = qi * q_chunk
        kv_end = qs + q_chunk
        kv_start = 0
        if window:
            kv_start = max(0, (qs - window) // kv_chunk * kv_chunk)
        outs.append(flash_jnp(q[:, qs:qs + q_chunk], k[:, kv_start:kv_end],
                              v[:, kv_start:kv_end],
                              chunk=min(kv_chunk, kv_end - kv_start),
                              window=window))
    return torch.cat(outs, dim=1)


def attend(q, k, v, impl: str = "flash_jnp", chunk: int = 1024,
           window: int = 0, block_causal: bool = False, q_chunk: int = 4096):
    """Causal self-attention by `impl` ("naive" | "flash_jnp" | "pallas",
    the last the hand-written flash-attention kernel).  As in the JAX
    package, every impl goes naive when sk <= chunk or sk is not a multiple
    of chunk.  The kernel is forward only: "pallas" raises a RuntimeError
    while autograd records and an input requires grad, as the JAX
    package's Pallas kernel cannot be differentiated.

    On DTensors (the dry run), attention runs on each rank's shards of
    batch rows and heads (`sharding.constraints.on_local_shards`): it is
    independent per (row, head), as GSPMD partitions it."""
    if is_dtensor(q):
        return on_local_shards(
            functools.partial(attend, impl=impl, chunk=chunk, window=window,
                              block_causal=block_causal, q_chunk=q_chunk),
            q, _gqa_expand(k, q.shape[2]), _gqa_expand(v, q.shape[2]))
    sk = k.shape[1]
    if impl == "naive" or sk % max(chunk, 1) != 0 or sk <= chunk:
        return naive_causal(q, k, v, window=window)
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=True, window=window)
    if block_causal:
        return flash_block_causal(q, k, v, q_chunk=q_chunk, kv_chunk=chunk,
                                  window=window)
    return flash_jnp(q, k, v, chunk=chunk, window=window)
