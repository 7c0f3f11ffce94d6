"""The decoder LM for the `dense` family (qwen2-7b and its kin), in torch.

A model is a stack of *periods*; for the dense family a period is one
slot, (attention, dense SwiGLU MLP).  Parameters are a plain dict keyed
like the JAX package's pytree — "embed", "lm_head", "final_norm.scale",
"slots"[0]."attn"."wq" stacked over periods (layers), and so on — so
`repro_torch.convert.params_from_jax` maps one onto the other leaf by
leaf.  The layer loop is a Python loop over periods (the JAX package
scans).

Entry points:
  init(gen, cfg, device)                     -> params
  forward(params, tokens, cfg, rc, plan=plan) -> logits, aux  (prefill)
  init_cache(cfg, rc, batch, max_len, device) -> cache (list of dicts)
  decode_step(params, cache, tok, pos, cfg, rc, plan) -> logits, cache

Unlike the JAX package, which returns a new cache, `decode_step` writes
the new token's K/V into `cache` in place and returns the same object.
With `RunConfig(kv_cache_dtype="int8")` the cache holds int8 codes with a
bf16 scale per (position, kv head), as in the JAX package.

Not ported yet: the other families (moe, ssm, hybrid, vlm, audio),
ragged per-slot positions and the paged cache (`block_tables`), with the
int8 KV cache on it; they raise NotImplementedError naming their
ROADMAP.md queue-1 item ('The other families', 'Batched serving').
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig, RunConfig
from .attention import attend, decode_attend
from .layers import (apply_rope, attn_out_proj, dense_init, dtype_of,
                     embed_init, linear, qkv_proj, rmsnorm, swiglu)


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str          # "attn"
    ffn: str | None     # "dense"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (only 'dense'); see "
            f"ROADMAP.md, queue 1, 'The other families'")


def period_slots(cfg: ModelConfig) -> list[Slot]:
    _check_family(cfg)
    return [Slot("attn", "dense")]


def n_periods(cfg: ModelConfig) -> int:
    P = len(period_slots(cfg))
    if cfg.n_layers % P:
        raise ValueError(f"{cfg.n_layers} layers do not split into periods "
                         f"of {P}")
    return cfg.n_layers // P


# --- init --------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters from `gen` (a torch.Generator on `device`),
    made one layer at a time straight into the stacked tensors."""
    _check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    L, d = n_periods(cfg), cfg.d_model
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    params = {"embed": embed_init(gen, cfg.vocab, d, dtype, device)}
    if not cfg.tie_embeddings:
        # the JAX package draws (vocab, d) and transposes; drawing (d, vocab)
        # gives the same distribution with a contiguous head
        params["lm_head"] = (torch.randn((d, cfg.vocab), generator=gen,
                                         device=device) * 0.02).to(dtype)
    params["final_norm"] = {"scale": torch.ones(d, dtype=dtype,
                                                device=device)}
    mats = {"attn": {"wq": (d, nh * dh, None), "wk": (d, kvh * dh, None),
                     "wv": (d, kvh * dh, None),
                     "wo": (nh * dh, d, 1.0 / math.sqrt(nh * dh))},
            "mlp": {"w_gate": (d, cfg.d_ff, None), "w_up": (d, cfg.d_ff, None),
                    "w_down": (cfg.d_ff, d, None)}}
    slot = {"norm1": {"scale": torch.ones((L, d), dtype=dtype,
                                          device=device)},
            "norm2": {"scale": torch.ones((L, d), dtype=dtype,
                                          device=device)}}
    for group, leaves in mats.items():
        slot[group] = {name: torch.empty((L, k, n), dtype=dtype,
                                         device=device)
                       for name, (k, n, _) in leaves.items()}
    if cfg.qkv_bias:
        for name, n in (("bq", nh * dh), ("bk", kvh * dh), ("bv", kvh * dh)):
            slot["attn"][name] = torch.zeros((L, n), dtype=dtype,
                                             device=device)
    for i in range(L):
        for group, leaves in mats.items():
            for name, (k, n, scale) in leaves.items():
                slot[group][name][i] = dense_init(gen, k, n, dtype, scale,
                                                  device)
    params["slots"] = [slot]
    return params


def init_cache(cfg: ModelConfig, rc: RunConfig, batch: int, max_len: int,
               device="cuda"):
    """KV cache: one {"k", "v"} entry per slot, each (periods, batch,
    max_len, kv_heads, head_dim) in rc.kv_cache_dtype.  An "int8" cache
    holds int8 codes and adds bf16 "k_scale" / "v_scale" leaves of shape
    (periods, batch, max_len, kv_heads)."""
    int8 = rc.kv_cache_dtype == "int8"
    dtype = torch.int8 if int8 else dtype_of(rc.kv_cache_dtype)
    shape = (n_periods(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim())
    caches = []
    for _ in period_slots(cfg):
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
        if int8:
            for key in ("k_scale", "v_scale"):
                c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=device)
        caches.append(c)
    return caches


def _quantize_kv(t):
    """(..., head_dim) -> (int8 codes, bf16 scale (...,)): per-row max-abs
    / 127.  Every step runs in t's dtype, as in the JAX package.  At a
    row's max element t / scale can round to 128; XLA's float -> int8
    convert saturates that to 127, torch's `.to(torch.int8)` would wrap it
    to -128, so the codes are clamped before the cast."""
    scale = t.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.round(t / scale).clamp(-128, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def _dequantize_kv(q, scale):
    """int8 codes and their bf16 row scales -> bf16 K or V."""
    return q.to(torch.bfloat16) * scale[..., None]


# --- forward (prefill) and decode --------------------------------------------

def _layer(tree, i: int):
    """Layer i of a stacked parameter subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _lm_logits(params, x, cfg: ModelConfig, plan=None):
    """LM head ("lm_head"); tied embeddings reuse the float embedding."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(head, x, "lm_head", plan)


def forward(params, tokens, cfg: ModelConfig, rc: RunConfig,
            image_embeds=None, plan=None):
    """The full-sequence forward (prefill).  tokens: (b, l) int.  Returns
    (logits (b, l, vocab), aux), aux = 0.0 (the dense family has no
    auxiliary loss).  `plan` (a KernelPlanTable) gates quantized
    projections per label, as in `decode_step`; attention runs
    `attend(impl=rc.attn_impl)` on positions arange(l).

    The JAX package's `remat` and sharding constraints are training and
    mesh concerns and are not applied here; the layer loop is a Python
    loop over periods (so `scan_unroll` has nothing to unroll).  Cross
    attention (`image_embeds`) and the other families raise
    NotImplementedError."""
    _check_family(cfg)
    if image_embeds is not None:
        raise NotImplementedError("cross attention (vlm image_embeds) is not "
                                  "ported yet (ROADMAP.md, queue 1, 'The "
                                  "other families')")
    b, l = tokens.shape
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    pos = torch.arange(l, device=x.device)[None, :]
    slot_params = params["slots"][0]
    for i in range(n_periods(cfg)):
        sp = _layer(slot_params, i)
        h = rmsnorm(sp["norm1"], x, cfg.rmsnorm_eps)
        q, k, v = qkv_proj(sp["attn"], h, nh, kvh, dh, plan)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        o = attend(q, k, v, impl=rc.attn_impl, chunk=rc.attn_chunk,
                   window=cfg.sliding_window, block_causal=rc.block_causal,
                   q_chunk=rc.attn_q_chunk)
        x = x + attn_out_proj(sp["attn"], o.reshape(b, l, nh * dh), plan)
        h = rmsnorm(sp["norm2"], x, cfg.rmsnorm_eps)
        x = x + swiglu(sp["mlp"], h, plan)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return _lm_logits(params, x, cfg, plan), 0.0


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                rc: RunConfig, plan=None, active=None, block_tables=None):
    """One decode step.  tokens: (b, 1) int; pos: the current length, an
    int (or 0-d tensor) shared by the batch.  Writes this token's K/V at
    `pos` into `cache` in place and returns (logits (b, 1, vocab), cache).
    `plan` is the KernelPlanTable: gated projection labels run the INT8
    GEMM kernel.  With rc.kv_cache_dtype "int8" the new K/V are
    quantized per (position, kv head), written with their scales, and
    attention reads the dequantized cache, as in the JAX package."""
    _check_family(cfg)
    if active is not None or block_tables is not None:
        raise NotImplementedError(
            "the paged, slot-masked decode path (and the int8 KV cache on "
            "it) is not ported yet (ROADMAP.md, queue 1, 'Batched serving')")
    if torch.is_tensor(pos):
        if pos.ndim != 0:
            raise NotImplementedError(
                "ragged per-slot positions need the paged cache, not ported "
                "yet (ROADMAP.md, queue 1, 'Batched serving')")
        pos = int(pos)
    int8_kv = rc.kv_cache_dtype == "int8"
    b = tokens.shape[0]
    x = params["embed"][tokens].to(dtype_of(cfg.compute_dtype))
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    pvec = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    lens = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    slot_params, slot_cache = params["slots"][0], cache[0]
    for i in range(n_periods(cfg)):
        sp = _layer(slot_params, i)
        h = rmsnorm(sp["norm1"], x, cfg.rmsnorm_eps)
        q, k, v = qkv_proj(sp["attn"], h, nh, kvh, dh, plan)
        q = apply_rope(q, pvec, cfg.rope_theta)
        k = apply_rope(k, pvec, cfg.rope_theta)
        ck, cv = slot_cache["k"][i], slot_cache["v"][i]
        if int8_kv:
            cks, cvs = slot_cache["k_scale"][i], slot_cache["v_scale"][i]
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            ck[:, pos], cks[:, pos] = kq[:, 0], ks[:, 0]
            cv[:, pos], cvs[:, pos] = vq[:, 0], vs[:, 0]
            kd, vd = _dequantize_kv(ck, cks), _dequantize_kv(cv, cvs)
        else:
            ck[:, pos] = k[:, 0].to(ck.dtype)
            cv[:, pos] = v[:, 0].to(cv.dtype)
            kd, vd = ck, cv
        o = decode_attend(q, kd, vd, lens, window=cfg.sliding_window,
                          grouped=rc.gqa_einsum)
        x = x + attn_out_proj(sp["attn"], o.reshape(b, 1, nh * dh), plan)
        h = rmsnorm(sp["norm2"], x, cfg.rmsnorm_eps)
        x = x + swiglu(sp["mlp"], h, plan)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return _lm_logits(params, x, cfg, plan), cache
