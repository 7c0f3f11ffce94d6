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
  init_cache(cfg, rc, batch, max_len, device) -> cache (list of dicts)
  decode_step(params, cache, tok, pos, cfg, rc, plan) -> logits, cache

Unlike the JAX package, which returns a new cache, `decode_step` writes
the new token's K/V into `cache` in place and returns the same object.

Not ported yet: the other families (moe, ssm, hybrid, vlm, audio),
`forward`, `kv_cache_dtype="int8"`, ragged per-slot positions and the
paged cache (`block_tables`); they raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig, RunConfig
from .attention import decode_attend
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
            f"ROADMAP.md, the port's later slices")


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
    max_len, kv_heads, head_dim) in rc.kv_cache_dtype."""
    if rc.kv_cache_dtype == "int8":
        raise NotImplementedError("int8 KV cache is not ported yet "
                                  "(ROADMAP.md, port slice 3)")
    dtype = dtype_of(rc.kv_cache_dtype)
    shape = (n_periods(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim())
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in period_slots(cfg)]


# --- decode ---------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer i of a stacked parameter subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _lm_logits(params, x, cfg: ModelConfig, plan=None):
    """LM head ("lm_head"); tied embeddings reuse the float embedding."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(head, x, "lm_head", plan)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                rc: RunConfig, plan=None, active=None, block_tables=None):
    """One decode step.  tokens: (b, 1) int; pos: the current length, an
    int (or 0-d tensor) shared by the batch.  Writes this token's K/V at
    `pos` into `cache` in place and returns (logits (b, 1, vocab), cache).
    `plan` is the KernelPlanTable: gated projection labels run the INT8
    GEMM kernel."""
    _check_family(cfg)
    if active is not None or block_tables is not None:
        raise NotImplementedError("the paged, slot-masked decode path is "
                                  "not ported yet (ROADMAP.md)")
    if rc.kv_cache_dtype == "int8":
        raise NotImplementedError("int8 KV cache is not ported yet "
                                  "(ROADMAP.md, port slice 3)")
    if torch.is_tensor(pos):
        if pos.ndim != 0:
            raise NotImplementedError("ragged per-slot positions need the "
                                      "paged cache, not ported yet")
        pos = int(pos)
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
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        o = decode_attend(q, ck, cv, lens, window=cfg.sliding_window,
                          grouped=rc.gqa_einsum)
        x = x + attn_out_proj(sp["attn"], o.reshape(b, 1, nh * dh), plan)
        h = rmsnorm(sp["norm2"], x, cfg.rmsnorm_eps)
        x = x + swiglu(sp["mlp"], h, plan)
    x = rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return _lm_logits(params, x, cfg, plan), cache
