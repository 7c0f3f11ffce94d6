"""The decoder LM of every family of the JAX package, in torch.

A model is a stack of *periods*: the smallest repeating layer pattern.
Each period is a list of *slots*, each slot = (mixer, ffn) with mixer in
{attn, mla, mamba, cross} and ffn in {dense, moe, None}, as in the JAX
package:

  dense / moe / audio : period = [(attn | mla, dense | moe)]
  ssm (mamba2)        : period = [(mamba, None)]
  hybrid (jamba)      : period = [(attn, ffn0), (mamba, ffn1) x (attn_every-1)],
                        ffn_i = moe on every `moe.every_n_layers`-th slot
  vlm (llama3.2-v)    : period = [(attn, dense) x (cross_attn_every-1),
                                  (cross, dense)]

A model with `cfg.mla` (DeepSeek-V3's block, which the JAX package does
not have) attends by multi-head latent attention ("mla" slots, below),
and one with `cfg.moe.first_dense_layers` runs that many leading layers
of the same mixer with a dense FFN (width d_ff) before its periods; their
parameters are `params["lead"]`, stacked over those layers like a slot's.

An audio model (musicgen) reads and writes `n_codebooks` parallel token
streams: its embedding is (nb, vocab, d), summed over the codebooks, and
its head (nb, d, vocab), contracted by the spec "bld,ndv->blnv".  A
cross slot attends, without a mask, onto K/V projected from the image
embeddings (a (b, n_image_tokens, d_model) stub, as in the JAX package).

Parameters are a plain dict keyed like the JAX package's pytree —
"embed", "lm_head", "final_norm.scale", "slots"[s]."attn"."wq" stacked
over periods, and so on — so `repro_torch.convert.params_from_jax` maps
one onto the other leaf by leaf.  The layer loop is a Python loop over
periods and slots (the JAX package scans over periods); `forward` is
differentiable, with `rc.remat` applied per period.

Entry points:
  init(gen, cfg, device)                     -> params
  forward(params, tokens, cfg, rc[, image_embeds], plan=plan)
                                             -> logits, aux  (train, prefill)
  loss_fn(params, batch, cfg, rc)            -> loss, {"ce", "aux"}
  init_cache(cfg, rc, batch, max_len, device[, n_image_tokens])
                                             -> cache (list of dicts)
  init_paged_cache(cfg, rc, n_slots, n_blocks, block_size, device
                   [, n_image_tokens])       -> block-pool cache
  decode_step(params, cache, tok, pos, cfg, rc, plan
              [, active, block_tables])      -> logits, cache

Unlike the JAX package, which returns a new cache, `decode_step` writes
the new token's K/V, and each mamba slot's SSM state and conv carry, into
`cache` in place and returns the same object.  With
`RunConfig(kv_cache_dtype="int8")` the attention cache holds int8 codes
with a bf16 scale per (position, kv head), as in the JAX package, in the
contiguous and in the paged cache; the cross slots' image K/V stay bf16.
`decode_step` makes no host sync: `pos`, `active` and `block_tables` may
be device tensors, so the step can be captured as a CUDA graph
(`repro_torch.serving.core`).

Multi-head latent attention (an "mla" slot; HF `modeling_deepseek.py`
with `q_lora_rank` null).  Per token: q = h W_q, split per head into
q_nope (qk_nope_head_dim) and q_pe (qk_rope_head_dim); [c, k_pe] = h
W_kva, c = RMSNorm(c) (kv_lora_rank wide, eps rmsnorm_eps); RoPE on q_pe
and on k_pe, one head that every query head shares; [k_nope, v] = c
W_kvb per head; the softmax scale is qk_head_dim^-0.5.  RoPE rotates
the two halves of each 64-wide head, as the other attention slots do
(HF rotates interleaved pairs; on random weights the two differ by a
fixed permutation of W_q's and W_kva's rope columns).
  * `forward` runs the expanded form: k = [k_nope, k_pe], v per head,
    through `naive_causal`, the plain attention path (the flash kernels
    take one head width for q, k and v).
  * `decode_step` runs the absorbed form over a latent cache of one row
    [c, rope(k_pe)] (kv_lora_rank + qk_rope_head_dim wide, bf16) per
    token and layer, in place of K and V heads: the latent query
    [q_nope W_UK, q_pe] attends over the rows, the first kv_lora_rank
    columns of each row serving as V, and the result goes back through
    W_UV (W_UK and W_UV are W_kvb's k_nope and v columns).  A bf16 block
    pool on a card takes the paged MLA decode kernel
    (`kernels.ops.paged_mla_decode`), every other cache the plain
    `attention.latent_attend`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import spans
from ..configs.base import ModelConfig, RunConfig
from ..sharding.constraints import (constrain_qkv, constrain_residual,
                                    einsum, gather_fsdp, grad_placed,
                                    index_copy_, is_dtensor, logsumexp,
                                    merge_heads, pick_last, reduce_partial,
                                    replicate_over_model, split_heads)
from ..kernels import ops as kops
from ..kernels.paged import paged_view as _paged_view
from ..quant.lowbit import unpack_int4
from .attention import (_gqa_expand, _scale, attend, decode_attend,
                        latent_attend, naive_causal)
from .layers import (apply_rope, attn_out_proj, dense_init, dtype_of,
                     embed_init, linear, qkv_proj, rmsnorm, swiglu)
from .mamba2 import mamba_apply, mamba_cache_shapes, mamba_init
from .moe import moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str          # "attn" | "mamba" | "cross"
    ffn: str | None     # "dense" | "moe" | None


def period_slots(cfg: ModelConfig) -> list[Slot]:
    attn = "mla" if cfg.mla else "attn"
    if cfg.mla and cfg.family not in ("dense", "audio", "moe"):
        raise ValueError(f"{cfg.name}: latent attention runs in a dense, "
                         f"audio or moe model")
    if cfg.family in ("dense", "audio"):
        return [Slot(attn, "dense")]
    if cfg.family == "moe":
        return [Slot(attn, "moe")]
    if cfg.family == "ssm":
        return [Slot("mamba", None)]
    if cfg.family == "hybrid":
        slots = []
        for i in range(cfg.attn_every):
            mixer = "attn" if i == 0 else "mamba"
            ffn = "moe" if (cfg.moe and i % cfg.moe.every_n_layers
                            == cfg.moe.every_n_layers - 1) else "dense"
            slots.append(Slot(mixer, ffn))
        return slots
    if cfg.family == "vlm":
        ce = cfg.vision.cross_attn_every
        return [Slot("attn", "dense")] * (ce - 1) + [Slot("cross", "dense")]
    raise ValueError(f"unknown family {cfg.family!r}")


def n_lead(cfg: ModelConfig) -> int:
    """Leading layers with a dense FFN, ahead of the periods."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


def lead_slot(cfg: ModelConfig) -> Slot | None:
    """The leading layers' slot: the period's mixer and a dense FFN (only
    where the period is one slot), or None without leading layers."""
    if not n_lead(cfg):
        return None
    slots = period_slots(cfg)
    if len(slots) != 1:
        raise ValueError(f"{cfg.name}: leading dense layers ahead of a "
                         f"period of {len(slots)} slots")
    return Slot(slots[0].mixer, "dense")


def n_periods(cfg: ModelConfig) -> int:
    P = len(period_slots(cfg))
    n = cfg.n_layers - n_lead(cfg)
    if n < 0 or n % P:
        raise ValueError(f"{n} layers do not split into periods of {P}")
    return n // P


def cache_layers(cfg: ModelConfig, si: int) -> int:
    """Layers in slot si's cache entry: one per period, and slot 0's
    leading layers first (rows 0 .. n_lead - 1)."""
    return n_periods(cfg) + (n_lead(cfg) if si == 0 else 0)


# --- init --------------------------------------------------------------------

def _slot_init(gen: torch.Generator, slot: Slot, cfg: ModelConfig, dtype,
               device):
    """One layer of one slot, drawn from `gen`: the mixer's weights, then
    the FFN's (none for a slot without an FFN)."""
    d = cfg.d_model
    ones = dict(dtype=dtype, device=device)
    p = {"norm1": {"scale": torch.ones(d, **ones)}}
    if slot.mixer == "mla":
        a, nh = cfg.mla, cfg.n_heads
        p["attn"] = {
            "wq": dense_init(gen, d, nh * a.qk_head_dim, dtype,
                             device=device),
            "wkv_a": dense_init(gen, d, a.row_width, dtype, device=device),
            "kv_norm": {"scale": torch.ones(a.kv_lora_rank, **ones)},
            "wkv_b": dense_init(gen, a.kv_lora_rank,
                                nh * (a.qk_nope_head_dim + a.v_head_dim),
                                dtype, device=device),
            "wo": dense_init(gen, nh * a.v_head_dim, d, dtype,
                             1.0 / math.sqrt(nh * a.v_head_dim), device)}
    elif slot.mixer in ("attn", "cross"):
        nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
        p["attn"] = {
            name: dense_init(gen, k, n, dtype, scale, device)
            for name, (k, n, scale) in (
                ("wq", (d, nh * dh, None)), ("wk", (d, kvh * dh, None)),
                ("wv", (d, kvh * dh, None)),
                ("wo", (nh * dh, d, 1.0 / math.sqrt(nh * dh))))}
        if cfg.qkv_bias:
            for name, n in (("bq", nh * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
                p["attn"][name] = torch.zeros(n, **ones)
    else:
        p["mamba"] = mamba_init(gen, cfg, dtype, device)
    if slot.ffn is not None:
        p["norm2"] = {"scale": torch.ones(d, **ones)}
        if slot.ffn == "dense":
            p["mlp"] = {name: dense_init(gen, k, n, dtype, device=device)
                        for name, (k, n) in (("w_gate", (d, cfg.d_ff)),
                                             ("w_up", (d, cfg.d_ff)),
                                             ("w_down", (cfg.d_ff, d)))}
        else:
            p["moe"] = moe_init(gen, cfg, dtype, device)
    return p


def _stack_into(stacked, i: int, layer, n: int):
    """Write one layer's tree into row i of the stacked tree (allocated,
    with n rows, at the first layer)."""
    if stacked is None:
        stacked = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            stacked[k] = _stack_into(stacked.get(k), i, v, n)
        else:
            if k not in stacked:
                stacked[k] = torch.empty((n,) + tuple(v.shape),
                                         dtype=v.dtype, device=v.device)
            stacked[k][i] = v
    return stacked


def init(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters from `gen` (a torch.Generator on `device`), made
    one period at a time straight into the stacked tensors, slot by slot
    (so no more than one layer is drawn beside them).  An audio model
    draws one (vocab, d) embedding and one (d, vocab) head per codebook,
    stacked to (nb, vocab, d) and (nb, d, vocab); its head is never
    tied."""
    dtype = dtype_of(cfg.param_dtype)
    L, d = n_periods(cfg), cfg.d_model
    # the JAX package draws each head (vocab, d) and transposes; drawing
    # (d, vocab) gives the same distribution with a contiguous head
    def head():
        return (torch.randn((d, cfg.vocab), generator=gen,
                            device=device) * 0.02).to(dtype)
    if cfg.family == "audio":
        nb = cfg.audio.n_codebooks
        params = {
            "embed": torch.stack([embed_init(gen, cfg.vocab, d, dtype, device)
                                  for _ in range(nb)]),
            "lm_head": torch.stack([head() for _ in range(nb)])}
    else:
        params = {"embed": embed_init(gen, cfg.vocab, d, dtype, device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = head()
    params["final_norm"] = {"scale": torch.ones(d, dtype=dtype,
                                                device=device)}
    lead = None
    for i in range(n_lead(cfg)):
        lead = _stack_into(lead, i, _slot_init(gen, lead_slot(cfg), cfg,
                                               dtype, device), n_lead(cfg))
    if lead is not None:
        params["lead"] = lead
    slots = period_slots(cfg)
    stacked = [None] * len(slots)
    for i in range(L):
        for si, slot in enumerate(slots):
            stacked[si] = _stack_into(
                stacked[si], i, _slot_init(gen, slot, cfg, dtype, device), L)
    params["slots"] = stacked
    return params


def _mamba_entry(cfg: ModelConfig, batch: int, device,
                 conv_dtype=torch.bfloat16):
    """A mamba slot's per-slot O(1) cache: the f32 SSM state and the conv
    carry (bf16, as in the JAX package), stacked over periods."""
    sst, scv = mamba_cache_shapes(cfg, batch)
    np_ = n_periods(cfg)
    return {"state": torch.zeros((np_,) + sst, dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((np_,) + scv, dtype=conv_dtype,
                                device=device)}


def _cross_entry(cfg: ModelConfig, rows: int, n_image_tokens: int, device):
    """A cross slot's image K/V: bf16 {"k", "v"} of shape (periods, rows,
    n_image_tokens, kv_heads, head_dim), whatever rc.kv_cache_dtype is,
    as in the JAX package."""
    shape = (n_periods(cfg), rows, n_image_tokens, cfg.n_kv_heads,
             cfg.head_dim())
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_cache(cfg: ModelConfig, rc: RunConfig, batch: int, max_len: int,
               device="cuda", n_image_tokens: int = 0):
    """Cache: one entry per slot.  An attention slot gets {"k", "v"},
    each (periods, batch, max_len, kv_heads, head_dim) in
    rc.kv_cache_dtype; an "int8" cache holds int8 codes and adds bf16
    "k_scale" / "v_scale" leaves of shape (periods, batch, max_len,
    kv_heads).  A mamba slot gets {"state" f32 (periods, batch, heads,
    d_state, headdim), "conv" (periods, batch, d_conv - 1, channels)}.
    A cross slot gets the bf16 image K/V of `_cross_entry`, which no
    step writes (the JAX package's serving never fills them either).
    An "mla" slot gets {"kv"} (layers, batch, max_len, kv_lora_rank +
    qk_rope_head_dim): one latent row per token.  Slot 0's entry holds
    the leading dense layers' rows first (`cache_layers`).

    The conv carry is bf16 but under an f32 compute dtype, where it is
    f32: the JAX package's contiguous step returns the carry it computed
    uncast when no `active` mask is given, so its bf16 zeros turn into an
    f32 carry after the first step (its paged, masked step casts back to
    bf16, as `init_paged_cache`'s carry is)."""
    int8 = rc.kv_cache_dtype == "int8"
    dtype = torch.int8 if int8 else dtype_of(rc.kv_cache_dtype)
    conv_dtype = torch.promote_types(torch.bfloat16,
                                     dtype_of(cfg.compute_dtype))
    caches = []
    for si, slot in enumerate(period_slots(cfg)):
        if slot.mixer == "mla":
            caches.append({"kv": torch.zeros(
                (cache_layers(cfg, si), batch, max_len,
                 _latent_width(cfg, rc)), dtype=dtype, device=device)})
            continue
        if slot.mixer == "mamba":
            caches.append(_mamba_entry(cfg, batch, device, conv_dtype))
            continue
        if slot.mixer == "cross":
            caches.append(_cross_entry(cfg, batch, n_image_tokens, device))
            continue
        shape = (cache_layers(cfg, si), batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim())
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
        if int8:
            for key in ("k_scale", "v_scale"):
                c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=device)
        caches.append(c)
    return caches


def _latent_width(cfg: ModelConfig, rc: RunConfig) -> int:
    """An "mla" slot's cache row: the latent and the roped key.  The
    latent cache is kept in rc.kv_cache_dtype's float type only."""
    if rc.kv_cache_dtype == "int8":
        raise ValueError(f"{cfg.name}: latent attention keeps its cache in "
                         f"a float type, not int8")
    return cfg.mla.row_width


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


def _pool(shape, dtype, device):
    """Zeros of `shape` = (periods, n_blocks, block_size, ...): a view of
    a buffer that holds one more block after each period's pool, the
    spare block `_paged_write` sends inactive slots' rows to.  Made
    outside inference mode, whose tensors keep no view base."""
    with torch.inference_mode(False):
        base = torch.zeros((shape[0], shape[1] + 1) + tuple(shape[2:]),
                           dtype=dtype, device=device)
        return base[:, :shape[1]]


def init_paged_cache(cfg: ModelConfig, rc: RunConfig, n_slots: int,
                     n_blocks: int, block_size: int, device="cuda",
                     n_image_tokens: int = 0):
    """Block-pool KV cache for slot-scheduled continuous batching.

    Each attention slot gets a shared pool of `n_blocks` fixed-size
    blocks, (periods, n_blocks, block_size, kv_heads, head_dim), as in
    the JAX package, instead of one (batch, max_len) strip per request:
    each serving slot owns a host-managed list of physical block ids (its
    block table).  An "int8" cache adds bf16 "k_scale" / "v_scale" pools
    of shape (periods, n_blocks, block_size, kv_heads).  Every pool is a
    view of a buffer with one spare block per period beyond the pool
    (see `_paged_write`); the pool itself has the JAX package's shape.
    A mamba slot's state and conv carry stay per serving slot, one row
    for each of the `n_slots` (they are O(1) in sequence length: nothing
    to page), and so do a cross slot's image K/V.  An "mla" slot gets
    one latent pool {"kv"} (layers, n_blocks, block_size, kv_lora_rank +
    qk_rope_head_dim), leading dense layers first in slot 0's."""
    int8 = rc.kv_cache_dtype == "int8"
    dtype = torch.int8 if int8 else dtype_of(rc.kv_cache_dtype)
    caches = []
    for si, slot in enumerate(period_slots(cfg)):
        if slot.mixer == "mla":
            caches.append({"kv": _pool(
                (cache_layers(cfg, si), n_blocks, block_size,
                 _latent_width(cfg, rc)), dtype, device)})
            continue
        if slot.mixer == "mamba":
            caches.append(_mamba_entry(cfg, n_slots, device))
            continue
        if slot.mixer == "cross":
            caches.append(_cross_entry(cfg, n_slots, n_image_tokens, device))
            continue
        shape = (cache_layers(cfg, si), n_blocks, block_size,
                 cfg.n_kv_heads, cfg.head_dim())
        c = {"k": _pool(shape, dtype, device), "v": _pool(shape, dtype, device)}
        if int8:
            for key in ("k_scale", "v_scale"):
                c[key] = _pool(shape[:-1], torch.bfloat16, device)
        caches.append(c)
    return caches


def clone_cache(cache):
    """A copy of a cache from `init_cache` or `init_paged_cache` (each
    pool copied with its spare block, so `decode_step` can write it)."""
    out = []
    for entry in cache:
        copy = {}
        for key, t in entry.items():
            base = t._base
            if base is not None and base.dim() == t.dim() and (
                    base.shape[1] == t.shape[1] + 1):
                with torch.inference_mode(False):
                    copy[key] = base.clone()[:, :t.shape[1]]
            else:
                copy[key] = t.clone()
        out.append(copy)
    return out


def _rows_with_spare(pool):
    """The pool (n_blocks, block_size, ...) as rows (n_blocks *
    block_size + block_size, ...) that run on into its spare block.
    Raises unless the pool was allocated with one (`init_paged_cache`):
    past another pool's last block lie live rows."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    base, nd = pool._base, pool.dim()
    row = pool[0, 0].numel()
    ok = (base is not None and base.is_contiguous() and base.dim() >= nd
          and base.shape[base.dim() - nd] == n_blocks + 1
          and tuple(base.shape[base.dim() - nd + 1:]) == tuple(pool.shape[1:])
          and pool.stride()[:2] == (bs * row, row)
          and pool[0, 0].is_contiguous())
    if not ok:
        raise ValueError("a paged pool needs the spare block of "
                         "init_paged_cache to drop inactive slots' rows")
    return pool.as_strided(((n_blocks + 1) * bs,) + tuple(pool.shape[2:]),
                           (row,) + tuple(pool.stride()[2:]))


def _paged_write(pool, new, pos, block_tables, active):
    """Scatter one row per slot into a block pool, in place.

    pool: (n_blocks, block_size, ...); new: (b, ...); pos: (b,) logical
    positions; block_tables: (b, max_blocks) physical block ids.  An
    inactive slot's row goes to the pool's spare block, past the pool,
    and so touches no block (the JAX package sends it out of bounds and
    drops it; torch's index ops raise on an out-of-bounds index, and
    rewriting a live row with its old value would race with the slot
    that writes it).  Active slots own distinct blocks, so their rows
    never collide.  Returns the pool."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    pos = pos.long()
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    phys = blk * bs + pos % bs
    if active is not None:
        phys = torch.where(active, phys, n_blocks * bs)
    _rows_with_spare(pool).index_copy_(0, phys, new.to(pool.dtype))
    return pool


# --- forward (prefill) and decode --------------------------------------------

def _layer(tree, i: int):
    """Layer i of a stacked parameter subtree (views, no copies): how the
    decode step, which runs without autograd, takes its layers (`forward`
    unbinds each leaf once instead, `_per_period`)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype.  Audio tokens (..., nb) look
    up each codebook's table and sum the nb rows in f32 in codebook
    order, rounded once to the compute dtype: the JAX package's bf16
    `jnp.sum` over the gathers gives those bits on XLA (it accumulates a
    bf16 reduction in f32)."""
    dtype = dtype_of(cfg.compute_dtype)
    embed = gather_fsdp(params["embed"])
    if cfg.family != "audio":
        return reduce_partial(F.embedding(tokens, embed)).to(dtype)
    tables = embed.unbind(0)
    x = reduce_partial(F.embedding(tokens[..., 0], tables[0])).float()
    for i in range(1, len(tables)):
        x = x + reduce_partial(F.embedding(tokens[..., i],
                                           tables[i])).float()
    return x.to(dtype)


def _cross_q_proj(sp, h, nh, dh, plan=None):
    """Cross-attention query projection ("xattn-Q"), shared by the
    full-sequence forward and the decode step."""
    return split_heads(linear(sp["attn"]["wq"], h, "xattn-Q", plan), nh, dh)


def _lm_logits(params, x, cfg: ModelConfig, plan=None):
    """LM head ("lm_head").  An audio head is per codebook, (nb, d, vocab),
    contracted by the spec "bld,ndv->blnv" (so it never takes the GEMM
    kernel, which runs 2-D weights only); tied embeddings reuse the float
    embedding."""
    if cfg.family == "audio":
        return linear(gather_fsdp(params["lm_head"]), x, "lm_head", plan,
                      spec="bld,ndv->blnv")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return linear(gather_fsdp(head), x, "lm_head", plan)


def _cross_mix(sp, h, image_kv, cfg: ModelConfig, plan=None):
    """A cross slot's mixer over the full sequence: unmasked f32 softmax
    attention of the queries onto the image K/V, then "xattn-out"."""
    nh, dh = cfg.n_heads, cfg.head_dim()
    q = _cross_q_proj(sp, h, nh, dh, plan)
    kimg, vimg = (_gqa_expand(t, nh).float() for t in image_kv)
    s = einsum("bqhd,bkhd->bhqk", q.float(), kimg) / math.sqrt(dh)
    p = torch.softmax(s, dim=-1)
    o = einsum("bhqk,bkhd->bqhd", p, vimg)
    return attn_out_proj(sp["attn"], merge_heads(o.to(h.dtype)), plan,
                         label="xattn-out")


def _apply_ffn(slot: Slot, sp, x, cfg: ModelConfig, plan=None):
    """The slot's FFN with its residual: (x, aux); aux is 0.0 but for a
    MoE FFN."""
    if slot.ffn is None:
        return x, 0.0
    h = rmsnorm(sp["norm2"], x, cfg.rmsnorm_eps)
    if slot.ffn == "dense":
        return x + swiglu(sp["mlp"], h, plan), 0.0
    y, aux = moe_apply(sp["moe"], h, cfg, plan)
    return x + y, aux


def _per_period(tree, n: int) -> list:
    """The n per-period views of a stacked parameter subtree, each leaf
    unbound once along its period axis.  Under autograd one
    UnbindBackward0 per leaf stacks the n row gradients once; taking
    tree[i] in every period would add a SelectBackward0 per period, whose
    backward fills a zero tensor the size of the whole leaf."""
    if isinstance(tree, dict):
        per = {k: _per_period(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _dots_saveable():
    """Selective-checkpoint contexts that keep every matmul's output and
    recompute the rest (the counterpart of
    `jax.checkpoint_policies.dots_saveable`)."""
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def forward(params, tokens, cfg: ModelConfig, rc: RunConfig,
            image_embeds=None, plan=None):
    """The full-sequence forward (train and prefill).  tokens: (b, l) int,
    or (b, l, nb) for audio.  Returns (logits (b, l, vocab) (audio: (b,
    l, nb, vocab)), aux): aux sums the MoE load-balancing losses over the
    MoE slots (0.0 for a model without one).  A vlm model needs
    `image_embeds` (b, n_image_tokens, d_model): each cross slot projects
    its K/V from them ("xattn-KV", not normalized), as the JAX package
    does; other families ignore them.  `plan` (a KernelPlanTable) gates
    quantized projections per label, as in `decode_step`; attention runs
    `attend(impl=rc.attn_impl)` on positions arange(l); a mamba slot runs
    the chunked SSD with chunk min(cfg.ssm.chunk, l), which must divide l
    (ValueError otherwise).

    With `rc.remat`, and only while autograd records (a prefill under
    `torch.no_grad` or `inference_mode` runs plain), each period runs
    under `torch.utils.checkpoint.checkpoint` (non-reentrant): policy
    "nothing" keeps only the period's input and recomputes the rest in
    the backward, "dots" also keeps every matmul's output, as the JAX
    package's `jax.checkpoint` policies do.  Where the JAX package pins
    q/k/v (rc.shard_attn / shard_heads) and the residual
    (rc.sp_residual) with sharding constraints, and where GSPMD would
    gather FSDP weights or pad uneven heads, the port calls the
    redistribution points of `sharding.constraints`: they act on
    DTensors (the dry run) and return plain tensors as they came.  The
    layer loop is a Python loop over periods (so `scan_unroll` has
    nothing to unroll)."""
    slots = period_slots(cfg)
    if image_embeds is None and any(s.mixer == "cross" for s in slots):
        raise ValueError(f"{cfg.name}: a vlm forward needs image_embeds "
                         f"(b, n_image_tokens, d_model)")
    x = _embed(params, tokens, cfg)
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    pos = torch.arange(tokens.shape[1], device=x.device)[None, :]
    L = n_periods(cfg)
    layers = [_per_period(slot_params, L) for slot_params in params["slots"]]

    def block(slot, sp, x, aux):
        sp = gather_fsdp(sp)
        if slot.mixer == "cross":
            # the image K/V first, then the mixer: the JAX package's
            # order of the route trace
            image_kv = [split_heads(linear(sp["attn"][w], image_embeds,
                                           "xattn-KV", plan), kvh, dh, "kv")
                        for w in ("wk", "wv")]
        h = rmsnorm(sp["norm1"], x, cfg.rmsnorm_eps)
        if slot.mixer == "cross":
            y = _cross_mix(sp, h, image_kv, cfg, plan)
        elif slot.mixer == "mamba":
            y, _ = mamba_apply(sp["mamba"], h, cfg, plan=plan)
        elif slot.mixer == "mla":
            y = _mla_mix(sp["attn"], h, pos, cfg, plan)
        else:
            q, k, v = qkv_proj(sp["attn"], h, nh, kvh, dh, plan)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
            q, k, v = constrain_qkv(q, k, v, rc)
            o = attend(q, k, v, impl=rc.attn_impl, chunk=rc.attn_chunk,
                       window=cfg.sliding_window,
                       block_causal=rc.block_causal,
                       q_chunk=rc.attn_q_chunk)
            y = attn_out_proj(sp["attn"], merge_heads(o), plan)
        x, a = _apply_ffn(slot, sp, constrain_residual(x + y, rc), cfg, plan)
        return constrain_residual(x, rc), aux + a

    def period(i, x, aux):
        for slot, per in zip(slots, layers):
            x, aux = block(slot, per[i], x, aux)
        return x, aux

    def leading(i, x, aux):
        return block(lead_slot(cfg), lead[i], x, aux)

    lead = (_per_period(params["lead"], n_lead(cfg)) if n_lead(cfg)
            else [])
    remat = rc.remat and torch.is_grad_enabled()
    context_fn = (_dots_saveable if rc.remat_policy == "dots"
                  else noop_context_fn)
    aux = 0.0
    for fn, i in ([(leading, i) for i in range(len(lead))]
                  + [(period, i) for i in range(L)]):
        if remat:
            x, aux = checkpoint(fn, i, x, aux, use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = fn(i, x, aux)
    x = rmsnorm(gather_fsdp(params["final_norm"]), x, cfg.rmsnorm_eps)
    return _lm_logits(params, x, cfg, plan), aux


def loss_fn(params, batch, cfg: ModelConfig, rc: RunConfig):
    """batch: {"tokens", "targets"[, "image_embeds"]} -> (ce + aux,
    {"ce", "aux"}): the mean next-token cross entropy, f32 logsumexp of
    the logits minus the gold logit, plus the MoE aux loss (0 without
    MoE).  The gold logit is a gather, the same numbers as the JAX
    package's masked sum over the vocab axis, which the dry run's
    vocab-sharded DTensors take (`sharding.constraints.pick_last`).
    `rc.shard_loss` is a mesh concern and is ignored here."""
    logits, aux = forward(params, batch["tokens"], cfg, rc,
                          image_embeds=batch.get("image_embeds"))
    lf = logits.to(torch.float32)
    lse = logsumexp(lf)
    gold = pick_last(lf, batch["targets"])
    ce = torch.mean(grad_placed(lse - gold))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


def _mask_rows(new, old, active):
    """Per-slot select: active slots take the updated cache row, free or
    draining slots keep theirs, so garbage tokens can't corrupt them."""
    if active is None:
        return new
    m = active.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new.to(old.dtype), old)


def _mamba_step(mp, layer, h, cfg: ModelConfig, plan, active):
    """A mamba slot's decode step: the recurrent update from the layer's
    SSM state and conv carry, written back in place (an inactive slot's
    rows keep theirs).  Returns the mixer output."""
    y, (st, cv) = mamba_apply(mp, h, cfg, state=layer["state"],
                              conv_carry=layer["conv"], decode=True,
                              plan=plan)
    layer["state"].copy_(_mask_rows(st, layer["state"], active))
    layer["conv"].copy_(_mask_rows(cv, layer["conv"], active))
    return y


def paged_kernel_fits(pool, block_tables) -> bool:
    """Whether an attention slot's decode step attends through the paged
    flash-decoding kernel (`kernels.ops.paged_decode_attention`; an "mla"
    slot: `kernels.ops.paged_mla_decode`), from the kind of cache the
    step sees: a block pool (`block_tables` given) in bf16 on a card, not
    a DTensor.  The kernel's wrapper checks its shape contract and
    raises where a pool does not meet it.  Every other cache
    keeps `decode_attend`: the int8 pool (its dequant is not fused into
    the kernel), the contiguous cache, CPU tensors (the tests' and the
    reference comparisons' bits) and the dry run's meta DTensors.  A cross
    slot never asks (`_cross_step`)."""
    return (block_tables is not None and pool.device.type == "cuda"
            and pool.dtype == torch.bfloat16 and not is_dtensor(pool))


def _write_rows(t, new, pos, pvec, active, block_tables):
    """This step's rows new (b, 1, ...) into a layer's cache t: its block
    pool at each slot's position (`_paged_write`), or the contiguous
    cache (b, max_len, ...) at `pos`."""
    if block_tables is not None:
        _paged_write(t, new[:, 0], pvec[:, 0], block_tables, active)
    elif torch.is_tensor(pos):
        index_copy_(t, 1, pvec[:1, 0], new.to(t.dtype))
    else:
        t[:, pos] = new[:, 0].to(t.dtype)


def absorbed_mla(ap, cfg: ModelConfig, dtype):
    """An "mla" slot's W_kvb (..., kv_lora_rank, H * (nope + v)), one
    layer's or a stack's, as the absorbed decode's two operands: {"uk":
    W_UK (..., H, nope, kv_lora_rank), "uv": W_UV (..., H, kv_lora_rank,
    v)} in `dtype`, contiguous.  A quantized leaf's codes times its
    per-column scale are formed in f32 and rounded to `dtype` once."""
    a, nh = cfg.mla, cfg.n_heads
    w = ap["wkv_b"]
    if not isinstance(w, dict):
        wf = w.float()
    else:
        codes = (unpack_int4(w["q4"], a.kv_lora_rank) if "q4" in w
                 else w["qf8" if "qf8" in w else "q"])
        wf = codes.float() * w["scale"].float()[..., None, :]
    uk, uv = wf.unflatten(-1, (nh, -1)).split(
        [a.qk_nope_head_dim, a.v_head_dim], -1)
    return {"uk": uk.movedim(-3, -1).contiguous().to(dtype),
            "uv": uv.movedim(-2, -3).contiguous().to(dtype)}


def with_absorbed(params, cfg: ModelConfig):
    """`params` with each "mla" slot's absorbed W_UK / W_UV stacked over
    its layers beside W_kvb (`attn["absorbed"]`, in the compute dtype),
    so that the decode step reads them in place of re-forming them from
    W_kvb every step; a model without latent attention as it is."""
    if not cfg.mla:
        return params
    dtype = dtype_of(cfg.compute_dtype)
    out = dict(params)
    for key in ("lead", "slots"):
        if key not in params:
            continue
        entries = params[key] if key == "slots" else [params[key]]
        done = []
        for slot, sp in zip([lead_slot(cfg)] if key == "lead"
                            else period_slots(cfg), entries):
            if slot.mixer == "mla":
                sp = {**sp, "attn": {**sp["attn"], "absorbed": absorbed_mla(
                    sp["attn"], cfg, dtype)}}
            done.append(sp)
        out[key] = done if key == "slots" else done[0]
    return out


def _mla_qc(ap, h, pos, cfg: ModelConfig, plan):
    """The queries and the latent rows of tokens h (b, l, d) at positions
    pos (b | 1, l): q_nope (b, l, H, qk_nope_head_dim), q_pe roped (b, l,
    H, qk_rope_head_dim) and the rows [RMSNorm(c), rope(k_pe)] (b, l,
    kv_lora_rank + qk_rope_head_dim)."""
    a, nh = cfg.mla, cfg.n_heads
    q = split_heads(linear(ap["wq"], h, "Wq", plan), nh, a.qk_head_dim, "q")
    q_nope, q_pe = q.split([a.qk_nope_head_dim, a.qk_rope_head_dim], -1)
    c, k_pe = linear(ap["wkv_a"], h, "Wkva", plan).split(
        [a.kv_lora_rank, a.qk_rope_head_dim], -1)
    c = rmsnorm(ap["kv_norm"], c, cfg.rmsnorm_eps)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    k_pe = apply_rope(k_pe[..., None, :], pos, cfg.rope_theta)[..., 0, :]
    return q_nope, q_pe, torch.cat([c, k_pe], dim=-1)


def _mla_mix(ap, h, pos, cfg: ModelConfig, plan=None):
    """An "mla" slot's mixer over the full sequence, in the expanded
    form: k = [c W_UK, k_pe] and v = c W_UV per head ("Wkvb"), causal
    attention by `naive_causal` at scale qk_head_dim^-0.5, then "Wo"."""
    a, nh = cfg.mla, cfg.n_heads
    b, l = h.shape[:2]
    q_nope, q_pe, row = _mla_qc(ap, h, pos, cfg, plan)
    c, k_pe = row.split([a.kv_lora_rank, a.qk_rope_head_dim], -1)
    kv = split_heads(linear(ap["wkv_b"], c, "Wkvb", plan), nh,
                     a.qk_nope_head_dim + a.v_head_dim, "kv")
    k_nope, v = kv.split([a.qk_nope_head_dim, a.v_head_dim], -1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        b, l, nh, a.qk_rope_head_dim)], dim=-1)
    return attn_out_proj(ap, merge_heads(naive_causal(q, k, v)), plan)


def _mla_step(ap, layer, h, pos, pvec, lens, cfg: ModelConfig, plan,
              active, block_tables):
    """An "mla" slot's decode step, in the absorbed form: this token's
    latent row written into the layer's latent cache ("attn.kv_write"),
    then ("attn.core") the latent query [q_nope W_UK, q_pe] attends over
    the rows at scale qk_head_dim^-0.5 (the paged MLA kernel on a bf16
    pool on a card, `latent_attend` on every other cache) and the
    latent output goes back through W_UV.  W_UK and W_UV are the
    layer's `absorbed_mla` operands, prepared once by `with_absorbed`
    (formed here where the params lack them).  Returns "Wo"'s output."""
    a, nh = cfg.mla, cfg.n_heads
    b = h.shape[0]
    q_nope, q_pe, row = _mla_qc(ap, h, pvec, cfg, plan)
    with spans.span("attn.kv_write"):
        _write_rows(layer["kv"], row, pos, pvec, active, block_tables)
    with spans.span("attn.core"):
        ab = (ap["absorbed"] if "absorbed" in ap
              else absorbed_mla(ap, cfg, h.dtype))
        q_lat = einsum("bhj,hjc->bhc", q_nope[:, 0], ab["uk"])
        qf = torch.cat([q_lat, q_pe[:, 0]], dim=-1)   # (b, H, row_width)
        sm = _scale(a.qk_head_dim)
        if paged_kernel_fits(layer["kv"], block_tables):
            o = kops.paged_mla_decode(qf, layer["kv"], block_tables, lens,
                                      sm)
        else:
            rows = (layer["kv"] if block_tables is None
                    else _paged_view(layer["kv"], block_tables))
            o = latent_attend(qf, rows, lens, sm, a.kv_lora_rank)
        o = einsum("bhc,hcj->bhj", o, ab["uv"])
    return attn_out_proj(ap, o.reshape(b, 1, nh * a.v_head_dim), plan)


def _attn_step(ap, layer, h, pos, pvec, lens, cfg: ModelConfig,
               rc: RunConfig, plan, active, block_tables):
    """An attention slot's decode step: this token's K/V (int8 codes and
    scales with an "int8" cache) written into the layer's contiguous
    cache at `pos`, or into its block pool at each slot's position, then
    attention over the valid prefix: the paged kernel reads a bf16 pool
    in place where `paged_kernel_fits`, `decode_attend` takes every other
    cache (a pool through each slot's gathered strip).  Returns the
    output projection."""
    b = h.shape[0]
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    int8_kv = rc.kv_cache_dtype == "int8"
    q, k, v = qkv_proj(ap, h, nh, kvh, dh, plan)
    q = apply_rope(q, pvec, cfg.rope_theta)
    k = apply_rope(k, pvec, cfg.rope_theta)
    with spans.span("attn.kv_write"):
        if int8_kv:
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            rows = {"k": k, "v": v}
        for key, new in rows.items():
            _write_rows(layer[key], new, pos, pvec, active, block_tables)
    kernel = paged_kernel_fits(layer["k"], block_tables)
    with spans.span("attn.gather"):
        strip = layer
        if block_tables is not None and not kernel:
            strip = {key: _paged_view(layer[key], block_tables)
                     for key in rows}
        if int8_kv:
            kd = _dequantize_kv(strip["k"], strip["k_scale"])
            vd = _dequantize_kv(strip["v"], strip["v_scale"])
        else:
            kd, vd = strip["k"], strip["v"]
    with spans.span("attn.core"):
        if kernel:
            o = kops.paged_decode_attention(q, kd, vd, block_tables, lens,
                                            window=cfg.sliding_window)
        else:
            o = decode_attend(q, kd, vd, lens, window=cfg.sliding_window,
                              grouped=rc.gqa_einsum)
    return attn_out_proj(ap, o.reshape(b, 1, nh * dh), plan)


def _cross_step(sp, layer, h, cfg: ModelConfig, plan):
    """A cross slot's decode step: the query attends, through the plain
    `decode_attend`, to all n_image_tokens rows of the layer's image K/V
    (read only).  Returns "xattn-out"'s output."""
    b = h.shape[0]
    nh, dh = cfg.n_heads, cfg.head_dim()
    q = _cross_q_proj(sp, h, nh, dh, plan)
    n_img = torch.full((b,), layer["k"].shape[1], dtype=torch.long,
                       device=h.device)
    with spans.span("attn.core"):
        o = decode_attend(q, layer["k"], layer["v"], n_img)
    return attn_out_proj(sp["attn"], o.reshape(b, 1, nh * dh), plan,
                         label="xattn-out")


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                rc: RunConfig, plan=None, active=None, block_tables=None):
    """One decode step.  tokens: (b, 1) int (audio: (b, 1, nb)); pos: the
    current length shared by the batch, an int or a 0-d tensor, OR (b,)
    per-slot lengths (ragged, continuous batching).  Writes this token's
    K/V, and each mamba slot's new SSM state and conv carry, into `cache`
    in place and returns (logits (b, 1, vocab) (audio: (b, 1, nb,
    vocab)), cache).  A cross slot attends to its image K/V as they
    stand in the cache.  `plan` is the KernelPlanTable: gated projection
    labels run the INT8 GEMM kernel.
    With rc.kv_cache_dtype "int8" the new K/V are quantized per
    (position, kv head), written with their scales, and attention reads
    the dequantized cache, as in the JAX package.

    Continuous batching (as in the JAX package):
      * ragged `pos` (b,): each slot attends and ropes at its own length;
      * `active` (b,) bool: inactive (free or draining) slots write no
        cache row, and their mamba state and conv carry stay as they were;
      * `block_tables` (b, max_blocks) int: K/V (an "mla" slot: latent
        rows) live in the block pool of `init_paged_cache`; the step
        scatters one row into each slot's current block and attends over
        the slot's positions (a bf16 pool on the card through the paged
        kernel, which reads the pool in place; every other pool through
        the slot's gathered strip).
        Required whenever `pos` is ragged and the period has an attention
        slot.

    No input is read on the host: a tensor `pos` stays on the device, so
    the step can be captured as a CUDA graph and replayed."""
    slots = period_slots(cfg)
    ragged = torch.is_tensor(pos) and pos.ndim == 1
    if torch.is_tensor(pos) and pos.ndim > 1:
        raise ValueError(f"pos must be 0-d or (b,), got {tuple(pos.shape)}")
    if ragged and block_tables is None and any(s.mixer in ("attn", "mla")
                                              for s in slots):
        raise ValueError("ragged per-slot positions need a paged KV cache: "
                         "pass block_tables (see init_paged_cache)")
    b = tokens.shape[0]
    with spans.span("decode.step"):
        x = _embed(params, tokens, cfg)
        if torch.is_tensor(pos):
            pvec = pos.long().reshape(-1, 1).expand(b, 1)
            lens = pvec[:, 0] + 1
        else:
            pvec = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
            lens = torch.full((b,), pos + 1, dtype=torch.long, device=x.device)

        def block(slot, sp, layer, x):
            sp = gather_fsdp(sp)
            h = rmsnorm(sp["norm1"], x, cfg.rmsnorm_eps)
            if slot.mixer == "mamba":
                y = _mamba_step(sp["mamba"], layer, h, cfg, plan, active)
            elif slot.mixer == "cross":
                y = _cross_step(sp, layer, h, cfg, plan)
            elif slot.mixer == "mla":
                y = _mla_step(sp["attn"], layer, h, pos, pvec, lens, cfg,
                              plan, active, block_tables)
            else:
                y = _attn_step(sp["attn"], layer, h, pos, pvec, lens, cfg,
                               rc, plan, active, block_tables)
            x, _ = _apply_ffn(slot, sp, replicate_over_model(x + y), cfg,
                              plan)
            return replicate_over_model(x)

        lead = n_lead(cfg)
        for i in range(lead):           # slot 0's cache rows 0 .. lead - 1
            x = block(lead_slot(cfg), _layer(params["lead"], i),
                      {key: t[i] for key, t in cache[0].items()}, x)
        for i in range(n_periods(cfg)):
            for si, (slot, slot_params, slot_cache) in enumerate(
                    zip(slots, params["slots"], cache)):
                row = i + (lead if si == 0 else 0)
                x = block(slot, _layer(slot_params, i),
                          {key: t[row] for key, t in slot_cache.items()}, x)
        x = rmsnorm(gather_fsdp(params["final_norm"]), x, cfg.rmsnorm_eps)
        return _lm_logits(params, x, cfg, plan), cache
