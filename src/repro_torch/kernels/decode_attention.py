"""Flash-decoding — the hand-written Hopper kernel that replaces the TPU
kernel `repro/kernels/decode_attention.py` (`_kernel`: one query token
against a KV cache whose first `length` positions are valid), beside its
plain torch version.

Folded contract, as the TPU kernel's: q (bh, 1, d); caches (bh_kv, S, d)
with bh a multiple of bh_kv, query row i reading cache row
i // (bh // bh_kv) (with bh_kv == bh this is exactly the TPU kernel's
contract; `ops.decode_attention` folds (b, 1, H, d) this way without
repeating the caches); `length` a scalar.  Positions >= length are masked
with -1e30, so length = 0 gives the mean of v over all S positions.

The CUDA source is `csrc/decode_attention.cu` (its header gives the bound
and the designs: the S axis is split across blocks by `split_plan` and a
second kernel combines the splits).  `kernels/build.py` compiles it with
nvcc for sm_90a at first use and loads it with ctypes.  `decode_attention`
takes the launch path of `kernels/launch.py` (`length` may be a Python
int or an int tensor on the card: the kernel reads it from device
memory, so a launch never syncs the host).  The dtype picks the design
(`design`): "mma" for bf16 (a TMA ring and tensor-core products, every
head width in HEAD_DIMS), "fma" for f32.

`paged_decode_attention` is the engine's decode attention over a paged
KV cache (`models/model.py:init_paged_cache`), design "paged": q (b, 1,
H, d) against the layer's K and V block pools (n_blocks, bs, KV, d),
read in place through `block_tables` (b, max_blocks) at each slot's own
`lengths` (b,) and `window` (0 = none), both read from device memory.
Its plain version, `paged_decode_attention_ref`, is `decode_attend` (the
model's decode attention over a contiguous cache, kept here beside the
kernel) over each slot's gathered strip (`paged.paged_view`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..sharding.constraints import einsum
from . import launch
from .build import KernelBuild, build_library
from .flash_attention import (HEAD_DIMS, NEG_INF, _repeat, check_card,
                              compare_to_plain)
from .paged import (card_tables, check_pools, check_tables, paged_view,
                    split_plan)

HEADS_PER_BLOCK = 16             # csrc/decode_attention.cu: HB_MAX
TILE = 64                        # csrc/decode_attention.cu: TK and dk::T
DESIGNS = ("mma", "fma")
PAGED_DESIGNS = ("paged",)


def design(dtype) -> str:
    """The kernel design a CUDA call in `dtype` runs: "mma" for bf16,
    "fma" for f32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return build_library(
        "decode_attention",
        decode_attention_launch=[vp] * 6 + [i32] * 8 + [ctypes.c_float, vp],
        paged_decode_attention_launch=(
            [vp, ll, ll, vp, vp] + [i32] * 3 + [ll] * 3
            + [vp, ll, i32, vp, vp, vp] + [i32] * 8 + [ctypes.c_float, vp]))


@functools.lru_cache(maxsize=None)
def inv_sqrt_f32(d: int) -> float:
    """1 / sqrt(d) rounded to f32, as a Python float holding that f32
    value exactly.  It is computed once, on the CPU, so a step captured
    as a CUDA graph makes no host-to-device copy for it; multiplying an
    f32 tensor by it gives the same bits as multiplying by the f32
    tensor (IEEE sqrt and division are correctly rounded on both
    devices)."""
    return (1.0 / torch.sqrt(torch.tensor(float(d),
                                          dtype=torch.float32))).item()


def gqa_expand(k, n_heads: int):
    """(b, s, kv, d) -> (b, s, H, d) by repeating kv heads (each kv head
    n_heads // kv times in a row, as `repeat_interleave` does; written as
    an expand and a reshape, which DTensor propagates over a sharded
    sequence dim where its `repeat_interleave` does not)."""
    b, s, kv, d = k.shape
    if kv == n_heads:
        return k
    return k[:, :, :, None, :].expand(b, s, kv, n_heads // kv, d).reshape(
        b, s, n_heads, d)


def decode_attend(q, k_cache, v_cache, cache_len, window: int = 0,
                  grouped: bool = False):
    """Single-token decode attention over a (b, S, KV, d) cache: the
    model's decode attention wherever no kernel reads its cache, and the
    paged kernel's plain version.

    cache_len: (b,) valid lengths.  q: (b, 1, H, d).  Linear in S.
    grouped=True uses grouped-query einsums that never materialize the
    GQA-expanded cache."""
    b, _, nh, d = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    scale = inv_sqrt_f32(d)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < cache_len[:, None]
    if window:
        valid &= pos >= (cache_len[:, None] - window)
    if grouped:
        rep = nh // kv
        qg = q.reshape(b, 1, kv, rep, d).float()
        s = einsum("bqgrd,bsgd->bgrqs", qg, k_cache.float()) * scale
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = einsum("bgrqs,bsgd->bqgrd", p, v_cache.float())
        return out.reshape(b, 1, nh, d).to(q.dtype)
    k = gqa_expand(k_cache, nh)
    v = gqa_expand(v_cache, nh)
    s = einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _probs(q, k_cache, length, window: int = 0):
    """The plain version's softmax weights, (bh, 1, S) in f32; the cache
    already repeated to q's rows.  `length`: one valid prefix, or one per
    row (bh,); a window keeps positions >= length - window."""
    S, d = k_cache.shape[1], k_cache.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(),
                     k_cache.float()) * inv_sqrt_f32(d)
    pos = torch.arange(S, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    if length.ndim:
        length = length.reshape(-1, 1, 1)
    mask = pos < length
    if window:
        mask = mask & (pos >= length - window)
    return torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)


def decode_attention_ref(q, k_cache, v_cache, length):
    """The plain version: `repro/kernels/ref.py:decode_attention_ref` on
    folded tensors (caches repeated to q's rows), in f32, output (bh, 1, d)
    in q's dtype."""
    rows = q.shape[0]
    p = _probs(q, _repeat(k_cache, rows), length)
    return torch.einsum("bqk,bkd->bqd", p,
                        _repeat(v_cache, rows).float()).to(q.dtype)


def decode_attention_check(got, q, k_cache, v_cache, length,
                           window: int = 0) -> dict:
    """`flash_attention.compare_to_plain` for a decode_attention result on
    folded inputs; the kernel keeps p in f32.  `length` and `window` as
    `_probs` takes them (a paged result: fold it, q and the gathered
    strips, with one length per query row)."""
    rows = q.shape[0]
    return compare_to_plain(
        got, _probs(q, _repeat(k_cache, rows), length, window),
        _repeat(v_cache, rows), p_rounded=False)


def check_shapes(q, k_cache, v_cache, block_kv: int) -> int:
    """Validate the folded shapes and the TPU kernel's block contract
    (S divisible by min(block_kv, S)); returns rep = bh // bh_kv."""
    if q.ndim != 3 or q.shape[1] != 1 or k_cache.ndim != 3 or (
            v_cache.shape != k_cache.shape):
        raise ValueError(f"decode_attention wants q (bh, 1, d) and caches "
                         f"(bh_kv, S, d); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    bh, _, d = q.shape
    bh_kv, S, dk = k_cache.shape
    if dk != d or bh_kv < 1 or bh % bh_kv:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}: head widths must match "
                         f"and bh be a multiple of bh_kv")
    bkv = min(block_kv, S)
    if bkv < 1 or S % bkv:
        raise ValueError(f"S={S} is not a multiple of the block {bkv}; the "
                         f"TPU kernel's contract")
    return bh // bh_kv


def heads_per_block(rep: int) -> int:
    """The most query heads of one kv head a block can serve (a divisor
    of rep, at most HEADS_PER_BLOCK)."""
    return max(h for h in range(1, min(rep, HEADS_PER_BLOCK) + 1)
               if rep % h == 0)


@launch.counted(*DESIGNS)
def decode_attention(q, k_cache, v_cache, length, *, block_kv: int = 512):
    """q (bh, 1, d), caches (bh_kv, S, d), length: the valid prefix ->
    (bh, 1, d) in q's dtype.

    `block_kv` keeps the TPU kernel's shape contract; the CUDA kernel
    splits S by its own plan, which changes only the order of f32 sums.
    Forward only: raises a RuntimeError while autograd records and an
    input requires grad (`launch.refuse_autograd`)."""
    launch.refuse_autograd("decode_attention", q, k_cache, v_cache)
    rep = check_shapes(q, k_cache, v_cache, block_kv)
    dev = launch.device("decode_attention", "q and the caches", q, k_cache,
                        v_cache)
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    if dev.type == "meta":
        return torch.empty_like(q)
    check_card(q, k_cache, v_cache, "q and the caches")
    bh, _, d = q.shape
    S = k_cache.shape[1]
    if torch.is_tensor(length):
        if length.numel() != 1 or length.is_floating_point():
            raise TypeError("length must be one integer")
        if length.device != dev:
            raise ValueError(f"length lives on {length.device}, the caches "
                             f"on {dev}")
        length = length.reshape(1).to(torch.int32)
    else:
        length = torch.tensor([int(length)], dtype=torch.int32, device=dev)
    hb = heads_per_block(rep)
    if bh // hb > 65535:
        raise ValueError(f"bh={bh} exceeds the kernel's grid")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, split_len = split_plan(bh // hb, S, n_sms, TILE)
    part = torch.empty(bh * n_splits * (d + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(q)
    scale = float(np.float32(1.0 / math.sqrt(d)))
    launch.run(decode_attention, dev, build().lib.decode_attention_launch,
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               length.data_ptr(), part.data_ptr(), out.data_ptr(),
               int(q.dtype == torch.bfloat16), bh, S, d, hb, rep, n_splits,
               split_len, scale, designs=(design(q.dtype),))
    return out


# --- the paged design: the engine's decode step over a block pool ----------

def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                               window: int = 0):
    """The plain version: each slot's strip gathered from the pools
    (`paged_view`), then `decode_attend` over the strips (GQA expanded,
    f32 scores masked to [lengths - window, lengths) with -1e30, softmax,
    f32 PV), output (b, 1, H, d) in q's dtype."""
    return decode_attend(q, paged_view(k_pool, block_tables),
                         paged_view(v_pool, block_tables), lengths,
                         window=window)


def check_paged(q, k_pool, v_pool, block_tables, lengths, window) -> int:
    """Validate the paged entry's shapes and dtypes; returns rep = H //
    KV."""
    if q.ndim != 4 or q.shape[1] != 1 or k_pool.ndim != 4 or (
            v_pool.shape != k_pool.shape):
        raise ValueError(f"paged_decode_attention wants q (b, 1, H, d) and "
                         f"pools (n_blocks, block_size, KV, d); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, _, nh, d = q.shape
    kv = k_pool.shape[2]
    if k_pool.shape[3] != d or nh % kv:
        raise ValueError(f"q {tuple(q.shape)} and pools "
                         f"{tuple(k_pool.shape)}: head widths must match "
                         f"and H be a multiple of KV")
    check_tables(block_tables, lengths, b)
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError(f"q and the pools must all be bfloat16 (or all "
                        f"float32 on the CPU); got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return nh // kv


def check_paged_card(q, k_pool, v_pool) -> None:
    """The CUDA kernel's contract beyond `check_paged`: bf16, a head width
    in HEAD_DIMS, the pools' `paged.check_pools`, q's last dim
    contiguous.  Raises TypeError / ValueError."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    check_pools(k_pool, v_pool)
    if q.stride(3) != 1 or q.stride(0) % 2 or q.stride(2) % 2 or (
            q.data_ptr() % 4):
        raise ValueError(f"q's last dim must be contiguous and its rows "
                         f"4-byte aligned; got strides {q.stride()}")


@launch.counted(*PAGED_DESIGNS)
def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           window: int = 0):
    """q (b, 1, H, d), pools (n_blocks, block_size, KV, d), block_tables
    (b, max_blocks) physical block ids, lengths (b,) valid prefixes ->
    (b, 1, H, d) in q's dtype: slot i attends to its positions [lengths[i]
    - window, lengths[i]) of [0, max_blocks * block_size) (every position,
    the mean of v, when none is valid).

    On the card: bf16 q and pools, the head width in HEAD_DIMS, block_size
    a multiple of `paged.PAGED_ROWS`, each tensor's last dim contiguous;
    tables are read as int32 and lengths as int64 (others are converted,
    one copy each).  Nothing is read on the host and nothing synced, so a
    CUDA graph can capture the call.  Forward only: raises a RuntimeError
    while autograd records and an input requires grad."""
    launch.refuse_autograd("paged_decode_attention", q, k_pool, v_pool)
    rep = check_paged(q, k_pool, v_pool, block_tables, lengths, window)
    dev = launch.device("paged_decode_attention",
                        "q, the pools, block_tables and lengths", q, k_pool,
                        v_pool, block_tables, lengths)
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lengths, window)
    if dev.type == "meta":
        return torch.empty_like(q)
    check_paged_card(q, k_pool, v_pool)
    b, _, nh, d = q.shape
    n_blocks, bs, kv, _ = k_pool.shape
    tables, lens = card_tables(block_tables, lengths)
    hb = heads_per_block(rep)
    if b * nh // hb > 65535:
        raise ValueError(f"b * H = {b * nh} exceeds the kernel's grid")
    max_blocks = tables.shape[1]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, split_len = split_plan(b * nh // hb, max_blocks * bs, n_sms,
                                     TILE)
    part = (torch.empty(b * nh * n_splits * (d + 2), dtype=torch.float32,
                        device=dev) if n_splits > 1 else None)
    out = torch.empty((b, 1, nh, d), dtype=q.dtype, device=dev)
    launch.run(paged_decode_attention, dev,
               build().lib.paged_decode_attention_launch,
               q.data_ptr(), q.stride(0), q.stride(2), k_pool.data_ptr(),
               v_pool.data_ptr(), n_blocks, bs, kv, k_pool.stride(0),
               k_pool.stride(1), k_pool.stride(2), tables.data_ptr(),
               tables.stride(0), max_blocks, lens.data_ptr(),
               None if part is None else part.data_ptr(), out.data_ptr(), b,
               nh, d, hb, rep, int(window), n_splits, split_len,
               inv_sqrt_f32(d), designs=PAGED_DESIGNS)
    return out
