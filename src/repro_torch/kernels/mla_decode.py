"""Paged MLA decode -- the hand-written Hopper kernel of the engine's
latent attention step, beside its plain torch version.

It replaces no TPU kernel: the JAX package has no latent attention.  A
model with `cfg.mla` (DeepSeek-V3's block, `models/model.py: _mla_step`)
decodes in the absorbed form, in which every query head attends over one
cached row per position: the 512-wide latent and the 64-wide roped key,
576 columns, the latent serving as V.

Contract: q (b, H, 576) latent queries, H <= 16; a layer's latent pool
(n_blocks, block_size, 576) read in place through `block_tables` (b,
max_blocks) at each slot's own `lengths` (b,) (positions [0, length)
are valid; a slot with none gets zeros); `scale` the softmax scale (the
model's qk_head_dim^-0.5) -> (b, H, 512) in q's dtype: the softmax (f32)
of q . row * scale over the valid positions, times each row's first 512
columns.

The CUDA source is `csrc/mla_decode.cu` (its header gives the bound and
the design); `kernels/build.py` compiles it with nvcc for sm_90a at first
use and loads it with ctypes.  `paged_mla_decode` takes the launch path
of `kernels/launch.py`; its plain version, `paged_mla_decode_ref`, is
`latent_attend` (the model's latent attention over a contiguous cache,
kept here beside the kernel) over each slot's gathered strip.  Nothing
is read on the host and nothing synced, so a CUDA graph can capture the
call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..sharding.constraints import einsum
from . import launch
from .build import KernelBuild, build_library
from .flash_attention import NEG_INF, compare_to_plain
from .paged import (card_tables, check_pools, check_tables, paged_view,
                    split_plan)

LATENT = 512                     # the latent's width: V, and the output's
ROW = 576                        # a cached row: the latent and the rope key
MAX_HEADS = 16                   # csrc/mla_decode.cu: HMAX
TILE = 32                        # csrc/mla_decode.cu: T
DESIGNS = ("mla",)


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return build_library("mla_decode", paged_mla_decode_launch=(
        [vp, vp, i32, i32, ll, ll, vp, ll, i32, vp, vp, vp] + [i32] * 4
        + [ctypes.c_float, vp]))


def latent_attend(q, rows, cache_len, scale: float, v_dim: int):
    """Latent (MLA) decode attention: every query head over one shared
    row per position.  q: (b, H, w); rows: (b, S, w); cache_len (b,):
    positions < cache_len are valid.  The scores q . row times `scale`
    in f32, masked with NEG_INF, softmax, then the weighted sum of each
    row's first `v_dim` columns in f32 -> (b, H, v_dim) in q's dtype; a
    slot with no valid position gives zeros."""
    S = rows.shape[1]
    s = einsum("bhw,bsw->bhs", q.float(), rows.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
    p = torch.softmax(torch.where(valid[:, None, :], s, NEG_INF), dim=-1)
    out = einsum("bhs,bsc->bhc", p, rows[..., :v_dim].float())
    out = torch.where((cache_len > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_mla_decode_ref(q, pool, block_tables, lengths, scale: float,
                         v_dim: int = LATENT):
    """The plain version: each slot's strip of rows gathered from the pool
    (`paged_view`), then `latent_attend`, output (b, H, v_dim) in q's
    dtype."""
    return latent_attend(q, paged_view(pool, block_tables), lengths, scale,
                         v_dim)


def mla_decode_check(got, q, pool, block_tables, lengths, scale: float,
                     v_dim: int = LATENT) -> dict:
    """Hold a paged_mla_decode result `got` (b, H, v_dim) element by
    element against the plain softmax over each slot's gathered strip:
    `flash_attention.compare_to_plain` on one row per (slot, head), with
    the plain weights zero for a slot with no valid position (whose
    output is zeros) and the strips' first v_dim columns as v; the
    kernel keeps p in f32 (a hi/lo bf16 pair), so p is not rounded."""
    b, H, _ = q.shape
    strips = paged_view(pool, block_tables)
    S = strips.shape[1]
    s = torch.einsum("bhw,bsw->bhs", q.float(), strips.float()) * scale
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    p = torch.softmax(torch.where(valid[:, None], s, -1e30), dim=-1)
    p = p * (lengths > 0)[:, None, None]
    v = strips[..., :v_dim].repeat_interleave(H, 0)
    return compare_to_plain(got.reshape(b * H, 1, v_dim),
                            p.reshape(b * H, 1, S), v, p_rounded=False)


def check_mla(q, pool, block_tables, lengths, v_dim: int) -> None:
    """Validate the shapes and dtypes every device takes."""
    if q.ndim != 3 or pool.ndim != 3 or q.shape[2] != pool.shape[2]:
        raise ValueError(f"paged_mla_decode wants q (b, H, w) and a pool "
                         f"(n_blocks, block_size, w); got {tuple(q.shape)}, "
                         f"{tuple(pool.shape)}")
    b = q.shape[0]
    if not 0 < v_dim <= q.shape[2]:
        raise ValueError(f"v_dim {v_dim} must lie in [1, {q.shape[2]}]")
    check_tables(block_tables, lengths, b)
    if q.dtype not in (torch.bfloat16, torch.float32) or (
            pool.dtype != q.dtype):
        raise TypeError(f"q and the pool must both be bfloat16 (or both "
                        f"float32 on the CPU); got {q.dtype}, {pool.dtype}")


def check_mla_card(q, pool, v_dim: int) -> None:
    """The CUDA kernel's contract beyond `check_mla`: bf16, rows of 576
    with the first 512 as V, at most 16 heads, the pool's
    `paged.check_pools`.  Raises TypeError / ValueError."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got {q.dtype}")
    if q.shape[2] != ROW or v_dim != LATENT:
        raise ValueError(f"the CUDA kernel is built for rows of {ROW} "
                         f"(latent {LATENT} + rope {ROW - LATENT}) with V "
                         f"the latent; got width {q.shape[2]}, v_dim "
                         f"{v_dim}")
    if not 1 <= q.shape[1] <= MAX_HEADS:
        raise ValueError(f"the CUDA kernel serves 1 to {MAX_HEADS} heads, "
                         f"got {q.shape[1]}")
    check_pools(pool)


@launch.counted(*DESIGNS)
def paged_mla_decode(q, pool, block_tables, lengths, scale: float,
                     v_dim: int = LATENT):
    """q (b, H, w), pool (n_blocks, block_size, w), block_tables (b,
    max_blocks) physical block ids, lengths (b,) valid prefixes, scale ->
    (b, H, v_dim) in q's dtype (see the module docstring).

    On the card: bf16, w = 576 and v_dim = 512, H <= 16, block_size a
    multiple of `paged.PAGED_ROWS`; tables are read as int32 and lengths
    as int64 (others are converted, one copy each), q made contiguous.
    Forward only: raises a RuntimeError while autograd records and an
    input requires grad."""
    launch.refuse_autograd("paged_mla_decode", q, pool)
    check_mla(q, pool, block_tables, lengths, v_dim)
    dev = launch.device("paged_mla_decode",
                        "q, the pool, block_tables and lengths", q, pool,
                        block_tables, lengths)
    if dev.type == "cpu":
        return paged_mla_decode_ref(q, pool, block_tables, lengths, scale,
                                    v_dim)
    if dev.type == "meta":
        return q.new_empty(q.shape[:2] + (v_dim,))
    check_mla_card(q, pool, v_dim)
    b, H, _ = q.shape
    n_blocks, bs, _ = pool.shape
    q = q.contiguous()
    tables, lens = card_tables(block_tables, lengths)
    if b > 65535:
        raise ValueError(f"b = {b} exceeds the kernel's grid")
    max_blocks = tables.shape[1]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, split_len = split_plan(b, max_blocks * bs, n_sms, TILE)
    part = (torch.empty(b * n_splits * MAX_HEADS * (LATENT + 2),
                        dtype=torch.float32, device=dev)
            if n_splits > 1 else None)
    out = torch.empty((b, H, LATENT), dtype=q.dtype, device=dev)
    launch.run(paged_mla_decode, dev, build().lib.paged_mla_decode_launch,
               q.data_ptr(), pool.data_ptr(), n_blocks, bs, pool.stride(0),
               pool.stride(1), tables.data_ptr(), tables.stride(0),
               max_blocks, lens.data_ptr(),
               None if part is None else part.data_ptr(), out.data_ptr(), b,
               H, n_splits, split_len, float(scale), designs=DESIGNS)
    return out
