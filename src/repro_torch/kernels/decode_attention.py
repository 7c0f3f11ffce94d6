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
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises (`length` may be a Python int or an int
tensor on the card — the kernel reads it from device memory, so a launch
never syncs the host); on "meta" tensors it returns an empty meta tensor.
The dtype picks the design (`design`): "mma" for bf16 (a TMA ring and
tensor-core products, every head width in HEAD_DIMS), "fma" for f32.
`decode_attention.launches` counts calls that launched the kernel and
`decode_attention.launches_by_design` counts them per design.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .build import KernelBuild, build_library
from .flash_attention import _repeat, compare_to_plain, refuse_autograd

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # head widths the CUDA kernel is built for
HEADS_PER_BLOCK = 16             # csrc/decode_attention.cu: HB_MAX
TILE = 64                        # csrc/decode_attention.cu: TK and dk::T
BLOCKS_PER_SM = 1                # the bf16 kernel's resident blocks per SM
DESIGNS = ("mma", "fma")


def design(dtype) -> str:
    """The kernel design a CUDA call in `dtype` runs: "mma" for bf16,
    "fma" for f32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    kb = build_library("decode_attention")
    fn = kb.lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return kb


def _probs(q, k_cache, length):
    """The plain version's softmax weights, (bh, 1, S) in f32; the cache
    already repeated to q's rows."""
    S, d = k_cache.shape[1], k_cache.shape[2]
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d))))     # f32
    s = torch.einsum("bqd,bkd->bqk", q.float(), k_cache.float()) * scale
    mask = torch.arange(S, device=q.device) < torch.as_tensor(
        length, device=q.device)
    return torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)


def decode_attention_ref(q, k_cache, v_cache, length):
    """The plain version: `repro/kernels/ref.py:decode_attention_ref` on
    folded tensors (caches repeated to q's rows), in f32, output (bh, 1, d)
    in q's dtype."""
    rows = q.shape[0]
    p = _probs(q, _repeat(k_cache, rows), length)
    return torch.einsum("bqk,bkd->bqd", p,
                        _repeat(v_cache, rows).float()).to(q.dtype)


def decode_attention_check(got, q, k_cache, v_cache, length) -> dict:
    """`flash_attention.compare_to_plain` for a decode_attention result on
    folded inputs; the kernel keeps p in f32."""
    rows = q.shape[0]
    return compare_to_plain(got, _probs(q, _repeat(k_cache, rows), length),
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


@functools.lru_cache(maxsize=1024)
def split_plan(n_blocks: int, S: int, n_sms: int) -> tuple[int, int]:
    """(n_splits, split_len): split S into TILE-aligned pieces, as many as
    the n_blocks blocks of one split can take while every block of the
    call still fits one wave of BLOCKS_PER_SM blocks per SM (at least
    one piece, at most one per tile).  Pure: the same arguments give the
    same plan."""
    want = max(1, min(math.ceil(S / TILE),
                      BLOCKS_PER_SM * n_sms // n_blocks))
    split_len = TILE * math.ceil(math.ceil(S / want) / TILE)
    return math.ceil(S / split_len), split_len


def heads_per_block(rep: int) -> int:
    """The most query heads of one kv head a block can serve (a divisor
    of rep, at most HEADS_PER_BLOCK)."""
    return max(h for h in range(1, min(rep, HEADS_PER_BLOCK) + 1)
               if rep % h == 0)


def decode_attention(q, k_cache, v_cache, length, *, block_kv: int = 512):
    """q (bh, 1, d), caches (bh_kv, S, d), length: the valid prefix ->
    (bh, 1, d) in q's dtype.

    `block_kv` keeps the TPU kernel's shape contract; the CUDA kernel
    splits S by its own plan, which changes only the order of f32 sums.
    Forward only: raises a RuntimeError while autograd records and an
    input requires grad (`flash_attention.refuse_autograd`)."""
    refuse_autograd("decode_attention", q, k_cache, v_cache)
    rep = check_shapes(q, k_cache, v_cache, block_kv)
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"q and the caches must share a device; got {dev}, "
                         f"{k_cache.device}, {v_cache.device}")
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    if dev.type == "meta":
        return torch.empty_like(q)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda (or cpu/meta), got "
                         f"{dev}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k_cache.dtype == v_cache.dtype == q.dtype):
        raise TypeError(f"q and the caches must all be bfloat16 or all "
                        f"float32; got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    bh, _, d = q.shape
    S = k_cache.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
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
    n_splits, split_len = split_plan(bh // hb, S, n_sms)
    part = torch.empty(bh * n_splits * (d + 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty_like(q)
    lib = build().lib
    scale = float(np.float32(1.0 / math.sqrt(d)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            length.data_ptr(), part.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, S, d, hb, rep, n_splits,
            split_len, scale, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} (10000 + n: CUresult n of a TMA "
                           f"descriptor)")
    decode_attention.launches += 1
    decode_attention.launches_by_design[design(q.dtype)] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
