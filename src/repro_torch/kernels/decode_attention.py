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

`paged_decode_attention` is the engine's decode attention over a paged
KV cache (`models/model.py:init_paged_cache`), design "paged": q (b, 1,
H, d) against the layer's K and V block pools (n_blocks, bs, KV, d),
read in place through `block_tables` (b, max_blocks) at each slot's own
`lengths` (b,) and `window` (0 = none), both read from device memory.
Its plain version, `paged_decode_attention_ref`, is
`models/attention.py:decode_attend` over each slot's gathered strip
(`models/model.py:_paged_view`); the wrapper takes it only for CPU
tensors, and counts launches in `paged_decode_attention.launches` /
`launches_by_design`.
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
PAGED_DESIGNS = ("paged",)
PAGED_ROWS = 8                   # a pool block's rows: a multiple of this


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
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = kb.lib.paged_decode_attention_launch
    fn.argtypes = ([vp, ll, ll, vp, vp] + [i32] * 3 + [ll] * 3
                   + [vp, ll, i32, vp, vp, vp] + [i32] * 8
                   + [ctypes.c_float, vp])
    fn.restype = ctypes.c_int
    return kb


def _probs(q, k_cache, length, window: int = 0):
    """The plain version's softmax weights, (bh, 1, S) in f32; the cache
    already repeated to q's rows.  `length`: one valid prefix, or one per
    row (bh,); a window keeps positions >= length - window."""
    from ..models.attention import _scale
    S, d = k_cache.shape[1], k_cache.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k_cache.float()) * _scale(d)
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


# --- the paged design: the engine's decode step over a block pool ----------

def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                               window: int = 0):
    """The plain version: each slot's strip gathered from the pools
    (`models/model.py:_paged_view`), then `models/attention.py:
    decode_attend` over the strips (GQA expanded, f32 scores masked to
    [lengths - window, lengths) with -1e30, softmax, f32 PV), output (b,
    1, H, d) in q's dtype."""
    from ..models.attention import decode_attend
    from ..models.model import _paged_view
    return decode_attend(q, _paged_view(k_pool, block_tables),
                         _paged_view(v_pool, block_tables), lengths,
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
    if block_tables.ndim != 2 or block_tables.shape[0] != b or (
            tuple(lengths.shape) != (b,)):
        raise ValueError(f"want block_tables (b, max_blocks) and lengths "
                         f"(b,) for b={b}; got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if block_tables.is_floating_point() or lengths.is_floating_point() or (
            block_tables.dtype == torch.bool):
        raise TypeError(f"block_tables and lengths must be integers; got "
                        f"{block_tables.dtype}, {lengths.dtype}")
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
    in HEAD_DIMS, blocks of a multiple of PAGED_ROWS rows, pools sharing
    strides of whole 16-byte rows with the last dim contiguous, q's last
    dim contiguous.  Raises TypeError / ValueError."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got {q.dtype}")
    d, bs = q.shape[3], k_pool.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, got {d}")
    if bs % PAGED_ROWS:
        raise ValueError(f"block_size {bs} is not a multiple of "
                         f"{PAGED_ROWS}")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1 or any(
            st % 8 for st in k_pool.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError(f"the pools must share strides, each a multiple of "
                         f"8 elements with the last dim contiguous, and be "
                         f"16-byte aligned; got {k_pool.stride()}, "
                         f"{v_pool.stride()}")
    if q.stride(3) != 1 or q.stride(0) % 2 or q.stride(2) % 2 or (
            q.data_ptr() % 4):
        raise ValueError(f"q's last dim must be contiguous and its rows "
                         f"4-byte aligned; got strides {q.stride()}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           window: int = 0):
    """q (b, 1, H, d), pools (n_blocks, block_size, KV, d), block_tables
    (b, max_blocks) physical block ids, lengths (b,) valid prefixes ->
    (b, 1, H, d) in q's dtype: slot i attends to its positions [lengths[i]
    - window, lengths[i]) of [0, max_blocks * block_size) (every position,
    the mean of v, when none is valid).

    On the card: bf16 q and pools, the head width in HEAD_DIMS, block_size
    a multiple of PAGED_ROWS, each tensor's last dim contiguous; tables
    are read as int32 and lengths as int64 (others are converted, one copy
    each).  Nothing is read on the host and nothing synced, so a CUDA
    graph can capture the call.  Forward only: raises a RuntimeError
    while autograd records and an input requires grad."""
    refuse_autograd("paged_decode_attention", q, k_pool, v_pool)
    rep = check_paged(q, k_pool, v_pool, block_tables, lengths, window)
    dev = q.device
    if any(t.device != dev for t in (k_pool, v_pool, block_tables, lengths)):
        raise ValueError(f"q, the pools, block_tables and lengths must share "
                         f"a device; got {dev}, {k_pool.device}, "
                         f"{v_pool.device}, {block_tables.device}, "
                         f"{lengths.device}")
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lengths, window)
    if dev.type == "meta":
        return torch.empty_like(q)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda (or "
                         f"cpu/meta), got {dev}")
    check_paged_card(q, k_pool, v_pool)
    b, _, nh, d = q.shape
    n_blocks, bs, kv, _ = k_pool.shape
    tables = block_tables.to(torch.int32)
    if tables.stride(1) != 1:
        tables = tables.contiguous()
    lens = lengths.to(torch.int64).contiguous()
    hb = heads_per_block(rep)
    if b * nh // hb > 65535:
        raise ValueError(f"b * H = {b * nh} exceeds the kernel's grid")
    max_blocks = tables.shape[1]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, split_len = split_plan(b * nh // hb, max_blocks * bs, n_sms)
    part = (torch.empty(b * nh * n_splits * (d + 2), dtype=torch.float32,
                        device=dev) if n_splits > 1 else None)
    out = torch.empty((b, 1, nh, d), dtype=q.dtype, device=dev)
    from ..models.attention import _scale
    lib = build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode_attention_launch(
            q.data_ptr(), q.stride(0), q.stride(2), k_pool.data_ptr(),
            v_pool.data_ptr(), n_blocks, bs, kv, k_pool.stride(0),
            k_pool.stride(1), k_pool.stride(2), tables.data_ptr(),
            tables.stride(0), max_blocks, lens.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(), b, nh,
            d, hb, rep, int(window), n_splits, split_len, _scale(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc} (10000 + n: CUresult n of a TMA "
                           f"descriptor)")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_design["paged"] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_design = dict.fromkeys(PAGED_DESIGNS, 0)
