"""Blocked causal flash attention — the hand-written Hopper kernel that
replaces the TPU kernel `repro/kernels/flash_attention.py` (`_kernel`, the
Pallas kernel behind `attend(impl="pallas")` in the prefill forward),
beside its plain torch version.

Folded contract, as the TPU kernel's: q (bh, sq, d); k, v (bh_kv, sk, d)
with bh a multiple of bh_kv, query row i attending to kv row
i // (bh // bh_kv) — the GQA heads of one kv head are consecutive rows, so
`ops.flash_attention` folds (b, s, H, d) into rows without repeating k and
v (with bh_kv == bh this is exactly the TPU kernel's contract).  Queries are
the tail of the kv sequence (`seq_offset = sk - sq`); masked scores are
-1e30; the output has q's dtype.  As in the TPU kernel, a `window` masks
keys at distance >= window whether or not `causal` is set
(`repro/kernels/ref.py:flash_attention_ref` applies it only when causal).

The CUDA source is `csrc/flash_attention.cu` (its header gives the bound
and the designs); `kernels/build.py` compiles it with nvcc for sm_90a at
first use and loads it with ctypes.  `flash_attention` takes the launch
path of `kernels/launch.py` (the plain version on the CPU, the kernel on
the card).  The dtype picks the design (`design`): "wgmma" for bf16 (TMA
+ wgmma, every head width in HEAD_DIMS), "fma" for f32 (off the prefill
path).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import launch
from .build import KernelBuild, build_library

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # head widths both attention kernels take
DESIGNS = ("wgmma", "fma")


def design(dtype) -> str:
    """The kernel design a CUDA call in `dtype` runs: "wgmma" for bf16,
    "fma" for f32."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    return build_library("flash_attention", flash_attention_launch=(
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]))


def _mask(sq: int, sk: int, causal: bool, window: int, device):
    """(sq, sk) bool: the keys each query row sees, as the TPU kernel
    masks them (queries are the tail of the kv sequence)."""
    pos_q = torch.arange(sq, device=device)[:, None] + (sk - sq)
    pos_k = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_q >= pos_k
    if window:
        mask &= (pos_q - pos_k) < window
    return mask


def _repeat(t, rows: int):
    """Repeat the kv rows of a folded tensor to `rows` query rows (the
    JAX wrappers' GQA repeat)."""
    rep = rows // t.shape[0]
    return t.repeat_interleave(rep, dim=0) if rep > 1 else t


def _probs(q, k, causal: bool, window: int):
    """The plain version's softmax weights, (bh, sq, sk) in f32; k already
    repeated to q's rows."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = float(1.0 / torch.sqrt(torch.tensor(float(d))))     # f32
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(_mask(sq, sk, causal, window, q.device), s, NEG_INF)
    return torch.softmax(s, dim=-1)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """The plain version: `repro/kernels/ref.py:flash_attention_ref` on
    folded tensors (k and v repeated to q's rows), in f32, output in q's
    dtype."""
    rows = q.shape[0]
    p = _probs(q, _repeat(k, rows), causal, window)
    return torch.einsum("bqk,bkd->bqd", p,
                        _repeat(v, rows).float()).to(q.dtype)


def compare_to_plain(got, p, v, p_rounded: bool) -> dict:
    """Hold a kernel's output `got` against its plain version p @ v (p the
    plain softmax weights in f32, v repeated to p's rows), element by
    element; returns max|Δ|, the largest |Δ| / bound and whether every
    element is finite and within its bound.

    f32: |Δ| ≤ 1e-5·max|want| (the same f32 recurrence, other orders).
    bf16: |Δ| ≤ 1.02·2^-7·|want| + c·(p @ |v|).  Each side rounds its
    f32 result to bf16 once (unit roundoff 2^-8), so they differ by at
    most one ulp, 2^-7·|want|; 1.02 covers |want| against the unrounded
    values.  c = 2^-12 covers f32 sums taken in other orders, and
    c += 2^-8 where the kernel rounds p to bf16 for its PV product: each
    p moves by at most 2^-8 of itself, so an output element by at most
    2^-8·Σ p|v| / Σ p.  The bound follows each row's own magnitude, so a
    late row with a wrong or missing tile cannot hide under the large
    outputs of the first rows."""
    vf = v.float()
    want = torch.einsum("bqk,bkd->bqd", p, vf).to(got.dtype).float()
    if got.shape != want.shape:
        raise ValueError(f"got {tuple(got.shape)}, want {tuple(want.shape)}")
    err = (got.float() - want).abs()
    if got.dtype == torch.float32:
        bound = torch.full_like(want, 1e-5 * want.abs().max().item())
    else:
        c = 2.0 ** -12 + (2.0 ** -8 if p_rounded else 0.0)
        bound = 1.02 * 2.0 ** -7 * want.abs() + c * torch.einsum(
            "bqk,bkd->bqd", p, vf.abs())
    return {"max_abs_err": err.max().item(),
            "worst": (err / bound.clamp_min(1e-30)).max().item(),
            "ok": bool(torch.isfinite(got).all()) and bool(
                (err <= bound).all())}


def check_card(q, k, v, what: str) -> None:
    """The attention kernels' contract on the card: `what` (q, then its
    keys and values) all bfloat16 or all float32, a head width in
    HEAD_DIMS, each contiguous and 16-byte aligned.  Raises TypeError /
    ValueError."""
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{what} must all be bfloat16 or all float32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def flash_attention_check(got, q, k, v, causal: bool = True,
                          window: int = 0) -> dict:
    """`compare_to_plain` for a flash_attention result on folded inputs;
    the bf16 kernel rounds p to bf16 for PV."""
    rows = q.shape[0]
    return compare_to_plain(got, _probs(q, _repeat(k, rows), causal, window),
                            _repeat(v, rows),
                            p_rounded=q.dtype == torch.bfloat16)


def check_shapes(q, k, v, block_q: int, block_kv: int) -> int:
    """Validate the folded shapes and the TPU kernel's block contract
    (sq and sk divisible by their blocks); returns rep = bh // bh_kv."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (bh, sq, d), k and v "
                         f"(bh_kv, sk, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    bh_kv, sk, dk = k.shape
    if dk != d or bh_kv < 1 or bh % bh_kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: head "
                         f"widths must match and bh be a multiple of bh_kv")
    bq, bkv = min(block_q, sq), min(block_kv, sk)
    if bq < 1 or bkv < 1 or sq % bq or sk % bkv:
        raise ValueError(f"sq={sq}, sk={sk} are not multiples of the blocks "
                         f"({bq}, {bkv}); the TPU kernel's contract")
    return bh // bh_kv


@launch.counted(*DESIGNS)
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128):
    """q (bh, sq, d), k/v (bh_kv, sk, d) -> (bh, sq, d) in q's dtype.

    `block_q` / `block_kv` keep the TPU kernel's shape contract; the CUDA
    kernel tiles by its own fixed blocks (128 query rows and 128-key tiles
    in bf16), which changes only the order of f32 sums.  Forward only:
    raises a RuntimeError while autograd records and an input requires
    grad (`launch.refuse_autograd`)."""
    launch.refuse_autograd("flash_attention", q, k, v)
    rep = check_shapes(q, k, v, block_q, block_kv)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = launch.device("flash_attention", "q, k and v", q, k, v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window)
    if dev.type == "meta":
        return torch.empty_like(q)
    check_card(q, k, v, "q, k and v")
    bh, sq, d = q.shape
    if bh > 65535:
        raise ValueError(f"bh={bh} exceeds the kernel's grid (65535)")
    o = torch.empty_like(q)
    scale = float(np.float32(1.0 / math.sqrt(d)))
    launch.run(flash_attention, dev, build().lib.flash_attention_launch,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               int(q.dtype == torch.bfloat16), bh, sq, k.shape[1], d, rep,
               int(bool(causal)), int(window), scale,
               designs=(design(q.dtype),))
    return o
