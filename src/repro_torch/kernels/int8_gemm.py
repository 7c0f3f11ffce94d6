"""W8A16 GEMM: y = (x @ w_q) * scale[None, :], summed in f32 — the
hand-written Hopper kernels that replace the TPU kernel
`repro/kernels/int8_gemm.py` (both dataflows: `_kernel_os`, which every
CiM-gated projection runs, and `_kernel_ws`; both weight types it takes:
int8, and float8 e4m3, the FP8 route of `quant/lowbit.py`), beside their
plain torch version.

The CUDA source is `csrc/int8_gemm.cu` (its header comment gives the bound
and the designs).  `kernels/build.py` compiles it with nvcc for sm_90a at
first use and loads it with ctypes.  `plan_gemm` picks the kernel for a
call from its shapes, strides, alignment and dataflow:

* design "A" — TMA + wgmma tiled GEMM, for bf16 x with more than
  `A_MIN_ROWS` (32) rows on the output-stationary dataflow ("os"), when
  TMA can address the operands (16-byte aligned bases and row strides):
  the prefill, and decode batches above 32;
* design "B" — weight-stationary split-K on mma.sync, for every other
  bf16 shape and for the weight-stationary dataflow ("ws") at every M:
  decode at batch 32 or less;
* "fma" — an f32 FMA kernel for f32 x on either dataflow (off the serving
  path).

Every design takes both weight formats (`WEIGHT_FORMATS`): the kernels
are templates on the format and differ only in how a weight byte is
decoded, so `plan_gemm` does not look at it.

`int8_gemm` takes the launch path of `kernels/launch.py` ("meta" tensors
are the shape-only trace behind `DecodeCore.route_report`).  It counts
one launch per GEMM, also when design B adds its reduce pass, and
`int8_gemm.launches_by_format` counts them per weight format ("int8",
"fp8").
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import launch
from .build import KernelBuild, build_library

DESIGNS = ("A", "B", "fma")
# weight dtype -> format name; the kernels' `w_fp8` argument is 1 for "fp8"
WEIGHT_FORMATS = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
SMS = 132                        # streaming multiprocessors of an H100 SXM
A_ROWS = 128                     # design A's rows per tile
A_COLS = 64                      # design A's columns per tile
# "os" calls with more rows take design A: from M = 64 on it beats design
# B summed over a qwen2-7b decode step, at M = 32 it does not (PERF.md)
A_MIN_ROWS = 32
B_COLS = 128                     # design B's columns per block
B_MIN_SLICE = 64                 # design B's fewest K rows per slice
B_TARGET_BLOCKS = 4 * SMS        # design B fills each SM with >= 4 blocks
WORKSPACE_CAP = 256 * 2 ** 20    # bytes of design B's f32 partials


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Which kernel runs a call: `design` in DESIGNS; design B's `splits`
    K-slices of `kslice` rows."""
    design: str
    splits: int = 1
    kslice: int = 0


@functools.lru_cache(maxsize=4096)
def plan_gemm(m: int, n: int, k: int, *, x_bf16: bool = True,
              dataflow: str = "os", ldx: int | None = None,
              ldw: int | None = None, x_align: int = 16,
              w_align: int = 16) -> GemmPlan:
    """The kernel for an (m, k) x (k, n) call, from its shapes, the row
    strides of x and w_q (elements; default contiguous), the byte
    alignment of their base addresses and the dataflow.  Pure (and
    cached): the same arguments give the same plan, and the plan does not
    depend on the output dtype (a bf16 output is the f32 one rounded)."""
    if dataflow not in ("os", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    ldx = k if ldx is None else ldx
    ldw = n if ldw is None else ldw
    if not x_bf16:
        return GemmPlan("fma")
    tma_ok = (x_align % 16 == 0 and w_align % 16 == 0
              and (2 * ldx) % 16 == 0 and ldw % 16 == 0)
    if dataflow == "os" and m > A_MIN_ROWS and tma_ok:
        return GemmPlan("A")
    k16 = math.ceil(k / 16)
    splits = min(math.ceil(k / B_MIN_SLICE),
                 max(1, math.ceil(B_TARGET_BLOCKS / math.ceil(n / B_COLS))))
    if splits > 1:                       # bound the f32 partials
        splits = max(1, min(splits, WORKSPACE_CAP // (4 * m * n)))
    kslice = 16 * math.ceil(k16 / splits)
    return GemmPlan("B", splits=math.ceil(k / kslice), kslice=kslice)


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    os_args = [vp, vp, vp, vp, i, i, i, ll, ll, i, i, vp]
    return build_library(
        "int8_gemm", int8_gemm_fma_launch=os_args,
        int8_gemm_tma_launch=os_args,
        int8_gemm_ws_launch=[vp, vp, vp, vp, vp, i, i, i, ll, ll, i, i, i, i,
                             vp])


def int8_gemm_ref(x, w_q, scale, out_dtype=torch.float32):
    """The plain version: x (M, K) bf16/f32, w_q (K, N) int8 or float8
    e4m3, scale (N,) f32 -> y = x @ (w_q * scale) in f32 (the dequantize-first form of
    `repro/kernels/ref.py:int8_gemm_ref`), cast to `out_dtype`."""
    return (x.float() @ (w_q.float() * scale.float())).to(out_dtype)


def _alignment(ptr: int) -> int:
    """Byte alignment of an address, capped at 16 (all the plan asks)."""
    return min(ptr & -ptr, 16) if ptr else 16


@launch.counted(*DESIGNS, formats=tuple(WEIGHT_FORMATS.values()))
def int8_gemm(x, w_q, scale, *, out_dtype=torch.float32,
              dataflow: str = "os"):
    """y = (x @ w_q) * scale[None, :] -> (M, N) `out_dtype` (float32, as
    the TPU kernel's output, or bfloat16: the f32 result rounded once).

    x: (M, K) bfloat16 or float32 with unit column stride; w_q: (K, N)
    int8 or float8_e4m3fn with unit column stride (any other weight type
    raises TypeError); scale: (N,) float32, contiguous.
    `dataflow` is the TPU kernel's: "os" or "ws" (see `plan_gemm`)."""
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"int8_gemm wants x (M, K), w_q (K, N), scale (N,);"
                         f" got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x.shape
    K2, N = w_q.shape
    if K2 != K or scale.shape[0] != N:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    fmt = WEIGHT_FORMATS.get(w_q.dtype)
    if fmt is None:
        raise TypeError(f"w_q must be int8 or float8_e4m3fn, got "
                        f"{w_q.dtype}")
    if dataflow not in ("os", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    dev = launch.device("int8_gemm", "x, w_q and scale", x, w_q, scale)
    if dev.type == "cpu":
        return int8_gemm_ref(x, w_q, scale, out_dtype)
    if dev.type == "meta":
        return torch.empty((M, N), dtype=out_dtype, device=dev)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError("scale must be a contiguous float32 vector")
    if x.stride(1) != 1 or w_q.stride(1) != 1:
        raise ValueError("x and w_q need unit column stride")
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    xp, wp, ldx, ldw = x.data_ptr(), w_q.data_ptr(), x.stride(0), w_q.stride(0)
    plan = plan_gemm(M, N, K, x_bf16=x.dtype == torch.bfloat16,
                     dataflow=dataflow, ldx=ldx, ldw=ldw,
                     x_align=_alignment(xp), w_align=_alignment(wp))
    lib = build().lib
    out_bf16, w_fp8 = int(out_dtype == torch.bfloat16), int(fmt == "fp8")
    if plan.design == "B":
        part = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                            device=dev) if plan.splits > 1 else None)
        launch.run(int8_gemm, dev, lib.int8_gemm_ws_launch, xp, wp,
                   scale.data_ptr(), y.data_ptr(),
                   None if part is None else part.data_ptr(), M, N, K, ldx,
                   ldw, plan.kslice, plan.splits, out_bf16, w_fp8,
                   designs=(plan.design,), formats=(fmt,))
    else:
        launch.run(int8_gemm, dev, lib.int8_gemm_tma_launch
                   if plan.design == "A" else lib.int8_gemm_fma_launch, xp,
                   wp, scale.data_ptr(), y.data_ptr(), M, N, K, ldx, ldw,
                   out_bf16, w_fp8, designs=(plan.design,), formats=(fmt,))
    return y
