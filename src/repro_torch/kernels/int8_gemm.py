"""W8A16 GEMM: y = (x @ w_q) * scale[None, :] in f32 — the hand-written
Hopper kernel that replaces the TPU kernel `repro/kernels/int8_gemm.py`
(`_kernel_os`, the output-stationary dataflow every CiM-gated projection
runs), beside its plain torch version.

The CUDA source is `csrc/int8_gemm.cu` (its header comment gives the
bound and the design).  `kernels/build.py` compiles it with nvcc for
sm_90a at first use and loads it with ctypes.

`int8_gemm` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.  On "meta" tensors (the
shape-only trace behind `DecodeCore.route_report`) it returns an empty
meta tensor of the output shape.  `int8_gemm.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import KernelBuild, build_library


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    kb = build_library("int8_gemm")
    fn = kb.lib.int8_gemm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return kb


def int8_gemm_ref(x, w_q, scale):
    """The plain version: x (M, K) bf16/f32, w_q (K, N) int8, scale (N,)
    f32 -> y = x @ (w_q * scale) in f32 (the dequantize-first form of
    `repro/kernels/ref.py:int8_gemm_ref`)."""
    return x.float() @ (w_q.float() * scale.float())


def int8_gemm(x, w_q, scale):
    """y = (x @ w_q) * scale[None, :] -> (M, N) f32.

    x: (M, K) bfloat16 or float32 with unit column stride; w_q: (K, N)
    int8 with unit column stride; scale: (N,) float32, contiguous."""
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"int8_gemm wants x (M, K), w_q (K, N), scale (N,);"
                         f" got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, K = x.shape
    K2, N = w_q.shape
    if K2 != K or scale.shape[0] != N:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    dev = x.device
    if w_q.device != dev or scale.device != dev:
        raise ValueError(f"x, w_q and scale must share a device; got {dev}, "
                         f"{w_q.device}, {scale.device}")
    if dev.type == "cpu":
        return int8_gemm_ref(x, w_q, scale)
    if dev.type == "meta":
        return torch.empty((M, N), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda (or cpu/meta), got {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError("scale must be a contiguous float32 vector")
    if x.stride(1) != 1 or w_q.stride(1) != 1:
        raise ValueError("x and w_q need unit column stride")
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    lib = build().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.int8_gemm_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w_q.data_ptr(),
            scale.data_ptr(), y.data_ptr(), M, N, K, x.stride(0),
            w_q.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: CUDA error {rc}")
    int8_gemm.launches += 1
    return y


int8_gemm.launches = 0
