"""The planner's sweep row evaluator — the hand-written Hopper kernel that
replaces the TPU kernel `repro/kernels/sweep_eval.py` (`_sweep_kernel`,
the fused CiM cost spec behind the planner's backend="pallas"), beside
its plain torch version.

Layout: B candidate rows are stacked as a (len(FLAT_FIELDS), B) = (24, B)
f32 field-major matrix, and come back as the (len(SWEEP_OUT_FIELDS), B) =
(11, B) f32 matrix, `valid` as 0/1.  The plain version, `sweep_eval_ref`,
runs `core.vectorized.evaluate_flat`'s spec on the rows of that matrix.

The CUDA source is `csrc/sweep_eval.cu` (its header comment gives the
bound and the design); `kernels/build.py` compiles it with nvcc for
sm_90a at first use, with multiply-add contraction off (`--fmad=false`),
and loads it with ctypes.  The kernel equals its plain version bit for
bit, NaN positions included.

`sweep_eval` takes the launch path of `kernels/launch.py`; it counts its
launches but is not in the launch registry (the plan service runs it on
a thread of its own).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.cost_model import DRAM_STREAM_EFFICIENCY
from ..core.loopnest import check_order_mode
from ..core.mapping import PSUM_BYTES
from ..core.memory import DRAM, RF, SMEM, TEMPORAL_REDUCTION_PJ
from ..core.vectorized import (FLAT_FIELDS, SWEEP_OUT_FIELDS, evaluate_flat,
                               f32_reciprocal)
from . import launch
from .build import KernelBuild, build_library

NVCC_EXTRA = ("--fmad=false",)


class SweepConsts(ctypes.Structure):
    """The cost model's constants as the kernel's by-value argument
    (`struct SweepConsts` in csrc/sweep_eval.cu, same field order)."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "psum_bytes", "smem_capacity", "rf_gran", "smem_gran", "dram_gran",
        "rf_energy", "smem_energy", "dram_energy", "reduction_pj",
        "inv_dram_bw", "inv_smem_bw")]


def sweep_consts(dram_eff: float = DRAM_STREAM_EFFICIENCY) -> SweepConsts:
    """The constants, each rounded to f32 as torch rounds the spec's
    Python scalars."""
    vals = (PSUM_BYTES, SMEM.capacity_bytes, RF.access_granularity_bytes,
            SMEM.access_granularity_bytes, DRAM.access_granularity_bytes,
            RF.access_energy_pj, SMEM.access_energy_pj, DRAM.access_energy_pj,
            TEMPORAL_REDUCTION_PJ,
            f32_reciprocal(DRAM.bandwidth_bytes_per_cycle * dram_eff),
            f32_reciprocal(SMEM.bandwidth_bytes_per_cycle))
    return SweepConsts(*(float(np.float32(v)) for v in vals))


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    return build_library("sweep_eval", NVCC_EXTRA, sweep_eval_launch=[
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        SweepConsts, ctypes.c_void_p])


def kernel_status(device="cuda") -> dict:
    """How `sweep_eval` runs for tensors on `device`: mode "cuda" (the
    hand-written kernel) or "plain" (the torch version, CPU tensors)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"mode": "cuda", "reason": None}
    if dev.type == "cpu":
        return {"mode": "plain",
                "reason": "cpu tensors run the plain torch version"}
    raise ValueError(f"sweep_eval runs on cuda or cpu, got {dev}")


def _check_rows(rows) -> None:
    if rows.ndim != 2 or rows.shape[0] != len(FLAT_FIELDS):
        raise ValueError(f"sweep_eval wants a ({len(FLAT_FIELDS)}, B) field "
                         f"matrix, got {tuple(rows.shape)}")


def sweep_eval_ref(rows, order_mode: str = "exact",
                   dram_eff: float = DRAM_STREAM_EFFICIENCY):
    """The plain version: evaluate_flat's spec on the rows of the (24, B)
    matrix -> the (11, B) f32 matrix of SWEEP_OUT_FIELDS."""
    check_order_mode(order_mode)
    _check_rows(rows)
    cols = {f: rows[i] for i, f in enumerate(FLAT_FIELDS)}
    out = evaluate_flat(cols, dram_eff, order_mode)
    return torch.stack([out[f].to(torch.float32) for f in SWEEP_OUT_FIELDS])


@launch.counted("sweep", registered=False)
def sweep_eval(rows, order_mode: str = "exact",
               dram_eff: float = DRAM_STREAM_EFFICIENCY):
    """(24, B) f32 field matrix -> (11, B) f32 SWEEP_OUT_FIELDS matrix.

    CPU tensors take `sweep_eval_ref`; a CUDA tensor (contiguous f32)
    launches the kernel on the current stream or raises."""
    check_order_mode(order_mode)
    _check_rows(rows)
    dev = launch.device("sweep_eval", "the rows", rows)
    if dev.type == "cpu":
        return sweep_eval_ref(rows, order_mode, dram_eff)
    n = rows.shape[1]
    out = torch.empty((len(SWEEP_OUT_FIELDS), n), dtype=torch.float32,
                      device=dev)
    if dev.type == "meta":
        return out
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError("sweep_eval wants a contiguous float32 matrix")
    if n == 0:
        return out
    launch.run(sweep_eval, dev, build().lib.sweep_eval_launch,
               rows.data_ptr(), out.data_ptr(), n,
               int(order_mode == "greedy"), sweep_consts(dram_eff),
               designs=("sweep",))
    return out
