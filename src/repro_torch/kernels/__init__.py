"""Hand-written Hopper kernels, each beside its plain torch version.

* `int8_gemm` — the W8A16 GEMM every CiM-gated projection runs
  (replaces the TPU kernel `repro/kernels/int8_gemm.py:_kernel_os`).
* `sweep_eval` — the planner's sweep row evaluator behind
  backend="pallas" (replaces `repro/kernels/sweep_eval.py:_sweep_kernel`).

`build.py` compiles each CUDA source with nvcc at first use on a machine
with a card; importing this package compiles nothing.  As attributes of
the package, `int8_gemm` and `sweep_eval` are the wrapper functions;
their modules are reached as `repro_torch.kernels.int8_gemm` and
`repro_torch.kernels.sweep_eval` through the import system.
"""
from .int8_gemm import int8_gemm, int8_gemm_ref
from .sweep_eval import (SWEEP_OUT_FIELDS, kernel_status, sweep_eval,
                         sweep_eval_ref)

__all__ = ["int8_gemm", "int8_gemm_ref", "SWEEP_OUT_FIELDS",
           "kernel_status", "sweep_eval", "sweep_eval_ref"]
