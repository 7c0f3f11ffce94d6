"""Hand-written Hopper kernels, each beside its plain torch version.

* `int8_gemm` — the W8A16 GEMM every CiM-gated projection runs
  (replaces the TPU kernel `repro/kernels/int8_gemm.py:_kernel_os`).

The kernels build at first use on a machine with nvcc; importing this
package compiles nothing.
"""
from .int8_gemm import int8_gemm, int8_gemm_ref

__all__ = ["int8_gemm", "int8_gemm_ref"]
