"""PyTorch / CUDA port of the WWW planning + serving stack, for an NVIDIA
H100 (Hopper, sm_90a).

It mirrors the JAX package `repro` subpackage by subpackage and name by
name, so each function has a counterpart a reader can find:

* `repro_torch.core` — GEMM taxonomy, the scalar cost model and the
  What/When/Where planner (scalar backend).
* `repro_torch.quant` — INT8 weight quantization, the planner-gated
  linear route and the static `KernelPlanTable`.
* `repro_torch.kernels` — hand-written Hopper kernels (CUDA C++ sources
  under `kernels/csrc/`, built with nvcc at first use) beside the plain
  torch version of each.
* `repro_torch.models` / `repro_torch.serving` — the dense decoder's
  decode step and the fixed-batch `ServeSession` over a `DecodeCore`.
* `repro_torch.convert` — the JAX package's parameters as torch tensors.

Entry points run on `"cuda"` unless the caller passes `device="cpu"`.
The package imports torch and never jax or `repro`.
"""
