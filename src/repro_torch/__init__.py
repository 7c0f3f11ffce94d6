"""PyTorch / CUDA port of the WWW planning + serving stack, for an NVIDIA
H100 (Hopper, sm_90a).

It mirrors the JAX package `repro` subpackage by subpackage and name by
name, so each function has a counterpart a reader can find:

* `repro_torch.core` — GEMM taxonomy, the scalar and batched cost
  models, the sweep engine, the What/When/Where planner (backends
  "vectorized", "pallas" and "scalar") and the design-space campaigns.
* `repro_torch.quant` — INT8 weight quantization, the planner-gated
  linear route and the static `KernelPlanTable`.
* `repro_torch.kernels` — hand-written Hopper kernels (CUDA C++ sources
  under `kernels/csrc/`, built with nvcc at first use) beside the plain
  torch version of each.
* `repro_torch.models` / `repro_torch.serving` — the decoder of every
  family (prefill forward and decode step), the fixed-batch
  `ServeSession` and the continuous-batching engine over a `DecodeCore`.
* `repro_torch.optim` / `repro_torch.data` / `repro_torch.train` — the
  optimizers and schedule, the synthetic token pipeline, and the train
  step and loop with checkpoints and fault tolerance.
* `repro_torch.launch` — the CLIs: campaigns, serving, training, the
  paper's experiments, and the kernels' benchmarks.
* `repro_torch.convert` — the JAX package's parameters as torch tensors.
* `repro_torch.tree` — walking nested dicts and lists of tensors.

Entry points run on `"cuda"` unless the caller passes `device="cpu"`.
The package imports torch and never jax or `repro`.
"""
