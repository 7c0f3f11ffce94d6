"""Hand-written Hopper kernels, each beside its plain torch version.

* `int8_gemm` — the W8A16 GEMM every CiM-gated projection runs
  (replaces the TPU kernel `repro/kernels/int8_gemm.py`: `_kernel_os` and
  `_kernel_ws`), with `plan_gemm` choosing its design per call.
* `sweep_eval` — the planner's sweep row evaluator behind
  backend="pallas" (replaces `repro/kernels/sweep_eval.py:_sweep_kernel`).
* `flash_attention` — blocked causal attention of the prefill forward
  with `attn_impl="pallas"` (replaces
  `repro/kernels/flash_attention.py:_kernel`).
* `decode_attention` — flash-decoding of one query against a KV cache
  (replaces `repro/kernels/decode_attention.py:_kernel`).
* `paged_decode_attention` — its paged design, the engine's decode
  attention read in place from the block pool through the block tables
  (no TPU counterpart: the JAX package gathers the strips for XLA).
* `paged_mla_decode` — the engine's latent (MLA) decode attention over a
  latent block pool, 16 heads on one 576-wide row per position (no TPU
  counterpart: the JAX package has no latent attention).
* `moe_experts` — the MoE decode step's grouped INT8 experts: each routed
  expert's int8 weights read once, run over its routed tokens only (no
  TPU counterpart: the JAX package leaves the experts to XLA's einsums).

`autotune` reports the blocks, shared memory and grid of the GEMM kernel
`plan_gemm` picks for a shape (`autotune_report`).  `csrc/span_mark.cu`
is the one-thread mark of `repro_torch.spans` (no TPU counterpart),
built by `build.py` when a span recorder is first armed on a card.

`ops` holds the public wrappers in the JAX package's (b, s, heads, d)
layouts.  `launch` is every wrapper's one launch path (the device
choice, the stream, the return code, the counters) and the registry of
counted wrappers whose launches a replayed CUDA graph credits; `paged`
is the block pool's contract that both paged kernels read.  `build.py`
compiles each CUDA source with nvcc at first use on a machine with a
card; importing this package compiles nothing.  As attributes of the
package the seven names above are the wrapper functions, so the modules
`int8_gemm`, `sweep_eval`, `flash_attention` and `decode_attention` are
reached through the import system (`importlib.import_module`).

A kernel is added as its CUDA source under `csrc/`, its module here and
its names in the exports below.  The module holds the wrapper, decorated with
`launch.counted` (and so in the registry), its shape and dtype contract,
its plan, its C call through `launch.run`, and its plain version: what
the wrapper runs on CPU tensors and what the tests hold the kernel to.
"""
from . import ops
from .decode_attention import (decode_attention, decode_attention_check,
                               decode_attention_ref, paged_decode_attention,
                               paged_decode_attention_ref)
from .flash_attention import (flash_attention, flash_attention_check,
                              flash_attention_ref)
from .int8_gemm import GemmPlan, int8_gemm, int8_gemm_ref, plan_gemm
from .mla_decode import paged_mla_decode, paged_mla_decode_ref
from .moe_experts import moe_experts, moe_experts_ref
from .sweep_eval import (SWEEP_OUT_FIELDS, kernel_status, sweep_eval,
                         sweep_eval_ref)

__all__ = ["ops", "int8_gemm", "int8_gemm_ref", "plan_gemm",
           "GemmPlan", "flash_attention",
           "flash_attention_ref", "flash_attention_check",
           "decode_attention", "decode_attention_ref",
           "decode_attention_check", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_mla_decode",
           "paged_mla_decode_ref", "moe_experts", "moe_experts_ref",
           "SWEEP_OUT_FIELDS", "kernel_status", "sweep_eval",
           "sweep_eval_ref"]
