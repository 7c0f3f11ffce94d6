"""Command-line entry points of the port.

* `python -m repro_torch.launch.campaign` — the design-space campaign
  CLI (streaming Pareto fronts with constraint contracts and a
  certification gate), on the card unless `--device cpu`.
* `python -m repro_torch.launch.serve` — the serving CLI: a fixed-batch
  session (route report, gated against ungated steady tokens/s) or
  continuous-batching synthetic traffic (`--requests N`, optionally
  `--adaptive`), on the card unless `--device cpu`.
* `python -m repro_torch.launch.gemm_bench` — times the INT8 GEMM's
  designs at qwen2-7b's projection shapes against `torch.matmul` and,
  with `--baseline DIR`, another checkout's wrapper (needs a card).
* `python -m repro_torch.launch.attn_bench` — times the flash-attention
  and flash-decoding kernels at qwen2-7b's shapes against
  `scaled_dot_product_attention` and, with `--baseline DIR`, another
  checkout's kernels (needs a card).
"""
