"""Command-line entry points of the port.

* `python -m repro_torch.launch.campaign` — the design-space campaign
  CLI (streaming Pareto fronts with constraint contracts and a
  certification gate), on the card unless `--device cpu`.
* `python -m repro_torch.launch.serve` — the serving CLI: a fixed-batch
  session (route report, gated against ungated steady tokens/s) or
  continuous-batching synthetic traffic (`--requests N`, optionally
  `--adaptive`), on the card unless `--device cpu`.
* `python -m repro_torch.launch.train` — the training CLI (a few steps
  of one arch, checkpoints, injected failure and auto-resume), on the
  card unless `--device cpu`.
* `python -m repro_torch.launch.paper` — the paper's seven artefacts
  (Figs. 2, 7 + Table II, 9, 10, 11/12, 13 and Table VI) as CSV and
  derived JSON, the sweeps on the sweep kernel with `--backend pallas`,
  on the card unless `--device cpu`.
* `python -m repro_torch.launch.gemm_bench` — times the INT8 GEMM's
  designs at qwen2-7b's projection shapes against `torch.matmul` and,
  with `--baseline DIR`, another checkout's wrapper (needs a card).
* `python -m repro_torch.launch.attn_bench` — times the flash-attention
  and flash-decoding kernels at qwen2-7b's shapes against
  `scaled_dot_product_attention` and, with `--baseline DIR`, another
  checkout's kernels (needs a card).
"""
