"""Command-line entry points of the port.

* `python -m repro_torch.launch.campaign` — the design-space campaign
  CLI (streaming Pareto fronts with constraint contracts and a
  certification gate), on the card unless `--device cpu`.
* `python -m repro_torch.launch.gemm_bench` — times the INT8 GEMM's
  designs at qwen2-7b's projection shapes against `torch.matmul` and,
  with `--baseline DIR`, another checkout's wrapper (needs a card).
"""
