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
* `python -m repro_torch.launch.dryrun` — the multi-pod dry run: one
  (arch x shape x mesh) cell, or `--all`, traced on "meta" DTensors over
  a fake process group of 512 ranks (the 16x16 and 2x16x16 production
  meshes), one JSON per cell with per-rank memory, FLOPs, bytes,
  collectives, roofline and (decode) planner telemetry; no card needed.
* `python -m repro_torch.launch.report` — renders dry-run cell, serve
  bench and campaign JSONs (and the sweep engine's telemetry blocks) as
  markdown tables.
* `python -m repro_torch.launch.gemm_bench` — times the INT8 GEMM's
  designs at qwen2-7b's projection shapes against `torch.matmul` and,
  with `--baseline DIR`, another checkout's wrapper (needs a card).
* `python -m repro_torch.launch.attn_bench` — times the flash-attention
  and flash-decoding kernels at qwen2-7b's shapes against
  `scaled_dot_product_attention` and, with `--baseline DIR`, another
  checkout's kernels (needs a card).

Library modules: `mesh` (`DeviceMesh` construction: the row mesh, the
production (16, 16) / (2, 16, 16) meshes, the device-less abstract mesh),
`distributed` (process-group init from the REPRO_* env vars, the
row-sharded sweep's split and gather), `specs` (meta-device input and
parameter stand-ins per cell), `roofline` (the analytic step roofline
on the H100's data-sheet rates) and `trace_analysis` (a traced step's
per-rank collectives, op census, FLOPs, bytes and peak memory).
"""
