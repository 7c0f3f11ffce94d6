"""Command-line entry points of the port.

* `python -m repro_torch.launch.campaign` — the design-space campaign
  CLI (streaming Pareto fronts with constraint contracts and a
  certification gate), on the card unless `--device cpu`.
"""
