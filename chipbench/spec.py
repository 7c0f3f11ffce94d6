"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root
names the cells, configurations and metrics; each lives in a file of its
own that nothing else needs to list:

  chipbench/cells/<cell>.json      what the cell runs: its driver, sizes,
                                   traffic and the limits of its check
  <configs[i].file>                a configuration (chipbench/configs/):
                                   its "model" block goes to the program,
                                   its "arch" names the architecture
  chipbench/archs/<arch>.py        an architecture: weight layout, plain
                                   reference, operation counts
                                   (chipbench/archs/__init__.py)
  chipbench/metrics/<metric>.py    a metric's reader: read(run) -> number
                                   or None (nothing to read)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_cell(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "cells" / f"{name}.json").read_text())


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            config = json.loads((root / c["file"]).read_text())
            if "arch" not in config:
                raise KeyError(f"{c['file']} has no \"arch\" naming its "
                               "chipbench/archs/<arch>.py")
            return config
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def arch(name: str, here: Path = HERE):
    """The module chipbench/archs/<name>.py: what the harness knows of
    the architecture a configuration's "arch" names."""
    path = here / "archs" / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise FileNotFoundError(
            f"architecture {name!r}: no module "
            f"{path.relative_to(here.parent)} (a configuration's \"arch\" "
            "names a file of chipbench/archs/)")
    return importlib.import_module(f"chipbench.archs.{name}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: with trace the per-layer ones,
    without it the end-to-end ones, each where its "workloads" lists the
    cell or it has no such list."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, here: Path = HERE):
    """The `read` function of chipbench/metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "chipbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
