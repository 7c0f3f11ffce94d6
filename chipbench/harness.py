"""One run of one cell: the cell's driver sets the program up and drives
it for the window, then the trace is read, the reference judges what the
window produced, and the cell's metrics are read by their readers.

The reference runs once the window has closed, the peak memory has been
read and the program's state is freed; it draws the seed's weights again
(the program never touches them) and is not counted in `setup_s`.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from . import check, spec, trace, weights
from .drivers.common import log, release


@dataclasses.dataclass
class Ctx:
    bench: dict
    workload: str
    cell: dict
    model: dict             # the configuration's "model" block
    arch: str               # and its "arch" (chipbench/archs/<arch>.py)
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float          # host clock at process start


def read_trace(tr: dict) -> None:
    """Replace the profiler window of a traced run by what it recorded."""
    tw = tr.pop("window")
    dev, host = trace.spans(tw.prof.profiler.kineto_results.events())
    tr["window_s"] = tw.t1 - tw.t0
    tr["busy_s"] = trace.busy(dev) / 1e6
    tr["by_name"] = {k: v / 1e6 for k, v in trace.by_name(dev).items()}
    stamps = [s[1] for s in dev + host] + [s[2] for s in dev + host]
    lo, hi = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
    tr["breakdown"] = trace.breakdown(dev, host, lo, hi)
    # what the span readers take (chipbench/span_readers.py)
    tr["forward_spans"] = [[a, b] for name, a, b in host
                           if name == "prefill.forward"]
    tr["device"] = [[a, b] for _, a, b in dev]


def judge(ctx: Ctx, kind: str, samples: list) -> dict:
    """The reference over the window's sampled outputs."""
    params = weights.make(ctx.arch, ctx.model, ctx.seed, ctx.device)
    pick = check.served if kind == "served" else check.scored
    seqs, reads, chosen = pick(samples, ctx.device)
    gaps, _ = check.top_gaps(ctx.arch, ctx.model, params, seqs, reads,
                             chosen)
    del params
    release()
    return check.verdict(gaps, ctx.cell["check"])


def run(ctx: Ctx) -> dict:
    driver = importlib.import_module(f"chipbench.drivers.{ctx.cell['driver']}")
    out = driver.run(ctx)
    rec = out["record"]
    rec["setup_s"] = rec["t0"] - ctx.t_start
    rec["model"], rec["arch"], rec["cell"], rec["seconds"] = \
        ctx.model, ctx.arch, ctx.cell, ctx.seconds
    log(f"window closed; set-up {rec['setup_s']:.3f} s")
    if "trace" in rec:
        read_trace(rec["trace"])
        log("trace read")
    verdict = judge(ctx, out["kind"], out["samples"])
    log("reference done")
    metrics = {}
    for md in spec.metrics_of(ctx.bench, ctx.workload, ctx.trace):
        value = spec.reader(md["name"])(rec)
        if value is not None:
            metrics[md["name"]] = {"value": value, "unit": md["unit"]}
    on_card = torch.device(ctx.device).type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": verdict["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if "trace" in rec:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = verdict["checks"]
    return result
