"""The prefill cells: prompts scored one at a time (a closed loop, batch
1) through the program's prefill forward, `make_prefill` under the
prefill-phase plan table of a `DecodeCore` with INT8 weights.

Set-up: the seed's weights on the card, the core (quantize, plan), and
one forward at each prompt length the traffic holds.  In the window each
prompt's ids go to the card, the forward runs and the host waits for it
before it sends the next; a forward counts when it finished in the
window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..traffic import Traffic
from .common import (TraceWindow, log, program_config, release,
                     run_config, sync, warm_profiler)


def run(ctx) -> dict:
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import int8_gemm
    from repro_torch.models.layers import CIM_ROUTE, route_trace
    from repro_torch.serving import DecodeCore, make_prefill

    cell, m, dev = ctx.cell, ctx.model, ctx.device
    cfg, rc = program_config(m), run_config(cell)
    spec = cell["traffic"]
    params = weights.make(ctx.arch, m, ctx.seed, dev)
    sync(dev)
    log("weights drawn")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=1,
                      plan_max_len=spec["prompt"]["max"], device=dev)
    del params
    release()
    log("core built (quantized, planned)")
    prefill = make_prefill(cfg, rc, core.prefill_plan_table)
    qparams = core.params
    traffic = Traffic(spec, m["vocab"], ctx.seed)
    gemm_labels: dict[str, int] = {}
    for i, n in enumerate(traffic.distinct_prompt_lengths()):
        ids = torch.zeros((1, n), dtype=torch.long, device=dev)
        if i == 0:
            with route_trace() as records:
                prefill(qparams, ids)
            for r in records:
                if r["route"] == CIM_ROUTE:
                    gemm_labels[r["label"]] = gemm_labels.get(r["label"],
                                                              0) + 1
        else:
            prefill(qparams, ids)
    log("a forward at each prompt length")
    first = [traffic.next() for _ in range(traffic.n)]
    longest = max(range(len(first)), key=lambda i: len(first[i].prompt))
    rng = np.random.default_rng([ctx.seed, 1])
    others = [i for i in rng.permutation(len(first)) if i != longest]
    picked = set([longest] + others[:cell["check"]["forwards"] - 1])
    if ctx.trace:
        warm_profiler(dev)
    sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    t1 = t0 + ctx.seconds
    tw = None
    if ctx.trace:
        span = min(ctx.seconds, cell["trace_seconds"])
        start = t0 + (ctx.seconds - span) / 2
        tw = TraceWindow(dev, start, start + span)
    marks = {}
    done_lengths: list[int] = []
    lengths_in_span: list[int] = []
    tops = {}
    k = 0
    while time.perf_counter() < t1:
        item = first[k] if k < len(first) else traffic.next()
        ids = torch.from_numpy(item.prompt.astype(np.int64))[None].to(dev)
        logits = prefill(qparams, ids)
        if k in picked:
            tops[k] = logits[0].argmax(-1)
        del logits
        sync(dev)
        t = time.perf_counter()
        if t <= t1:
            done_lengths.append(len(item.prompt))
            if tw is not None and tw.t0 is not None and not tw.closed:
                lengths_in_span.append(len(item.prompt))
        elif k in tops:
            del tops[k]
        k += 1
        if tw is not None:
            mark = tw.poll(t)
            if mark:
                marks[mark] = (int8_gemm.launches, flash.launches)
    if tw is not None and tw.prof is not None and not tw.closed:
        tw.stop()
        marks["stop"] = (int8_gemm.launches, flash.launches)

    peak = (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
    samples = [(first[i].prompt.copy(), tops[i].cpu().numpy())
               for i in sorted(tops)]
    del prefill, qparams, core, tops
    release()
    rec = {"t0": t0, "t1": t1, "attempted": k, "failed": 0,
           "memory_peak_bytes": peak, "done_lengths": done_lengths}
    if tw is not None and tw.prof is not None:
        (g0, f0), (g1, f1) = marks["start"], marks["stop"]
        rec["trace"] = {
            "window": tw, "forwards": len(lengths_in_span),
            "gemm_calls": [[label, n, c] for n in lengths_in_span
                           for label, c in gemm_labels.items()],
            "gemm_launches": g1 - g0,
            "flash_calls": [[n, m["n_layers"]] for n in lengths_in_span],
            "flash_launches": f1 - f0}
    return {"record": rec, "samples": samples, "kind": "scored"}
