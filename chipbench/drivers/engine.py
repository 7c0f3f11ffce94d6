"""The serving cells: requests through the program's continuous-batching
engine (`ContinuousBatchingEngine.submit` and `.step` over a `DecodeCore`
with INT8 weights gated by the planner), each step a replayed CUDA graph.

Set-up: the seed's weights on the card, the core (quantize, plan), the
engine, and one warm-up request of 2 + 2 tokens, which captures both
phase variants of the step (all slots prefilling, and decoding).  Then
the cell's traffic starts and runs for the cell's `warm_s` seconds
before the window opens, so that the window opens on a batch in steady
state (requests of staggered ages), not on an empty engine or on every
slot streaming its prompt at once; those seconds count as set-up.  The
window goes on submitting the traffic on the host clock and calling
`step()` until it closes; after each step the host stamps every output
token that reached it.  Open-loop traffic goes on past the close until
every request due in the window has its first token.

A traced run arms the program's span recorder (`repro_torch.spans`)
before the core is built, so that each captured step gets its marked
twin, and opens it for the `trace_seconds` before the profiler's window:
the span readers take the sections' device time per step from those
steps, and the profiler's window sees only plain replays.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..traffic import Traffic
from .common import (TraceWindow, log, program_config, release,
                     run_config, sync, warm_profiler)


def _routes(core, n_slots: int, max_len: int) -> dict:
    """plan table -> {label: calls of the GEMM kernel per step}: the
    labels each table routes to the kernel (`cim-int8-pallas`) in one
    shape-only step, counted per call."""
    from repro_torch.models.layers import CIM_ROUTE
    from repro_torch.serving.core import _meta, meta_route_records
    meta = _meta(core.params)
    out = {}
    for name, table in (("decode", core.plan_table),
                        ("prefill", core.prefill_plan_table)):
        calls: dict[str, int] = {}
        for r in meta_route_records(core.cfg, core.rc, meta, table, n_slots,
                                    max_len):
            if r["route"] == CIM_ROUTE:
                calls[r["label"]] = calls.get(r["label"], 0) + 1
        out[name] = calls
    return out


def build(ctx):
    """The core: the seed's weights on the card, quantized and planned
    at the cell's slots and length."""
    from repro_torch.serving import DecodeCore
    cell, m = ctx.cell, ctx.model
    cfg, rc = program_config(m), run_config(cell)
    params = weights.make(ctx.arch, m, ctx.seed, ctx.device)
    sync(ctx.device)
    log("weights drawn")
    core = DecodeCore(cfg, rc, params, quantize=True,
                      plan_batch=cell["slots"], plan_max_len=cell["max_len"],
                      device=ctx.device)
    del params
    release()
    log("core built (quantized, planned)")
    return core


def new_engine(ctx, core):
    """An engine over the core, its step captured in both phases by one
    warm-up request of 2 + 2 tokens."""
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request
    cell = ctx.cell
    engine = ContinuousBatchingEngine(core, n_slots=cell["slots"],
                                      max_len=cell["max_len"],
                                      block_size=cell["block_size"],
                                      seed=ctx.seed)
    engine.submit(Request(rid="warm-up", prompt=np.array([1, 2], np.int32),
                          max_new_tokens=2))
    engine.drain()
    log("engine warmed up (both phases captured)")
    return engine


def run(ctx) -> dict:
    from repro_torch import spans
    if ctx.trace:
        spans.arm(ctx.device)
    try:
        core = build(ctx)
        engine = new_engine(ctx, core)
        if ctx.trace:
            warm_profiler(ctx.device)
        out = window(ctx, engine, ctx.cell["traffic"])
    finally:
        if spans.recorder() is not None:
            spans.disarm()
    del engine, core
    release()
    return out


class SpanWindow:
    """The armed span recorder, open from `start_at` until `stop_at` on
    the host clock, opened and closed between engine steps; `steps` is
    the number of steps it was open for, once it has closed."""

    def __init__(self, recorder, start_at: float, stop_at: float):
        self.rec = recorder
        self.start_at, self.stop_at = start_at, stop_at
        self.opened_at_step = None
        self.steps = None

    def poll(self, now: float, engine_steps: int) -> None:
        if self.steps is not None:
            return
        if self.opened_at_step is None:
            if self.start_at <= now < self.stop_at:
                self.rec.open()
                self.opened_at_step = engine_steps
        elif now >= self.stop_at:
            self.rec.close()
            self.steps = engine_steps - self.opened_at_step


def _positions(engine, reqs: list) -> list[int]:
    """Forward positions each request has run so far: a finished one all
    its prompt and every output but the last; a running one as far as
    its slot has been dispatched; a queued one none."""
    pos = [r.prompt_len + r.max_new_tokens - 1 if r.state == "done"
           else 0 for r in reqs]
    index = {id(r): i for i, r in enumerate(reqs)}
    for st in engine.slots:
        if st is not None and id(st.req) in index:
            pos[index[id(st.req)]] = st.pos
    return pos


def window(ctx, engine, spec: dict) -> dict:
    """Drive `engine` with the traffic `spec`: `warm_s` seconds of it in
    set-up, then the window; returns the record, the sampled (prompt,
    served tokens) pairs and their kind.  The caller frees the engine
    afterwards."""
    from repro_torch import spans
    from repro_torch.kernels import int8_gemm
    from repro_torch.serving.scheduler import Request

    cell, m, dev = ctx.cell, ctx.model, ctx.device
    n_slots = cell["slots"]
    # the warm-up draws its own requests (stream 2 of the seed); the
    # window's traffic starts afresh at the open, so every seed's window
    # takes the same grids of sizes and gaps
    traffic = Traffic(spec, m["vocab"], ctx.seed, stream=2)
    poisson = spec["arrival"] == "poisson"
    depth = spec.get("depth", 0)
    pending = traffic.next() if poisson else None
    tag = "warm-"                 # request ids of the warm-up
    reqs: list = []               # every request, in submit order
    due: list[float] = []
    stamps: list[list[float]] = []
    admit: list[float | None] = []
    live: list[int] = []
    waiting: list[tuple[float, int]] = []
    failed = 0
    n_admitted = 0
    offset = None                 # host clock minus the engine's clock
    t0 = None                     # the window's open, once set-up is done
    sync(dev)
    tq = time.perf_counter()      # the traffic's clock

    def submit(item, when):
        nonlocal offset, failed
        req = Request(rid=f"{tag}{item.index}", prompt=item.prompt,
                      max_new_tokens=item.out_len)
        try:
            engine.submit(req)
        except ValueError:
            failed += 1
            return
        if offset is None:
            offset = time.perf_counter() - req.t_submit
        reqs.append(req)
        due.append(when)
        stamps.append([])
        admit.append(None)

    def tick():
        """Submit what is due, step the engine once, stamp what reached
        the host."""
        nonlocal pending, n_admitted, live
        now = time.perf_counter()
        if poisson:
            while tq + pending.due <= now:
                submit(pending, tq + pending.due)
                pending = traffic.next()
        else:
            while len(reqs) - n_admitted < depth:
                submit(traffic.next(), now)
        stepped = engine.step()
        t = time.perf_counter()
        while n_admitted < len(reqs) and reqs[n_admitted].t_admit is not None:
            admit[n_admitted] = reqs[n_admitted].t_admit + offset
            live.append(n_admitted)
            n_admitted += 1
        still = []
        for i in live:
            r, s = reqs[i], stamps[i]
            while len(s) < len(r.tokens):
                s.append(t)
            if r.state != "done":
                still.append(i)
        live = still
        if t0 is not None:
            waiting.append((t, len(reqs) - n_admitted))
        if not stepped and poisson:
            time.sleep(max(0.0, min(1e-3, tq + pending.due
                                    - time.perf_counter())))
        return t

    while time.perf_counter() < tq + cell.get("warm_s", 0):
        tick()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pos_start = _positions(engine, reqs)
    steps0 = engine.steps
    host0 = engine.dispatch_s + engine.host_fetch_s + engine.telemetry_s
    traffic, tag = Traffic(spec, m["vocab"], ctx.seed), ""
    pending = traffic.next() if poisson else None

    t0 = tq = time.perf_counter()
    t1 = t0 + ctx.seconds
    tw = sw = None
    if ctx.trace:
        span = min(ctx.seconds, cell["trace_seconds"])
        start = t0 + (ctx.seconds - span) / 2
        tw = TraceWindow(dev, start, start + span)
        if spans.recorder() is not None:
            # closed where the profiler's window opens, so that no
            # marked step falls inside it
            sw = SpanWindow(spans.recorder(), start - span, start)
    span_marks = {}

    while time.perf_counter() < t1:
        t = tick()
        if sw is not None:
            sw.poll(t, engine.steps)
        if tw is not None:
            mark = tw.poll(t)
            if mark:
                span_marks[mark] = (engine.steps, dict(engine.phase_steps),
                                    int8_gemm.launches)
    if tw is not None and not tw.closed and tw.prof is not None:
        tw.stop()
        span_marks["stop"] = (engine.steps, dict(engine.phase_steps),
                              int8_gemm.launches)
    n_close = len(reqs)
    steps = engine.steps - steps0
    host_s = (engine.dispatch_s + engine.host_fetch_s + engine.telemetry_s
              - host0)
    pos_end = _positions(engine, reqs)
    pos_start += [0] * (n_close - len(pos_start))
    # open-loop traffic goes on past the close until every request due in
    # the window has its first token (at most `cell["extend_s"]`), so
    # that a TTFT is taken whole and not cut at the close
    in_window = [i for i in range(n_close) if t0 <= due[i] < t1]
    t_end = t1
    while poisson and any(not stamps[i] for i in in_window) and (
            time.perf_counter() < t1 + cell.get("extend_s", 0)):
        t_end = tick()
    peak = (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
    served = [(r.prompt.copy(), [int(x) for x in r.tokens]) for r in reqs]

    rec = {"t0": t0, "t1": t1, "t_end": t_end,
           "attempted": n_close + failed, "failed": failed,
           "memory_peak_bytes": peak, "due": due[:n_close],
           "admit": admit[:n_close], "stamps": stamps[:n_close],
           "prompt_len": [len(p) for p, _ in served[:n_close]],
           "pos_start": pos_start, "pos_end": pos_end[:n_close],
           "steps": steps, "host_s": host_s, "waiting": waiting}
    if tw is not None and tw.prof is not None:
        routes = _routes(engine.core, n_slots, cell["max_len"])
        (s0, ph0, l0), (s1, ph1, l1) = span_marks["start"], span_marks["stop"]
        calls = []
        for phase, labels in routes.items():
            n = ph1[phase] - ph0[phase]
            for label, c in labels.items():
                calls.append([label, n_slots, c * n])
        rec["trace"] = {"window": tw, "steps": s1 - s0, "gemm_calls": calls,
                        "gemm_launches": l1 - l0}
        if sw is not None and sw.steps is not None:
            rec["trace"]["spans"] = {"steps": sw.steps,
                                     "seconds": spans.disarm()}
    return {"record": rec, "samples": _sample(served, ctx, cell),
            "kind": "served"}


def _sample(served: list, ctx, cell) -> list:
    """The requests whose served tokens the reference checks: the one
    with the longest context, then others in an order drawn from the
    seed, until `check.tokens` served tokens are in."""
    cand = [i for i, (_, toks) in enumerate(served) if toks]
    if not cand:
        return []
    longest = max(cand, key=lambda i: len(served[i][0]) + len(served[i][1]))
    rng = np.random.default_rng([ctx.seed, 1])
    order = [longest] + [cand[j] for j in rng.permutation(len(cand))
                         if cand[j] != longest]
    out, total = [], 0
    for i in order:
        if total >= cell["check"]["tokens"]:
            break
        out.append(served[i])
        total += len(served[i][1])
    return out
