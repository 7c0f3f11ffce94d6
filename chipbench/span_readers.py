"""Arithmetic of the readers of the program's spans (each reader is a
file of `metrics/`).

A traced run of a program that marks spans carries, under "trace":

  "spans"          {"steps": engine steps in the span window,
                    "seconds": {span name: self seconds over them}}:
                   the device spans of the decode step
                   (`repro_torch.spans`), summed inside the captured
                   step's marked twin over a window of steps before the
                   profiler's window opens;
  "forward_spans"  [[start, end], ...] microseconds: the profiler's host
                   ranges named "prefill.forward" (`make_prefill`), each
                   as long as the program issues one forward;
  "device"         [[start, end], ...] microseconds: every device
                   activity of the profiler's window, on the same clock.

A record without them (a program with no spans) reads None.
"""
from __future__ import annotations

from . import trace


def section_ms(run: dict, names: tuple[str, ...]) -> float | None:
    """Milliseconds per engine step in the spans `names`, or None when
    the run has no span window or none of them ran."""
    sp = (run.get("trace") or {}).get("spans")
    if not sp or not sp["steps"]:
        return None
    total = sum(sp["seconds"].get(n, 0.0) for n in names)
    return 1e3 * total / sp["steps"] if total > 0 else None


def forward_idle_ms(run: dict) -> float | None:
    """Mean device-idle milliseconds inside a prefill forward: for each
    "prefill.forward" range, the time within it in which no device
    activity ran.  The range lasts while the program issues the forward;
    the gap after it, where the caller waits for the device and sends
    the next prompt, lies outside.  None without such ranges."""
    tr = run.get("trace") or {}
    fwd = tr.get("forward_spans") or []
    dev = tr.get("device") or []
    if not fwd or not dev:
        return None
    idle = 0.0
    for a, b in fwd:
        inside = [("", max(s, a), min(e, b)) for s, e in dev
                  if s < b and e > a]
        idle += (b - a) - trace.busy(inside)
    return idle / 1e3 / len(fwd)
