"""Reading the device trace: a frozen copy of the smoke test's
`profile_window` arithmetic (chip_smoke.py: device activities of a
torch.profiler window, the union of their intervals as device-busy time,
device time summed by kernel name), read from the profiler's raw
activity records, and the breakdown the result line carries.

Times inside are microseconds, as the profiler gives them.
"""
from __future__ import annotations

import bisect
import math
import re


def spans(records) -> tuple[list, list]:
    """(device spans, host spans), each (name, start, end) in
    microseconds, of a finished profiler's raw activity records
    (`prof.profiler.kineto_results.events()`): a record whose device
    type is CUDA ran on the card, any other on the host."""
    dev, host = [], []
    for r in records:
        kind = getattr(r.device_type(), "name", str(r.device_type()))
        a = r.start_ns() / 1e3
        (dev if kind.endswith("CUDA") else host).append(
            (r.name(), a, a + r.duration_ns() / 1e3))
    return dev, host


def busy(spans) -> float:
    """The union of the spans' intervals (the device-busy time)."""
    total, end = 0.0, -math.inf
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def by_name(spans) -> dict[str, float]:
    """Device time summed per kernel name."""
    out: dict[str, float] = {}
    for name, a, b in spans:
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which no device activity ran."""
    out, cursor = [], lo
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def host_at(host, starts, t: float, look: int = 2000) -> str:
    """The innermost host op running at time t among `host` (sorted by
    start; `starts` their starts), or "host (no op)"."""
    best = None
    i = bisect.bisect_right(starts, t)
    for name, a, b in host[max(0, i - look):i]:
        if t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "host (no op)"


_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "internal::",
          "::operator()() const", "at::TensorIteratorBase&", "std::array",
          "TrivialOffsetCalculator", "unsigned int", "at::native::memory::")


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without the template noise that makes most of a
    PyTorch kernel's name, cut to `width` characters."""
    for noise in _NOISE:
        name = name.replace(noise, "")
    name = re.sub(r"\{lambda\(([^)]*)\)#\d+\}",
                  lambda m: f"fn({m.group(1)})" if m.group(1) else "fn", name)
    name = re.sub(r"\s+", " ", name)
    return name[:width]


def breakdown(device, host, lo: float, hi: float, top: int = 10) -> dict:
    """The result line's "breakdown": the device ops that took most time
    and the idle gaps summed by what the host was doing at each gap's
    middle, each as [name, seconds], at most `top` of each."""
    ops = sorted(by_name(device).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(device, lo, hi), key=lambda g: g[0] - g[1])
    by_host: dict[str, float] = {}
    host = sorted(host, key=lambda s: s[1])
    starts = [s[1] for s in host]
    for a, b in gaps[:200]:
        name = host_at(host, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short_name(n), us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}
