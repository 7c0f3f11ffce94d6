"""Arithmetic the metric readers share (each reader is a file of
`metrics/`; these take the run record a driver filled)."""
from __future__ import annotations

from . import flops, spec, window


def arch(run: dict):
    """The module of the run's architecture (its operation counts)."""
    return spec.arch(run["arch"])


def first_token(run: dict) -> list:
    return [s[0] if s else None for s in run["stamps"]]


def kernel_seconds(run: dict, marker: str) -> float:
    """Device seconds of the traced window's kernels whose name holds
    `marker`."""
    return sum(s for name, s in run["trace"]["by_name"].items()
               if marker in name)


def gemm_roofline(run: dict) -> float | None:
    """Percent: the summed bounds of the traced window's INT8 GEMM calls
    over those kernels' device time.  None when the calls counted from the
    routes do not match the kernel's launch counter, or nothing ran."""
    tr = run.get("trace")
    if not tr:
        return None
    calls = tr["gemm_calls"]
    if sum(c for _, _, c in calls) != tr["gemm_launches"]:
        return None
    shapes = arch(run).projection_shapes(run["model"])
    bound = sum(c * flops.bound_s(*flops.gemm_call(rows, shapes[label][0],
                                                   shapes[label][1]))
                for label, rows, c in calls)
    busy = kernel_seconds(run, "int8_gemm")
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None


def flash_roofline(run: dict) -> float | None:
    tr = run.get("trace")
    if not tr:
        return None
    calls = tr["flash_calls"]
    if sum(c for _, c in calls) != tr["flash_launches"]:
        return None
    call = arch(run).flash_call
    bound = sum(c * flops.bound_s(*call(run["model"], n)) for n, c in calls)
    busy = kernel_seconds(run, "flash_")
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None


def idle_frac(run: dict) -> float | None:
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def mfu(run: dict, ops: float) -> float:
    """Percent of the bf16 peak: `ops` over the window's seconds."""
    return 100.0 * window.rate(ops, run["t0"], run["t1"]) \
        / flops.PEAK_BF16_FLOPS
