"""Output tokens per second: every token that reached the host in the
window, over the window's seconds."""
from chipbench import window


def read(run):
    t0, t1 = run["t0"], run["t1"]
    n = sum(sum(1 for t in s if t0 <= t <= t1) for s in run["stamps"])
    return window.rate(n, run["t0"], run["t1"]) if n else None
