"""Inter-token gap p95 (ms): every gap between consecutive output
tokens of one request as the host saw them, over the window."""
from chipbench import window


def read(run):
    p = window.percentile(window.gaps(run["stamps"], run["t0"], run["t1"]),
                          95)
    return None if p is None else 1e3 * p
