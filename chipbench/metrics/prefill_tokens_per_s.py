"""Prefill tokens per second: the prompt tokens of every forward that
finished in the window, over the window's seconds."""
from chipbench import window


def read(run):
    n = sum(run["done_lengths"])
    return window.rate(n, run["t0"], run["t1"]) if n else None
