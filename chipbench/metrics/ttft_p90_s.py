"""TTFT p90 (s): from each request's due time to its first output
token on the host, over every request due in the window (the open loop
serves on past the close until each has its first token, at most the
cell's `extend_s`; one still without it then counts its wait so far)."""
from chipbench import readers, window


def read(run):
    return window.percentile(window.waits(
        run["due"], readers.first_token(run), run["t0"], run["t1"],
        run["t_end"]), 90)
