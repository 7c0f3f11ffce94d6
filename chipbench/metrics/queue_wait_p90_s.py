"""Queue wait p90 (s): from due time to admission into a slot
(`Request.t_admit`), every request due in the window, watched as long as
its TTFT is (one still queued then counts its wait so far)."""
from chipbench import window


def read(run):
    return window.percentile(window.waits(
        run["due"], run["admit"], run["t0"], run["t1"], run["t_end"]), 90)
