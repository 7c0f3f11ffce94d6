"""Set-up seconds: process start to the window's first operation
(weights made on the card from the seed, quantize, plan, graph captures
and warm-up of the cell's own shapes)."""


def read(run):
    return run["setup_s"]
