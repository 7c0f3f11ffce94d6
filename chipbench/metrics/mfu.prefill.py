"""Prefill MFU (%): the operations of every forward finished in the
window (every position with its LM head, causal attention at its
length) over the window's seconds and the bf16 peak."""
from chipbench import readers


def read(run):
    m, arch = run["model"], readers.arch(run)
    ops = sum(arch.positions_flops(m, 0, n, 0) for n in run["done_lengths"])
    return readers.mfu(run, ops) if ops else None
