"""Decode MFU (%): the operations the window's forward positions need
(chipbench/flops.py: every position each request ran in the window, the
LM head where its logits were read) over the window's seconds and the
bf16 peak."""
from chipbench import flops, readers


def read(run):
    m = run["model"]
    ops = sum(flops.positions_flops(m, start, end, plen - 1)
              for start, end, plen in zip(run["pos_start"], run["pos_end"],
                                          run["prompt_len"]))
    return readers.mfu(run, ops) if ops else None
