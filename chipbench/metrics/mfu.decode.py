"""Decode MFU (%): the operations the window's forward positions need
(the architecture's `positions_flops`: every position each request ran
in the window, the LM head where its logits were read) over the
window's seconds and the bf16 peak."""
from chipbench import readers


def read(run):
    m, arch = run["model"], readers.arch(run)
    ops = sum(arch.positions_flops(m, start, end, plen - 1)
              for start, end, plen in zip(run["pos_start"], run["pos_end"],
                                          run["prompt_len"]))
    return readers.mfu(run, ops) if ops else None
