"""Paged MLA decode kernel's roofline share (%) in the engine's steps:
the kernel's bound over the device time of the traced window's kernels
named "paged_mla".

The bound is the window's mean per step: for every position each request
ran in the window (`pos_start` .. `pos_end`), one call of the
architecture's `mla_decode_call` at that position's rows (p + 1) in
every layer, summed, bounded as one (`flops.bound_s` of the summed
operations and bytes), divided by the window's engine steps and
multiplied by the traced window's steps.  None where the architecture
has no such call or no such kernel ran."""
from chipbench import flops, readers


def read(run):
    tr = run.get("trace")
    call = getattr(readers.arch(run), "mla_decode_call", None)
    if not tr or call is None or not tr["steps"] or not run["steps"]:
        return None
    m = run["model"]
    ops = moved = 0.0
    for start, end in zip(run["pos_start"], run["pos_end"]):
        for p in range(start, end):
            o, b = call(m, p + 1)
            ops += o
            moved += b
    bound = (flops.bound_s(ops, moved) * m["n_layers"] / run["steps"]
             * tr["steps"])
    busy = readers.kernel_seconds(run, "paged_mla")
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
