"""The readings a cell's correctness limit is set from: for each seed,
one run of the cell at its own size and load (set-up, a window of
--seconds, the sample the benchmark checks), then the number the cell's
check compares (the widest top-token gap, or the cell's quantile of the
gaps) for the program's tokens (the lower reading) and for the
control's, the reference computed with INT4 weights (the upper reading),
at the same positions.

    python chipbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--out chiprun_out/calibrate.jsonl]

Each seed runs in this process one after the other; a JSON line per seed
goes to standard output and to --out.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(ctx) -> dict:
    """One seed: the program's and the control's widest gaps."""
    from chipbench import check, weights
    from chipbench.drivers.common import release
    driver = importlib.import_module(f"chipbench.drivers.{ctx.cell['driver']}")
    out = driver.run(ctx)
    params = weights.make(ctx.arch, ctx.model, ctx.seed, ctx.device)
    pick = check.served if out["kind"] == "served" else check.scored
    seqs, reads, chosen = pick(out["samples"], ctx.device)
    t = time.perf_counter()
    prog, ctl = check.top_gaps(ctx.arch, ctx.model, params, seqs, reads,
                               chosen, control_bits=4)
    del params
    release()
    q = ctx.cell["check"].get("quantile", 100)
    return {"seed": ctx.seed, "tokens": int(sum(g.size for g in prog)),
            "program_gap": _widest(prog), "control_gap": _widest(ctl),
            "quantile": q, "program_compared": _at(prog, q),
            "control_compared": _at(ctl, q),
            "program": _quantiles(prog), "control": _quantiles(ctl),
            "reference_s": time.perf_counter() - t}


def _widest(gaps):
    return max((float(g.max()) for g in gaps if g.size), default=None)


def _at(gaps, q: float):
    """The gaps' q-th percentile over every position, as the check takes
    it."""
    import numpy as np
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    return float(np.percentile(flat, q)) if flat.size else None


def _quantiles(gaps) -> dict:
    """Where the gaps lie: quantiles over every position, the share that
    is not 0, and each sequence's widest."""
    import numpy as np
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    if not flat.size:
        return {}
    q = np.quantile(flat, [0.5, 0.9, 0.99])
    return {"mean": float(flat.mean()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "nonzero": float(np.mean(flat > 0)),
            "widest_per_sequence": [float(g.max()) for g in gaps if g.size]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from chipbench import harness, spec
    bench = spec.load_benchmark()
    entry = spec.workload(bench, args.workload)
    cell = spec.load_cell(args.workload)
    config = spec.load_config(bench, entry["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(bench=bench, workload=args.workload, cell=cell,
                          model=config["model"], arch=config["arch"],
                          seed=seed, seconds=args.seconds,
                          trace=False, device="cuda",
                          t_start=time.perf_counter())
        line = json.dumps({"workload": args.workload, **reading(ctx)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
