"""The knee of a Poisson serving cell: the cell's engine driven at a list
of arrival rates, one window each, over one core (set up once).

    python chipbench/sweep_rate.py --workload qwen2-7b.chat-poisson \
        --rates 4,5,6,7,8 --seconds 30 --seed 5 [--out FILE]

Each window opens after the cell's warm-up, as a run's does.  A rate is
sustained when the queue of requests waiting for a slot does not grow:
its mean over the window's last third stays under one request.  The knee
is the highest sustained rate; the cell's rate is set at 0.8 of it (by
hand, in its cell file).  Each rate prints one JSON line: the requests
due and finished, the waiting queue's mean over the first and last
thirds, TTFT p50 / p90 and the token gap p95.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summary(rate: float, rec: dict, reqs_done: int) -> dict:
    from chipbench import readers, window
    t0, t1 = rec["t0"], rec["t1"]
    third = (t1 - t0) / 3
    first = [n for t, n in rec["waiting"] if t < t0 + third]
    last = [n for t, n in rec["waiting"] if t >= t1 - third]
    ttft = window.waits(rec["due"], readers.first_token(rec), t0, t1,
                        rec["t_end"])
    gaps = window.gaps(rec["stamps"], t0, t1)
    mean_last = sum(last) / max(1, len(last))
    return {"rate": rate, "due": len(rec["due"]), "finished": reqs_done,
            "steps": rec["steps"],
            "ms_per_step": 1e3 * (t1 - t0) / max(1, rec["steps"]),
            "waiting_first_third": sum(first) / max(1, len(first)),
            "waiting_last_third": mean_last,
            "sustained": mean_last < 1.0,
            "ttft_p50_s": window.percentile(ttft, 50),
            "ttft_p90_s": window.percentile(ttft, 90),
            "itl_p95_ms": 1e3 * (window.percentile(gaps, 95) or 0.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="qwen2-7b.chat-poisson")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from chipbench import harness, spec
    from chipbench.drivers import engine as drv
    from chipbench.drivers.common import release
    bench = spec.load_benchmark()
    entry = spec.workload(bench, args.workload)
    # no serving past the close: a rate above the knee would run on to
    # the cap; TTFT here is cut at the close (a lower bound)
    cell = dict(spec.load_cell(args.workload), extend_s=0)
    config = spec.load_config(bench, entry["config"])
    ctx = harness.Ctx(bench=bench, workload=args.workload, cell=cell,
                      model=config["model"], arch=config["arch"],
                      seed=args.seed, seconds=args.seconds,
                      trace=False, device="cuda",
                      t_start=time.perf_counter())
    core = drv.build(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = copy.deepcopy(cell["traffic"])
        traffic["rate"] = rate
        # one grid of sizes and gaps spans the warm-up and the window,
        # as in the cell
        traffic["requests"] = max(32, round(
            1.05 * rate * (args.seconds + cell.get("warm_s", 0))))
        engine = drv.new_engine(ctx, core)
        out = drv.window(ctx, engine, traffic)
        rec = out["record"]
        done = sum(1 for r in engine.completed
                   if not str(r.rid).startswith("warm"))
        line = json.dumps({"workload": args.workload,
                           **summary(rate, rec, done)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del engine, out
        release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
