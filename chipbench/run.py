"""Run one cell of the benchmark once, on the card it is started on.

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its
metrics are found by name from BENCHMARK.json (see chipbench/spec.py).
The last line of standard output is the run's result as one JSON object;
the numbers its correctness check compared, each beside its limit, are
the last lines of standard error.  With no CUDA card, fewer cards than
the cell asks for, the program missing, or JAX or the JAX package loaded
in this process at the end, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX,
    Flax or the JAX package, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)

    from chipbench import harness, spec
    bench = spec.load_benchmark()
    entry = spec.workload(bench, args.workload)
    cell = spec.load_cell(args.workload)
    config = spec.load_config(bench, entry["config"])

    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"no run: the cell needs {entry['chips']} CUDA card(s), "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program: absent, no result)

    ctx = harness.Ctx(bench=bench, workload=args.workload, cell=cell,
                      model=config["model"], arch=config["arch"],
                      seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=T_START)
    result = harness.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"no result: this process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
