"""Times the INT8 GEMM at qwen2-7b's projection shapes, design by design
and weight format by weight format, against `torch.matmul` and another
checkout's `int8_gemm`.

    python -m repro_torch.launch.gemm_bench [--rows 8,16,32,64,128,129]
        [--baseline DIR] [--splits 1,2,4,8,16,32] [--weights int8,fp8]
        [--out FILE]

Needs a CUDA device.  For every M in --rows, every weight format in
--weights ("int8": random int8 codes; "fp8": float8 e4m3 weights holding
all 254 finite codes) and every (K, N) of the qwen2-7b projections, one
child process per checkout times, with f32 output (the TPU kernel's
output, and the only one older wrappers have):

* "plan"   — `int8_gemm(x, w_q, scale)` as `plan_gemm` dispatches it;
* "A"      — design A forced (`A_MIN_ROWS` set to 0 in the child);
* "B"      — design B as planned (`dataflow="ws"`);
* "B/s<S>" — design B with S K-slices, through its C entry (--splits);
* "matmul" — `torch.matmul` of x on a pre-dequantized bf16 weight;
* "baseline" — the `int8_gemm(x, w_q, scale)` of the checkout at
  --baseline (its `src/` on PYTHONPATH), run in its own child processes
  before and after this checkout's (baseline, this, this, baseline);
  a checkout whose wrapper takes no FP8 weight is timed on int8 only.

Each variant gets two times: "event_ms", CUDA events around back-to-back
calls (what a caller sees, host launch cost included), and "device_ms",
the summed device activity torch.profiler records per call.  Weights are
cycled over copies that together exceed twice the L2, so they come from
HBM.  The "plan" rows also carry the host time per call, measured over
calls issued without synchronising.  Rows go to --out as JSON lines; a
table of per-shape times and, per M, the sums over the 197 GEMMs of one
decode step is printed with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

L2_BYTES = 50 * 2 ** 20
MAX_COPIES = 64


def _shapes():
    """qwen2-7b's projection (K, N) -> calls per decode step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import n_periods
    cfg = ARCHS["qwen2-7b"]
    d, dh, L = cfg.d_model, cfg.head_dim(), n_periods(cfg)
    return {(d, cfg.n_heads * dh): 2 * L, (d, cfg.n_kv_heads * dh): 2 * L,
            (d, cfg.d_ff): 2 * L, (cfg.d_ff, d): L, (d, cfg.vocab): 1}


def _event_ms(torch, fn, n):
    for i in range(2):
        fn(i % n)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn(0)
    b.record()
    b.synchronize()
    iters = int(min(200, max(5, 30.0 / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for i in range(iters):
        fn(i % n)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, n, calls=24):
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(i % n)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % n)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if getattr(e.device_type, "name",
                            str(e.device_type)).endswith("CUDA")]
        if len(spans) >= calls:
            return sum(spans) / 1e3 / calls
    return float("nan")


def _host_us(torch, fn, n, calls=100):
    """Host time per call of fn over calls issued without a sync (fewer
    than the launch queue holds, so the host never waits for the card)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i % n)
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _weight(torch, fmt, k, n, gen, dev):
    """A (K, N) weight: int8 codes, or e4m3 bytes over the 254 finite
    codes."""
    if fmt == "int8":
        return torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                             dtype=torch.int8)
    codes = torch.tensor([c for c in range(256) if c & 0x7F != 0x7F],
                         dtype=torch.uint8, device=dev)
    idx = torch.randint(0, codes.numel(), (k, n), generator=gen, device=dev)
    return codes[idx].view(torch.float8_e4m3fn)


def child(rows, shapes, tag, splits, out, weights=("int8",)):
    """Times this process's `repro_torch` (PYTHONPATH) and prints rows."""
    import importlib
    import torch
    from repro_torch.kernels import int8_gemm
    i8 = importlib.import_module("repro_torch.kernels.int8_gemm")
    current = hasattr(i8, "plan_gemm")
    takes_fp8 = hasattr(i8, "WEIGHT_FORMATS")
    dev = torch.device("cuda")
    with open(out, "a") as f:
        def emit(row):
            row["tree"] = tag
            f.write(json.dumps(row) + "\n")
            f.flush()

        for m, fmt, (k, n) in ((m, fmt, kn) for m in rows for fmt in weights
                               for kn in shapes):
            if fmt != "int8" and not takes_fp8:
                continue
            gen = torch.Generator(device="cuda").manual_seed(k + n + m)
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = _weight(torch, fmt, k, n, gen, dev)
            s = torch.rand(n, generator=gen, device=dev) * 0.02 + 1e-3
            if fmt == "fp8":
                s = s / 448
            copies = min(MAX_COPIES, math.ceil(2 * L2_BYTES / (k * n)))
            qs = [q] + [q.clone() for _ in range(copies - 1)]
            want = i8.int8_gemm_ref(x, q, s)
            ref = want.abs().max().item()
            base = {"M": m, "K": k, "N": n, "weights": fmt}

            def run(name, fn, host=False, check=True):
                err = None
                if check:
                    err = ((fn(0) - want).abs().max().item() / ref)
                row = dict(base, variant=name, rel_err=err,
                           event_ms=_event_ms(torch, fn, copies),
                           device_ms=_device_ms(torch, fn, copies))
                if host:
                    row["host_us"] = _host_us(torch, fn, copies)
                emit(row)

            if not current:
                run("baseline", lambda i: int8_gemm(x, qs[i], s),
                    host=True)
            else:
                plan = i8.plan_gemm(m, n, k)
                run("plan", lambda i: int8_gemm(x, qs[i], s), host=True)
                keep = i8.A_MIN_ROWS
                i8.A_MIN_ROWS = 0
                i8.plan_gemm.cache_clear()
                run("A", lambda i: int8_gemm(x, qs[i], s))
                i8.A_MIN_ROWS = keep
                i8.plan_gemm.cache_clear()
                bplan = i8.plan_gemm(m, n, k, dataflow="ws")
                run("B", lambda i: int8_gemm(x, qs[i], s,
                                              dataflow="ws"))
                lib = i8.build().lib
                # the kernels' weight-format argument, where they have one
                fmt_arg = (int(fmt == "fp8"),) if takes_fp8 else ()
                y = torch.empty((m, n), device=dev)
                for sp in (splits if m > 8 else []):
                    ksl = 16 * math.ceil(math.ceil(k / 16) / sp)
                    if math.ceil(k / ksl) != sp or sp == bplan.splits:
                        continue
                    part = torch.empty((sp, m, n), device=dev)
                    stream = torch.cuda.current_stream().cuda_stream

                    def forced(i, sp=sp, ksl=ksl, part=part):
                        rc = lib.int8_gemm_ws_launch(
                            x.data_ptr(), qs[i].data_ptr(), s.data_ptr(),
                            y.data_ptr(), part.data_ptr(), m, n, k, k, n,
                            ksl, sp, 0, *fmt_arg, stream)
                        if rc:
                            raise RuntimeError(f"launch failed: {rc}")
                        return y
                    run(f"B/s{sp}", forced, host=True)
                    del part
                wb = (q.to(torch.bfloat16) * s.to(torch.bfloat16))
                lcopies = min(MAX_COPIES,
                              math.ceil(2 * L2_BYTES / (2 * k * n)))
                ws = [wb] + [wb.clone() for _ in range(lcopies - 1)]
                row = dict(base, variant="matmul", rel_err=None,
                           event_ms=_event_ms(
                               torch, lambda i: torch.matmul(x, ws[i]),
                               lcopies),
                           device_ms=_device_ms(
                               torch, lambda i: torch.matmul(x, ws[i]),
                               lcopies),
                           host_us=_host_us(
                               torch, lambda i: torch.matmul(x, ws[i]),
                               lcopies))
                emit(row)
                emit(dict(base, variant="plan-design", rel_err=None,
                          design=plan.design, b_splits=bplan.splits))
                del ws, wb
            del qs
            torch.cuda.empty_cache()


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", default="8,16,32,64,128,129")
    p.add_argument("--baseline", default=None)
    p.add_argument("--splits", default="1,2,4,8,16,32")
    p.add_argument("--weights", default="int8",
                   help="weight formats to time, of int8,fp8")
    p.add_argument("--out", default="runs/gemm_bench.jsonl")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    rows = [int(v) for v in a.rows.split(",")]
    splits = [int(v) for v in a.splits.split(",") if v]
    weights = [v for v in a.weights.split(",") if v]
    if set(weights) - {"int8", "fp8"}:
        p.error(f"--weights takes int8 and fp8, got {a.weights}")
    if a.child is not None:
        shapes = [tuple(s) for s in json.loads(os.environ["GEMM_BENCH_SHAPES"])]
        child(rows, shapes, a.child, splits, a.out, weights)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gemm_bench needs a CUDA device", file=sys.stderr)
        return 1
    shapes = _shapes()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    open(a.out, "w").close()
    trees = [("this", here)]
    if a.baseline:
        base = os.path.join(os.path.abspath(a.baseline), "src")
        trees = [("baseline", base), ("this", here), ("this", here),
                 ("baseline", base)]
    for tag, src in trees:
        env = dict(os.environ, PYTHONPATH=src,
                   GEMM_BENCH_SHAPES=json.dumps(list(shapes)))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tag, "--rows", a.rows, "--splits", a.splits,
                        "--weights", a.weights,
                        "--out", os.path.abspath(a.out)],
                       env=env, check=True, cwd=os.path.dirname(src))
        print(f"{tag} ({src}): {time.perf_counter() - t0:.1f} s")
    report(a.out, shapes, rows)
    print(card())
    return 0


def report(path, shapes, rows) -> None:
    """Per-shape table (means over the runs of each tree, the baseline's
    variants marked "(baseline)") and per-step sums per M, weight format
    and variant."""
    acc = {}
    designs = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            tree = "" if r["tree"] == "this" else f" ({r['tree']})"
            key = (r["M"], r["K"], r["N"],
                   f"{r.get('weights', 'int8')} {r['variant']}{tree}")
            if r["variant"] == "plan-design":
                designs[key[:3]] = (r["design"], r["b_splits"])
                continue
            acc.setdefault(key, []).append(r)
    for (m, k, n, v), rs in sorted(acc.items()):
        ev = sum(r["event_ms"] for r in rs) / len(rs)
        dv = sum(r["device_ms"] for r in rs) / len(rs)
        host = [r["host_us"] for r in rs if "host_us" in r]
        err = [r["rel_err"] for r in rs if r["rel_err"] is not None]
        print(f"M={m} K={k} N={n} {v}: event {ev!r} ms, device {dv!r} ms"
              + (f", host {sum(host) / len(host)!r} us/call" if host else "")
              + (f", max rel err {max(err)!r}" if err else "")
              + (f" [plan {designs.get((m, k, n))}]"
                 if " plan" in v else ""))
    for m in rows:
        for v in sorted({key[3] for key in acc if key[0] == m}):
            if not all((m, k, n, v) in acc for (k, n) in shapes):
                continue
            tot = {t: sum(cnt * sum(r[t] for r in acc[(m, k, n, v)])
                          / len(acc[(m, k, n, v)])
                          for (k, n), cnt in shapes.items())
                   for t in ("event_ms", "device_ms")}
            print(f"per step at M={m} ({sum(shapes.values())} GEMMs) {v}: "
                  f"event {tot['event_ms']!r} ms, device "
                  f"{tot['device_ms']!r} ms")


if __name__ == "__main__":
    raise SystemExit(main())
