#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`src/repro_torch`).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path — the scalar What/When/Where planner, the
static plan tables, the gated INT8 projections and the fixed-batch
`ServeSession` — at the full width of qwen2-7b (28 layers, random weights
from a seed, INT8-quantized), and:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the TF32 switches (both off);
2. builds the INT8 GEMM kernel from `src/repro_torch/kernels/csrc` with
   nvcc and prints its build time and ptxas register/smem/spill lines;
3. holds the kernel against its plain torch version at every qwen2-7b
   projection shape (M = 8 and 128, bf16) and at ragged shapes, with
   max|Δ| ≤ 1e-4·max|ref|, and times kernel, plain version, the weight-
   bytes bound and a yardstick (`torch.matmul` against a pre-dequantized
   bf16 weight, which the port never calls);
4. serves batch 8 (16-token prompt, 16 greedy tokens) with gating on,
   checks the route report (all 8 labels on the kernel) and that the
   kernel ran exactly (16 + 16) x 197 times, then serves the same weights
   ungated (0 launches) and compares the first-step logits;
5. prints one JSON line of kernel numbers, the card line, and last
   `{"ok": true, "device": {...}}`.

Any failed phase raises and exits non-zero; so does a machine with no
CUDA device or a directory without the port.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "qwen2-7b"
BATCH, PROMPT, NEW = 8, 16, 16
TOL = 1e-4                   # kernel vs plain: max|Δ| ≤ TOL·max|ref|
LOGIT_TOL = 5e-2             # gated vs ungated logits: ≤ LOGIT_TOL·max|ref|
MIN_TOKEN_AGREEMENT = 6      # of BATCH greedy first tokens
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20
MAX_COPIES = 64
RAGGED = [(5, 300, 1000), (1, 17, 33), (130, 1000, 37)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, n_inputs: int) -> float:
    """Mean device time of fn(i) over many launches (CUDA events), cycling
    over n_inputs input copies so the weights come from HBM, not L2."""
    for i in range(2):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(0)
    stop.record()
    stop.synchronize()
    est = max(start.elapsed_time(stop), 1e-3)
    iters = int(min(200, max(5, 30.0 / est)))
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_parts_ms(m: int, k: int, n: int, x_bytes: int,
                   peak_ops: float) -> tuple[float, float]:
    """The two floors of one call: each input read once and the f32
    output written once at HBM rate, and 2·M·N·K operations at the peak
    rate; the call's bound is the larger."""
    moved = m * k * x_bytes + k * n + 4 * n + 4 * m * n
    return 1e3 * moved / HBM_BYTES_PER_S, 1e3 * 2.0 * m * n * k / peak_ops


def check_kernel(torch, int8_gemm, int8_gemm_ref, m, k, n, dtype) -> dict:
    """Kernel vs plain version at one shape, and the kernel's, the plain
    version's and the yardstick's times."""
    gen = torch.Generator(device="cuda").manual_seed(m * 7919 + k + n)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(n, generator=gen, device="cuda") * 0.02 + 1e-3
    got = int8_gemm(x, q, s)
    want = int8_gemm_ref(x, q, s)
    torch.cuda.synchronize()
    ref_max = want.abs().max().item()
    err = (got - want).abs().max().item()
    row = {"M": m, "K": k, "N": n, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "max_rel_err": err / ref_max,
           "ok": bool(torch.isfinite(got).all().item())
           and err <= TOL * ref_max}
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    row["bytes_ms"], row["ops_ms"] = bound_parts_ms(m, k, n,
                                                    x.element_size(), peak)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    # weight copies cycled so the weights come from HBM, not L2 (capped:
    # the smallest shapes stay L2-resident, as they would in a model)
    copies = min(MAX_COPIES, math.ceil(2 * L2_BYTES / (k * n)))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    row["ms"] = time_ms(torch, lambda i: int8_gemm(x, qs[i], s), copies)
    row["plain_ms"] = time_ms(
        torch, lambda i: int8_gemm_ref(x, qs[i], s), copies)
    del qs
    wb = (q.to(dtype) * s.to(dtype)).to(dtype)
    row["w_bytes_x"] = wb.element_size()
    lib_copies = min(MAX_COPIES, math.ceil(2 * L2_BYTES / (
        wb.element_size() * k * n)))
    ws = [wb] + [wb.clone() for _ in range(lib_copies - 1)]
    row["library_ms"] = time_ms(
        torch, lambda i: torch.matmul(x, ws[i]), lib_copies)
    del ws, wb
    torch.cuda.empty_cache()
    return row


def profile_window(torch, fn) -> dict:
    """Wall time, device-busy time and the kernels by device time of fn()
    under torch.profiler (a traced run: the profiler adds host cost)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for evt in prof.events():
        kind = getattr(evt.device_type, "name", str(evt.device_type))
        if not kind.endswith("CUDA"):
            continue
        a, b = evt.time_range.start, evt.time_range.end
        spans.append((a, b))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (b - a)
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):              # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "kernels": sorted(by_name.items(), key=lambda kv: -kv[1])}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.kernels.int8_gemm import build, int8_gemm, int8_gemm_ref
    from repro_torch.models import init, n_periods
    from repro_torch.models.layers import CIM_ROUTE
    from repro_torch.serving import ServeSession

    # --- 1. the card ------------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kb = build()
    print(f"int8_gemm: built for sm_90a in {kb.seconds:.2f} s by nvcc "
          f"({time.perf_counter() - t0:.2f} s with loading), {kb.path.name}")
    for line in kb.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # --- 3. kernel vs plain version ----------------------------------------
    cfg = ARCHS[ARCH]
    d, dh = cfg.d_model, cfg.head_dim()
    L = n_periods(cfg)
    # (K, N) -> calls per decode step (the projection GEMMs of one step)
    step_shapes = {(d, cfg.n_heads * dh): 2 * L,          # Wq, Wo
                   (d, cfg.n_kv_heads * dh): 2 * L,       # Wk, Wv
                   (d, cfg.d_ff): 2 * L,                  # mlp-gate, mlp-up
                   (cfg.d_ff, d): L,                      # mlp-down
                   (d, cfg.vocab): 1}                     # lm_head
    calls_per_step = sum(step_shapes.values())
    rows = []
    cases = [(m, k, n, torch.bfloat16) for m in (BATCH, 128)
             for (k, n) in step_shapes]
    cases += [(m, k, n, dt) for (m, k, n) in RAGGED
              for dt in (torch.bfloat16, torch.float32)]
    cases.append((BATCH, d, d, torch.float32))
    rows = [check_kernel(torch, int8_gemm, int8_gemm_ref, *case)
            for case in cases]
    for r in rows:
        print(f"int8_gemm M={r['M']} K={r['K']} N={r['N']} {r['dtype']}: "
              f"max|d|={r['max_abs_err']!r} max|d|/max|ref|="
              f"{r['max_rel_err']!r} (tol {TOL}) "
              f"{'ok' if r['ok'] else 'FAIL'} | kernel {r['ms']!r} ms, "
              f"bound {r['bound_ms']!r} ms ({r['bound_ms'] / r['ms']:.1%} of "
              f"bound) | plain {r['plain_ms']!r} ms | library_ms "
              f"{r['library_ms']!r} ms (torch.matmul on a pre-dequantized "
              f"{r['dtype']} weight: {r['w_bytes_x']}x the int8 weight "
              f"bytes)")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"int8_gemm disagrees with its plain version: "
                           f"{bad}")
    at_batch = {(r["K"], r["N"]): r for r in rows
                if r["M"] == BATCH and r["dtype"] == "bfloat16"}
    per_step = {key: sum(cnt * at_batch[kn][key]
                         for kn, cnt in step_shapes.items())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bytes_ms", "ops_ms")}
    print(f"int8_gemm per decode step at batch {BATCH} ({calls_per_step} "
          f"calls): kernel {per_step['ms']!r} ms, weight-bytes bound "
          f"{per_step['bound_ms']!r} ms, plain {per_step['plain_ms']!r} ms,"
          f" library_ms {per_step['library_ms']!r} ms")

    # --- 4. serving -----------------------------------------------------------
    rc = RunConfig()
    max_len = PROMPT + NEW + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    gated = ServeSession(cfg, rc, params, max_len=max_len, batch=BATCH,
                         quantize=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    print(f"serve: {ARCH} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), init {t_init:.2f} s, plan + quantize "
          f"{t_quant:.2f} s, decode plan {gated.plan_table.digest}, prefill "
          f"plan {gated.prefill_plan_table.digest}")
    report = gated.route_report()
    for label, r in report.items():
        print(f"  route {label}: {r['route']} ({r['what']} @ {r['where']})")
    projections = ("Wq", "Wk", "Wv", "Wo", "mlp-gate", "mlp-up", "mlp-down",
                   "lm_head")
    if sorted(report) != sorted(projections) or any(
            r["route"] != CIM_ROUTE for r in report.values()):
        raise RuntimeError(f"route report is not all {CIM_ROUTE}: {report}")

    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to("cuda")
    gated.generate(prompt[:, :2], 1)               # warm-up, then start over
    gated.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    int8_gemm.launches = 0
    t0 = time.perf_counter()
    tokens = gated.generate(prompt, NEW)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = int8_gemm.launches
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT + NEW
    expected = steps * calls_per_step
    step_ms = 1e3 * elapsed / steps
    print(f"serve gated: {steps} steps (prefill {PROMPT} + decode {NEW}) "
          f"at batch {BATCH} in {elapsed!r} s: {step_ms!r} ms/step, "
          f"{BATCH * NEW / elapsed!r} new tokens/s "
          f"({BATCH * steps / elapsed!r} tokens/s over all steps); weight-"
          f"bytes floor {per_step['bound_ms']!r} ms/step; peak memory "
          f"{peak / 2**30!r} GiB; int8_gemm launches {launches} (expected "
          f"{steps} x {calls_per_step} = {expected}) [{card}]")
    if launches != expected:
        raise RuntimeError(f"int8_gemm launched {launches} times, expected "
                           f"{expected}")
    if tokens.shape != (BATCH, NEW) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise RuntimeError(f"bad token stream {tokens.shape}")

    ungated = ServeSession(cfg, rc, gated.params, max_len=max_len,
                           batch=BATCH, quantize=True, gated=False)
    if any(r["route"] == CIM_ROUTE for r in ungated.route_report().values()):
        raise RuntimeError("the ungated session routes a label to the kernel")
    int8_gemm.launches = 0
    t0 = time.perf_counter()
    ungated_tokens = ungated.generate(prompt, NEW)
    torch.cuda.synchronize()
    t_ungated = time.perf_counter() - t0
    if int8_gemm.launches != 0:
        raise RuntimeError(f"ungated session launched int8_gemm "
                           f"{int8_gemm.launches} times")
    print(f"serve ungated: {steps} steps in {t_ungated!r} s "
          f"({1e3 * t_ungated / steps!r} ms/step), 0 int8_gemm launches; "
          f"greedy streams equal on {int((tokens == ungated_tokens).all(1).sum())}"
          f" of {BATCH} lanes")

    gated.reset()
    ungated.reset()
    lg = gated.prefill(prompt[:, :1]).float()
    lu = ungated.prefill(prompt[:, :1]).float()
    if not (torch.isfinite(lg).all() and torch.isfinite(lu).all()):
        raise RuntimeError("non-finite first-step logits")
    diff = (lg - lu).abs().max().item()
    ref_max = lu.abs().max().item()
    agree = int((lg.argmax(-1) == lu.argmax(-1)).sum().item())
    print(f"first-step logits gated vs ungated: max|d|={diff!r}, "
          f"max|ref|={ref_max!r} (tol {LOGIT_TOL}·max|ref|: bf16 rounds at "
          f"other places on the two routes); greedy tokens agree on {agree}"
          f" of {BATCH} (need {MIN_TOKEN_AGREEMENT})")
    if diff > LOGIT_TOL * ref_max or agree < MIN_TOKEN_AGREEMENT:
        raise RuntimeError("gated and ungated first-step logits disagree")

    # traced run: where the time of a gated step goes on the device
    gated.reset()
    n_traced = 4
    prof = profile_window(torch, lambda: gated.prefill(prompt[:, :n_traced]))
    if prof["busy_ms"] > 0:
        print(f"traced gated steps ({n_traced}, profiler on): wall "
              f"{prof['wall_ms'] / n_traced!r} ms/step, device busy "
              f"{prof['busy_ms'] / n_traced!r} ms/step, device idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:8]:
            print(f"  device {us / 1e3 / n_traced!r} ms/step "
                  f"({us / 1e3 / prof['busy_ms']:.1%}): {name[:90]}")
    else:
        print("traced gated steps: the profiler recorded no device time "
              "(device busy share not measured)")

    # --- 5. result lines -----------------------------------------------------
    kernels = [{
        "name": "int8_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm.py:33",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": ("bytes" if per_step["bytes_ms"] >= per_step["ops_ms"]
                     else "operations"),
        "library_ms": per_step["library_ms"],
        "work": f"the {calls_per_step} calls of one {ARCH} decode step at "
                f"batch {BATCH} (per-shape times x calls per step)"}]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
