#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`src/repro_torch`).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main paths on the card: the planner-gated serving of
qwen2-7b at full width (28 layers, random weights from a seed) with INT8,
FP8 and INT4 weights and with the int8 KV cache, each step a replayed
CUDA graph, its continuous batching (32 ragged requests through the
paged, slot-masked engine, also adaptive and with the int8 KV pool) and
its serving CLI, its prefill forward (one
2048-token prompt through the flash-attention kernel) with INT8 and FP8
weights, and the batched What/When/Where sweep with its design-space
campaigns.  In order it:

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions and the TF32 switches (both off);
2. builds the four kernels from `src/repro_torch/kernels/csrc` with nvcc,
   the four nvcc runs started together, and prints their build times and
   ptxas register/smem/spill lines;
3. holds the INT8 GEMM kernels against their plain torch version at
   every qwen2-7b projection shape (M = 8, 32, 128, 129 and the
   prefill's 2048, bf16; `dataflow="ws"` at M = 8) and at ragged shapes
   in both dataflows, with max|Δ| ≤ 1e-4·max|ref| and the bf16 output
   equal to the f32 output cast; each row names the design that ran
   (`int8_gemm.plan_gemm`: A = TMA + wgmma, B = weight-stationary
   split-K, fma = f32 x); times kernel, plain version, the bound and a
   yardstick (`torch.matmul` against a pre-dequantized bf16 weight, which
   the port never calls) with the output in x's dtype, as the gated
   route asks for it, by CUDA events around back-to-back calls (host
   launch cost included, as for every kernel here) and by the profiler's
   device time per call (`device_ms`, `library_device_ms`); and runs the
   197 calls of one decode step through `ops.int8_matmul(dataflow="ws")`,
   counting their launches;
3b. does the same for the kernel's float8 e4m3 weight operand, on weights
   that hold all 254 finite e4m3 codes: every qwen2-7b projection shape at
   M = 8 (design B), 2048 (A) and `dataflow="ws"` (B), and f32 x (fma),
   each row checked for its design and its launch counted under "fp8";
   prints the per-step and per-forward sums beside the int8 rows' of the
   same call (same bound: one byte a weight), and runs the 197 `ws` calls
   of one decode step with fp8 weights;
4. holds the flash-attention kernel against its plain version (every
   case in f32 and bf16; GQA 28/4 and 8/1; sq = sk and sq < sk; a window;
   d = 64 and 128), element by element within the bounds of ATTN_TOL_DOC,
   each row naming the design that ran (`flash_attention.design`: "wgmma"
   = TMA + wgmma for bf16, "fma" for f32), and times it, the plain
   version and `scaled_dot_product_attention` (the yardstick) at
   qwen2-7b's prefill shape, by CUDA events (`ms`) and by the profiler's
   device time per call (`device_ms`, `library_device_ms`);
5. does the same for the flash-decoding kernel (length 0, 7, 300 and S;
   S = 300, not a multiple of 512; designs "mma" = TMA ring + mma.sync
   for bf16, "fma" for f32), timed at qwen2-7b's decode_32k shape; its
   main path is its public wrapper `ops.decode_attention`, called once
   there with the launch count read around the call;
6. holds the sweep kernel against its plain version bit for bit (NaN
   positions included) on the CUDA tensors and on a CPU copy of the first
   65,536 rows: every candidate row of the 1338-verdict golden grid in
   both order modes, invalid and degenerate rows, and the 32,768-row
   batch of benchmarks/sweep_bench.py tiled to 4,194,304 rows, which it
   also times against the plain version and the bytes bound;
7. plans the golden grid on the card with backend="vectorized" and
   "pallas" (every verdict equal to tests/golden/planner_verdicts.csv),
   with cold and cached plan times;
8. runs campaigns on the card: the golden spec on both backends and on a
   chunk_rows=512 engine (front CSV byte-equal to
   tests/golden/campaign_front.csv), then the default 142,720-point grid
   through `python -m repro_torch.launch.campaign --backend pallas` (the
   frontier byte-equal to results/campaign/frontier.csv once that file's
   precision column is normalized from `8` to `int8`), and a profiler
   window and a host (cProfile) profile over a smaller campaign;
9. serves batch 8 (16-token prompt, 16 greedy tokens) with gating on,
   prints the plan-cache telemetry of the batched planner, checks the
   route report (all 8 labels on the kernel) and that the kernel ran
   exactly (16 + 16) x 197 times, all on design B, then serves the same
   weights ungated
   (0 launches) and compares the first-step logits;
10. runs the prefill forward on the serve's INT8 weights: a `DecodeCore`
   planned at batch 8 and length 2048, `make_prefill(cfg,
   RunConfig(attn_impl="pallas"), core.prefill_plan_table)` on one
   (1, 2048) prompt; checks that the prefill table gates all 8 labels,
   that the forward launched flash_attention exactly 28 times, all on
   its "wgmma" design, and int8_gemm exactly 197 times, all on design A,
   and that its logits
   agree with the same
   forward on `attn_impl="flash_jnp"` (plain torch attention); prints the
   wall time, prefill tokens/s, peak memory and a traced forward's device
   time by kernel, with the flash kernel's share of it;
11. cross-checks the two serving paths: `forward` with attn_impl="pallas"
   and attn_chunk=8 on the serve's batch-8, 16-token prompt (the kernel
   at a 16-row block) under the serve's prefill table, against
   `ServeSession.prefill` (token by token): last-position logits within
   LOGIT_TOL·max|ref| and the greedy next tokens;
12. serves the INT8 weights again with `RunConfig(kv_cache_dtype="int8")`
   (int8 codes and bf16 scales in the cache): the first greedy tokens
   agree with the bf16-KV serve on at least MIN_TOKEN_AGREEMENT lanes;
   then frees the INT8 weights;
13. serves at `precision="fp8"` (weights drawn again from seed 0, FP8-
   quantized): all 8 labels on `cim-fp8-pallas`, exactly (16 + 16) x 197
   launches, all on design B and all with an e4m3 weight; the ungated
   session 0 launches; first-step logits and greedy tokens as in phase 9;
   ms/step, tokens/s and peak memory beside the INT8 serve's;
14. runs the prefill forward on those FP8 weights (phase 10's prompt and
   `attn_impl="pallas"`): 28 flash launches on "wgmma", 197 int8_gemm
   launches on design A with an e4m3 weight, logits against the same
   forward ungated (the dequant route) within LOGIT_TOL·max|ref|, the wall
   time and a traced forward's device time by kernel; then frees them;
15. serves at `precision="int4"` as phase 13 (`cim-int4-pallas`; the
   nibbles are unpacked to int8 before the kernel, so all launches are
   on an int8 weight);
16. runs the continuous-batching engine (`ContinuousBatchingEngine`,
   INT8 weights from seed 0, gated; 8 slots, block size 16, max_len 65,
   40 KV blocks) on 32 `synthetic_requests(seed=0, prompt_len=(8, 32),
   new_tokens=(8, 32))`: (a) all at once — every request completes with
   its max_new_tokens, int8_gemm launched exactly (steps + captures) x
   197 times, all on design B, `batch_decode_executables` equal to the
   phase plans served, one replayed engine step bit for bit against the
   eager `decode_step(..., active=, block_tables=)` on a clone of the
   pools, and eight requests on phase 9's prompt against `ServeSession`
   (first-step logits within LOGIT_TOL·max|ref|, greedy first tokens on
   at least MIN_TOKEN_AGREEMENT lanes); (b) Poisson arrivals at 4 req/s
   (TTFT, queue wait, tokens/s, occupancy, the step breakdown, peak
   memory) and a traced window's device busy and idle share; (c) the
   int8 KV pool (first tokens against the bf16-KV engine on at least
   24 of 32); (d) adaptive, `PlanService(backend="pallas")` over
   `BucketLattice.for_engine(8, 65)`: sweep_eval launched, and the
   streams equal the frozen engine's when no bucket gates a projection
   otherwise, else one capture per live plan variant;
17. runs `python -m repro_torch.launch.serve --arch qwen2-7b --smoke
   --requests 8 --quantize` as a subprocess: exit 0 and a JSON report;
18. prints one JSON line of kernel numbers, the card line, and last
   `{"ok": true, "device": {...}}`.

Phase 9 also holds the graphs: the serve's steps replay CUDA graphs
captured once (`decode_executables == prefill_executables == 1`), their
streams equal the eager `make_serve_step`'s, both steps bit for bit
against it on a clone of the cache, with ms/step, tokens/s and peak
memory of both, the graph pools' memory, and traced graphed and eager
steps; phases 12, 13 and 15 replay graphs too (replays credit the
launch counts).

Each kernel's launch count in that line comes from its own main path
(for sweep_eval, which has two entries: the default-grid campaign and
the adaptive engine run; for int8_gemm, which has eight entries, each
with its design and weight format: the gated INT8 serve, the INT8
prefill forward, the 197 calls of one decode step through
`ops.int8_matmul(dataflow="ws")`, the same three with FP8 weights, the
gated INT4 serve, and the continuous engine's all-at-once run; the
prefill forward for flash_attention; one call of the public wrapper for
decode_attention), counted from 0 just before that path ran.

Any failed phase raises and exits non-zero; so does a machine with no
CUDA device or a directory without the port.
"""
from __future__ import annotations

import csv
import importlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SWEEP_BENCH_ROWS = 32768     # benchmarks/sweep_bench.py:LARGE_BATCH_ROWS
SWEEP_TILES = 128            # 32,768 x 128 = 4,194,304 rows
SWEEP_CPU_ROWS = 65536       # rows also held against the CPU plain version
SWEEP_IN_FIELDS, SWEEP_OUT_ROWS = 24, 11
CAMPAIGN_CHUNK = 4096        # the campaign CLI's default --chunk-rows
GOLDEN_DIR = os.path.join(HERE, "tests", "golden")
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
PREFILL = 2048               # prefill prompt length (qwen2-7b prefill phase)
DECODE_S = 32768             # decode_32k cache length
ATTN_TOL_DOC = ("per element, against the plain version: f32 "
                "1e-5·max|ref|; bf16 1.02·2^-7·|ref| (one bf16 ulp) + "
                "2^-12·(P|v|), plus 2^-8·(P|v|) for flash_attention, which "
                "rounds p to bf16 for PV (P the plain softmax weights; "
                "kernels/flash_attention.py:compare_to_plain)")
# flash cases (b, sq, sk, H, KV, d, window), each in bf16 and f32; the card
# tests (tests/test_torch_cuda.py) run these and their own edge cases
FLASH_CASES = [(1, PREFILL, PREFILL, 28, 4, 128, 0),
               (2, 256, 256, 8, 1, 64, 0),
               (2, 128, 384, 28, 4, 128, 0),
               (1, 512, 512, 8, 1, 64, 100),
               (BATCH, PROMPT, PROMPT, 28, 4, 128, 0)]
# decode cases (b, S, H, KV, d), each in bf16 and f32 at length 0, 7, 300, S
DECODE_CASES = [(BATCH, DECODE_S, 28, 4, 128), (3, 4096, 28, 4, 128),
                (2, 300, 8, 1, 64)]
ATTN_DTYPES = ("bfloat16", "float32")
# continuous batching (phase 16): slots, block size, length cap, KV blocks
# (full provisioning: 8 x ceil(65 / 16)), requests, Poisson rate, and the
# requests of the traced window
CB_SLOTS, CB_BLOCK, CB_MAX_LEN, CB_BLOCKS = 8, 16, 65, 40
CB_REQUESTS, CB_RATE, CB_TRACED = 32, 4.0, 12
FRONTIER = os.path.join(HERE, "results", "campaign", "frontier.csv")


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


def device_ms(torch, fn, n_inputs: int, calls: int = 24) -> float:
    """Mean device time of fn(i) per call: the summed durations of the
    device activity torch.profiler records over `calls` calls, cycling
    over n_inputs input copies.  Unlike time_ms it leaves out the time the
    device waits for the host between small launches.  NaN (not measured)
    when five windows in a row lost records: a yardstick, not a check."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    for _ in range(5):      # a window that lost its records is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % n_inputs)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if getattr(e.device_type, "name",
                            str(e.device_type)).endswith("CUDA")]
        if len(spans) >= calls:          # every call launches >= 1 kernel
            return sum(spans) / 1e3 / calls
    print(f"device_ms: the profiler recorded fewer device activities than "
          f"calls in five windows; not measured", file=sys.stderr)
    return math.nan


def bound_parts_ms(m: int, k: int, n: int, x_bytes: int,
                   peak_ops: float, y_bytes: int = 4) -> tuple[float, float]:
    """The two floors of one call: each input read once and the output
    written once at HBM rate, and 2·M·N·K operations at the peak rate; the
    call's bound is the larger."""
    moved = m * k * x_bytes + k * n + 4 * n + y_bytes * m * n
    return 1e3 * moved / HBM_BYTES_PER_S, 1e3 * 2.0 * m * n * k / peak_ops


def gemm_weight(torch, weights, k, n, gen):
    """A (K, N) weight on the card and a scale for it: random int8 codes,
    or ("fp8") float8 e4m3 bytes whose first 254 elements are the 254
    finite codes in order, the rest drawn from them."""
    s = torch.rand(n, generator=gen, device="cuda") * 0.02 + 1e-3
    if weights == "int8":
        return torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                             dtype=torch.int8), s
    codes = torch.tensor([c for c in range(256) if c & 0x7F != 0x7F],
                         dtype=torch.uint8, device="cuda")
    idx = torch.randint(0, codes.numel(), (k * n,), generator=gen,
                        device="cuda")
    idx[:codes.numel()] = torch.arange(codes.numel(), device="cuda")
    return codes[idx].reshape(k, n).view(torch.float8_e4m3fn), s / 448


def check_kernel(torch, int8_gemm, int8_gemm_ref, m, k, n, dtype,
                 dataflow="os", weights="int8") -> dict:
    """Kernel vs plain version at one shape (f32 output, and the output in
    x's dtype, as the gated route asks for it, bit-equal to the f32 one
    cast), the design that ran, and the kernel's, the plain version's and
    the yardstick's times with the output in x's dtype.  `weights` is the
    weight format, "int8" or "fp8" (see gemm_weight)."""
    gen = torch.Generator(device="cuda").manual_seed(m * 7919 + k + n)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    q, s = gemm_weight(torch, weights, k, n, gen)
    before = dict(int8_gemm.launches_by_design)
    fmt_before = dict(int8_gemm.launches_by_format)
    got = int8_gemm(x, q, s, dataflow=dataflow)
    design = "+".join(d for d, c in int8_gemm.launches_by_design.items()
                      if c != before[d])
    fmt_ran = "+".join(f for f, c in int8_gemm.launches_by_format.items()
                       if c != fmt_before[f])
    want = int8_gemm_ref(x, q, s)
    same_cast = torch.equal(int8_gemm(x, q, s, out_dtype=dtype,
                                      dataflow=dataflow), got.to(dtype))
    torch.cuda.synchronize()
    ref_max = want.abs().max().item()
    err = (got - want).abs().max().item()
    row = {"M": m, "K": k, "N": n, "dtype": str(dtype).split(".")[-1],
           "dataflow": dataflow, "design": design, "weights": weights,
           "max_abs_err": err, "max_rel_err": err / ref_max,
           "out_cast_equal": same_cast,
           "ok": bool(torch.isfinite(got).all().item())
           and err <= TOL * ref_max and same_cast and fmt_ran == weights}
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    row["bytes_ms"], row["ops_ms"] = bound_parts_ms(
        m, k, n, x.element_size(), peak, x.element_size())
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    # weight copies cycled so the weights come from HBM, not L2 (capped:
    # the smallest shapes stay L2-resident, as they would in a model)
    copies = min(MAX_COPIES, math.ceil(2 * L2_BYTES / (k * n)))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    def kern(i):
        return int8_gemm(x, qs[i], s, out_dtype=dtype, dataflow=dataflow)

    def plain(i):
        return int8_gemm_ref(x, qs[i], s, dtype)

    row["ms"] = time_ms(torch, kern, copies)
    row["device_ms"] = device_ms(torch, kern, copies)
    row["plain_ms"] = time_ms(torch, plain, copies)
    del qs
    wb = (q.to(dtype) * s.to(dtype)).to(dtype)
    row["w_bytes_x"] = wb.element_size()
    lib_copies = min(MAX_COPIES, math.ceil(2 * L2_BYTES / (
        wb.element_size() * k * n)))
    ws = [wb] + [wb.clone() for _ in range(lib_copies - 1)]
    row["library_ms"] = time_ms(
        torch, lambda i: torch.matmul(x, ws[i]), lib_copies)
    row["library_device_ms"] = device_ms(
        torch, lambda i: torch.matmul(x, ws[i]), lib_copies)
    del ws, wb
    torch.cuda.empty_cache()
    return row


def top2_gaps(logits) -> list[float]:
    """Per batch lane, the gap between the two largest logits: a greedy
    token whose gap is below the two routes' difference can flip."""
    top = logits.reshape(logits.shape[0], -1).topk(2, dim=-1).values
    return [round(v, 5) for v in (top[:, 0] - top[:, 1]).tolist()]


def reset_counts(wrapper) -> None:
    """Set a kernel wrapper's launch counts, in all, per design and (for
    int8_gemm) per weight format, to 0."""
    wrapper.launches = 0
    for counts in (wrapper.launches_by_design,
                   getattr(wrapper, "launches_by_format", {})):
        for key in counts:
            counts[key] = 0


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


def host_profile(fn, named: tuple[str, ...]) -> dict:
    """Wall time of fn() under cProfile, the 8 functions with the most
    self time, and the cumulative time of the `named` functions."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    lines = []
    for (path, line, name), (_, calls, self_s, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:8]:
        lines.append(f"self {self_s!r} s ({self_s / wall:.1%}) in {name} "
                     f"({os.path.basename(path)}:{line}), {calls} calls")
    for want in named:
        cum = sum(v[3] for (_, _, name), v in stats.items() if name == want)
        lines.append(f"cumulative {cum!r} s ({cum / wall:.1%}) in {want}")
    return {"wall_s": wall, "lines": lines}


def attn_inputs(torch, shapes, dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in shapes]


def changed(wrapper, before: dict) -> str:
    """The designs whose launch count moved since `before` (a copy of
    wrapper.launches_by_design)."""
    return "+".join(d for d, c in wrapper.launches_by_design.items()
                    if c != before[d])


def check_flash(torch, ops, fa_mod) -> list[dict]:
    """ops.flash_attention vs the plain version on every FLASH_CASES, in
    both dtypes, element by element (ATTN_TOL_DOC)."""
    rows = []
    for (b, sq, sk, h, kv, d, window), dt in (
            (c, dt) for c in FLASH_CASES for dt in ATTN_DTYPES):
        q, k, v = attn_inputs(torch, [(b, sq, h, d), (b, sk, kv, d),
                                      (b, sk, kv, d)], getattr(torch, dt),
                              seed=sq + sk + h + d + window)
        before = dict(fa_mod.flash_attention.launches_by_design)
        got = ops.fold(ops.flash_attention(q, k, v, window=window))
        r = fa_mod.flash_attention_check(got, ops.fold(q), ops.fold(k),
                                         ops.fold(v), True, window)
        rows.append({"case": (b, sq, sk, h, kv, d, window, dt),
                     "design": changed(fa_mod.flash_attention, before), **r})
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


def check_decode(torch, ops, da_mod) -> list[dict]:
    """ops.decode_attention vs the plain version on every DECODE_CASES, in
    both dtypes, at length 0, 7, 300 and S, element by element."""
    rows = []
    for (b, S, h, kv, d), dt in ((c, dt) for c in DECODE_CASES
                                 for dt in ATTN_DTYPES):
        q, kc, vc = attn_inputs(torch, [(b, 1, h, d), (b, S, kv, d),
                                        (b, S, kv, d)], getattr(torch, dt),
                                seed=S + h + d)
        for length in sorted({0, 7, min(300, S), S}):
            before = dict(da_mod.decode_attention.launches_by_design)
            got = ops.fold(ops.decode_attention(q, kc, vc, length))
            r = da_mod.decode_attention_check(got, ops.fold(q), ops.fold(kc),
                                              ops.fold(vc), length)
            rows.append({"case": (b, S, h, kv, d, dt, length),
                         "design": changed(da_mod.decode_attention, before),
                         **r})
        del q, kc, vc
        torch.cuda.empty_cache()
    return rows


def golden_grid(ARCHS, SHAPES, gemms_of_model, phase_gemms_of_model):
    """(arch, shape, precision, GEMM) of tests/test_golden_verdicts.py's
    1338-row grid, in its order."""
    precisions = {"int8": (8, False), "int4": (4, False), "fp8": (8, True)}
    for arch, mc in ARCHS.items():
        workloads = [(s, gemms_of_model(mc, SHAPES[s]))
                     for s in ("train_4k", "decode_32k")]
        workloads += [(f"phase-{ph}", gs) for ph, gs in
                      phase_gemms_of_model(mc, 2048, 8).items()]
        for sname, gemms in workloads:
            for g in gemms:
                for tok, (bits, fp) in precisions.items():
                    yield (arch, sname, tok,
                           g if (g.bits == bits and g.fp == fp)
                           else g.scaled(bits=bits, fp=fp))


def canon(torch, x):
    """f32 bits with every NaN rewritten to one NaN: equal int32 views
    mean equal values and equal NaN positions (NaN payloads differ
    between the CPU and the card)."""
    x = x.clone()
    x[torch.isnan(x)] = float("nan")
    return x.view(torch.int32)


def degenerate_rows(np, FLAT_FIELDS, config_row, configs):
    """Invalid and degenerate rows on every standard config: k_arr = 0
    (NaN and inf terms), M = N = K = 1, zero and oversized mapping
    factors, int4 and fp8 on both compute types."""
    rows = []
    for c in configs:
        for bits, fp in ((8, 0), (4, 0), (8, 1)):
            for mnk in ((1, 1, 1), (1, 4096, 4096), (7, 3, 5)):
                base = {"M": mnk[0], "N": mnk[1], "K": mnk[2], "bits": bits,
                        "is_fp": fp, **config_row(c), "k_arr": 16,
                        "n_arr": 8, "pk": 1, "pn": 1, "m1": 4, "fk": 2,
                        "fn": 2}
                for edit in ({}, {"k_arr": 0}, {"n_arr": 0}, {"m1": 0},
                             {"fk": 0}, {"pk": 64, "pn": 64}, {"M": 0},
                             {"k_arr": 1e6}, {"at_rf": 0}):
                    rows.append({**base, **edit})
    return np.asarray([[r[f] for r in rows] for f in FLAT_FIELDS],
                      np.float32)


def ops_per_row(torch, sweep_eval_ref, rows) -> int:
    """Elementwise operations the plain sweep version runs per row: aten
    calls whose output has one element per row, counted under a dispatch
    mode (views, copies and constant fills excluded)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    n = rows.shape[1]
    skip = {"select", "view", "alias", "detach", "clone", "_to_copy",
            "lift_fresh", "full_like", "ones_like", "zeros_like", "full",
            "zeros", "ones", "empty", "empty_like", "copy_", "stack"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__ not in skip
                    and isinstance(out, torch.Tensor) and out.numel() == n):
                Count.ops += 1
            return out

    with Count():
        sweep_eval_ref(rows, "exact")
    return Count.ops


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.configs import ARCHS, SHAPES, RunConfig
    from repro_torch.core import (CampaignSpec, GEMM, SweepEngine,
                                  gemms_of_model, phase_gemms_of_model,
                                  plan_workload, run_campaign,
                                  standard_configs)
    from repro_torch.core.campaign import CIM_LEVELS
    from repro_torch.core.sweep import candidate_cols
    from repro_torch.core.vectorized import (FLAT_FIELDS, MAP_FIELDS,
                                             config_row, enumerate_space,
                                             precision_row)
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import int8_gemm, int8_gemm_ref
    from repro_torch.launch import campaign as campaign_cli
    from repro_torch.models import forward, init, n_periods, route_trace
    from repro_torch.models.layers import (CIM_FP8_ROUTE, CIM_INT4_ROUTE,
                                           CIM_ROUTE)
    from repro_torch.core import BucketLattice, PlanService
    from repro_torch.models import clone_cache, decode_step
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                     Request, ServeSession, make_prefill,
                                     make_serve_step, poisson_arrivals,
                                     sample_token, synthetic_requests)
    i8_mod = importlib.import_module("repro_torch.kernels.int8_gemm")
    sw_mod = importlib.import_module("repro_torch.kernels.sweep_eval")
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    da_mod = importlib.import_module("repro_torch.kernels.decode_attention")
    sweep_eval, sweep_eval_ref = sw_mod.sweep_eval, sw_mod.sweep_eval_ref
    import torch.nn.functional as F

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

    # --- 2. build the four kernels, nvcc runs started together -------------
    t0 = time.perf_counter()
    mods = (("int8_gemm", i8_mod), ("sweep_eval", sw_mod),
            ("flash_attention", fa_mod), ("decode_attention", da_mod))
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {name: pool.submit(mod.build) for name, mod in mods}
        builds = {name: f.result() for name, f in futures.items()}
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(parallel nvcc)")
    for name, kb in builds.items():
        print(f"{name}: built for sm_90a in {kb.seconds:.2f} s by nvcc, "
              f"{kb.path.name}")
        for line in kb.log.splitlines():
            if "registers" in line or "spill" in line or (
                    "Compiling" in line or "Performance" in line):
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
    cases = [(m, k, n, torch.bfloat16)
             for m in (BATCH, 32, 128, 129, PREFILL)
             for (k, n) in step_shapes]
    cases += [(BATCH, k, n, torch.bfloat16, "ws") for (k, n) in step_shapes]
    cases += [(m, k, n, dt, df) for (m, k, n) in RAGGED
              for dt in (torch.bfloat16, torch.float32) for df in ("os", "ws")]
    cases.append((BATCH, d, d, torch.float32))
    rows = [check_kernel(torch, int8_gemm, int8_gemm_ref, *case)
            for case in cases]

    def print_row(r):
        print(f"int8_gemm {r['weights']} weight M={r['M']} K={r['K']} "
              f"N={r['N']} {r['dtype']} "
              f"dataflow={r['dataflow']} design {r['design']}: "
              f"max|d|={r['max_abs_err']!r} max|d|/max|ref|="
              f"{r['max_rel_err']!r} (tol {TOL}), {r['dtype']} output == "
              f"f32 output cast {r['out_cast_equal']} "
              f"{'ok' if r['ok'] else 'FAIL'} | CUDA-event times over "
              f"back-to-back calls (host launch cost included): kernel "
              f"{r['ms']!r} ms, bound {r['bound_ms']!r} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of bound) | plain "
              f"{r['plain_ms']!r} ms | library_ms {r['library_ms']!r} ms "
              f"(torch.matmul on a pre-dequantized {r['dtype']} weight: "
              f"{r['w_bytes_x']}x the {r['weights']} weight bytes) | "
              f"profiler device "
              f"times: kernel {r['device_ms']!r} ms "
              f"({r['bound_ms'] / r['device_ms']:.1%} of bound), library "
              f"{r['library_device_ms']!r} ms")
    for r in rows:
        print_row(r)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"int8_gemm disagrees with its plain version: "
                           f"{bad}")

    def per_call_sum(m, dataflow, src=None):
        at = {(r["K"], r["N"]): r for r in (rows if src is None else src)
              if r["M"] == m and r["dtype"] == "bfloat16"
              and r["dataflow"] == dataflow}
        out = {key: sum(cnt * at[kn][key] for kn, cnt in step_shapes.items())
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bytes_ms", "ops_ms", "device_ms",
                           "library_device_ms")}
        out["design"] = "+".join(sorted({at[kn]["design"]
                                         for kn in step_shapes}))
        out["max_abs_err"] = max(at[kn]["max_abs_err"] for kn in step_shapes)
        return out

    per_step = per_call_sum(BATCH, "os")
    ws_step = per_call_sum(BATCH, "ws")
    for name, agg in (("int8_gemm", per_step),
                      ("ops.int8_matmul(dataflow='ws')", ws_step)):
        print(f"{name} per decode step at batch {BATCH} ({calls_per_step} "
              f"calls, design {agg['design']}): kernel {agg['ms']!r} ms, "
              f"weight-bytes bound {agg['bound_ms']!r} ms "
              f"({agg['bound_ms'] / agg['ms']:.1%} of bound), plain "
              f"{agg['plain_ms']!r} ms, library_ms {agg['library_ms']!r} ms "
              f"(CUDA-event times); device times: kernel "
              f"{agg['device_ms']!r} ms "
              f"({agg['bound_ms'] / agg['device_ms']:.1%} of bound), library "
              f"{agg['library_device_ms']!r} ms [{card}]")
    def ws_path(weights):
        """The ws main path: the 197 calls of one decode step through the
        public wrapper with `weights`, counted from 0."""
        ws_inputs = []
        for (k, n), cnt in step_shapes.items():
            gen = torch.Generator(device="cuda").manual_seed(k + n)
            x_ = torch.randn((BATCH, k), generator=gen,
                             device="cuda").to(torch.bfloat16)
            ws_inputs.append((x_, *gemm_weight(torch, weights, k, n, gen),
                              cnt))
        reset_counts(int8_gemm)
        for x_, q_, s_, cnt in ws_inputs:
            for _ in range(cnt):
                y_ = ops.int8_matmul(x_, q_, s_, dataflow="ws")
        torch.cuda.synchronize()
        n_launched = int8_gemm.launches
        by_design = dict(int8_gemm.launches_by_design)
        by_format = dict(int8_gemm.launches_by_format)
        print(f"ops.int8_matmul(dataflow='ws') over the {calls_per_step} "
              f"calls of one decode step at batch {BATCH}, {weights} "
              f"weights: launches {n_launched}, by design {by_design}, by "
              f"weight format {by_format}")
        if n_launched != calls_per_step or by_design["B"] != calls_per_step \
                or by_format[weights] != calls_per_step \
                or not bool(torch.isfinite(y_).all()):
            raise RuntimeError(f"the ws path launched {by_design}, "
                               f"{by_format}")
        del ws_inputs, y_
        torch.cuda.empty_cache()
        return n_launched

    ws_launches = ws_path("int8")
    per_fwd = per_call_sum(PREFILL, "os")
    print(f"int8_gemm per prefill forward at M = {PREFILL} ({calls_per_step}"
          f" calls, design {per_fwd['design']}): kernel {per_fwd['ms']!r} "
          f"ms, bound (operations) {per_fwd['bound_ms']!r} ms "
          f"({per_fwd['bound_ms'] / per_fwd['ms']:.1%} of bound), plain "
          f"{per_fwd['plain_ms']!r} ms, library_ms {per_fwd['library_ms']!r}"
          f" ms (CUDA-event times); device times: kernel "
          f"{per_fwd['device_ms']!r} ms, library "
          f"{per_fwd['library_device_ms']!r} ms [{card}]")

    # --- 3b. the FP8 e4m3 weight operand vs plain version, per design -------
    fp8_cases = [(m, k, n, torch.bfloat16, "os", "fp8")
                 for m in (BATCH, PREFILL) for (k, n) in step_shapes]
    fp8_cases += [(BATCH, k, n, torch.bfloat16, "ws", "fp8")
                  for (k, n) in step_shapes]
    fp8_cases.append((BATCH, d, d, torch.float32, "os", "fp8"))
    fp8_rows = [check_kernel(torch, int8_gemm, int8_gemm_ref, *case)
                for case in fp8_cases]
    for r in fp8_rows:
        print_row(r)
    bad = [r for r in fp8_rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"int8_gemm with an fp8 weight disagrees with its "
                           f"plain version: {bad}")
    fp8_design = {(BATCH, "os", "bfloat16"): "B", (PREFILL, "os", "bfloat16"):
                  "A", (BATCH, "ws", "bfloat16"): "B",
                  (BATCH, "os", "float32"): "fma"}
    if any(r["design"] != fp8_design[(r["M"], r["dataflow"], r["dtype"])]
           for r in fp8_rows):
        raise RuntimeError(f"int8_gemm ran an unexpected design with an fp8 "
                           f"weight: "
                           f"{[(r['M'], r['design']) for r in fp8_rows]}")
    fp8_step = per_call_sum(BATCH, "os", fp8_rows)
    fp8_ws_step = per_call_sum(BATCH, "ws", fp8_rows)
    fp8_fwd = per_call_sum(PREFILL, "os", fp8_rows)
    for what, f8, i8 in (("per decode step at batch 8", fp8_step, per_step),
                         ("per decode step, dataflow='ws'", fp8_ws_step,
                          ws_step),
                         (f"per prefill forward at M = {PREFILL}", fp8_fwd,
                          per_fwd)):
        print(f"int8_gemm {what} ({calls_per_step} calls, design "
              f"{f8['design']}), fp8 weights against int8 weights in this "
              f"call: kernel {f8['ms']!r} ms (int8 {i8['ms']!r}), device "
              f"{f8['device_ms']!r} ms (int8 {i8['device_ms']!r}), bound "
              f"{f8['bound_ms']!r} ms (the int8 bound: both are 1 byte a "
              f"weight), plain {f8['plain_ms']!r} ms, library_ms "
              f"{f8['library_ms']!r} ms, library device "
              f"{f8['library_device_ms']!r} ms (torch.matmul on the "
              f"dequantized bf16 weight) [{card}]")
    fp8_ws_launches = ws_path("fp8")

    # --- 4. flash attention vs plain version; timed at the prefill shape -----
    frows = check_flash(torch, ops, fa_mod)
    for r in frows:
        print(f"flash_attention (b, sq, sk, H, KV, d, window, dtype) = "
              f"{r['case']}, design {r['design']}: max|d|="
              f"{r['max_abs_err']!r}, max |d|/bound={r['worst']!r} "
              f"{'ok' if r['ok'] else 'FAIL'}")
    if not all(r["ok"] for r in frows):
        raise RuntimeError(f"flash_attention disagrees with its plain "
                           f"version ({ATTN_TOL_DOC}): "
                           f"{[r for r in frows if not r['ok']]}")
    flash_design = {"bfloat16": "wgmma", "float32": "fma"}
    if any(r["design"] != flash_design[r["case"][-1]] for r in frows):
        raise RuntimeError(f"flash_attention ran an unexpected design: "
                           f"{[(r['case'], r['design']) for r in frows]}")
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q, k, v = attn_inputs(torch, [(1, PREFILL, H, dh), (1, PREFILL, KV, dh),
                                  (1, PREFILL, KV, dh)], torch.bfloat16, 7)
    qf, kf, vf = ops.fold(q), ops.fold(k), ops.fold(v)
    flash_ms = time_ms(torch, lambda i: fa_mod.flash_attention(qf, kf, vf), 1)
    flash_dev_ms = device_ms(
        torch, lambda i: fa_mod.flash_attention(qf, kf, vf), 1)
    flash_plain_ms = time_ms(
        torch, lambda i: fa_mod.flash_attention_ref(qf, kf, vf), 1)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          enable_gqa=True)
    sdpa_err = (sdpa.transpose(1, 2).float()
                - ops.flash_attention(q, k, v).float()).abs().max().item()
    flash_lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 1)
    flash_lib_dev_ms = device_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), 1)
    pairs = int(fa_mod._mask(PREFILL, PREFILL, True, 0, "cpu").sum())
    flash_ops_ms = 1e3 * 4 * dh * pairs * H / BF16_OPS_PER_S
    flash_bytes_ms = 1e3 * 2 * (qf.numel() * 2 + kf.numel() * 2) \
        / HBM_BYTES_PER_S
    flash_bound_ms = max(flash_ops_ms, flash_bytes_ms)
    print(f"flash_attention timing at (1, {PREFILL}, {H}/{KV}, {dh}) bf16 "
          f"causal (one prefill layer): kernel {flash_ms!r} ms, plain "
          f"{flash_plain_ms!r} ms, library_ms {flash_lib_ms!r} ms "
          f"(scaled_dot_product_attention, enable_gqa; max|d| vs the kernel "
          f"{sdpa_err!r}); bound {flash_bound_ms!r} ms = max(operations: "
          f"{4 * dh * pairs * H / 1e9:.2f} GFLOP over {pairs} unmasked "
          f"pairs per head at 989 TFLOP/s = {flash_ops_ms!r} ms, bytes: "
          f"{flash_bytes_ms!r} ms), {flash_bound_ms / flash_ms:.1%} of "
          f"bound; per {L}-layer forward {L * flash_ms!r} ms (CUDA-event "
          f"times); profiler device times: kernel {flash_dev_ms!r} ms "
          f"({flash_bound_ms / flash_dev_ms:.1%} of bound), library "
          f"{flash_lib_dev_ms!r} ms; design "
          f"{fa_mod.design(qf.dtype)} [{card}]")
    del q, k, v, qf, kf, vf, q4, k4, v4, sdpa
    torch.cuda.empty_cache()

    # --- 5. flash-decoding vs plain version; timed at decode_32k -------------
    drows = check_decode(torch, ops, da_mod)
    for r in drows:
        print(f"decode_attention (b, S, H, KV, d, dtype, length) = "
              f"{r['case']}, design {r['design']}: max|d|="
              f"{r['max_abs_err']!r}, max |d|/bound={r['worst']!r} "
              f"{'ok' if r['ok'] else 'FAIL'}")
    if not all(r["ok"] for r in drows):
        raise RuntimeError(f"decode_attention disagrees with its plain "
                           f"version ({ATTN_TOL_DOC}): "
                           f"{[r for r in drows if not r['ok']]}")
    decode_design = {"bfloat16": "mma", "float32": "fma"}
    if any(r["design"] != decode_design[r["case"][5]] for r in drows):
        raise RuntimeError(f"decode_attention ran an unexpected design: "
                           f"{[(r['case'], r['design']) for r in drows]}")
    q, kc, vc = attn_inputs(torch, [(BATCH, 1, H, dh),
                                    (BATCH, DECODE_S, KV, dh),
                                    (BATCH, DECODE_S, KV, dh)],
                            torch.bfloat16, 8)
    length = torch.tensor(DECODE_S, dtype=torch.int32, device="cuda")
    reset_counts(da_mod.decode_attention)    # its main path: the public
    out = ops.decode_attention(q, kc, vc, length)  # wrapper, one call
    torch.cuda.synchronize()
    decode_launches = da_mod.decode_attention.launches
    decode_by_design = dict(da_mod.decode_attention.launches_by_design)
    if decode_launches != 1 or decode_by_design["mma"] != 1 or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"ops.decode_attention launched "
                           f"{decode_by_design}")
    qf, kf, vf = ops.fold(q), ops.fold(kc), ops.fold(vc)
    decode_ms = time_ms(
        torch, lambda i: da_mod.decode_attention(qf, kf, vf, length), 1)
    decode_dev_ms = device_ms(
        torch, lambda i: da_mod.decode_attention(qf, kf, vf, length), 1)
    decode_plain_ms = time_ms(
        torch, lambda i: da_mod.decode_attention_ref(qf, kf, vf, length), 1)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, kc, vc))
    sdpa_err = (F.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=True).transpose(1, 2).float()
        - out.float()).abs().max().item()
    decode_lib_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=True), 1)
    decode_lib_dev_ms = device_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True), 1)
    decode_bytes = 2 * (kf.numel() * 2 + qf.numel() * 2)
    decode_bytes_ms = 1e3 * decode_bytes / HBM_BYTES_PER_S
    decode_ops_ms = 1e3 * 4 * dh * DECODE_S * H * BATCH / BF16_OPS_PER_S
    decode_bound_ms = max(decode_bytes_ms, decode_ops_ms)
    print(f"decode_attention timing at ({BATCH}, {DECODE_S}, {H}/{KV}, {dh}) "
          f"bf16, length {DECODE_S}: kernel {decode_ms!r} ms, plain "
          f"{decode_plain_ms!r} ms, library_ms {decode_lib_ms!r} ms "
          f"(scaled_dot_product_attention, enable_gqa; max|d| vs the kernel "
          f"{sdpa_err!r}); bound {decode_bound_ms!r} ms = max(bytes: "
          f"{decode_bytes / 1e6:.1f} MB at 3.35 TB/s = {decode_bytes_ms!r} "
          f"ms, operations: {decode_ops_ms!r} ms), "
          f"{decode_bound_ms / decode_ms:.1%} of bound (CUDA-event times); "
          f"profiler device times: kernel {decode_dev_ms!r} ms "
          f"({decode_bound_ms / decode_dev_ms:.1%} of bound), library "
          f"{decode_lib_dev_ms!r} ms; main-path launches {decode_launches} "
          f"by design {decode_by_design} [{card}]")
    del q, kc, vc, qf, kf, vf, q4, k4, v4, out
    torch.cuda.empty_cache()

    # --- 6. the sweep kernel against its plain version, bit for bit ----------
    configs = standard_configs()
    entries = list(golden_grid(ARCHS, SHAPES, gemms_of_model,
                               phase_gemms_of_model))
    sets = {}
    for om in ("exact", "greedy"):
        parts = [candidate_cols(g, c, om)[1] for *_, g in entries
                 for c in configs.values()]
        sets[f"golden grid, {om}"] = (np.stack(
            [np.concatenate([p[f] for p in parts]) for f in FLAT_FIELDS]), om)
        sets[f"degenerate rows, {om}"] = (degenerate_rows(
            np, FLAT_FIELDS, config_row, configs.values()), om)
    g_bench = GEMM(4096, 4096, 4096)
    c_bench = configs["Digital-6T@RF"]
    space = enumerate_space(g_bench, c_bench, max_points=SWEEP_BENCH_ROWS,
                            device="cpu")
    cols = {f: space[f].numpy().astype(np.float32) for f in MAP_FIELDS}
    for name, v in {"M": g_bench.M, "N": g_bench.N, "K": g_bench.K,
                    **precision_row(g_bench), **config_row(c_bench)}.items():
        cols[name] = np.full(SWEEP_BENCH_ROWS, float(v), np.float32)
    bench = np.stack([cols[f] for f in FLAT_FIELDS])
    sets["sweep_bench batch x128, exact"] = (np.tile(bench,
                                                      (1, SWEEP_TILES)),
                                              "exact")
    for name, (host, om) in sets.items():
        cpu_rows = torch.from_numpy(np.ascontiguousarray(host))
        dev = cpu_rows.to("cuda")
        got = sweep_eval(dev, om)
        want = sweep_eval_ref(dev, om)
        cpu = sweep_eval_ref(cpu_rows[:, :SWEEP_CPU_ROWS], om)
        torch.cuda.synchronize()
        same_cuda = torch.equal(canon(torch, got), canon(torch, want))
        same_cpu = torch.equal(canon(torch, got[:, :SWEEP_CPU_ROWS].cpu()),
                               canon(torch, cpu))
        n_nan = int(torch.isnan(want).any(0).sum().item())
        n_invalid = int((want[0] == 0).sum().item())
        print(f"sweep_eval {name}: {cpu_rows.shape[1]} rows ({n_invalid} "
              f"invalid, {n_nan} with NaN outputs): kernel == plain on cuda "
              f"{same_cuda}, == plain on cpu (first "
              f"{min(cpu_rows.shape[1], SWEEP_CPU_ROWS)} rows) {same_cpu}")
        if not (same_cuda and same_cpu):
            bad = (canon(torch, got) != canon(torch, want)).any(0)
            raise RuntimeError(f"sweep_eval disagrees with its plain version "
                               f"on {name}: {int(bad.sum())} rows differ")
        del got, want
    big = dev                       # the last set: the 4,194,304-row batch
    n_big = big.shape[1]
    sweep_ms = time_ms(torch, lambda i: sweep_eval(big, "exact"), 1)
    sweep_plain_ms = time_ms(torch, lambda i: sweep_eval_ref(big, "exact"), 1)
    chunk = big[:, :CAMPAIGN_CHUNK].contiguous()
    chunk_ms = time_ms(torch, lambda i: sweep_eval(chunk, "exact"), 1)
    chunk_plain_ms = time_ms(torch, lambda i: sweep_eval_ref(chunk, "exact"),
                             1)
    row_bytes = 4 * (SWEEP_IN_FIELDS + SWEEP_OUT_ROWS)
    n_ops = ops_per_row(torch, sweep_eval_ref, big[:, :1024].cpu())
    sweep_bytes_ms = 1e3 * row_bytes * n_big / HBM_BYTES_PER_S
    sweep_ops_ms = 1e3 * n_ops * n_big / F32_OPS_PER_S
    sweep_bound_ms = max(sweep_bytes_ms, sweep_ops_ms)
    print(f"sweep_eval timing on {n_big} rows (exact): kernel {sweep_ms!r} "
          f"ms ({1e6 * sweep_ms / n_big!r} ns/row), plain {sweep_plain_ms!r}"
          f" ms; bound {sweep_bound_ms!r} ms = max(bytes: {row_bytes} B/row "
          f"= {row_bytes * n_big / 1e6:.1f} MB at 3.35 TB/s = "
          f"{sweep_bytes_ms!r} ms, operations: {n_ops} f32 ops/row at 67 "
          f"TFLOP/s = {sweep_ops_ms!r} ms), {sweep_bound_ms / sweep_ms:.1%} "
          f"of bound; library_ms none (no single torch call computes it); "
          f"one {CAMPAIGN_CHUNK}-row campaign chunk: kernel {chunk_ms!r} ms, "
          f"plain {chunk_plain_ms!r} ms [{card}]")
    del big, chunk, dev
    torch.cuda.empty_cache()

    # --- 7. the planner on the card -----------------------------------------
    with open(os.path.join(GOLDEN_DIR, "planner_verdicts.csv")) as f:
        golden = [(r["arch"], r["shape"], r["precision"], r["label"],
                   r["best_energy"], r["best_throughput"], r["use_cim"],
                   r["where"]) for r in csv.DictReader(f)]
    gemms = [g for *_, g in entries]
    plan_workload(gemms[:24], engine=SweepEngine(device="cuda"),
                  backend="pallas")                   # warm-up: CUDA init
    for backend in ("vectorized", "pallas"):
        engine = SweepEngine(device="cuda")
        sw_mod.sweep_eval.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decisions = plan_workload(gemms, backend=backend, engine=engine)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launched = sw_mod.sweep_eval.launches
        t0 = time.perf_counter()
        again = plan_workload(gemms, backend=backend, engine=engine)
        cached = time.perf_counter() - t0
        got = [(arch, sname, prec, g.label, d.best_energy,
                d.best_throughput, str(int(d.use_cim)), d.where)
               for (arch, sname, prec, g), d in zip(entries, decisions)]
        diffs = [i for i, (a, b) in enumerate(zip(got, golden)) if a != b]
        print(f"planner backend={backend} on cuda: {len(got)} verdicts, "
              f"{len(diffs)} differ from tests/golden/planner_verdicts.csv;"
              f" cold plan (empty result cache) {cold!r} s, cached plan "
              f"{cached!r} s; sweep_eval launches {launched}; cache_info "
              f"{json.dumps(engine.cache_info())} [{card}]")
        if diffs or len(got) != len(golden) or [
                d.best_energy for d in again] != [d.best_energy
                                                  for d in decisions]:
            raise RuntimeError(f"planner verdicts differ on the card: rows "
                               f"{diffs[:20]}")

    # --- 8. campaigns on the card -------------------------------------------
    golden_spec = CampaignSpec(
        workloads=(("mistral-nemo-12b", "train_4k"),
                   ("mistral-nemo-12b", "decode_32k")),
        prototypes=("Analog-6T", "Analog-8T", "Digital-6T", "Digital-8T"),
        precisions=("int8", "int4", "fp8"),
        levels=("RF", "SMEM-A", "SMEM-B"), scales=(1.0, 4.0),
        serialize_modes=(True,), kn_thresholds=(4,),
        order_modes=("exact", "greedy"))
    with open(os.path.join(GOLDEN_DIR, "campaign_front.csv"),
              newline="") as f:
        golden_front = f.read()
    for backend, chunk_rows in (("vectorized", None), ("pallas", None),
                                ("pallas", 512)):
        engine = SweepEngine(chunk_rows=chunk_rows, device="cuda")
        t0 = time.perf_counter()
        result = run_campaign(golden_spec, engine=engine, backend=backend,
                              block_points=256, group_by="gemm")
        wall = time.perf_counter() - t0
        chunks = engine.cache_info()["chunks"]
        same = result.csv_text() == golden_front
        print(f"campaign golden spec backend={backend} chunk_rows="
              f"{chunk_rows}: {result.stats['n_points']} points, "
              f"{len(result.front)} front rows, byte-equal to "
              f"tests/golden/campaign_front.csv {same}; {wall!r} s, "
              f"{chunks['evaluated']} chunks")
        if not same or chunks["evaluated"] < 2:
            raise RuntimeError(f"golden campaign front differs on the card "
                               f"({backend}, chunk_rows={chunk_rows})")

    out_dir = os.path.join(HERE, "build", "chip_smoke", "campaign")
    sw_mod.sweep_eval.launches = 0          # the campaign path starts
    t0 = time.perf_counter()
    rc = campaign_cli.main(["--backend", "pallas", "--device", "cuda",
                            "--max-certify-groups", "2", "--out", out_dir])
    campaign_wall = time.perf_counter() - t0
    sweep_launches = sw_mod.sweep_eval.launches     # ... and ends here
    with open(os.path.join(out_dir, "campaign_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "frontier.csv"), newline="") as f:
        ours = f.read()
    with open(FRONTIER, newline="") as f:
        lines = f.read().split("\n")
    prec = lines[0].split(",").index("precision")
    for i in range(1, len(lines)):
        # the one normalization: the committed file predates the canonical
        # precision tokens, so its precision column reads 8 where the
        # campaign now writes int8 (the CSV has no quoted fields)
        cells = lines[i].split(",")
        if len(cells) > prec and cells[prec] == "8":
            cells[prec] = "int8"
            lines[i] = ",".join(cells)
    same = ours == "\n".join(lines)
    stats = report["report"]["stats"]
    run_s = report["run_seconds"]
    print(f"campaign default grid (--backend pallas): "
          f"{stats['n_points']} points in {run_s!r} s "
          f"({stats['n_points'] / run_s!r} points/s; CLI wall "
          f"{campaign_wall!r} s with certification), "
          f"{stats['engine_chunks']['rows']} rows evaluated in "
          f"{stats['engine_chunks']['evaluated']} chunks, sweep_eval "
          f"launches {sweep_launches}, {len(report['certification']['points'])}"
          f" champion points certified {report['certification']['ok']} in "
          f"{report['certify_seconds']!r} s; frontier "
          f"{report['frontier_csv']['rows']} rows, sha256 "
          f"{report['frontier_csv']['sha256'][:16]}, byte-equal to "
          f"results/campaign/frontier.csv (precision 8 -> int8) {same} "
          f"[{card}]")
    if rc != 0 or not same or sweep_launches == 0:
        raise RuntimeError(f"default campaign failed: rc {rc}, frontier "
                           f"equal {same}, launches {sweep_launches}")

    cells = campaign_cli.default_workloads()[:2]
    small = CampaignSpec(workloads=cells, levels=CIM_LEVELS,
                         scales=campaign_cli.DEFAULT_SCALES,
                         serialize_modes=(True, False), kn_thresholds=(4, 8),
                         order_modes=("exact", "greedy"), precisions=(8,))
    prof = profile_window(torch, lambda: run_campaign(
        small, engine=SweepEngine(chunk_rows=CAMPAIGN_CHUNK, device="cuda"),
        backend="pallas"))
    if prof["busy_ms"] > 0:
        print(f"traced campaign ({small.n_points} points, {cells}, profiler "
              f"on): wall {prof['wall_ms']!r} ms, device busy "
              f"{prof['busy_ms']!r} ms, device idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:6]:
            print(f"  device {us / 1e3!r} ms "
                  f"({us / 1e3 / prof['busy_ms']:.1%}): {name[:90]}")
    else:
        print("traced campaign: the profiler recorded no device time "
              "(device busy share not measured)")
    host = host_profile(lambda: run_campaign(
        small, engine=SweepEngine(chunk_rows=CAMPAIGN_CHUNK, device="cuda"),
        backend="pallas"), ("candidate_mappings", "cim_metrics",
                            "_stream_batches", "sweep_eval",
                            "metrics_from_row", "pareto_mask_np"))
    print(f"host profile of the same campaign (cProfile on): wall "
          f"{host['wall_s']!r} s")
    for line in host["lines"]:
        print(f"  {line}")

    # --- 9. serving --------------------------------------------------------
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
    print(f"serve plan (backend=vectorized on cuda) plan_cache_telemetry: "
          f"{json.dumps(gated.plan_cache_telemetry)}")
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
    torch.cuda.synchronize()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    gated.generate(prompt[:, :2], 1)      # warm-up and capture, start over
    gated.reset()
    torch.cuda.synchronize()
    graph_alloc = torch.cuda.memory_allocated() - mem0[0]
    graph_reserved = torch.cuda.memory_reserved() - mem0[1]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(int8_gemm)
    t0 = time.perf_counter()
    tokens = gated.generate(prompt, NEW)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = int8_gemm.launches
    serve_by_design = dict(int8_gemm.launches_by_design)
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT + NEW
    expected = steps * calls_per_step
    step_ms = 1e3 * elapsed / steps
    i8_tokens_s = BATCH * NEW / elapsed
    print(f"serve gated: {steps} steps (prefill {PROMPT} + decode {NEW}) "
          f"at batch {BATCH} in {elapsed!r} s: {step_ms!r} ms/step, "
          f"{BATCH * NEW / elapsed!r} new tokens/s "
          f"({BATCH * steps / elapsed!r} tokens/s over all steps); weight-"
          f"bytes floor {per_step['bound_ms']!r} ms/step; peak memory "
          f"{peak / 2**30!r} GiB; int8_gemm launches {launches} (expected "
          f"{steps} x {calls_per_step} = {expected}), by design "
          f"{serve_by_design} [{card}]")
    if launches != expected or serve_by_design["B"] != expected:
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
          f" of {BATCH} (need {MIN_TOKEN_AGREEMENT}); top-2 logit gap per "
          f"lane: gated {top2_gaps(lg)}, ungated {top2_gaps(lu)}")
    if diff > LOGIT_TOL * ref_max or agree < MIN_TOKEN_AGREEMENT:
        raise RuntimeError("gated and ungated first-step logits disagree")

    def trace_steps(sess, what, n_traced=4):
        """Where the time of a gated step goes on the device: n_traced
        prefill-phase steps of `sess` under the profiler."""
        sess.reset()
        prof = profile_window(
            torch, lambda: sess.prefill(prompt[:, :n_traced]))
        sess.reset()
        if prof["busy_ms"] <= 0:
            print(f"traced {what} steps: the profiler recorded no device "
                  f"time (device busy share not measured)")
            return
        print(f"traced {what} steps ({n_traced}, profiler on): wall "
              f"{prof['wall_ms'] / n_traced!r} ms/step, device busy "
              f"{prof['busy_ms'] / n_traced!r} ms/step, device idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:8]:
            print(f"  device {us / 1e3 / n_traced!r} ms/step "
                  f"({us / 1e3 / prof['busy_ms']:.1%}): {name[:90]}")

    trace_steps(gated, "gated")

    # --- 9b. the graphed step against the eager step ------------------------
    def eager_generate(sess, toks, n_new):
        """ServeSession.generate on the eager step (`make_serve_step`, the
        function the core captures), on the session's own cache."""
        pre = make_serve_step(cfg, sess.rc, sess.prefill_plan_table)
        dec = make_serve_step(cfg, sess.rc, sess.plan_table)
        sess.reset()
        with torch.inference_mode():
            for t in range(toks.shape[1]):
                logits, sess.cache = pre(sess.params, sess.cache,
                                         toks[:, t:t + 1], sess.pos)
                sess.pos += 1
            out, tok = [], sample_token(cfg, logits, 0.0)
            for _ in range(n_new):
                out.append(tok)
                logits, sess.cache = dec(sess.params, sess.cache, tok,
                                         sess.pos)
                sess.pos += 1
                tok = sample_token(cfg, logits, 0.0)
        return torch.cat(out, dim=1) if out else None

    eager_generate(gated, prompt[:, :2], 1)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(int8_gemm)
    t0 = time.perf_counter()
    eager_tokens = eager_generate(gated, prompt, NEW)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    eager_launches = dict(int8_gemm.launches_by_design)
    eager_peak = torch.cuda.max_memory_allocated()
    gated.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = gated.generate(prompt, NEW)
    torch.cuda.synchronize()
    t_graph2 = time.perf_counter() - t0
    eager_step_ms = 1e3 * t_eager / steps
    graph_step_ms = 1e3 * min(elapsed, t_graph2) / steps
    print(f"serve gated, graphed vs eager on the same weights ({steps} steps "
          f"at batch {BATCH}): graphed {step_ms!r} and "
          f"{1e3 * t_graph2 / steps!r} ms/step "
          f"({BATCH * NEW / elapsed!r}, {BATCH * NEW / t_graph2!r} new "
          f"tokens/s), eager make_serve_step {eager_step_ms!r} ms/step "
          f"({BATCH * NEW / t_eager!r} new tokens/s): "
          f"{eager_step_ms / graph_step_ms:.2f}x; eager launches by design "
          f"{eager_launches}; peak memory graphed {peak / 2**30!r} GiB, "
          f"eager {eager_peak / 2**30!r} GiB; the captures (graph pools "
          f"and static buffers) hold {graph_alloc / 2**20!r} MiB allocated, "
          f"{graph_reserved / 2**20!r} MiB reserved [{card}]")
    if not (torch.equal(eager_tokens, tokens) and torch.equal(again, tokens)):
        raise RuntimeError("the graphed serve's greedy streams differ from "
                           "the eager step's")
    if eager_launches["B"] != expected:
        raise RuntimeError(f"the eager serve launched {eager_launches}")
    if peak > eager_peak + max(graph_alloc, 0):
        raise RuntimeError("the graphed serve's peak memory exceeds the "
                           "eager serve's by more than the graph pools")

    def graphed_vs_eager(sess, n_fill):
        """Both steps of a session, graphed, against the eager function on
        a clone of the cache: logits and caches bit for bit."""
        sess.reset()
        sess.prefill(prompt[:, :n_fill])
        results = []
        for name, fn, table in (("prefill", sess.core.prefill_step,
                                 sess.prefill_plan_table),
                                ("decode", sess.core.step, sess.plan_table)):
            copy = clone_cache(sess.cache)
            tok = prompt[:, n_fill:n_fill + 1]
            got, _ = fn(sess.cache, tok, sess.pos)
            with torch.inference_mode():
                want, copy = make_serve_step(cfg, sess.rc, table)(
                    sess.params, copy, tok, sess.pos)
            same = torch.equal(got, want) and all(
                torch.equal(sess.cache[0][k], copy[0][k]) for k in copy[0])
            results.append((name, same))
        sess.reset()
        return results

    bitwise = graphed_vs_eager(gated, 5)
    print(f"graphed steps vs the eager function on a clone of the cache "
          f"(logits and cache bit for bit): {bitwise}; decode_executables "
          f"{gated.decode_executables}, prefill_executables "
          f"{gated.prefill_executables} (prefill table "
          f"{'==' if gated.prefill_plan_table == gated.plan_table else '!='}"
          f" decode table)")
    if not all(same for _, same in bitwise) or (
            gated.decode_executables, gated.prefill_executables) != (1, 1):
        raise RuntimeError("the graphed step is not the eager step, or was "
                           "captured more than once")
    eager_prof = profile_window(torch, lambda: eager_generate(
        gated, prompt[:, :4], 0))
    gated.reset()
    if eager_prof["busy_ms"] > 0:
        print(f"traced eager steps (4, profiler on): wall "
              f"{eager_prof['wall_ms'] / 4!r} ms/step, device busy "
              f"{eager_prof['busy_ms'] / 4!r} ms/step, device idle share "
              f"{1 - eager_prof['busy_ms'] / eager_prof['wall_ms']!r}")

    # --- 10. the prefill forward at full width ------------------------------
    prc = RunConfig(attn_impl="pallas")
    t0 = time.perf_counter()
    core = DecodeCore(cfg, prc, gated.params, quantize=True,
                      plan_batch=BATCH, plan_max_len=PREFILL, device="cuda")
    ptable = core.prefill_plan_table
    t_plan = time.perf_counter() - t0
    gates = {lab: ptable.use_cim(lab) for lab in projections}
    print(f"prefill core: planned at batch {BATCH}, length {PREFILL} in "
          f"{t_plan:.2f} s; prefill plan {ptable.digest}; gates {gates}")
    if not all(gates.values()):
        raise RuntimeError(f"the prefill table does not gate every "
                           f"projection onto CiM: {gates}")
    prefill = make_prefill(cfg, prc, ptable)
    long_prompt = torch.randint(0, cfg.vocab, (1, PREFILL),
                                generator=torch.Generator().manual_seed(2)
                                ).to("cuda")
    prefill(core.params, long_prompt)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa_mod.flash_attention)     # the prefill path starts
    reset_counts(int8_gemm)
    with route_trace() as records:
        t0 = time.perf_counter()
        logits = prefill(core.params, long_prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    flash_launches = fa_mod.flash_attention.launches   # ... and ends here
    flash_by_design = dict(fa_mod.flash_attention.launches_by_design)
    prefill_i8 = int8_gemm.launches
    prefill_by_design = dict(int8_gemm.launches_by_design)
    prefill_peak = torch.cuda.max_memory_allocated()
    prefill_routes = sorted({(r["label"], r["route"]) for r in records})
    print(f"prefill forward: {ARCH} full width ({L} layers), 1 x {PREFILL} "
          f"tokens in {prefill_s!r} s: {PREFILL / prefill_s!r} prefill "
          f"tokens/s; peak memory {prefill_peak / 2**30!r} GiB; "
          f"flash_attention launches {flash_launches} (expected {L}), by "
          f"design {flash_by_design}, "
          f"int8_gemm launches {prefill_i8} (expected {calls_per_step}), "
          f"by design {prefill_by_design}; routes {prefill_routes} [{card}]")
    if flash_launches != L or flash_by_design["wgmma"] != L or (
            prefill_i8 != calls_per_step) or (
            prefill_by_design["A"] != calls_per_step):
        raise RuntimeError(f"the prefill launched flash_attention "
                           f"{flash_launches} and int8_gemm {prefill_i8} "
                           f"times")
    if logits.shape != (1, PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")
    ref_logits = make_prefill(cfg, RunConfig(attn_impl="flash_jnp"), ptable)(
        core.params, long_prompt)
    diff = (logits.float() - ref_logits.float()).abs().max().item()
    ref_max = ref_logits.float().abs().max().item()
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
    print(f"prefill logits, flash kernel vs attn_impl='flash_jnp' (plain "
          f"torch attention): max|d|={diff!r}, max|ref|={ref_max!r} (tol "
          f"{LOGIT_TOL}·max|ref|); greedy tokens agree at {agree:.2%} of "
          f"{PREFILL} positions")
    if diff > LOGIT_TOL * ref_max:
        raise RuntimeError("the prefill forward disagrees with flash_jnp")
    del logits, ref_logits
    torch.cuda.empty_cache()
    prof = profile_window(torch, lambda: prefill(core.params, long_prompt))
    if prof["busy_ms"] > 0:
        print(f"traced prefill forward (profiler on): wall "
              f"{prof['wall_ms']!r} ms, device busy {prof['busy_ms']!r} ms, "
              f"device idle share {1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:10]:
            print(f"  device {us / 1e3!r} ms ({us / 1e3 / prof['busy_ms']:.1%}"
                  f"): {name[:90]}")
        flash_us = sum(us for name, us in prof["kernels"]
                       if "flash_wgmma_kernel" in name)
        print(f"  flash_attention's share of the traced forward: "
              f"{flash_us / 1e3!r} ms of {prof['busy_ms']!r} ms busy "
              f"({flash_us / 1e3 / prof['busy_ms']:.1%})")
    else:
        print("traced prefill forward: the profiler recorded no device time "
              "(device busy share not measured)")
    del core, prefill
    torch.cuda.empty_cache()

    # --- 11. forward vs the token-by-token prefill of the serve -------------
    gated.reset()
    step_logits = gated.prefill(prompt)[:, -1].float()
    fa_mod.flash_attention.launches = 0
    int8_gemm.launches = 0
    with torch.inference_mode():
        fwd_logits, _ = forward(gated.params, prompt, cfg,
                                RunConfig(attn_impl="pallas", attn_chunk=8),
                                plan=gated.prefill_plan_table)
    torch.cuda.synchronize()
    fwd_logits = fwd_logits[:, -1].float()
    x_launches = (fa_mod.flash_attention.launches, int8_gemm.launches)
    diff = (fwd_logits - step_logits).abs().max().item()
    ref_max = step_logits.abs().max().item()
    fwd_tok, step_tok = fwd_logits.argmax(-1), step_logits.argmax(-1)
    agree = int((fwd_tok == step_tok).sum().item())
    print(f"forward (attn_impl='pallas', attn_chunk=8: the kernel at a "
          f"{PROMPT}-row block) vs ServeSession.prefill on the serve's "
          f"{BATCH} x {PROMPT} prompt: launches (flash_attention, int8_gemm) "
          f"{x_launches}; last-position logits max|d|={diff!r}, "
          f"max|ref|={ref_max!r} (tol {LOGIT_TOL}·max|ref|: the step path "
          f"keeps p in f32 over the bf16 cache, the kernel rounds p to bf16, "
          f"across {L} bf16 layers); greedy next tokens forward "
          f"{fwd_tok.tolist()}, token by token {step_tok.tolist()}: agree on "
          f"{agree} of {BATCH} (need {MIN_TOKEN_AGREEMENT})")
    if x_launches != (L, calls_per_step):
        raise RuntimeError(f"the cross-check forward launched {x_launches}")
    if not bool(torch.isfinite(fwd_logits).all()) or (
            diff > LOGIT_TOL * ref_max or agree < MIN_TOKEN_AGREEMENT):
        raise RuntimeError("forward and token-by-token prefill disagree")

    # --- 12. the int8 KV cache on the INT8 serve ----------------------------
    kv_sess = ServeSession(cfg, RunConfig(kv_cache_dtype="int8"),
                           gated.params, max_len=max_len, batch=BATCH,
                           quantize=True)
    kv_sess.generate(prompt[:, :2], 1)             # warm-up, then start over
    kv_sess.reset()
    torch.cuda.synchronize()
    reset_counts(int8_gemm)
    t0 = time.perf_counter()
    kv_tokens = kv_sess.generate(prompt, NEW)
    torch.cuda.synchronize()
    t_kv = time.perf_counter() - t0
    kv_launches = dict(int8_gemm.launches_by_design)
    kv_agree = int((kv_tokens[:, 0] == tokens[:, 0]).sum().item())
    print(f"serve gated, int8 KV cache (kv_cache_dtype='int8', INT8 weights):"
          f" {steps} steps in {t_kv!r} s: {1e3 * t_kv / steps!r} ms/step "
          f"(bf16 KV cache: {step_ms!r}), {BATCH * NEW / t_kv!r} new "
          f"tokens/s; cache {kv_sess.cache[0]['k'].dtype} + bf16 scales; "
          f"int8_gemm launches by design {kv_launches}; greedy first tokens "
          f"agree with the bf16-KV serve on {kv_agree} of {BATCH} (need "
          f"{MIN_TOKEN_AGREEMENT}); whole streams on "
          f"{int((kv_tokens == tokens).all(1).sum())} lanes [{card}]")
    if kv_sess.cache[0]["k"].dtype != torch.int8 or (
            kv_launches["B"] != expected) or kv_agree < MIN_TOKEN_AGREEMENT:
        raise RuntimeError("the int8-KV serve disagrees with the bf16-KV "
                           "serve")
    trace_steps(kv_sess, "int8-KV gated")
    del kv_sess, gated, ungated                 # free the INT8 tree
    torch.cuda.empty_cache()

    # --- 13.-15. FP8 and INT4 weights: serve, and the FP8 prefill -----------
    def serve_at(precision):
        """Serve batch 8 at `precision` on weights drawn from seed 0, gated
        then ungated on the same weights; returns (numbers, gated session).
        Checks the routes, the launch counts by design and weight format,
        and the first-step logits and greedy tokens gated vs ungated."""
        cim = {"fp8": CIM_FP8_ROUTE, "int4": CIM_INT4_ROUTE}[precision]
        fmt = {"fp8": "fp8", "int4": "int8"}[precision]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
        sess = ServeSession(cfg, rc, params, max_len=max_len, batch=BATCH,
                            quantize=True, precision=precision)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        report = sess.route_report()
        print(f"serve at precision={precision!r}: init + plan + quantize "
              f"{t_setup:.2f} s; routes "
              f"{ {lab: r['route'] for lab, r in report.items()} }")
        if sorted(report) != sorted(projections) or any(
                r["route"] != cim for r in report.values()):
            raise RuntimeError(f"route report is not all {cim}: {report}")
        sess.generate(prompt[:, :2], 1)             # warm-up
        sess.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(int8_gemm)
        t0 = time.perf_counter()
        toks = sess.generate(prompt, NEW)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        out = {"launches": int8_gemm.launches,
               "by_design": dict(int8_gemm.launches_by_design),
               "by_format": dict(int8_gemm.launches_by_format),
               "step_ms": 1e3 * elapsed / steps,
               "tokens_s": BATCH * NEW / elapsed,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"serve gated at {precision}: {steps} steps at batch {BATCH} in "
              f"{elapsed!r} s: {out['step_ms']!r} ms/step (INT8 weights: "
              f"{step_ms!r}), {out['tokens_s']!r} new tokens/s (INT8: "
              f"{i8_tokens_s!r}); peak memory "
              f"{out['peak_gib']!r} GiB (INT8: {peak / 2 ** 30!r}); int8_gemm "
              f"launches {out['launches']} (expected {expected}), by design "
              f"{out['by_design']}, by weight format {out['by_format']} "
              f"[{card}]")
        if out["launches"] != expected or out["by_design"]["B"] != expected \
                or out["by_format"][fmt] != expected:
            raise RuntimeError(f"the {precision} serve launched int8_gemm "
                               f"{out}")
        if toks.shape != (BATCH, NEW) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise RuntimeError(f"bad token stream {toks.shape}")
        ung = ServeSession(cfg, rc, sess.params, max_len=max_len,
                           batch=BATCH, quantize=True, gated=False,
                           precision=precision)
        if any(r["route"] == cim for r in ung.route_report().values()):
            raise RuntimeError("the ungated session routes a label to the "
                               "kernel")
        reset_counts(int8_gemm)
        t0 = time.perf_counter()
        ung_toks = ung.generate(prompt, NEW)
        torch.cuda.synchronize()
        t_ung = time.perf_counter() - t0
        if int8_gemm.launches != 0:
            raise RuntimeError(f"ungated {precision} session launched "
                               f"int8_gemm {int8_gemm.launches} times")
        sess.reset()
        ung.reset()
        lg = sess.prefill(prompt[:, :1]).float()
        lu = ung.prefill(prompt[:, :1]).float()
        if not (torch.isfinite(lg).all() and torch.isfinite(lu).all()):
            raise RuntimeError("non-finite first-step logits")
        diff = (lg - lu).abs().max().item()
        ref_max = lu.abs().max().item()
        agree = int((lg.argmax(-1) == lu.argmax(-1)).sum().item())
        print(f"serve ungated at {precision}: {1e3 * t_ung / steps!r} "
              f"ms/step, 0 int8_gemm launches; greedy streams equal on "
              f"{int((toks == ung_toks).all(1).sum())} of {BATCH} lanes; "
              f"first-step logits gated vs ungated: max|d|={diff!r}, "
              f"max|ref|={ref_max!r} (tol {LOGIT_TOL}·max|ref|); greedy "
              f"tokens agree on {agree} of {BATCH} (need "
              f"{MIN_TOKEN_AGREEMENT}); top-2 gap per lane: gated "
              f"{top2_gaps(lg)}, ungated {top2_gaps(lu)}")
        if diff > LOGIT_TOL * ref_max or agree < MIN_TOKEN_AGREEMENT:
            raise RuntimeError(f"gated and ungated first-step logits "
                               f"disagree at {precision}")
        sess.reset()
        del ung
        trace_steps(sess, f"{precision} gated")
        return out, sess

    fp8_serve, fp8_sess = serve_at("fp8")

    t0 = time.perf_counter()
    core8 = DecodeCore(cfg, prc, fp8_sess.params, quantize=True,
                       precision="fp8", plan_batch=BATCH, plan_max_len=PREFILL,
                       device="cuda")
    ptable8 = core8.prefill_plan_table
    gates8 = {lab: ptable8.use_cim(lab) for lab in projections}
    print(f"fp8 prefill core: planned in {time.perf_counter() - t0:.2f} s; "
          f"prefill plan {ptable8.digest}; gates {gates8}")
    if not all(gates8.values()):
        raise RuntimeError(f"the prefill table does not gate every "
                           f"projection onto CiM: {gates8}")
    prefill8 = make_prefill(cfg, prc, ptable8)
    prefill8(core8.params, long_prompt)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa_mod.flash_attention)     # the fp8 prefill path starts
    reset_counts(int8_gemm)
    t0 = time.perf_counter()
    logits8 = prefill8(core8.params, long_prompt)
    torch.cuda.synchronize()
    fp8_prefill_s = time.perf_counter() - t0
    fp8_flash = dict(fa_mod.flash_attention.launches_by_design)  # ... ends
    fp8_prefill_i8 = int8_gemm.launches
    fp8_prefill_design = dict(int8_gemm.launches_by_design)
    fp8_prefill_format = dict(int8_gemm.launches_by_format)
    print(f"prefill forward at fp8: 1 x {PREFILL} tokens in "
          f"{fp8_prefill_s!r} s (INT8 weights: {prefill_s!r} s): "
          f"{PREFILL / fp8_prefill_s!r} prefill tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30!r} GiB; "
          f"flash_attention launches by design {fp8_flash}; int8_gemm "
          f"launches {fp8_prefill_i8} (expected {calls_per_step}), by design "
          f"{fp8_prefill_design}, by weight format {fp8_prefill_format} "
          f"[{card}]")
    if fa_mod.flash_attention.launches != L or fp8_flash["wgmma"] != L or (
            fp8_prefill_i8 != calls_per_step) or (
            fp8_prefill_design["A"] != calls_per_step) or (
            fp8_prefill_format["fp8"] != calls_per_step):
        raise RuntimeError(f"the fp8 prefill launched flash_attention "
                           f"{fp8_flash} and int8_gemm {fp8_prefill_design}, "
                           f"{fp8_prefill_format}")
    if logits8.shape != (1, PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits8).all()):
        raise RuntimeError(f"bad fp8 prefill logits {tuple(logits8.shape)}")
    ref8 = make_prefill(cfg, prc, ptable8.ungated())(core8.params,
                                                      long_prompt)
    diff = (logits8.float() - ref8.float()).abs().max().item()
    ref_max = ref8.float().abs().max().item()
    agree = (logits8.argmax(-1) == ref8.argmax(-1)).float().mean().item()
    print(f"fp8 prefill logits, gated (the kernel, design A) vs ungated (the "
          f"dequant route, torch.matmul on qf.to(bf16)): max|d|={diff!r}, "
          f"max|ref|={ref_max!r} (tol {LOGIT_TOL}·max|ref|); greedy tokens "
          f"agree at {agree:.2%} of {PREFILL} positions")
    if diff > LOGIT_TOL * ref_max:
        raise RuntimeError("the fp8 prefill disagrees with its dequant route")
    del logits8, ref8
    torch.cuda.empty_cache()
    prof = profile_window(torch, lambda: prefill8(core8.params, long_prompt))
    if prof["busy_ms"] > 0:
        print(f"traced fp8 prefill forward (profiler on): wall "
              f"{prof['wall_ms']!r} ms, device busy {prof['busy_ms']!r} ms, "
              f"device idle share {1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:10]:
            print(f"  device {us / 1e3!r} ms ({us / 1e3 / prof['busy_ms']:.1%}"
                  f"): {name[:90]}")
    else:
        print("traced fp8 prefill forward: the profiler recorded no device "
              "time (device busy share not measured)")
    del core8, prefill8, fp8_sess
    torch.cuda.empty_cache()

    int4_serve, int4_sess = serve_at("int4")
    del int4_sess
    torch.cuda.empty_cache()

    # --- 16. continuous batching at full width ------------------------------
    t0 = time.perf_counter()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    cb_core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=CB_SLOTS,
                         plan_max_len=CB_MAX_LEN, device="cuda")
    del params
    torch.cuda.empty_cache()
    print(f"continuous batching: {ARCH} full width, INT8 weights from seed "
          f"0, gated; {CB_SLOTS} slots, block size {CB_BLOCK}, max_len "
          f"{CB_MAX_LEN}, {CB_BLOCKS} KV blocks (full provisioning); init + "
          f"plan + quantize {time.perf_counter() - t0:.2f} s; decode plan "
          f"{cb_core.plan_table.digest}, prefill plan "
          f"{cb_core.prefill_plan_table.digest}")

    def cb_requests():
        return synthetic_requests(cfg, CB_REQUESTS, seed=0,
                                  prompt_len=(8, 32), new_tokens=(8, 32))

    def cb_engine(core, **kw):
        """An engine at the phase's settings, warmed by two short requests
        (prefill-phase and decode-phase steps: both graphs captured)."""
        eng = ContinuousBatchingEngine(core, n_slots=CB_SLOTS,
                                       max_len=CB_MAX_LEN,
                                       block_size=CB_BLOCK,
                                       n_kv_blocks=CB_BLOCKS, **kw)
        if kw.get("plan_service") is None:
            eng.run(synthetic_requests(cfg, 2, seed=1, prompt_len=(2, 2),
                                       new_tokens=(2, 2)), None)
        return eng

    def cb_run(eng, reqs, arrivals, what):
        """Run `reqs` to completion; print and return this run's numbers
        (from its own requests and the engine's counters' deltas)."""
        done0 = len(eng.completed)
        before = (eng.steps, eng.dispatch_s, eng.host_fetch_s,
                  eng.telemetry_s, len(eng.occupancy_samples))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.run(reqs, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = eng.completed[done0:]
        n_steps = eng.steps - before[0]
        ttft = [r.t_first - r.t_submit for r in done if r.t_first is not None]
        waits = [r.t_admit - r.t_submit for r in done]
        new_tokens = sum(len(r.tokens) for r in done)
        makespan = max(r.t_done for r in done)
        decode_rates = [(len(r.tokens) - 1) / (r.t_done - r.t_first)
                        for r in done if len(r.tokens) > 1
                        and r.t_done > r.t_first]
        out = {
            "requests": len(done), "steps": n_steps, "wall_s": wall,
            "ms_per_step": 1e3 * wall / max(1, n_steps),
            "new_tokens": new_tokens,
            "engine_tokens_per_s": new_tokens / makespan,
            "request_decode_tokens_per_s_mean": float(np.mean(decode_rates)),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "queue_wait_mean_s": float(np.mean(waits)),
            "queue_wait_max_s": float(max(waits)),
            "slot_occupancy_mean": float(np.mean(
                eng.occupancy_samples[before[4]:])),
            "dispatch_ms_per_step": 1e3 * (eng.dispatch_s - before[1])
            / max(1, n_steps),
            "host_fetch_ms_per_step": 1e3 * (eng.host_fetch_s - before[2])
            / max(1, n_steps),
            "telemetry_ms_per_step": 1e3 * (eng.telemetry_s - before[3])
            / max(1, n_steps),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"engine, {what}: {json.dumps(out)} [{card}]")
        return out, {r.rid: [int(t) for t in r.tokens] for r in done}, done

    # (a) arrivals all at once
    eng = cb_engine(cb_core)
    reset_counts(int8_gemm)
    caps0 = cb_core.batch_decode_executables
    reqs = cb_requests()
    cb_all, cb_streams, done = cb_run(eng, reqs, None, "arrivals all at once")
    cb_launches = int8_gemm.launches
    cb_by_design = dict(int8_gemm.launches_by_design)
    cb_by_format = dict(int8_gemm.launches_by_format)
    new_caps = cb_core.batch_decode_executables - caps0
    cb_expected = (cb_all["steps"] + new_caps) * calls_per_step
    served = {cb_core.plan_table} | ({cb_core.prefill_plan_table}
                                     if eng.phase_steps["prefill"] else set())
    print(f"engine, all at once: {len(done)} of {CB_REQUESTS} requests done "
          f"({sorted({r.done_reason for r in done})}), int8_gemm launches "
          f"{cb_launches} (expected ({cb_all['steps']} steps + {new_caps} "
          f"captures) x {calls_per_step} = {cb_expected}), by design "
          f"{cb_by_design}, by weight format {cb_by_format}; "
          f"batch_decode_executables {cb_core.batch_decode_executables} for "
          f"{len(served)} distinct phase plans served (phase steps "
          f"{eng.phase_steps})")
    if len(done) != CB_REQUESTS or any(
            len(r.tokens) != r.max_new_tokens or r.done_reason != "max_tokens"
            or not all(0 <= int(t) < cfg.vocab for t in r.tokens)
            for r in done):
        raise RuntimeError("the engine did not complete every request with "
                           "its max_new_tokens")
    if cb_launches != cb_expected or cb_by_design["B"] != cb_expected or (
            cb_by_format["int8"] != cb_expected):
        raise RuntimeError(f"the engine launched int8_gemm {cb_by_design}")
    if cb_core.batch_decode_executables != len(served):
        raise RuntimeError("the engine captured a batch step more than once "
                           "per plan")

    # one engine step, graphed, against the eager decode_step on a clone
    gen = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, cfg.vocab, (CB_SLOTS, 1), generator=gen,
                        device="cuda")
    pos = torch.tensor([0, 5, 17, 31, 40, 63, 2, 50], dtype=torch.int32,
                       device="cuda")
    active = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool,
                          device="cuda")
    tables = torch.arange(CB_BLOCKS, dtype=torch.int32, device="cuda").view(
        CB_SLOTS, -1)
    tables[3] = tables[0]                 # an inactive slot aliasing slot 0
    copy = clone_cache(eng.cache)
    got, _ = cb_core.batch_step_for(cb_core.plan_table)(eng.cache, tok, pos,
                                                        active, tables)
    with torch.inference_mode():
        want, copy = decode_step(cb_core.params, copy, tok, pos, cfg, rc,
                                 plan=cb_core.plan_table, active=active,
                                 block_tables=tables)
    same = torch.equal(got, want) and all(
        torch.equal(eng.cache[0][k], copy[0][k]) for k in copy[0])
    print(f"one engine step (replayed graph) vs the eager decode_step(..., "
          f"active=, block_tables=) on a clone of the pools: logits and "
          f"pools bit for bit {same}")
    if not same:
        raise RuntimeError("the engine's graphed step is not the eager step")
    del copy, got, want

    # eight equal-length requests against the fixed-batch session
    eng.record_logits = True
    eq_reqs = [Request(rid=f"eq{i}", prompt=prompt[i].cpu().numpy(),
                       max_new_tokens=NEW) for i in range(BATCH)]
    eng.run(eq_reqs, None)
    eng.record_logits = False
    first = torch.from_numpy(np.stack([r.first_logits for r in eq_reqs]))
    sess = ServeSession(cfg, rc, cb_core.params, max_len=max_len,
                        batch=BATCH, quantize=True)
    ref = sess.prefill(prompt)[:, -1].float().cpu()
    sess.reset()
    full = sess.generate(prompt, NEW).cpu()
    eq_tokens = torch.tensor([[int(t) for t in r.tokens] for r in eq_reqs])
    diff = (first - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    agree = int((first.argmax(-1) == ref.argmax(-1)).sum().item())
    print(f"engine vs ServeSession (batch {BATCH}) on the phase-9 prompt: "
          f"first-step logits max|d|={diff!r}, max|ref|={ref_max!r} (tol "
          f"{LOGIT_TOL}·max|ref|: the paged strip sums attention over other "
          f"lengths); greedy first tokens agree on {agree} of {BATCH} (need "
          f"{MIN_TOKEN_AGREEMENT}); whole streams equal on "
          f"{int((eq_tokens == full).all(1).sum())} lanes; top-2 gap per "
          f"lane: engine {top2_gaps(first)}, session {top2_gaps(ref)}")
    if diff > LOGIT_TOL * ref_max or agree < MIN_TOKEN_AGREEMENT:
        raise RuntimeError("the engine disagrees with the fixed-batch session")
    del sess
    torch.cuda.empty_cache()

    # (b) Poisson arrivals at CB_RATE req/s, and one traced window
    cb_poisson, _, _ = cb_run(eng, cb_requests(),
                              poisson_arrivals(CB_REQUESTS, CB_RATE, seed=0),
                              f"Poisson arrivals at {CB_RATE} req/s")
    prof = profile_window(torch, lambda: eng.run(
        cb_requests()[:CB_TRACED], poisson_arrivals(CB_TRACED, CB_RATE,
                                                    seed=0)))
    if prof["busy_ms"] > 0:
        print(f"traced engine window ({CB_TRACED} Poisson requests, profiler "
              f"on): wall {prof['wall_ms']!r} ms, device busy "
              f"{prof['busy_ms']!r} ms, device idle share "
              f"{1 - prof['busy_ms'] / prof['wall_ms']!r}")
        for name, us in prof["kernels"][:6]:
            print(f"  device {us / 1e3!r} ms ({us / 1e3 / prof['busy_ms']:.1%}"
                  f"): {name[:90]}")
    else:
        print("traced engine window: the profiler recorded no device time "
              "(device busy share not measured)")
    saturated = cb_run(eng, cb_requests(), None,
                       "arrivals all at once, again")[0]
    del eng
    torch.cuda.empty_cache()

    # (c) the int8 KV cache on the paged pool
    kv_core = DecodeCore(cfg, RunConfig(kv_cache_dtype="int8"),
                         cb_core.params, quantize=True, plan_batch=CB_SLOTS,
                         plan_max_len=CB_MAX_LEN, device="cuda")
    kv_eng = cb_engine(kv_core)
    cb_kv, kv_streams, _ = cb_run(kv_eng, cb_requests(), None,
                                  "int8 KV cache, all at once")
    kv_first = sum(kv_streams[rid][0] == cb_streams[rid][0]
                   for rid in cb_streams)
    need = math.ceil(MIN_TOKEN_AGREEMENT / BATCH * CB_REQUESTS)
    print(f"engine, int8 KV pool ({kv_eng.cache[0]['k'].dtype} codes + "
          f"{kv_eng.cache[0]['k_scale'].dtype} scales): first tokens agree "
          f"with the bf16-KV engine on {kv_first} of {CB_REQUESTS} requests "
          f"(need {need}); whole streams on "
          f"{sum(kv_streams[r] == cb_streams[r] for r in cb_streams)}")
    if kv_first < need or kv_eng.cache[0]["k"].dtype != torch.int8:
        raise RuntimeError("the int8-KV engine disagrees with the bf16-KV "
                           "engine")
    del kv_eng, kv_core
    torch.cuda.empty_cache()

    # (d) adaptive: the shape-bucketed plan service on the sweep kernel
    ad_core = DecodeCore(cfg, rc, cb_core.params, quantize=True,
                         plan_batch=CB_SLOTS, plan_max_len=CB_MAX_LEN,
                         device="cuda")
    service = PlanService(cfg, BucketLattice.for_engine(CB_SLOTS, CB_MAX_LEN),
                          backend="pallas")
    ad_eng = cb_engine(ad_core, plan_service=service)
    sw_mod.sweep_eval.launches = 0     # the adaptive path starts
    cb_ad, ad_streams, _ = cb_run(ad_eng, cb_requests(), None,
                                  "adaptive (PlanService, backend=pallas), "
                                  "all at once")
    service.drain()
    ad_sweep_launches = sw_mod.sweep_eval.launches     # ... and ends here
    ad = ad_eng.telemetry()["adaptive"]
    # tables served that gate a projection otherwise than the frozen plan
    # (tables differing only in activation GEMMs route alike)
    served_tables = [service._buckets[b].table for b in service._buckets]
    route_flips = sorted({lab for t in served_tables
                          for lab in t.flips(ad_core.plan_table)
                          if lab in projections})
    same_streams = sum(ad_streams[r] == cb_streams[r] for r in cb_streams)
    print(f"engine, adaptive: verdict_flips {service.verdict_flips}, plan "
          f"swaps {ad['plan_swaps']} (swap latency {ad['swap_latency_s']}), "
          f"bucket transitions {ad['bucket_transitions']}, plan_variants "
          f"{ad_core.plan_variants} (evictions {ad_core.plan_evictions}), "
          f"batch_decode_executables {ad_core.batch_decode_executables}; "
          f"buckets served {len(served_tables)}, projections gated otherwise "
          f"than the frozen plan in some bucket {route_flips}; sweep_eval "
          f"launches {ad_sweep_launches}; streams equal to the frozen-plan "
          f"engine's on {same_streams} of {CB_REQUESTS}; service "
          f"{json.dumps(ad['service'])[:600]}")
    if ad_sweep_launches == 0:
        raise RuntimeError("the adaptive run's plan service launched no "
                           "sweep_eval")
    if service.verdict_flips == 0 and not route_flips:
        if same_streams != CB_REQUESTS:
            raise RuntimeError("the adaptive engine's streams differ from "
                               "the frozen-plan engine's")
    elif ad_core.batch_decode_executables != ad_core.plan_variants:
        raise RuntimeError("the adaptive engine captured a plan variant more "
                           "than once")
    del ad_eng, ad_core, cb_core, service
    torch.cuda.empty_cache()

    # --- 17. the serving CLI ------------------------------------------------
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--smoke", "--requests", "8", "--quantize"]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cli, capture_output=True, text=True, cwd=HERE,
                          env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cli[1:])} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    cli_report = json.loads(proc.stdout)
    cli_agg = cli_report["traffic"]["aggregate"]
    print(f"CLI `python {' '.join(cli[1:])}`: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, JSON report with keys "
          f"{sorted(cli_report)}; completed {cli_agg['completed']}, "
          f"decode_executables {cli_agg['decode_executables']}, "
          f"engine tokens/s {cli_agg['engine_tokens_per_s']!r}")
    if cli_agg["completed"] != 8 or cli_report["mode"] != (
            "continuous-batching"):
        raise RuntimeError("the serving CLI's report is wrong")

    # --- 18. result lines ----------------------------------------------------
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
        "device_ms": per_step["device_ms"],
        "library_device_ms": per_step["library_device_ms"],
        "path": "decode step", "design": per_step["design"],
        "weights": "int8",
        "work": f"the {calls_per_step} calls of one {ARCH} decode step at "
                f"batch {BATCH} (per-shape times x calls per step); "
                f"launches counted over the gated serve's "
                f"{PROMPT + NEW} steps"}, {
        "name": "int8_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm.py:33",
        "launches": prefill_i8,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["M"] == PREFILL),
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": ("bytes" if per_fwd["bytes_ms"] >= per_fwd["ops_ms"]
                     else "operations"),
        "library_ms": per_fwd["library_ms"],
        "device_ms": per_fwd["device_ms"],
        "library_device_ms": per_fwd["library_device_ms"],
        "path": "prefill forward", "design": per_fwd["design"],
        "weights": "int8",
        "work": f"the {calls_per_step} calls of one {ARCH} prefill forward "
                f"at M = {PREFILL} (per-shape times x calls per "
                f"forward); "
                f"launches counted over one forward"}, {
        "name": "int8_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm.py:53",
        "launches": ws_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dataflow"] == "ws" and r["design"] == "B"),
        "ms": ws_step["ms"], "plain_ms": ws_step["plain_ms"],
        "bound_ms": ws_step["bound_ms"],
        "bound_by": ("bytes" if ws_step["bytes_ms"] >= ws_step["ops_ms"]
                     else "operations"),
        "library_ms": ws_step["library_ms"],
        "device_ms": ws_step["device_ms"],
        "library_device_ms": ws_step["library_device_ms"],
        "path": "ops.int8_matmul(dataflow='ws')", "design": ws_step["design"],
        "weights": "int8",
        "work": f"the {calls_per_step} calls of one {ARCH} decode step at "
                f"batch {BATCH} through ops.int8_matmul(dataflow='ws') "
                f"(per-shape times x calls per step); launches counted "
                f"around those {calls_per_step} calls"}]
    fp8_src = {"fp8 decode step": (fp8_step, fp8_serve["launches"],
                                   "src/repro/kernels/int8_gemm.py:33",
                                   f"the gated fp8 serve's {steps} steps"),
               "fp8 prefill forward": (fp8_fwd, fp8_prefill_i8,
                                       "src/repro/kernels/int8_gemm.py:33",
                                       "one fp8 prefill forward"),
               "fp8 ops.int8_matmul(dataflow='ws')": (
                   fp8_ws_step, fp8_ws_launches,
                   "src/repro/kernels/int8_gemm.py:53",
                   f"the {calls_per_step} calls of one decode step through "
                   f"ops.int8_matmul(dataflow='ws')"),
               "int4 decode step": (per_step, int4_serve["launches"],
                                    "src/repro/kernels/int8_gemm.py:33",
                                    f"the gated int4 serve's {steps} steps")}
    for path, (agg, n, replaces, counted) in fp8_src.items():
        int4 = path.startswith("int4")
        wdesc = ("int8 (the int8 rows: the kernel reads the unpacked int4 "
                 "weights as int8)" if int4 else "e4m3")
        shape = (f"prefill forward at M = {PREFILL}" if "prefill" in path
                 else f"decode step at batch {BATCH}")
        kernels.append({
            "name": "int8_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": agg["max_abs_err"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                         else "operations"),
            "library_ms": agg["library_ms"],
            "device_ms": agg["device_ms"],
            "library_device_ms": agg["library_device_ms"],
            "path": path, "design": agg["design"],
            "weights": ("int4, unpacked to int8 before the kernel" if int4
                        else "float8_e4m3fn"),
            "work": (f"the {calls_per_step} calls of one {ARCH} {shape} "
                     f"with {wdesc} weights (per-shape times x calls); "
                     f"launches counted over {counted}")})
    kernels += [{
        "name": "sweep_eval", "route": "cuda", "path": "default campaign",
        "source": "src/repro_torch/kernels/csrc/sweep_eval.cu",
        "replaces": "src/repro/kernels/sweep_eval.py:58",
        "launches": sweep_launches,
        "max_abs_err": 0.0,
        "ms": sweep_ms, "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": ("bytes" if sweep_bytes_ms >= sweep_ops_ms
                     else "operations"),
        "library_ms": None,
        "work": f"one launch on {n_big} rows (the sweep_bench batch tiled "
                f"{SWEEP_TILES}x), exact order mode; bit-equal to the plain "
                f"version; launches counted over the default-grid campaign"}, {
        "name": "flash_attention", "route": "cuda", "path": "prefill forward",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:21",
        "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in frows),
        "ms": flash_ms, "plain_ms": flash_plain_ms,
        "bound_ms": flash_bound_ms,
        "bound_by": ("bytes" if flash_bytes_ms >= flash_ops_ms
                     else "operations"),
        "library_ms": flash_lib_ms,
        "device_ms": flash_dev_ms, "library_device_ms": flash_lib_dev_ms,
        "design": "+".join(d for d, c in flash_by_design.items() if c),
        "work": f"one call at (1, {PREFILL}, {cfg.n_heads}/{cfg.n_kv_heads}, "
                f"{dh}) bf16 causal: one layer of the {ARCH} prefill "
                f"({L} per forward); launches counted over one forward"}, {
        "name": "decode_attention", "route": "cuda",
        "path": "ops.decode_attention",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:20",
        "launches": decode_launches,
        "max_abs_err": max(r["max_abs_err"] for r in drows),
        "ms": decode_ms, "plain_ms": decode_plain_ms,
        "bound_ms": decode_bound_ms,
        "bound_by": ("bytes" if decode_bytes_ms >= decode_ops_ms
                     else "operations"),
        "library_ms": decode_lib_ms,
        "device_ms": decode_dev_ms, "library_device_ms": decode_lib_dev_ms,
        "design": "+".join(d for d, c in decode_by_design.items() if c),
        "work": f"one call at ({BATCH}, {DECODE_S}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads}, {dh}) bf16, length {DECODE_S} ({ARCH} "
                f"decode_32k); its main path is one call of the public "
                f"wrapper ops.decode_attention (no model calls it)"}]
    kernels += [{
        "name": "int8_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm.py:33",
        "launches": cb_launches,
        "max_abs_err": per_step["max_abs_err"],
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": ("bytes" if per_step["bytes_ms"] >= per_step["ops_ms"]
                     else "operations"),
        "library_ms": per_step["library_ms"],
        "device_ms": per_step["device_ms"],
        "library_device_ms": per_step["library_device_ms"],
        "path": "continuous batching",
        "design": "+".join(d for d, c in cb_by_design.items() if c),
        "weights": "int8",
        "work": f"the {calls_per_step} calls of one {ARCH} decode step at "
                f"M = {CB_SLOTS} slots (phase 3's per-shape times x calls "
                f"per step); launches counted over the {CB_REQUESTS}-request "
                f"all-at-once engine run ({cb_all['steps']} steps replaying "
                f"the captured graphs, credited per replay)"}, {
        "name": "sweep_eval", "route": "cuda",
        "path": "adaptive plan service",
        "source": "src/repro_torch/kernels/csrc/sweep_eval.cu",
        "replaces": "src/repro/kernels/sweep_eval.py:58",
        "launches": ad_sweep_launches,
        "max_abs_err": 0.0,
        "ms": sweep_ms, "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": ("bytes" if sweep_bytes_ms >= sweep_ops_ms
                     else "operations"),
        "library_ms": None,
        "work": f"phase 6's launch on {n_big} rows (times and bound); "
                f"launches counted over the adaptive engine run "
                f"(PlanService(backend='pallas') planning each bucket it "
                f"served on the card)"}]
    for entry in kernels:               # JSON has no NaN: not measured
        for key in ("device_ms", "library_device_ms"):
            if key in entry and not math.isfinite(entry[key]):
                entry[key] = None
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
