#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (`src/repro_torch`).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main paths on the card: training (qwen2-7b at full
size, its full width at 8 layers, mamba2-780m), the planner-gated serving of
qwen2-7b, qwen2-moe-a2.7b, mamba2-780m and musicgen-large at full width
and depth and llama-3.2-vision-90b at full width, 10 of its 100 layers
deep (random weights from a seed; jamba-1.5-large-398b's mixed
attention / mamba, dense / MoE period at reduced size), for qwen2-7b with INT8,
FP8 and INT4 weights and with the int8 KV cache, each step a replayed
CUDA graph, its continuous batching (32 ragged requests through the
paged, slot-masked engine, also adaptive and with the int8 KV pool) and
its serving CLI, its prefill forward (one
2048-token prompt through the flash-attention kernel) with INT8 and FP8
weights, the batched What/When/Where sweep with its design-space
campaigns, the paper's own experiments on the sweep kernel, and the
distributed layer (the row-sharded sweep over a process group, the int8
compressed all-reduce).  In order it:

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
   for bf16, "fma" for f32), timed at qwen2-7b's decode_32k shape; the
   TPU contract's main path is its public wrapper `ops.decode_attention`,
   called once there with the launch count read around the call.  Then
   the paged design (`paged_decode_attention`, the engine's decode
   attention read through the block tables) at the engine cells' shapes
   (PAGED_CASES: 32 slots x 512 in blocks of 16, 28/4 and 16/16 heads),
   at ragged lengths with and without a window, against its plain version,
   and timed (CUDA events, device time) at ragged lengths and at S beside
   its bound at the valid lengths, its plain version and
   `scaled_dot_product_attention` over the gathered strips; its launches
   are counted on the engines of phases 16 (a) (one per layer a step) and
   21, 24 and 25, and phase 16 (c)'s int8 KV pool must launch none;
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
18. frees every qwen2-7b tree and graph pool (at most FREED_GIB stays
   allocated), then holds the INT8 GEMM kernel against its plain version
   at every 2-D projection shape of qwen2-moe-a2.7b and mamba2-780m at
   M = 8 (design B) and M = 2048 (design A where `plan_gemm` picks it:
   mamba2's lm_head, N = 50280, is not 16-aligned and runs B), including
   mamba2's K = 1536, N = 48 and 128, and of reduced jamba at M = 8, each
   row checked for the design `plan_gemm` plans; and the flash kernel at
   qwen2-moe's (1, 2048, 16/16, 128) (group size 1) in both dtypes, timed
   against its plain version and SDPA;
19. serves qwen2-moe-a2.7b at full width (24 layers, 60 experts top-4 + 4
   shared, seed 0, INT8, gated, batch 8, 16 + 16 steps): the route report
   (every gated 2-D label on the kernel, the experts on the dequant
   route: the grouped expert kernels, timed in phase 34), int8_gemm
   launches equal to the gated calls of each phase's
   table times its steps, all on design B, one capture per step,
   both steps bit for bit against the eager step on a clone of the
   cache, the ungated session (0 launches, first-step logits within
   LOGIT_TOL), ms/step, tokens/s, peak memory and a traced step;
20. runs its (1, 2048) prefill forward (buffered dispatch) with
   attn_impl="pallas": 24 flash launches on "wgmma", int8_gemm launches
   per the route trace and `plan_gemm`'s designs, logits against the
   `flash_jnp` forward within LOGIT_TOL, wall time and a traced forward;
21. runs the continuous engine on it (8 slots, 16
   `synthetic_requests(seed=0, ...)` all at once): every request done,
   launches per phase table, no new capture, one replayed step bit for
   bit against the eager `decode_step(..., active=, block_tables=)`;
22.-24. do phases 19-21 for mamba2-780m (48 layers; ssm-BCdt on the
   kernel 3 times a layer a step); its prefill forward (chunk 256, no
   flash) is checked against its first SSM_CHECK positions fed one by
   one through the graphed step within LOGIT_TOL; its engine runs the
   same requests a second time, every joining slot's state and conv
   carry reading 0 after its reset, with the same streams;
25. serves and runs the engine on jamba-1.5-large-398b at reduced(...)
   (printed as reduced: a full-width period is 4 MoE layers of 16
   experts of 8192 x 24576, ~46 GB at int8), with the checks of 19 and
   24;
26. runs `python -m repro_torch.launch.serve --arch mamba2-780m --smoke
   --batch 8 --quantize` as a subprocess: exit 0, a JSON report, and at
   least one label (ssm-BCdt) on the kernel;
27. holds the INT8 GEMM at every 2-D projection shape of musicgen-large
   and of llama-3.2-vision at M = 8 and 2048, and at the vlm's xattn-KV
   shape (M = 1601 image tokens, K = 8192, N = 1024: design A with a
   masked tail), and flash at musicgen's (1, 2048, 32/32, 64), the first
   model path at d_head 64, against its plain version and SDPA; then
   serves musicgen-large at full size (48 layers, 4 codebooks, seed 0,
   INT8, gated, batch 8, (b, 1, 4) tokens, 16 + 16 steps) with the checks
   of phase 19 (its per-codebook lm_head on the dequant einsum), runs its
   (1, 2048) prefill with attn_impl="pallas" (48 flash launches on d_head
   64, logits against `flash_jnp`) and the engine on 16 audio requests;
28. holds flash at the vlm's (1, 2048, 64/8, 128), then serves
   llama-3.2-vision-90b at full width cut to VLM_LAYERS = 10 layers (two
   periods: 8 self- and 2 cross-attention layers; printed as reduced:
   all 100 layers are ~86 GB at int8 and do not fit one card beside
   their bf16 draw) with 1601 image tokens of image K/V per cross slot
   (never filled, as in the JAX package), with the checks of phase 19;
   runs its prefill with image embeddings from seed 5 (xattn-KV on design
   A at M = 1601, 8 flash launches, logits against `flash_jnp`); and
   checks that the continuous engine refuses a vlm core, as the JAX
   package's does;
29. runs `launch/paper.py`'s seven artefacts (Figs. 2, 7 + Table II, 9,
   10, 11/12, 13 and Table VI) on the card with backend "vectorized" and
   "pallas", each on a fresh engine: rows and derived metrics equal
   (runtime fields aside), the sweep kernel launched (counted from 0 over
   the pallas run) and not by the vectorized run, the two checks of
   docs/reproducing-paper-figures.md, and `python -m
   repro_torch.launch.paper --backend pallas --out runs/paper` as a
   subprocess;
30. trains on the card (`train_phase()`; no kernel runs on this path, as
   none runs on the JAX package's: float weights take torch.matmul and
   attention the chunked `flash_jnp`): (a) qwen2-7b at full size (28
   layers, 7.6 B params, bf16 weights from seed 0) with Adafactor,
   batch 2 x seq 4096; (b) qwen2-7b at full width cut to 8 layers with
   AdamW, batch 8 x 1024 in 2 microbatches (the f32 accumulator); (c)
   mamba2-780m at full size with AdamW, batch 8 x 1024 (the SSD's
   backward); each with remat (policy "nothing"), one warm-up step,
   TRAIN_TIMED steps timed by CUDA events (forward + backward and the
   optimizer apart), tokens/s, model TFLOP/s
   (`launch/roofline.py:model_flops`) and its share of 989 TFLOP/s, the
   analytic roofline terms of `Roofline` beside the measured step, peak
   memory and a traced step (top kernels, idle share); each checks finite
   losses and gnorms, the step-0 loss within 0.5 of ln(vocab), every
   leaf moved by step 1, zero launches of all four kernels across its
   steps, and no SelectBackward0 into a stacked leaf; (d) one f32 step
   of reduced qwen2-7b widened to d_model 256 on the card against the
   CPU, then `python -m repro_torch.launch.train --smoke --steps 30
   --ckpt-dir tmp_chip/ckpt_train --ckpt-every 10` crashed by
   `--fail-at 25` (non-zero exit) and rerun: resumed from 20, loss_last
   < loss_first, and its losses bit for bit those of an uninterrupted
   run of the same flags;
31. runs the distributed layer (`distributed_phase()`): (a) a world of 1
   under NCCL, `launch.distributed.initialize()` from the REPRO_* env
   vars on a free localhost port: `distributed_engine(chunk_rows=512)`
   plans the golden grid with backend "vectorized" and "pallas" through
   the row-sharded path (every verdict equal to
   tests/golden/planner_verdicts.csv and to the unsharded engine, >= 2
   chunks, the sweep kernel launched on pallas) and runs the golden
   campaign through it (front byte-equal); (c) in the same group,
   `optim.grad_compress.compressed_psum` on a bf16 tree of qwen2-7b's
   parameter shapes at 8 layers (2.95 B elements, from seed 0 on the
   card): ms per call by CUDA events, the bytes on the wire, the HBM
   bytes bound, peak memory, two all-reduces per leaf, and the embedding
   and one stacked MLP leaf bit for bit against the same call under a
   gloo group on the CPU; the group is destroyed; (b) two gloo ranks
   sharing the card (`chip_smoke.py --sweep-rank` subprocesses, waited on
   with a timeout and killed in `finally`), each scoring its half of
   every golden tile through the sweep kernel on cuda:0 and gathering
   the columns on the host: both bit for bit the golden CSV, shard
   balance n/2 each, identical plans;
32. runs the dry run (`dryrun_phase()`): (a) DRY_CELLS through `python -m
   repro_torch.launch.dryrun` as subprocesses on the host's CPU (the dry
   run uses no card), all started together within DRY_BUDGET_S: every
   cell status ok, each printed with its trace seconds, per-rank FLOPs,
   bytes and collective bytes by type, argument and temp bytes, the
   bottleneck and roofline fraction (decode cells: the planner's n_gemms
   and cim_routed_fraction), and all rendered by
   `launch/report.py:dryrun_table`; (b) `kernels/autotune.py`'s
   `autotune_report()` at BLOCK_SHAPES (the JAX package's exemplars and
   block-test shapes and 4096^3), each shape run once with int8 and once
   with e4m3 weights against the plain version within TOL·max|ref|, the
   design launched the report's (`launches_by_design` moves by exactly
   the designs it names), then timed with int8 weights as phase 3 times
   its shapes; (c) the dry run's per-rank accounting (`dryrun.trace_step`
   at a mesh of one rank of a fake group) of phase 30 (b)'s cell against
   FlopCounterMode over one real step of it on the card: the FLOPs equal,
   the dry run's argument + temp bytes beside the step's
   `torch.cuda.max_memory_allocated`, and the `Roofline` bound of the dry
   run's counts beside the measured ms/step;
33. holds the paged MLA decode kernel (`mla_phase()`): at the
   moonlight-16b-a3b cell's shape (128 slots x 512 positions in blocks of
   16, 16 heads, rows of 576) at ragged chat lengths and with every slot
   at 512, element by element against its plain version and against
   `paged_mla_decode_ref`, timed beside the plain version and SDPA over
   the gathered strips; then moonlight-16b-a3b at full size (INT8, 128
   slots) through the continuous engine, its captured steps crediting one
   MLA launch per layer a step and no other attention kernel.
   `python3 chip_smoke.py --mla` runs this phase alone;
34. holds the grouped INT8 expert kernels (`moe_phase()`): one MoE layer
   at each MoE cell's experts and batch (qwen2-moe-a2.7b, 32 tokens top-4
   of 60; moonlight-16b-a3b, 128 tokens top-6 of 64), routed by a seeded
   router through the model's `route` (the touched-expert share printed),
   element by element against `moe_experts_ref` (MOE_TOL_DOC), timed
   beside the touched experts' bytes bound, the plain version and the
   three dequant einsums the port no longer calls there (`library_ms`);
   then each model at full size (INT8, its cell's capacity and slots)
   through the continuous engine, its captured steps crediting two
   expert launches per MoE layer.  `python3 chip_smoke.py --moe` runs
   this phase alone;
35. prints one JSON line of kernel numbers, the card line, and last
   `{"ok": true, "device": {...}}`.

Phase 9 also holds the graphs: the serve's steps replay CUDA graphs
captured once (`decode_executables == prefill_executables == 1`), their
streams equal the eager `make_serve_step`'s, both steps bit for bit
against it on a clone of the cache, with ms/step, tokens/s and peak
memory of both, the graph pools' memory, and traced graphed and eager
steps; phases 12, 13 and 15 replay graphs too (replays credit the
launch counts).

Each kernel's launch count in that line comes from its own main path
(for sweep_eval, which has four entries: the default-grid campaign,
the adaptive engine run, the paper's artefacts and the row-sharded
sweep of phase 31(a) and (b); for int8_gemm, which
has twenty-one entries, each with its design and weight format: the gated
INT8 serve, the INT8 prefill forward, the 197 calls of one decode step
through `ops.int8_matmul(dataflow="ws")`, the same three with FP8
weights, the gated INT4 serve, the continuous engine's all-at-once run,
for qwen2-moe-a2.7b, mamba2-780m and musicgen-large each the serve, the
prefill forward and the engine, for the vlm the serve and the prefill
forward, reduced jamba's serve and engine, and phase 32 (b)'s block
report; the qwen2-7b,
qwen2-moe-a2.7b, musicgen-large and vlm prefill forwards for
flash_attention; one call of the public wrapper for decode_attention;
phase 16 (a)'s engine run and the families' engine runs for
paged_decode_attention; phase 33's engine run for paged_mla_decode;
phase 34's engine runs for moe_experts),
counted from 0 just before that path ran.

Any failed phase raises and exits non-zero; so does a machine with no
CUDA device or a directory without the port.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
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
# the paged design at the engine cells' attention (b slots of S positions in
# blocks of bs; qwen2-7b 28/4 and qwen2-moe-a2.7b 16/16 heads, d 128):
# (b, S, bs, H, KV, d), checked with and without a window, timed at ragged
# lengths and at S
PAGED_CASES = [(32, 512, 16, 28, 4, 128), (32, 512, 16, 16, 16, 128)]
PAGED_WINDOW = 64
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


def counts(wrapper) -> list:
    """A kernel wrapper's launch counts, in all, per design and (for
    int8_gemm) per weight format (`repro_torch.kernels.launch`)."""
    from repro_torch.kernels import launch
    return launch.snapshot([wrapper])


def reset_counts(wrapper) -> None:
    """Set a kernel wrapper's launch counts to 0."""
    from repro_torch.kernels import launch
    launch.credit(counts(wrapper), [wrapper], sign=-1)


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


def changed(wrapper, before: list) -> str:
    """The designs whose launch count moved since `before`
    (`counts(wrapper)`)."""
    from repro_torch.kernels import launch
    moved = launch.since(before, [wrapper])[1:]    # per design, then format
    return "+".join(d for d, n in zip(wrapper.launches_by_design, moved) if n)


def time_flash(torch, ops, fa_mod, H: int, KV: int, dh: int) -> dict:
    """The flash kernel, its plain version and the yardstick
    (scaled_dot_product_attention, which the port never calls) at (1,
    PREFILL, H/KV, dh) bf16 causal, one prefill layer: CUDA-event times
    (`ms`), profiler device times (`device_ms`), the bound and a line to
    print."""
    import torch.nn.functional as F
    q, k, v = attn_inputs(torch, [(1, PREFILL, H, dh), (1, PREFILL, KV, dh),
                                  (1, PREFILL, KV, dh)], torch.bfloat16, 7)
    qf, kf, vf = ops.fold(q), ops.fold(k), ops.fold(v)
    out = {"ms": time_ms(torch, lambda i: fa_mod.flash_attention(qf, kf, vf),
                         1),
           "device_ms": device_ms(
               torch, lambda i: fa_mod.flash_attention(qf, kf, vf), 1),
           "plain_ms": time_ms(
               torch, lambda i: fa_mod.flash_attention_ref(qf, kf, vf), 1)}
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          enable_gqa=True)
    sdpa_err = (sdpa.transpose(1, 2).float()
                - ops.flash_attention(q, k, v).float()).abs().max().item()
    out["library_ms"] = time_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), 1)
    out["library_device_ms"] = device_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), 1)
    pairs = int(fa_mod._mask(PREFILL, PREFILL, True, 0, "cpu").sum())
    out["ops_ms"] = 1e3 * 4 * dh * pairs * H / BF16_OPS_PER_S
    out["bytes_ms"] = 1e3 * 2 * (qf.numel() * 2 + kf.numel() * 2) \
        / HBM_BYTES_PER_S
    out["bound_ms"] = max(out["ops_ms"], out["bytes_ms"])
    out["line"] = (
        f"kernel {out['ms']!r} ms, plain {out['plain_ms']!r} ms, library_ms "
        f"{out['library_ms']!r} ms (scaled_dot_product_attention, "
        f"enable_gqa; max|d| vs the kernel {sdpa_err!r}); bound "
        f"{out['bound_ms']!r} ms = max(operations: "
        f"{4 * dh * pairs * H / 1e9:.2f} GFLOP over {pairs} unmasked pairs "
        f"per head at 989 TFLOP/s = {out['ops_ms']!r} ms, bytes: "
        f"{out['bytes_ms']!r} ms), {out['bound_ms'] / out['ms']:.1%} of "
        f"bound (CUDA-event times); profiler device times: kernel "
        f"{out['device_ms']!r} ms ({out['bound_ms'] / out['device_ms']:.1%} "
        f"of bound), library {out['library_device_ms']!r} ms; design "
        f"{fa_mod.design(qf.dtype)}")
    del q, k, v, qf, kf, vf, q4, k4, v4, sdpa
    torch.cuda.empty_cache()
    return out


def check_flash(torch, ops, fa_mod, cases=None) -> list[dict]:
    """ops.flash_attention vs the plain version on every case of `cases`
    (default FLASH_CASES), in both dtypes, element by element
    (ATTN_TOL_DOC)."""
    rows = []
    for (b, sq, sk, h, kv, d, window), dt in (
            (c, dt) for c in (cases or FLASH_CASES) for dt in ATTN_DTYPES):
        q, k, v = attn_inputs(torch, [(b, sq, h, d), (b, sk, kv, d),
                                      (b, sk, kv, d)], getattr(torch, dt),
                              seed=sq + sk + h + d + window)
        before = counts(fa_mod.flash_attention)
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
            before = counts(da_mod.decode_attention)
            got = ops.fold(ops.decode_attention(q, kc, vc, length))
            r = da_mod.decode_attention_check(got, ops.fold(q), ops.fold(kc),
                                              ops.fold(vc), length)
            rows.append({"case": (b, S, h, kv, d, dt, length),
                         "design": changed(da_mod.decode_attention, before),
                         **r})
        del q, kc, vc
        torch.cuda.empty_cache()
    return rows


def paged_inputs(torch, case, seed: int, full: bool = False):
    """q, pools (b * S / bs blocks, shuffled among the slots) and int32
    tables for a PAGED_CASES case, and int64 lengths: ragged (0, 1, the
    edges of a block and a tile, S, past S, then uniform in [1, S]), or
    every slot at S."""
    b, S, bs, h, kv, d = case
    mb = S // bs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, 1, h, d), (b * mb, bs, kv, d),
                                      (b * mb, bs, kv, d)))
    tables = torch.randperm(b * mb, generator=gen, device="cuda").to(
        torch.int32).view(b, mb)
    edge = [0, 1, bs - 1, bs, bs + 1, 63, 64, 65, S, S + 50][:b]
    lengths = torch.randint(1, S + 1, (b,), generator=gen, device="cuda")
    if full:
        lengths.fill_(S)
    else:
        lengths[:len(edge)] = torch.tensor(edge, device="cuda")
    return q, kp, vp, tables, lengths


def check_paged(torch, ops, da_mod) -> list[dict]:
    """paged_decode_attention vs the plain version on every PAGED_CASES
    case at ragged lengths, without and with a window, element by element
    (decode_attention_check on the folded result, the gathered strips and
    one length per query row)."""
    from repro_torch.kernels.paged import paged_view
    rows = []
    for case in PAGED_CASES:
        q, kp, vp, tables, lengths = paged_inputs(torch, case, seed=case[3])
        kf, vf = (ops.fold(paged_view(p, tables)) for p in (kp, vp))
        for window in (0, PAGED_WINDOW):
            before = counts(da_mod.paged_decode_attention)
            got = da_mod.paged_decode_attention(q, kp, vp, tables, lengths,
                                                window)
            r = da_mod.decode_attention_check(
                ops.fold(got), ops.fold(q), kf, vf,
                lengths.repeat_interleave(case[3]), window)
            rows.append({"case": case + (window,),
                         "design": changed(da_mod.paged_decode_attention,
                                           before), **r})
        del q, kp, vp, kf, vf
        torch.cuda.empty_cache()
    return rows


def time_paged(torch, da_mod, case, full: bool) -> dict:
    """The paged kernel, its plain version and the yardstick at a
    PAGED_CASES case: CUDA-event times (`ms`), profiler device times
    (`device_ms`), and the bound at the rows' valid lengths (each valid
    K/V byte read once, q read and the output written once, at 3.35 TB/s;
    the operations, 4 d per (query head, valid position) at 989 TFLOP/s,
    are ~1000x smaller).  The yardstick (`library_ms`, which the port
    never calls) is scaled_dot_product_attention over the strips gathered
    beforehand, with the lengths as a boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged import paged_view
    b, S, bs, h, kv, d = case
    q, kp, vp, tables, lengths = paged_inputs(torch, case, seed=11,
                                              full=full)

    def kern(i):
        return da_mod.paged_decode_attention(q, kp, vp, tables, lengths)

    def plain(i):
        return da_mod.paged_decode_attention_ref(q, kp, vp, tables, lengths)
    ks, vs = (paged_view(p, tables).transpose(1, 2) for p in (kp, vp))
    mask = (torch.arange(S, device="cuda") < lengths[:, None])[:, None, None]

    def library(i):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), ks, vs, attn_mask=mask, enable_gqa=True)
    valid = int(lengths.clamp(0, S).sum())
    out = {"ms": time_ms(torch, kern, 1), "device_ms": device_ms(
        torch, kern, 1), "plain_ms": time_ms(torch, plain, 1),
        "library_ms": time_ms(torch, library, 1),
        "library_device_ms": device_ms(torch, library, 1),
        "valid_positions": valid}
    out["bytes_ms"] = 1e3 * (valid * kv * d * 2 * 2 + 2 * q.numel() * 2) \
        / HBM_BYTES_PER_S
    out["ops_ms"] = 1e3 * 4 * d * h * valid / BF16_OPS_PER_S
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    lib_err = (library(0).transpose(1, 2).float()
               - kern(0).float()).abs().max().item()
    out["line"] = (
        f"paged_decode_attention at (b, S, bs, H, KV, d) = {case}, "
        f"{'every slot at S' if full else 'ragged lengths'} ({valid} valid "
        f"positions): kernel {out['ms']!r} ms, plain {out['plain_ms']!r} "
        f"ms, library_ms {out['library_ms']!r} ms "
        f"(scaled_dot_product_attention over the gathered strips, masked; "
        f"max|d| vs the kernel {lib_err!r}); bound {out['bound_ms']!r} ms "
        f"(bytes {out['bytes_ms']!r}, operations {out['ops_ms']!r}), "
        f"{out['bound_ms'] / out['ms']:.1%} of bound (CUDA-event times); "
        f"profiler device times: kernel {out['device_ms']!r} ms "
        f"({out['bound_ms'] / out['device_ms']:.1%} of bound), library "
        f"{out['library_device_ms']!r} ms")
    del q, kp, vp, ks, vs
    torch.cuda.empty_cache()
    return out


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


def graphed_vs_eager(torch, sess, prompt, n_fill: int) -> list:
    """Both steps of a session, graphed, against the eager function on a
    clone of the cache after `n_fill` prompt tokens: logits and every
    cache entry bit for bit.  Returns [(step, same)]."""
    from repro_torch.models import clone_cache
    from repro_torch.serving import make_serve_step
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
            want, copy = make_serve_step(sess.cfg, sess.rc, table)(
                sess.params, copy, tok, sess.pos)
        results.append((name, torch.equal(got, want) and all(
            torch.equal(a[key], b[key]) for a, b in zip(sess.cache, copy)
            for key in a)))
    sess.reset()
    return results


def trace_steps(torch, sess, prompt, what: str, card: str,
                n_traced: int = 4):
    """Where the time of a gated step goes on the device: n_traced
    prefill-phase steps of `sess` under the profiler, with design B's
    share.  Returns device busy ms per step (None: not measured)."""
    sess.reset()
    prof = profile_window(torch, lambda: sess.prefill(prompt[:, :n_traced]))
    sess.reset()
    if prof["busy_ms"] <= 0:
        print(f"traced {what} steps: the profiler recorded no device time "
              f"(device busy share not measured)")
        return None
    b_us = sum(us for name, us in prof["kernels"] if "int8_gemm_ws" in name)
    print(f"traced {what} steps ({n_traced}, profiler on): wall "
          f"{prof['wall_ms'] / n_traced!r} ms/step, device busy "
          f"{prof['busy_ms'] / n_traced!r} ms/step, device idle share "
          f"{1 - prof['busy_ms'] / prof['wall_ms']!r}; design B "
          f"(int8_gemm_ws_kernel + its reduce) {b_us / 1e3 / n_traced!r} "
          f"ms/step ({b_us / 1e3 / prof['busy_ms']:.1%} of busy) [{card}]")
    for name, us in prof["kernels"][:10]:
        print(f"  device {us / 1e3 / n_traced!r} ms/step "
              f"({us / 1e3 / prof['busy_ms']:.1%}): {name[:90]}")
    return prof["busy_ms"] / n_traced


# --- the moe, ssm and hybrid families (phases 18-26) --------------------------

MOE_ARCH = "qwen2-moe-a2.7b"         # full width and depth
SSM_ARCH = "mamba2-780m"             # full width and depth
HYBRID_ARCH = "jamba-1.5-large-398b"  # at reduced(...) only: see phase 25
# qwen2-moe-a2.7b's prefill attention: 16/16 heads (group size 1), d 128
FAM_FLASH_CASES = [(1, PREFILL, PREFILL, 16, 16, 128, 0)]
# engines of phases 21 and 24: slots, block size, length cap, requests
FAM_SLOTS, FAM_BLOCK, FAM_MAX_LEN, FAM_REQUESTS = 8, 16, 65, 16
SSM_CHECK = 512          # mamba2 positions held decode-vs-forward (2 chunks)
FREED_GIB = 4.0          # allocated before the families' weights, at most
# --- the audio and vlm families (phases 27-28) ---
AUDIO_ARCH = "musicgen-large"         # full width and depth
VLM_ARCH = "llama-3.2-vision-90b"     # full width, VLM_LAYERS deep
VLM_LAYERS = 10          # two periods: 8 self-attention + 2 cross layers
# musicgen's prefill attention (32/32 heads at d 64) and the vlm's (64/8)
AUDIO_FLASH_CASES = [(1, PREFILL, PREFILL, 32, 32, 64, 0)]
VLM_FLASH_CASES = [(1, PREFILL, PREFILL, 64, 8, 128, 0)]


def projection_calls(cfg, period_slots, n_periods) -> list[tuple]:
    """(label, K, N, calls per decode step) of the 2-D projections of one
    step: every call the GEMM kernel can take (the MoE experts are
    stacked (E, K, N) leaves and never take it, nor does an audio model's
    per-codebook (nb, d, vocab) head, contracted by a spec).  A cross
    slot's decode step projects its query and output only; its image K/V
    are projected in the prefill forward (`image_kv_calls`)."""
    d, L = cfg.d_model, n_periods(cfg)
    nh, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    out = []
    for slot in period_slots(cfg):
        if slot.mixer == "attn":
            out += [("Wq", d, nh * dh, L), ("Wk", d, kvh * dh, L),
                    ("Wv", d, kvh * dh, L), ("Wo", nh * dh, d, L)]
        elif slot.mixer == "cross":
            out += [("xattn-Q", d, nh * dh, L), ("xattn-out", nh * dh, d, L)]
        else:
            s = cfg.ssm
            di, g = s.d_inner(d), s.n_groups * s.d_state
            out += [("ssm-z", d, di, L), ("ssm-x", d, di, L),
                    ("ssm-BCdt", d, g, 2 * L),
                    ("ssm-BCdt", d, s.n_ssm_heads(d), L),
                    ("ssm-out", di, d, L)]
        if slot.ffn == "dense":
            out += [("mlp-gate", d, cfg.d_ff, L), ("mlp-up", d, cfg.d_ff, L),
                    ("mlp-down", cfg.d_ff, d, L)]
        elif slot.ffn == "moe" and cfg.moe.n_shared_experts:
            sf = cfg.moe.shared_d_ff
            out += [("shared-gate", d, sf, L), ("shared-up", d, sf, L),
                    ("shared-down", sf, d, L)]
    if cfg.family != "audio":
        out.append(("lm_head", d, cfg.vocab, 1))
    return out


def image_kv_calls(cfg, period_slots, n_periods, batch: int) -> list[tuple]:
    """(label, K, N, calls, M) of the prefill forward's image K/V
    projections: wk and wv of each cross layer on the batch's image
    tokens, M = batch x n_image_tokens rows."""
    n_cross = n_periods(cfg) * sum(s.mixer == "cross"
                                   for s in period_slots(cfg))
    if not n_cross:
        return []
    return [("xattn-KV", cfg.d_model, cfg.n_kv_heads * cfg.head_dim(),
             2 * n_cross, batch * cfg.vision.n_image_tokens)]


def f32_tree(tree):
    """A parameter tree with every floating-point tensor in f32 (int8
    codes stay as they are)."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [f32_tree(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def gated_calls(calls, table) -> list[tuple]:
    """The entries of `calls` whose label `table` gates onto the kernel."""
    return [c for c in calls if table.use_cim(c[0])]


def per_path(rows: dict, calls, m: int) -> dict:
    """The kernel's numbers summed over `calls` (label, K, N, count[, M])
    at M = m (or the call's own M), each shape's row times its count, as
    per_call_sum does for the qwen2-7b paths."""
    keyed = [((c[4] if len(c) > 4 else m, c[1], c[2]), c[3]) for c in calls]
    out = {key: sum(cnt * rows[mkn][key] for mkn, cnt in keyed)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "bytes_ms", "ops_ms", "device_ms",
                       "library_device_ms")}
    out["design"] = "+".join(sorted({rows[mkn]["design"]
                                     for mkn, _ in keyed}))
    out["max_abs_err"] = max((rows[mkn]["max_abs_err"] for mkn, _ in keyed),
                             default=0.0)
    return out


def families(torch, card: str) -> list[dict]:
    """Phases 18-26: the moe, ssm and hybrid families on the card (see the
    module docstring).  Returns their entries of the kernels line."""
    import gc

    import numpy as np
    from repro_torch.configs import ARCHS, RunConfig, reduced
    from repro_torch.kernels import ops, paged_decode_attention
    from repro_torch.kernels.int8_gemm import (int8_gemm, int8_gemm_ref,
                                               plan_gemm)
    from repro_torch.models import (clone_cache, decode_step, init,
                                    init_cache, n_periods, period_slots,
                                    route_trace)
    from repro_torch.models.layers import CIM_ROUTE
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                     ServeSession, make_prefill,
                                     make_serve_step, synthetic_requests)
    from repro_torch.serving.core import token_shape
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    flash = fa_mod.flash_attention
    rc = RunConfig()
    steps, max_len = PROMPT + NEW, PROMPT + NEW + 1

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()

    free()
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"families: {held!r} GiB allocated before their weights are drawn "
          f"(the qwen2-7b weights and graph pools freed; at most "
          f"{FREED_GIB})")
    if held > FREED_GIB:
        raise RuntimeError(f"{held} GiB still allocated before the families")

    # --- 18. the kernels at the families' shapes ----------------------------
    moe_cfg, ssm_cfg = ARCHS[MOE_ARCH], ARCHS[SSM_ARCH]
    hyb_cfg = reduced(ARCHS[HYBRID_ARCH])
    calls = {a: projection_calls(c, period_slots, n_periods)
             for a, c in ((MOE_ARCH, moe_cfg), (SSM_ARCH, ssm_cfg),
                          (HYBRID_ARCH, hyb_cfg))}
    cases = sorted({(m, k, n) for a in (MOE_ARCH, SSM_ARCH)
                    for m in (BATCH, PREFILL) for _, k, n, _ in calls[a]})
    cases += sorted({(BATCH, k, n) for _, k, n, _ in calls[HYBRID_ARCH]})
    def kernel_rows(cases, what) -> dict:
        """check_kernel at each (M, K, N) of `cases` (bf16 x), each row
        checked for the design plan_gemm plans; raises on a bad row."""
        out = {}
        for m, k, n in cases:
            r = check_kernel(torch, int8_gemm, int8_gemm_ref, m, k, n,
                             torch.bfloat16)
            want = plan_gemm(m, n, k).design
            r["ok"] = r["ok"] and r["design"] == want
            out[(m, k, n)] = r
            print(f"int8_gemm ({what}) M={m} K={k} N={n} bf16 design "
                  f"{r['design']} (planned {want}): max|d|="
                  f"{r['max_abs_err']!r} max|d|/max|ref|="
                  f"{r['max_rel_err']!r} (tol {TOL}), bf16 output == f32 "
                  f"output cast {r['out_cast_equal']} "
                  f"{'ok' if r['ok'] else 'FAIL'} | kernel {r['ms']!r} ms, "
                  f"bound {r['bound_ms']!r} ms "
                  f"({r['bound_ms'] / r['ms']:.1%}), plain "
                  f"{r['plain_ms']!r} ms, library_ms {r['library_ms']!r} ms "
                  f"(CUDA events); device: kernel {r['device_ms']!r} ms, "
                  f"library {r['library_device_ms']!r} ms [{card}]")
        bad = [r for r in out.values() if not r["ok"]]
        if bad:
            raise RuntimeError(f"int8_gemm disagrees with its plain version "
                               f"at the {what} shapes: {bad}")
        return out

    def flash_rows(cases, what) -> tuple[list, dict]:
        """check_flash on `cases` (each in both dtypes, each row on its
        dtype's design), then time_flash at the first case's heads."""
        frows = check_flash(torch, ops, fa_mod, cases)
        for r in frows:
            print(f"flash_attention ({what}) (b, sq, sk, H, KV, d, window, "
                  f"dtype) = {r['case']}, design {r['design']}: max|d|="
                  f"{r['max_abs_err']!r}, max |d|/bound={r['worst']!r} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
        flash_design = {"bfloat16": "wgmma", "float32": "fma"}
        if not all(r["ok"] and r["design"] == flash_design[r["case"][-1]]
                   for r in frows):
            raise RuntimeError(f"flash_attention at the {what} shapes "
                               f"disagrees with its plain version "
                               f"({ATTN_TOL_DOC}): {frows}")
        _, _, _, fh, fkv, fdh, _ = cases[0]
        ft = time_flash(torch, ops, fa_mod, fh, fkv, fdh)
        ft["heads"] = (fh, fkv, fdh)
        print(f"flash_attention timing at (1, {PREFILL}, {fh}/{fkv}, {fdh}) "
              f"bf16 causal ({what}'s prefill layer): {ft['line']} [{card}]")
        return frows, ft

    rows = kernel_rows(cases, "families")
    frows, ft = flash_rows(FAM_FLASH_CASES, MOE_ARCH)

    def check_routes(sess, cfg_calls):
        """A 2-D label runs the kernel exactly when the decode table gates
        it; the stacked experts always contract on the dequant route."""
        report = sess.route_report()
        two_d = {c[0] for c in cfg_calls}
        for label, r in report.items():
            print(f"  route {label}: {r['route']} ({r['what']} @ "
                  f"{r['where']}, use_cim {r['use_cim']})")
            want_cim = label in two_d and r["use_cim"]
            if (r["route"] == CIM_ROUTE) != want_cim:
                raise RuntimeError(f"{label} runs {r['route']}")
        return report

    @contextlib.contextmanager
    def pinned_routing(ids: list):
        """Pin the MoE routing of two eager runs: while `ids` is empty,
        torch.topk (called, on these paths, by the MoE router alone)
        records the expert ids it picks into `ids`; after that it returns
        them in the recorded order, with the gate values gathered from this
        run's own router probabilities.  With random weights the router's
        top-k sits on near-ties that bf16 roundings of two routes fall on
        either side of; pinned, two runs can be held element by element."""
        real, replay = torch.topk, (iter(list(ids)) if ids else None)

        def topk(probs, k, *args, **kwargs):
            if replay is None:
                out = real(probs, k, *args, **kwargs)
                ids.append(out.indices)
                return out
            idx = next(replay)
            return probs.gather(-1, idx), idx
        torch.topk = topk
        try:
            yield
        finally:
            torch.topk = real

    def tok_shape(cfg, b: int, n: int) -> tuple:
        """b x n tokens, audio (b, n, nb)."""
        return (b, n) + token_shape(cfg, b)[2:]

    def serve(cfg, cfg_calls, what, n_img=0):
        """Phases 19, 22, 25, 27 and 28: the INT8-gated fixed-batch serve,
        graphed, with its checks (a vlm session holds n_img image tokens
        of image K/V per cross slot).  Returns the session and its
        numbers."""
        t0 = time.perf_counter()
        params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess = ServeSession(cfg, rc, params, max_len=max_len, batch=BATCH,
                            n_image_tokens=n_img, quantize=True)
        del params
        free()
        print(f"{what} serve: {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), seed 0, init {t_init:.2f} s, plan + "
              f"quantize {time.perf_counter() - t0:.2f} s, weights "
              f"{torch.cuda.memory_allocated() / 2**30!r} GiB on the card; "
              f"decode plan {sess.plan_table.digest}, prefill plan "
              f"{sess.prefill_plan_table.digest}")
        check_routes(sess, cfg_calls)
        n_dec = gated_calls(cfg_calls, sess.plan_table)
        n_pre = gated_calls(cfg_calls, sess.prefill_plan_table)
        expected = (PROMPT * sum(c[3] for c in n_pre)
                    + NEW * sum(c[3] for c in n_dec))
        prompt = torch.randint(0, cfg.vocab, tok_shape(cfg, BATCH, PROMPT),
                               generator=torch.Generator().manual_seed(1)
                               ).to("cuda")
        sess.generate(prompt[:, :2], 1)     # warm-up and captures
        sess.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(int8_gemm)
        t0 = time.perf_counter()
        tokens = sess.generate(prompt, NEW)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = int8_gemm.launches
        by_design = dict(int8_gemm.launches_by_design)
        out = {"launches": launches, "ms_per_step": 1e3 * elapsed / steps,
               "tokens_per_s": BATCH * NEW / elapsed,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "decode_calls": n_dec}
        print(f"{what} serve gated: {steps} steps (prefill {PROMPT} + decode "
              f"{NEW}) at batch {BATCH} in {elapsed!r} s: "
              f"{out['ms_per_step']!r} ms/step, {out['tokens_per_s']!r} new "
              f"tokens/s; peak memory {out['peak_gib']!r} GiB; int8_gemm "
              f"launches {launches} (expected {PROMPT} x "
              f"{sum(c[3] for c in n_pre)} + {NEW} x "
              f"{sum(c[3] for c in n_dec)} = {expected}), by design "
              f"{by_design}; decode_executables {sess.decode_executables}, "
              f"prefill_executables {sess.prefill_executables} [{card}]")
        if launches != expected or by_design["B"] != expected:
            raise RuntimeError(f"{what} serve launched int8_gemm {by_design}, "
                               f"expected {expected} on design B")
        if sess.decode_executables != 1 or sess.prefill_executables != 1:
            raise RuntimeError(f"{what} serve captured its steps more than "
                               f"once")
        if tokens.shape != tok_shape(cfg, BATCH, NEW) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab)).all()):
            raise RuntimeError(f"bad token stream {tokens.shape}")
        bitwise = graphed_vs_eager(torch, sess, prompt, 5)
        print(f"{what} graphed steps vs the eager function on a clone of the "
              f"cache (logits and every cache entry bit for bit): {bitwise}")
        if not all(same for _, same in bitwise):
            raise RuntimeError(f"{what}: a replayed step is not the eager "
                               f"step")
        ungated = ServeSession(cfg, rc, sess.params, max_len=max_len,
                               batch=BATCH, n_image_tokens=n_img,
                               quantize=True, gated=False)
        if any(r["route"] == CIM_ROUTE
               for r in ungated.route_report().values()):
            raise RuntimeError("the ungated session routes a label to the "
                               "kernel")
        int8_gemm.launches = 0
        t0 = time.perf_counter()
        ungated_tokens = ungated.generate(prompt, NEW)
        torch.cuda.synchronize()
        t_ungated = time.perf_counter() - t0
        if int8_gemm.launches != 0:
            raise RuntimeError(f"the ungated session launched int8_gemm "
                               f"{int8_gemm.launches} times")
        sess.reset()
        ungated.reset()
        lg = sess.prefill(prompt[:, :1]).float()
        lu = ungated.prefill(prompt[:, :1]).float()
        sess.reset()
        lane = (lg - lu).abs().reshape(BATCH, -1).amax(-1)
        # the first step eager (bit for bit the graphed one) on both
        # routes and in f32 on the same quantized weights (the dequant
        # route with every float leaf and activation in f32): each bf16
        # route is held to the f32 step, the MoE routing of the ungated and
        # f32 runs pinned to the gated run's
        f32cfg = dataclasses.replace(cfg, compute_dtype="float32")
        ids, runs = [], []
        for c, p_, table in ((cfg, sess.params, sess.prefill_plan_table),
                             (cfg, sess.params, ungated.prefill_plan_table),
                             (f32cfg, f32_tree(sess.params),
                              ungated.prefill_plan_table)):
            cache = init_cache(c, rc, BATCH, max_len, device="cuda",
                               n_image_tokens=n_img)
            with pinned_routing(ids), torch.inference_mode():
                runs.append(make_serve_step(c, rc, table)(
                    p_, cache, prompt[:, :1], 0)[0].float())
            del cache
        ref_max = runs[2].abs().max().item()
        diffs = [(r - runs[2]).abs().max().item() for r in runs[:2]]
        # the kernel route must be as close to the f32 step as LOGIT_TOL,
        # or as close as the plain route (torch ops alone) gets: a deep
        # bf16 model may sit farther from f32 than LOGIT_TOL on either
        bound = max(LOGIT_TOL * ref_max, diffs[1])
        agree = int((runs[0].argmax(-1) == runs[1].argmax(-1)).sum())
        # tokens per lane: one, or one per codebook
        per_lane = runs[0].argmax(-1).numel() // BATCH
        print(f"{what} serve ungated: {1e3 * t_ungated / steps!r} ms/step, 0 "
              f"int8_gemm launches, greedy streams equal on "
              f"{int((tokens == ungated_tokens).all(1).sum())} of {BATCH} "
              f"lanes; first-step logits, gated vs ungated as served: max|d| "
              f"per lane {[round(v, 5) for v in lane.tolist()]}; each route "
              f"against the f32 step (MoE routing pinned): gated max|d|="
              f"{diffs[0]!r}, ungated {diffs[1]!r}, gated vs ungated "
              f"{(runs[0] - runs[1]).abs().max().item()!r}, max|f32|="
              f"{ref_max!r}: the gated route within max({LOGIT_TOL}·max|f32|"
              f", the ungated route's max|d|) = {bound!r}; greedy tokens "
              f"agree on {agree} of {BATCH * per_lane} (need "
              f"{MIN_TOKEN_AGREEMENT * per_lane})")
        if not all(bool(torch.isfinite(t).all()) for t in (lg, lu, *runs)) \
                or diffs[0] > bound or agree < MIN_TOKEN_AGREEMENT * per_lane:
            raise RuntimeError(f"{what}: the first-step logits of the two "
                               f"routes disagree")
        del ungated
        out["busy_ms_per_step"] = trace_steps(torch, sess, prompt,
                                              f"{what} gated", card)
        return sess, out

    def prefill_forward(cfg, cfg_calls, params, what, attn_layers,
                        image=None):
        """Phases 20, 23, 27 and 28: the (1, PREFILL) forward under the
        prefill table of a core planned at batch 8 and length PREFILL,
        with attn_impl="pallas" (a vlm's cross slots on `image`);
        launches held against the route trace and plan_gemm's designs (a
        call (label, K, N, count, M) runs at its own M).  Returns the
        core, the prompt, the logits and the numbers."""
        prc = RunConfig(attn_impl="pallas")
        core = DecodeCore(cfg, prc, params, quantize=True, plan_batch=BATCH,
                          plan_max_len=PREFILL, device="cuda")
        ptable = core.prefill_plan_table
        run = make_prefill(cfg, prc, ptable)
        prompt = torch.randint(0, cfg.vocab, tok_shape(cfg, 1, PREFILL),
                               generator=torch.Generator().manual_seed(2)
                               ).to("cuda")
        run(core.params, prompt, image)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(flash)
        reset_counts(int8_gemm)
        with route_trace() as records:
            t0 = time.perf_counter()
            logits = run(core.params, prompt, image)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = {"launches": int8_gemm.launches,
               "by_design": dict(int8_gemm.launches_by_design),
               "flash": flash.launches,
               "flash_by_design": dict(flash.launches_by_design),
               "wall_s": wall,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "calls": gated_calls(cfg_calls, ptable)}
        want = {d: 0 for d in out["by_design"]}
        for c in out["calls"]:
            m = c[4] if len(c) > 4 else PREFILL
            want[plan_gemm(m, c[2], c[1]).design] += c[3]
        n_cim = sum(r["route"] == CIM_ROUTE for r in records)
        print(f"{what} prefill forward: 1 x {PREFILL} tokens in {wall!r} s "
              f"({PREFILL / wall!r} prefill tokens/s), peak memory "
              f"{out['peak_gib']!r} GiB; int8_gemm launches "
              f"{out['launches']} by design {out['by_design']} (expected "
              f"{want}; {n_cim} kernel routes traced), flash_attention "
              f"launches {out['flash']} by design {out['flash_by_design']} "
              f"(expected {attn_layers}) [{card}]")
        if out["by_design"] != want or n_cim != out["launches"]:
            raise RuntimeError(f"{what} prefill launched int8_gemm "
                               f"{out['by_design']}, expected {want}")
        if out["flash"] != attn_layers or (
                out["flash_by_design"]["wgmma"] != attn_layers):
            raise RuntimeError(f"{what} prefill launched flash_attention "
                               f"{out['flash_by_design']}")
        if logits.shape != prompt.shape + (cfg.vocab,) or not bool(
                torch.isfinite(logits).all()):
            raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")
        prof = profile_window(torch, lambda: run(core.params, prompt, image))
        if prof["busy_ms"] > 0:
            a_us = sum(us for name, us in prof["kernels"]
                       if "int8_gemm" in name)
            f_us = sum(us for name, us in prof["kernels"]
                       if "flash_wgmma_kernel" in name)
            out["busy_ms"] = prof["busy_ms"]
            print(f"traced {what} prefill forward (profiler on): wall "
                  f"{prof['wall_ms']!r} ms, device busy {prof['busy_ms']!r} "
                  f"ms, device idle share "
                  f"{1 - prof['busy_ms'] / prof['wall_ms']!r}; int8_gemm "
                  f"{a_us / 1e3!r} ms ({a_us / 1e3 / prof['busy_ms']:.1%}), "
                  f"flash_attention {f_us / 1e3!r} ms "
                  f"({f_us / 1e3 / prof['busy_ms']:.1%}) [{card}]")
            for name, us in prof["kernels"][:10]:
                print(f"  device {us / 1e3!r} ms "
                      f"({us / 1e3 / prof['busy_ms']:.1%}): {name[:90]}")
        else:
            print(f"traced {what} prefill forward: the profiler recorded no "
                  f"device time (device busy share not measured)")
        return core, prompt, logits, out

    def engine(core, cfg, cfg_calls, what, check_reset=False):
        """Phases 21, 24 and 25: FAM_REQUESTS requests all at once through
        the continuous engine (FAM_SLOTS slots), graphed; launches against
        the phase tables' gated calls, one replayed step bit for bit
        against the eager decode_step, and (check_reset) a second run of
        the same requests in which every joining slot's state and conv
        carry read 0 after their reset, with the same streams."""
        eng = ContinuousBatchingEngine(core, n_slots=FAM_SLOTS,
                                       max_len=FAM_MAX_LEN,
                                       block_size=FAM_BLOCK)
        eng.run(synthetic_requests(cfg, 2, seed=1, prompt_len=(2, 2),
                                   new_tokens=(2, 2)), None)   # captures
        caps0 = core.batch_decode_executables
        phase0, steps0 = dict(eng.phase_steps), eng.steps
        reqs = synthetic_requests(cfg, FAM_REQUESTS, seed=0,
                                  prompt_len=(8, 32), new_tokens=(8, 32))
        reset_counts(int8_gemm)
        reset_counts(paged_decode_attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = eng.completed[-FAM_REQUESTS:]
        n_steps = eng.steps - steps0
        ph = {k: eng.phase_steps[k] - phase0[k] for k in phase0}
        tables = {"prefill": core.prefill_plan_table,
                  "decode": core.plan_table}
        expected = sum(ph[k] * sum(c[3] for c in gated_calls(cfg_calls, t))
                       for k, t in tables.items())
        new_tokens = sum(len(r.tokens) for r in done)
        # every attention layer of every step on the paged design (the
        # pools are bf16 in blocks of FAM_BLOCK rows)
        attn = n_periods(cfg) * sum(sl.mixer == "attn"
                                    for sl in period_slots(cfg))
        paged = paged_decode_attention.launches_by_design["paged"]
        print(f"{what} engine: paged_decode_attention launches "
              f"{paged_decode_attention.launches} (expected {n_steps} steps "
              f"x {attn} attention layers = {n_steps * attn})")
        if paged_decode_attention.launches != n_steps * attn or (
                paged != n_steps * attn):
            raise RuntimeError(f"{what} engine launched the paged kernel "
                               f"{paged} times, expected {n_steps * attn}")
        out = {"launches": int8_gemm.launches, "steps": n_steps,
               "paged_launches": paged,
               "wall_s": wall,
               "tokens_per_s": new_tokens / max(r.t_done for r in done),
               "ms_per_step": 1e3 * wall / max(1, n_steps)}
        print(f"{what} engine, {FAM_REQUESTS} requests all at once on "
              f"{FAM_SLOTS} slots: {len(done)} done, {n_steps} steps "
              f"(phase steps {ph}) in {wall!r} s, {out['ms_per_step']!r} "
              f"ms/step, {out['tokens_per_s']!r} new tokens/s; int8_gemm "
              f"launches {out['launches']} (expected {expected}), by design "
              f"{dict(int8_gemm.launches_by_design)}; "
              f"batch_decode_executables {core.batch_decode_executables} "
              f"(new {core.batch_decode_executables - caps0}) [{card}]")
        if len(done) != FAM_REQUESTS or any(
                len(r.tokens) != r.max_new_tokens
                or not ((np.asarray(r.tokens) >= 0).all()
                        and (np.asarray(r.tokens) < cfg.vocab).all())
                for r in done):
            raise RuntimeError(f"{what} engine did not complete every "
                               f"request with its max_new_tokens")
        if out["launches"] != expected or (
                core.batch_decode_executables != caps0):
            raise RuntimeError(f"{what} engine launched int8_gemm "
                               f"{out['launches']} times, expected "
                               f"{expected}, or captured again")
        gen = torch.Generator(device="cuda").manual_seed(3)
        tok = torch.randint(0, cfg.vocab, tok_shape(cfg, FAM_SLOTS, 1),
                            generator=gen, device="cuda")
        pos = torch.tensor([0, 5, 17, 31, 40, 63, 2, 50], dtype=torch.int32,
                           device="cuda")
        active = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool,
                              device="cuda")
        blocks = torch.arange(eng.block_tables.size, dtype=torch.int32,
                              device="cuda").view(FAM_SLOTS, -1)
        copy = clone_cache(eng.cache)
        got, _ = core.batch_step_for(core.plan_table)(eng.cache, tok, pos,
                                                      active, blocks)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg,
                                     core.rc, plan=core.plan_table,
                                     active=active, block_tables=blocks)
        same = torch.equal(got, want) and all(
            torch.equal(a[key], b[key]) for a, b in zip(eng.cache, copy)
            for key in a)
        print(f"{what} engine: one step (replayed graph) vs the eager "
              f"decode_step(..., active=, block_tables=) on a clone of the "
              f"cache: logits and every cache entry bit for bit {same}")
        if not same:
            raise RuntimeError(f"{what}: the engine's graphed step is not the "
                               f"eager step")
        del copy, got, want
        if check_reset:
            first = {r.rid: np.asarray(r.tokens).tolist() for r in done}
            zeroed = []
            reset = eng._reset_slot_state

            def checked(i):
                reset(i)
                zeroed.append(max(
                    float(e[key][:, i].abs().max())
                    for e in eng.cache if "state" in e
                    for key in ("state", "conv")))
            eng._reset_slot_state = checked
            eng.run(synthetic_requests(cfg, FAM_REQUESTS, seed=0,
                                       prompt_len=(8, 32),
                                       new_tokens=(8, 32)), None)
            del eng._reset_slot_state
            again = {r.rid: np.asarray(r.tokens).tolist()
                     for r in eng.completed[-FAM_REQUESTS:]}
            print(f"{what} engine, the same requests again: {len(zeroed)} "
                  f"slot resets, the largest |state| or |conv| of a joining "
                  f"slot after its reset {max(zeroed)!r}; streams equal the "
                  f"first run's on {sum(again[r] == first[r] for r in first)}"
                  f" of {FAM_REQUESTS}")
            if len(zeroed) < FAM_REQUESTS or max(zeroed) != 0.0 or (
                    again != first):
                raise RuntimeError(f"{what}: a joining slot kept its state")
        del eng
        return out

    # --- 19.-21. qwen2-moe-a2.7b: serve, prefill forward, engine ---------------
    moe_sess, moe_serve = serve(moe_cfg, calls[MOE_ARCH], MOE_ARCH)
    moe_core, prompt_, lp, moe_pre = prefill_forward(
        moe_cfg, calls[MOE_ARCH], moe_sess.params, MOE_ARCH,
        n_periods(moe_cfg))
    table = moe_core.prefill_plan_table
    lr = make_prefill(moe_cfg, RunConfig(attn_impl="flash_jnp"), table)(
        moe_core.params, prompt_)
    free_agree = (lp.argmax(-1) == lr.argmax(-1)).float().mean().item()
    free_diff = (lp.float() - lr.float()).abs().max().item()
    ids = []
    with pinned_routing(ids):                 # records the kernel run's
        lp = make_prefill(moe_cfg, RunConfig(attn_impl="pallas"), table)(
            moe_core.params, prompt_)
    with pinned_routing(ids):                 # replays it
        lr = make_prefill(moe_cfg, RunConfig(attn_impl="flash_jnp"), table)(
            moe_core.params, prompt_)
    diff = (lp.float() - lr.float()).abs().max().item()
    ref_max = lr.float().abs().max().item()
    print(f"{MOE_ARCH} prefill logits, flash kernel vs attn_impl='flash_jnp' "
          f"(plain torch attention): as run, max|d|={free_diff!r} and greedy "
          f"tokens agree at {free_agree:.2%} of {PREFILL} positions (the "
          f"router's near-ties flip, and a flip moves later tokens' places "
          f"in the capacity buffers); with the routing pinned to the kernel "
          f"run's, max|d|={diff!r}, max|ref|={ref_max!r} (tol "
          f"{LOGIT_TOL}·max|ref|), greedy tokens agree at "
          f"{(lp.argmax(-1) == lr.argmax(-1)).float().mean().item():.2%}")
    if diff > LOGIT_TOL * ref_max:
        raise RuntimeError(f"{MOE_ARCH} prefill disagrees with flash_jnp")
    del lp, lr, prompt_, moe_core
    free()
    eng_core = DecodeCore(moe_cfg, rc, moe_sess.params, quantize=True,
                          plan_batch=FAM_SLOTS, plan_max_len=FAM_MAX_LEN,
                          device="cuda")
    moe_eng = engine(eng_core, moe_cfg, calls[MOE_ARCH], MOE_ARCH)
    del eng_core, moe_sess
    free()

    # --- 22.-24. mamba2-780m: serve, prefill forward and its check, engine ---
    ssm_sess, ssm_serve = serve(ssm_cfg, calls[SSM_ARCH], SSM_ARCH)
    bcdt = [c for c in ssm_serve["decode_calls"] if c[0] == "ssm-BCdt"]
    if sum(c[3] for c in bcdt) != 3 * n_periods(ssm_cfg):
        raise RuntimeError(f"ssm-BCdt is not on the kernel 3 times a layer: "
                           f"{bcdt}")
    ssm_core, prompt_, logits, ssm_pre = prefill_forward(
        ssm_cfg, calls[SSM_ARCH], ssm_sess.params, SSM_ARCH, 0)
    cache1 = init_cache(ssm_cfg, rc, 1, PREFILL, device="cuda")
    t0 = time.perf_counter()
    step_logits = []
    for t in range(SSM_CHECK):
        lg, cache1 = ssm_core.prefill_step(cache1, prompt_[:, t:t + 1], t)
        step_logits.append(lg[0, 0])
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    step_logits = torch.stack(step_logits).float()
    ref = logits[0, :SSM_CHECK].float()
    diff = (step_logits - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    agree = (step_logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    f32cfg = dataclasses.replace(ssm_cfg, compute_dtype="float32")
    l32 = make_prefill(f32cfg, RunConfig(), ssm_core.prefill_plan_table
                       .ungated())(f32_tree(ssm_core.params),
                                   prompt_)[0, :SSM_CHECK].float()
    d32 = [(x_ - l32).abs().max().item() for x_ in (step_logits, ref)]
    print(f"{SSM_ARCH} decode vs forward (chunk {ssm_cfg.ssm.chunk}): the "
          f"first {SSM_CHECK} positions of the prompt fed one by one "
          f"through the graphed step (batch 1, the forward's prefill table, "
          f"{1e3 * t_steps / SSM_CHECK!r} ms/step) against the forward's "
          f"logits: max|d|={diff!r}, max|ref|={ref_max!r} (tol "
          f"{LOGIT_TOL}·max|ref|); greedy tokens agree at {agree:.2%}; "
          f"against the f32 forward on the same weights (max|f32|="
          f"{l32.abs().max().item()!r}): steps max|d|={d32[0]!r}, bf16 "
          f"forward {d32[1]!r}")
    if diff > LOGIT_TOL * ref_max:
        raise RuntimeError(f"{SSM_ARCH} decode steps disagree with the "
                           f"forward")
    del ssm_core, cache1, logits, step_logits, ref, prompt_
    free()
    eng_core = DecodeCore(ssm_cfg, rc, ssm_sess.params, quantize=True,
                          plan_batch=FAM_SLOTS, plan_max_len=FAM_MAX_LEN,
                          device="cuda")
    ssm_eng = engine(eng_core, ssm_cfg, calls[SSM_ARCH], SSM_ARCH,
                     check_reset=True)
    del eng_core, ssm_sess
    free()

    # --- 25. the hybrid, reduced --------------------------------------------
    what = f"{HYBRID_ARCH} (reduced: {hyb_cfg.name})"
    hyb_sess, hyb_serve = serve(hyb_cfg, calls[HYBRID_ARCH], what)
    hyb_eng = engine(hyb_sess.core, hyb_cfg, calls[HYBRID_ARCH], what,
                     check_reset=True)
    del hyb_sess
    free()

    # --- 26. the serving CLI on mamba2 ----------------------------------------
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           SSM_ARCH, "--smoke", "--batch", "8", "--quantize"]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cli, capture_output=True, text=True, cwd=HERE,
                          env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cli[1:])} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    routes = report["gating"]["routes"]
    print(f"CLI `python {' '.join(cli[1:])}`: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, JSON report with keys "
          f"{sorted(report)}; generated {report['generated_shape']}, routes "
          f"{ {k: v['route'] for k, v in routes.items()} }, cim_routed "
          f"{report['gating']['cim_routed']}")
    if report["generated_shape"] != [8, 32] or (
            report["gating"]["cim_routed"] < 1):
        raise RuntimeError("the mamba2 serving CLI's report is wrong")

    # --- 27. musicgen-large at full size ------------------------------------
    aud_cfg = ARCHS[AUDIO_ARCH]
    vlm_cfg = dataclasses.replace(ARCHS[VLM_ARCH], n_layers=VLM_LAYERS)
    n_img = vlm_cfg.vision.n_image_tokens
    for a, c in ((AUDIO_ARCH, aud_cfg), (VLM_ARCH, vlm_cfg)):
        calls[a] = projection_calls(c, period_slots, n_periods)
    kv_calls = image_kv_calls(vlm_cfg, period_slots, n_periods, 1)
    rows.update(kernel_rows(
        sorted({(m, k, n) for a in (AUDIO_ARCH, VLM_ARCH)
                for m in (BATCH, PREFILL) for _, k, n, _ in calls[a]}
               | {(c[4], c[1], c[2]) for c in kv_calls}),
        "audio and vlm"))
    aud_frows, aud_ft = flash_rows(AUDIO_FLASH_CASES, AUDIO_ARCH)

    def against_flash_jnp(cfg, core, prompt, lp, what, image=None):
        """The kernel route's prefill logits `lp` against the same forward
        with attn_impl="flash_jnp" (plain torch attention) within
        LOGIT_TOL·max|ref|."""
        lr = make_prefill(cfg, RunConfig(attn_impl="flash_jnp"),
                          core.prefill_plan_table)(core.params, prompt, image)
        diff = (lp.float() - lr.float()).abs().max().item()
        ref_max = lr.float().abs().max().item()
        agree = (lp.argmax(-1) == lr.argmax(-1)).float().mean().item()
        print(f"{what} prefill logits, flash kernel vs attn_impl='flash_jnp'"
              f" (plain torch attention): max|d|={diff!r}, max|ref|="
              f"{ref_max!r} (tol {LOGIT_TOL}·max|ref|), greedy tokens agree "
              f"at {agree:.2%}")
        if diff > LOGIT_TOL * ref_max:
            raise RuntimeError(f"{what} prefill disagrees with flash_jnp")

    aud_sess, aud_serve = serve(aud_cfg, calls[AUDIO_ARCH], AUDIO_ARCH)
    aud_core, prompt_, lp, aud_pre = prefill_forward(
        aud_cfg, calls[AUDIO_ARCH], aud_sess.params, AUDIO_ARCH,
        n_periods(aud_cfg))
    against_flash_jnp(aud_cfg, aud_core, prompt_, lp, AUDIO_ARCH)
    del aud_core, prompt_, lp
    free()
    eng_core = DecodeCore(aud_cfg, rc, aud_sess.params, quantize=True,
                          plan_batch=FAM_SLOTS, plan_max_len=FAM_MAX_LEN,
                          device="cuda")
    aud_eng = engine(eng_core, aud_cfg, calls[AUDIO_ARCH], AUDIO_ARCH)
    del eng_core, aud_sess
    free()

    # --- 28. llama-3.2-vision at full width, two periods deep ------------------
    vlm_frows, vlm_ft = flash_rows(VLM_FLASH_CASES, VLM_ARCH)
    d, dh = vlm_cfg.d_model, vlm_cfg.head_dim()
    # a self- or cross-attention layer: wq, wo, wk, wv and the MLP
    layer_params = (2 * d * vlm_cfg.n_heads * dh
                    + 2 * d * vlm_cfg.n_kv_heads * dh + 3 * d * vlm_cfg.d_ff)
    full = ARCHS[VLM_ARCH].n_layers * layer_params
    what = f"{VLM_ARCH} (reduced: {VLM_LAYERS} of its 100 layers)"
    print(f"{what}: full width (d_model {vlm_cfg.d_model}, "
          f"{vlm_cfg.n_heads}/{vlm_cfg.n_kv_heads} heads, d_ff "
          f"{vlm_cfg.d_ff}, vocab {vlm_cfg.vocab}, a cross layer every "
          f"{vlm_cfg.vision.cross_attn_every}, {n_img} image tokens), cut to "
          f"{VLM_LAYERS} layers (8 self-attention + 2 cross): "
          f"{layer_params / 1e6:.0f} M parameters a layer, "
          f"{VLM_LAYERS * layer_params / 1e9:.2f} B for {VLM_LAYERS} layers "
          f"plus {2 * vlm_cfg.vocab * vlm_cfg.d_model / 1e9:.2f} B of "
          f"embedding and head, drawn in bf16 before quantization; all 100 "
          f"layers would be {full / 1e9:.1f} GB at int8 and do not fit one "
          f"card beside their bf16 draw")
    vlm_sess, vlm_serve = serve(vlm_cfg, calls[VLM_ARCH], what, n_img=n_img)
    image = torch.randn((1, n_img, vlm_cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda").to(torch.bfloat16)
    n_self = n_periods(vlm_cfg) * sum(sl.mixer == "attn"
                                      for sl in period_slots(vlm_cfg))
    vlm_core, prompt_, lp, vlm_pre = prefill_forward(
        vlm_cfg, calls[VLM_ARCH] + kv_calls, vlm_sess.params, what, n_self,
        image=image)
    kv_m = kv_calls[0][4]
    print(f"{what} prefill: xattn-KV {kv_calls[0][3]} calls at M = {kv_m} "
          f"(not a multiple of 128: design "
          f"{plan_gemm(kv_m, kv_calls[0][2], kv_calls[0][1]).design} with a "
          f"masked tail)")
    against_flash_jnp(vlm_cfg, vlm_core, prompt_, lp, what, image)
    del vlm_core, prompt_, lp, image
    free()
    try:
        ContinuousBatchingEngine(vlm_sess.core, n_slots=FAM_SLOTS,
                                 max_len=FAM_MAX_LEN, block_size=FAM_BLOCK)
    except NotImplementedError as e:
        print(f"{what} engine: refused, as the JAX package's is ({e})")
    else:
        raise RuntimeError("the engine took a vlm core")
    del vlm_sess
    free()

    # --- the families' entries of the kernels line -------------------------
    def entry(agg, launches, path, work):
        return {"name": "int8_gemm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
                "replaces": "src/repro/kernels/int8_gemm.py:33",
                "launches": launches, "max_abs_err": agg["max_abs_err"],
                "ms": agg["ms"], "plain_ms": agg["plain_ms"],
                "bound_ms": agg["bound_ms"],
                "bound_by": ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                             else "operations"),
                "library_ms": agg["library_ms"],
                "device_ms": agg["device_ms"],
                "library_device_ms": agg["library_device_ms"],
                "path": path, "design": agg["design"], "weights": "int8",
                "work": work}
    out = []
    for arch, srv, pre, eng_ in ((MOE_ARCH, moe_serve, moe_pre, moe_eng),
                                 (SSM_ARCH, ssm_serve, ssm_pre, ssm_eng),
                                 (AUDIO_ARCH, aud_serve, aud_pre, aud_eng),
                                 (VLM_ARCH, vlm_serve, vlm_pre, None)):
        dec = per_path(rows, srv["decode_calls"], BATCH)
        n = sum(c[3] for c in srv["decode_calls"])
        cut = f" ({VLM_LAYERS} layers)" if arch == VLM_ARCH else ""
        out += [
            entry(dec, srv["launches"], f"{arch}{cut} decode step",
                  f"the {n} gated calls of one {arch} decode step at batch "
                  f"{BATCH} (per-shape times x calls); launches counted over "
                  f"the gated serve's {steps} steps"),
            entry(per_path(rows, pre["calls"], PREFILL), pre["launches"],
                  f"{arch}{cut} prefill forward",
                  f"the gated calls of one {arch} prefill forward at M = "
                  f"{PREFILL}" + (f" (xattn-KV at M = {n_img})"
                                  if arch == VLM_ARCH else "")
                  + "; launches counted over one forward")]
        if eng_ is not None:
            out.append(entry(
                dec, eng_["launches"], f"{arch} continuous batching",
                f"the {n} gated calls of one {arch} decode step at M = "
                f"{FAM_SLOTS} slots; launches counted over the "
                f"{FAM_REQUESTS}-request all-at-once engine run "
                f"({eng_['steps']} steps)"))
            if eng_["paged_launches"]:
                out.append({
                    "name": "paged_decode_attention", "route": "cuda",
                    "path": f"{arch} continuous batching",
                    "source": "src/repro_torch/kernels/csrc/"
                              "decode_attention.cu",
                    "launches": eng_["paged_launches"], "design": "paged",
                    "work": f"launches counted over the {FAM_REQUESTS}-"
                            f"request all-at-once engine run "
                            f"({eng_['steps']} steps, one per attention "
                            f"layer a step); times: phase 5's rows"})
    hdec = per_path(rows, hyb_serve["decode_calls"], BATCH)
    out.append(entry(hdec, hyb_serve["launches"] + hyb_eng["launches"],
                     f"{HYBRID_ARCH} reduced serve and engine",
                     f"the gated calls of one reduced {HYBRID_ARCH} decode "
                     f"step at batch {BATCH}; launches counted over its "
                     f"gated serve and its engine run"))
    for arch, pre, fr, t in ((MOE_ARCH, moe_pre, frows, ft),
                             (AUDIO_ARCH, aud_pre, aud_frows, aud_ft),
                             (VLM_ARCH, vlm_pre, vlm_frows, vlm_ft)):
        h, kv, dh = t["heads"]
        out.append({
            "name": "flash_attention", "route": "cuda",
            "path": f"{arch} prefill forward",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:21",
            "launches": pre["flash"],
            "max_abs_err": max(r["max_abs_err"] for r in fr),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "design": "+".join(d for d, c in pre["flash_by_design"].items()
                               if c),
            "work": f"one call at (1, {PREFILL}, {h}/{kv}, {dh}) bf16 causal: "
                    f"one layer of the {arch} prefill; launches counted over "
                    f"one forward"})
    return out


# --- the paged MLA decode kernel (phase 33) -----------------------------------

MLA_ARCH = "moonlight-16b-a3b"
# the cell's latent attention: (slots, positions, block size, heads)
MLA_CASE = (128, 512, 16, 16)
MLA_REQUESTS = 128


def mla_inputs(torch, full: bool, seed: int):
    """q (b, H, 576), a latent pool of b * S / bs blocks shuffled among
    the slots, int32 tables and int64 lengths at MLA_CASE: ragged (0, 1,
    the edges of a tile and a block, S - 1, S, then chat-like lengths,
    log-normal around 170 positions), or every slot at S."""
    b, S, bs, H = MLA_CASE
    mb = S // bs
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, pool = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, H, 576), (b * mb, bs, 576)))
    tables = torch.randperm(b * mb, generator=gen, device="cuda").to(
        torch.int32).view(b, mb)
    lengths = (170 * torch.exp(torch.randn(b, generator=gen, device="cuda"))
               ).clamp(8, S).long()
    if full:
        lengths.fill_(S)
    else:
        edge = [0, 1, 31, 32, 33, bs, S - 1, S]
        lengths[:len(edge)] = torch.tensor(edge, device="cuda")
    return q, pool, tables, lengths, 192 ** -0.5


def time_mla(torch, mla_mod, full: bool) -> dict:
    """paged_mla_decode at MLA_CASE held element by element against the
    plain softmax (`mla_decode_check`, ATTN_TOL_DOC's bf16 bound) and
    against `paged_mla_decode_ref`, then timed: CUDA-event times (`ms`),
    profiler device times (`device_ms`), the plain version, and the
    yardstick (`library_ms`, which the port never calls): SDPA over the
    strips gathered beforehand, k the 576-wide rows expanded to every
    head, v their first 512 columns, the lengths as a boolean mask.  The bound
    is the bytes at the valid lengths (each row read once, q read and the
    output written once, at 3.35 TB/s) or the operations (2 H (576 + 512)
    per valid position at 989 TFLOP/s), whichever is longer."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged import paged_view
    b, S, bs, H = MLA_CASE
    q, pool, tables, lengths, scale = mla_inputs(torch, full, seed=7)
    kern = mla_mod.paged_mla_decode
    before = counts(kern)
    got = kern(q, pool, tables, lengths, scale)
    design = changed(kern, before)
    out = mla_mod.mla_decode_check(got, q, pool, tables, lengths, scale)
    ref = mla_mod.paged_mla_decode_ref(q, pool, tables, lengths, scale)
    out["ref_rel_err"] = ((got.float() - ref.float()).abs().max()
                          / ref.float().abs().max()).item()
    out["repeatable"] = bool(torch.equal(got, kern(q, pool, tables, lengths,
                                                   scale)))
    # every head reads the same rows: stride-0 views, which SDPA's
    # efficient kernel takes (enable_gqa sent it to the math path)
    strips = paged_view(pool, tables)[:, None].expand(b, H, S, 576)
    mask = (torch.arange(S, device="cuda") < lengths[:, None])[:, None,
                                                                None]
    qh = q[:, :, None]

    def library(i):
        return F.scaled_dot_product_attention(
            qh, strips, strips[..., :512], attn_mask=mask, scale=scale)
    live = lengths > 0
    lib_err = (library(0)[:, :, 0][live].float()
               - got[live].float()).abs().max().item()
    valid = int(lengths.sum())
    out.update({
        "design": design, "valid_positions": valid,
        "ms": time_ms(torch, lambda i: kern(q, pool, tables, lengths, scale),
                      1),
        "device_ms": device_ms(
            torch, lambda i: kern(q, pool, tables, lengths, scale), 1),
        "plain_ms": time_ms(torch, lambda i: mla_mod.paged_mla_decode_ref(
            q, pool, tables, lengths, scale), 1),
        "library_ms": time_ms(torch, library, 1),
        "library_device_ms": device_ms(torch, library, 1),
        "bytes_ms": 1e3 * (valid * 576 * 2 + b * H * (576 + 512) * 2)
        / HBM_BYTES_PER_S,
        "ops_ms": 1e3 * 2 * H * (576 + 512) * valid / BF16_OPS_PER_S})
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["line"] = (
        f"paged_mla_decode at (b, S, bs, H) = {MLA_CASE}, rows of 576, "
        f"{'every slot at S' if full else 'ragged lengths'} ({valid} valid "
        f"positions), design {design}: max|d|={out['max_abs_err']!r}, max "
        f"|d|/bound={out['worst']!r} {'ok' if out['ok'] else 'FAIL'} "
        f"({ATTN_TOL_DOC}); against paged_mla_decode_ref max|d|/max|ref| "
        f"{out['ref_rel_err']!r}; kernel {out['ms']!r} ms, plain "
        f"{out['plain_ms']!r} ms, library_ms {out['library_ms']!r} ms "
        f"(SDPA over the gathered strips, masked; max|d| vs the kernel "
        f"{lib_err!r}); bound {out['bound_ms']!r} ms (bytes "
        f"{out['bytes_ms']!r}, operations {out['ops_ms']!r}), "
        f"{out['bound_ms'] / out['ms']:.1%} of bound (CUDA-event times); "
        f"profiler device times: kernel {out['device_ms']!r} ms "
        f"({out['bound_ms'] / out['device_ms']:.1%} of bound), library "
        f"{out['library_device_ms']!r} ms")
    del q, pool, strips, got, ref
    torch.cuda.empty_cache()
    return out


def mla_engine(torch, card: str) -> dict:
    """moonlight-16b-a3b at full size, INT8 and planned, through the
    continuous engine (MLA_CASE's slots, length and blocks): one warm-up
    request to capture the step, then MLA_REQUESTS ragged requests all at
    once, the launch counts set to 0 just before.  Every replayed step
    must credit one paged_mla_decode launch per layer and launch no GQA
    attention kernel."""
    import gc

    from repro_torch.configs import RunConfig, get
    from repro_torch.kernels import paged_decode_attention, paged_mla_decode
    from repro_torch.models import init
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                     synthetic_requests)
    b, S, bs, _ = MLA_CASE
    cfg = get(MLA_ARCH)
    rc = RunConfig(attn_impl="naive", remat=False)
    t0 = time.perf_counter()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=b,
                      plan_max_len=S, device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng = ContinuousBatchingEngine(core, n_slots=b, max_len=S,
                                   block_size=bs)
    eng.run(synthetic_requests(cfg, 2, seed=1, prompt_len=(2, 2),
                               new_tokens=(2, 2)), None)      # captures
    setup = time.perf_counter() - t0
    steps0 = eng.steps
    reqs = synthetic_requests(cfg, MLA_REQUESTS, seed=0, prompt_len=(8, 64),
                              new_tokens=(8, 64))
    reset_counts(paged_mla_decode)
    reset_counts(paged_decode_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = eng.steps - steps0
    done = eng.completed[-MLA_REQUESTS:]
    out = {"launches": paged_mla_decode.launches,
           "by_design": dict(paged_mla_decode.launches_by_design),
           "gqa_launches": paged_decode_attention.launches,
           "steps": n_steps, "layers": cfg.n_layers,
           "ms_per_step": 1e3 * wall / max(1, n_steps),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"{MLA_ARCH} engine, {MLA_REQUESTS} requests all at once on {b} "
          f"slots x {S} (blocks of {bs}): {len(done)} done, {n_steps} steps "
          f"in {wall!r} s ({out['ms_per_step']!r} ms/step, set-up "
          f"{setup:.1f} s, peak {out['peak_gib']:.2f} GiB); "
          f"paged_mla_decode launches {out['launches']} by design "
          f"{out['by_design']} (expected {n_steps} steps x {cfg.n_layers} "
          f"layers = {n_steps * cfg.n_layers}), paged_decode_attention "
          f"launches {out['gqa_launches']} [{card}]")
    if out["launches"] != n_steps * cfg.n_layers or out["gqa_launches"] or (
            out["by_design"]["mla"] != out["launches"]):
        raise RuntimeError(f"{MLA_ARCH} engine launched paged_mla_decode "
                           f"{out['launches']} times, expected "
                           f"{n_steps * cfg.n_layers}")
    if len(done) != MLA_REQUESTS or any(
            len(r.tokens) != r.max_new_tokens for r in done):
        raise RuntimeError(f"{MLA_ARCH} engine did not complete every "
                           f"request with its max_new_tokens")
    del eng, core
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mla_phase(torch, card: str) -> list[dict]:
    """Phase 33 (see the module docstring).  Returns its entry of the
    kernels line."""
    t_phase = time.perf_counter()
    mla_mod = importlib.import_module("repro_torch.kernels.mla_decode")
    times = {}
    for full in (False, True):
        t = times[full] = time_mla(torch, mla_mod, full)
        print(f"{t['line']} [{card}]")
        if not (t["ok"] and t["repeatable"] and t["design"] == "mla"):
            raise RuntimeError(f"paged_mla_decode disagrees with its plain "
                               f"version ({ATTN_TOL_DOC}), is not "
                               f"repeatable or ran another design")
    eng = mla_engine(torch, card)
    print(f"mla: phase 33 took {time.perf_counter() - t_phase:.1f} s")
    t = times[False]
    return [{
        "name": "paged_mla_decode", "route": "cuda",
        "path": f"ops.paged_mla_decode in the {MLA_ARCH} engine's decode "
                f"step",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "replaces": "none: the JAX package has no latent attention "
                    "(kernels/mla_decode.py:latent_attend over the gathered "
                    "strips is the plain version)",
        "launches": eng["launches"],
        "max_abs_err": max(times[f]["max_abs_err"] for f in times),
        "ref_rel_err": max(times[f]["ref_rel_err"] for f in times),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                     else "operations"),
        "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
        "full_length": {k: times[True][k] for k in (
            "ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
            "library_device_ms")},
        "design": "mla",
        "work": f"one call at (b, S, bs, H) = {MLA_CASE}, rows of 576 bf16, "
                f"ragged lengths ({t['valid_positions']} valid positions; "
                f"full_length: every slot at S); launches counted over the "
                f"{MLA_ARCH} engine run ({eng['steps']} steps x "
                f"{eng['layers']} layers)"}]


# --- the grouped INT8 expert kernels (phase 34) -------------------------------

# the two MoE cells: (arch, slots, capacity factor as the cell's config)
MOE_CELLS = (("qwen2-moe-a2.7b", 32, 15.0), ("moonlight-16b-a3b", 128, 11.0))
MOE_ROUTINGS = 3            # seeded routings timed per cell


def moe_cell_cfg(arch: str, cf: float):
    from repro_torch.configs import get
    cfg = get(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def moe_layers(cfg) -> int:
    from repro_torch.models import n_periods, period_slots
    return n_periods(cfg) * sum(s.ffn == "moe" for s in period_slots(cfg))


def time_moe(torch, cfg, T: int, seed: int) -> dict:
    """One MoE layer's routed experts at the cell's width and batch: INT8
    leaves from the seed, T bf16 tokens routed by a seeded router through
    the model's own `route` (softmax, or sigmoid with the selection
    bias); the kernels held against moe_experts_ref (MOE_TOL_DOC), then
    timed (CUDA events `ms`, profiler device time `device_ms`) beside the
    touched experts' bytes bound, the plain version and the yardstick
    (`library_ms`): the three dequant einsums of every expert over every
    token, the route the port no longer calls here."""
    import torch.nn.functional as F
    from repro_torch.kernels.moe_experts import (MOE_TOL_DOC, moe_experts,
                                                 moe_experts_check,
                                                 moe_experts_ref)
    from repro_torch.models.moe import route
    from repro_torch.quant.int8 import dequant_contract
    m = cfg.moe
    E, k, d, f = m.n_experts, m.top_k, cfg.d_model, m.expert_d_ff
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def leaf(a, b):
        q = torch.randint(-127, 128, (E, a, b), generator=gen,
                          device="cuda", dtype=torch.int8)
        sc = (1.0 + torch.rand((E, b), generator=gen, device="cuda")) / (
            127 * a ** 0.5)
        return {"q": q, "scale": sc}
    wg, wu, wd = leaf(d, f), leaf(d, f), leaf(f, d)
    params = {"router": torch.randn((d, E), generator=gen, device="cuda")
              / d ** 0.5,
              "score_bias": 0.1 * torch.randn(E, generator=gen,
                                              device="cuda")}
    x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    _, _, ids = route(params, x, cfg)
    touched = int(torch.unique(ids).numel())
    before = counts(moe_experts)
    got = moe_experts(x, ids, wg, wu, wd)
    design = changed(moe_experts, before)
    out = moe_experts_check(got, x, ids, wg, wu, wd)
    out["repeatable"] = bool(torch.equal(got, moe_experts(x, ids, wg, wu,
                                                          wd)))

    def library(i):
        g = F.silu(dequant_contract(x, wg["q"], wg["scale"], "td,edf->etf"))
        u = dequant_contract(x, wu["q"], wu["scale"], "td,edf->etf")
        eo = dequant_contract(g * u, wd["q"], wd["scale"], "etf,efd->etd")
        return torch.gather(eo.transpose(0, 1), 1,
                            ids[:, :, None].expand(T, k, d))
    lib_err = (library(0).float() - got.float()).abs().max().item()
    # bytes each kernel needs: the touched experts' int8 weights and
    # scales, x read, h written and read, the output written
    moved = (touched * (3 * d * f + 4 * (2 * f + d)) + T * d * 2
             + 2 * T * k * f * 2 + T * k * d * 2)
    out.update({
        "design": design, "T": T, "top_k": k, "experts": E,
        "touched": touched, "touched_share": touched / E,
        "ms": time_ms(torch, lambda i: moe_experts(x, ids, wg, wu, wd), 1),
        "device_ms": device_ms(
            torch, lambda i: moe_experts(x, ids, wg, wu, wd), 1),
        "plain_ms": time_ms(torch, lambda i: moe_experts_ref(
            x, ids, wg, wu, wd), 1),
        "library_ms": time_ms(torch, library, 1),
        "library_device_ms": device_ms(torch, library, 1),
        "bytes_ms": 1e3 * moved / HBM_BYTES_PER_S,
        "ops_ms": 1e3 * 2 * T * k * 3 * d * f / BF16_OPS_PER_S})
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["line"] = (
        f"moe_experts at {cfg.name}'s experts (E {E}, top-{k}, d {d}, f "
        f"{f}), T {T}, seed {seed}: {touched} of {E} experts touched "
        f"({touched / E:.1%}), designs {design}: max|d|="
        f"{out['max_abs_err']!r}, max|d|/bound={out['worst']!r}, max|d|/"
        f"max|ref| {out['rel_err']!r}, rms(d)/rms(ref) {out['rms_rel']!r} "
        f"{'ok' if out['ok'] else 'FAIL'} "
        f"({MOE_TOL_DOC}); kernel {out['ms']!r} ms a layer, plain "
        f"{out['plain_ms']!r} ms, library_ms {out['library_ms']!r} ms (the "
        f"three dequant einsums over every expert and token, max|d| vs the "
        f"kernel {lib_err!r}); bound {out['bound_ms']!r} ms (bytes "
        f"{out['bytes_ms']!r}, operations {out['ops_ms']!r}), "
        f"{out['bound_ms'] / out['ms']:.1%} of bound (CUDA events); device "
        f"times: kernel {out['device_ms']!r} ms "
        f"({out['bound_ms'] / out['device_ms']:.1%} of bound), library "
        f"{out['library_device_ms']!r} ms")
    del wg, wu, wd, got
    torch.cuda.empty_cache()
    return out


def moe_engine(torch, card: str, arch: str, slots: int, cf: float) -> dict:
    """`arch` at full size, INT8 and planned, capacity as its cell's (every
    step T <= C), through the continuous engine on `slots` slots x 512
    (blocks of 16): one warm-up request to capture the step, then `slots`
    ragged requests all at once, the expert counts set to 0 just before.
    Every replayed step must credit two moe_experts launches per MoE
    layer, one per kernel."""
    import gc

    from repro_torch.configs import RunConfig
    from repro_torch.kernels import moe_experts
    from repro_torch.models import init
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                     synthetic_requests)
    cfg = moe_cell_cfg(arch, cf)
    S, bs = 512, 16
    rc = RunConfig(attn_impl="naive", remat=False)
    t0 = time.perf_counter()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=slots,
                      plan_max_len=S, device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng = ContinuousBatchingEngine(core, n_slots=slots, max_len=S,
                                   block_size=bs)
    eng.run(synthetic_requests(cfg, 2, seed=1, prompt_len=(2, 2),
                               new_tokens=(2, 2)), None)      # captures
    setup = time.perf_counter() - t0
    steps0 = eng.steps
    reqs = synthetic_requests(cfg, slots, seed=0, prompt_len=(8, 32),
                              new_tokens=(8, 32))
    reset_counts(moe_experts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = eng.steps - steps0
    layers = moe_layers(cfg)
    done = eng.completed[-slots:]
    out = {"arch": arch, "launches": moe_experts.launches,
           "by_design": dict(moe_experts.launches_by_design),
           "steps": n_steps, "moe_layers": layers,
           "ms_per_step": 1e3 * wall / max(1, n_steps)}
    print(f"{arch} engine, {slots} requests all at once on {slots} slots x "
          f"{S} (capacity factor {cf}): {len(done)} done, {n_steps} steps in "
          f"{wall!r} s ({out['ms_per_step']!r} ms/step, set-up {setup:.1f} "
          f"s); moe_experts launches {out['launches']} by design "
          f"{out['by_design']} (expected 2 x {n_steps} steps x {layers} MoE "
          f"layers = {2 * n_steps * layers}) [{card}]")
    if out["launches"] != 2 * n_steps * layers or any(
            c != n_steps * layers for c in out["by_design"].values()):
        raise RuntimeError(f"{arch} engine launched the expert kernels "
                           f"{out['launches']} times, expected "
                           f"{2 * n_steps * layers}")
    if len(done) != slots or any(len(r.tokens) != r.max_new_tokens
                                 for r in done):
        raise RuntimeError(f"{arch} engine did not complete every request "
                           f"with its max_new_tokens")
    del eng, core
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, card: str) -> list[dict]:
    """Phase 34 (see the module docstring).  Returns its entries of the
    kernels line, one per cell."""
    t_phase = time.perf_counter()
    entries = []
    for arch, slots, cf in MOE_CELLS:
        cfg = moe_cell_cfg(arch, cf)
        runs = []
        for seed in range(MOE_ROUTINGS):
            t = time_moe(torch, cfg, slots, seed=seed)
            print(f"{t['line']} [{card}]")
            if not (t["ok"] and t["repeatable"]
                    and t["design"] == "gate_up+down"):
                raise RuntimeError("moe_experts disagrees with its plain "
                                   "version, is not repeatable or ran "
                                   "other kernels")
            runs.append(t)
        eng = moe_engine(torch, card, arch, slots, cf)
        layers = eng["moe_layers"]
        mean = {key: sum(r[key] for r in runs) / len(runs)
                for key in ("ms", "device_ms", "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms", "bytes_ms",
                            "ops_ms", "touched_share")}
        print(f"moe_experts, {arch}: per layer over {MOE_ROUTINGS} routings "
              f"{mean['device_ms']!r} ms device ({mean['ms']!r} ms CUDA "
              f"events) against a bound of {mean['bound_ms']!r} ms "
              f"({mean['bound_ms'] / mean['device_ms']:.1%}); x {layers} "
              f"layers = {layers * mean['device_ms']!r} ms a step (library "
              f"{layers * mean['library_device_ms']!r} ms) [{card}]")
        entries.append({
            "name": "moe_experts", "route": "cuda",
            "path": f"models/moe.py:moe_apply's T <= C path in the {arch} "
                    f"engine's decode step",
            "source": "src/repro_torch/kernels/csrc/moe_experts.cu",
            "replaces": "none: the JAX package leaves the experts to XLA "
                        "(three dequant einsums; moe_experts_ref is the "
                        "plain version)",
            "launches": eng["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "rel_err": max(r["rel_err"] for r in runs),
            "rms_rel": max(r["rms_rel"] for r in runs),
            "ms": mean["ms"], "device_ms": mean["device_ms"],
            "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"],
            "bound_by": ("bytes" if mean["bytes_ms"] >= mean["ops_ms"]
                         else "operations"),
            "library_ms": mean["library_ms"],
            "library_device_ms": mean["library_device_ms"],
            "touched_share": mean["touched_share"],
            "design": "gate_up+down",
            "work": f"one MoE layer at T {slots}, the mean of "
                    f"{MOE_ROUTINGS} seeded routings; launches counted over "
                    f"the {arch} engine run ({eng['steps']} steps x {layers} "
                    f"MoE layers x 2)"})
    print(f"moe: phase 34 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# --- the paper's experiments (phase 29) --------------------------------------

PAPER_OUT = os.path.join("runs", "paper")    # the CLI's --out, gitignored


def paper_phase(torch, card: str) -> dict:
    """Phase 29: `launch/paper.py`'s seven artefacts on the card, once per
    sweep backend, each on a fresh engine (so every sweep point is scored
    in this run); rows and derived metrics of the two backends equal,
    the runtime fields aside; the sweep kernel's launches counted from 0
    over the pallas run; the two checks of
    docs/reproducing-paper-figures.md; and the CLI as a subprocess
    (`--backend pallas`), whose derived JSON equals the run's."""
    from repro_torch.core import SweepEngine
    from repro_torch.launch import paper
    sweep = importlib.import_module("repro_torch.kernels.sweep_eval"
                                    ).sweep_eval
    runs = {}
    for backend in ("vectorized", "pallas"):
        engine = SweepEngine(device="cuda")
        sweep.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = paper.run_all(backend=backend, device="cuda", engine=engine)
        torch.cuda.synchronize()
        runs[backend] = {"res": res, "wall_s": time.perf_counter() - t0,
                         "launches": sweep.launches}
        print(f"paper artefacts, backend {backend}: "
              f"{runs[backend]['wall_s']!r} s in all, sweep_eval launches "
              f"{sweep.launches}; per artefact "
              f"{ {n: round(r[2], 4) for n, r in res.items()} } s [{card}]")
    diffs = []
    for name in paper.ARTEFACTS:
        (rv, dv, _), (rp, dp, _) = (runs[b]["res"][name]
                                    for b in ("vectorized", "pallas"))
        strip = {k: v for k, v in dp.items() if k not in paper.RUNTIME_FIELDS}
        if rv != rp or strip != {k: v for k, v in dv.items()
                                 if k not in paper.RUNTIME_FIELDS}:
            diffs.append(name)
    fig7 = runs["pallas"]["res"]["fig7_table2_mapping_vs_heuristic"][1]
    docs_ok = (fig7["runtime_ratio"] > 1
               and 0.8 < fig7["tops_w_gain_geomean"] < 1.3)
    print(f"paper artefacts: rows and derived metrics of the two backends "
          f"equal (runtime fields aside) on "
          f"{len(paper.ARTEFACTS) - len(diffs)} of {len(paper.ARTEFACTS)} "
          f"{diffs or ''}; docs/reproducing-paper-figures.md checks: "
          f"runtime_ratio {fig7['runtime_ratio']!r} > 1, "
          f"tops_w_gain_geomean {fig7['tops_w_gain_geomean']!r} in (0.8, "
          f"1.3): {docs_ok}")
    if diffs or not docs_ok or runs["pallas"]["launches"] == 0 or (
            runs["vectorized"]["launches"] != 0):
        raise RuntimeError("the paper's artefacts failed on the card")
    cli = [sys.executable, "-m", "repro_torch.launch.paper", "--backend",
           "pallas", "--out", PAPER_OUT]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cli, capture_output=True, text=True, cwd=HERE,
                          env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cli[1:])} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    same = []
    for name, (_, derived, _) in runs["pallas"]["res"].items():
        with open(os.path.join(HERE, PAPER_OUT,
                               f"{name}.derived.json")) as f:
            got = json.load(f)
        want = json.loads(json.dumps(derived, default=str))
        same.append(all(got[k] == want[k] for k in want
                        if k not in paper.RUNTIME_FIELDS))
    print(f"CLI `python {' '.join(cli[1:])}`: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; derived JSON equal to the run's"
          f" on {sum(same)} of {len(same)}")
    if not all(same):
        raise RuntimeError("the paper CLI's derived JSON differs")
    return {"launches": runs["pallas"]["launches"],
            "wall_s": runs["pallas"]["wall_s"],
            "vectorized_wall_s": runs["vectorized"]["wall_s"]}


# --- training (phase 30) -------------------------------------------------------

# (label, arch, layers, optimizer, batch, seq, microbatches): qwen2-7b at
# full size (train_4k's length), at full width cut to 8 layers, and
# mamba2-780m at full size; each with remat (policy "nothing") and the
# chunked flash_jnp attention at chunk 1024
TRAIN_CASES = (("a", ARCH, 28, "adafactor", 2, 4096, 1),
               ("b", ARCH, 8, "adamw", 8, 1024, 2),
               ("c", "mamba2-780m", 48, "adamw", 8, 1024, 1))
TRAIN_TIMED = 3              # timed steps after one warm-up step
TRAIN_LR = 1e-3             # the train CLI's default rate
# a bf16 element moves by a step of ~lr only where lr reaches half its ulp,
# |p| < 2^8·lr; leaves whose sampled elements all lie above 2^7·lr (the
# norm scales at 1.0) are expected to stay, their f32 moments to move
TRAIN_BF16_MOVES = 2.0 ** 7 * TRAIN_LR
TRAIN_INIT_STD = 0.02        # the LM head's init (models/layers.py)
TRAIN_SAMPLE = 4096          # elements per leaf compared before / after
TRAIN_GRAPH_SEQ = 256        # the forward whose autograd graph is walked
# phase 30d: reduced qwen2-7b widened (tests/test_torch_lowbit_serving.py's
# width) in f32, one step on the card against the same step on the CPU
TRAIN_WIDE = dict(d_model=256, d_ff=512, d_head=64, vocab=512,
                  param_dtype="float32", compute_dtype="float32")
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 1e-5, 1e-4
TRAIN_FLIP_SHARE = 1e-3      # elements whose first Adam step may flip sign
TRAIN_CKPT = os.path.join("tmp_chip", "ckpt_train")   # gitignored
TRAIN_CLI_STEPS, TRAIN_CLI_EVERY, TRAIN_CLI_FAIL = 30, 10, 25


def select_into(loss, ids: set) -> int:
    """SelectBackward0 nodes of loss's autograd graph that feed the
    AccumulateGrad of a tensor in `ids`."""
    bad, seen, todo = 0, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if (type(node).__name__ == "SelectBackward0"
                    and type(nxt).__name__ == "AccumulateGrad"
                    and id(nxt.variable) in ids):
                bad += 1
            todo.append(nxt)
    return bad


def train_case(torch, card: str, label, arch, layers, optimizer, batch,
               seq, mb) -> dict:
    """One of phase 30's runs: a warm-up step, TRAIN_TIMED timed steps and
    one traced step of `make_train_step` on random bf16 weights from seed
    0, with its checks (see the module docstring)."""
    import gc

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import roofline
    from repro_torch.models import init, loss_fn
    from repro_torch.train import loop as loop_mod
    from repro_torch.tree import leaves
    kernels = importlib.import_module("repro_torch.kernels")
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
    full = ARCHS[arch].n_layers
    rc = RunConfig(optimizer=optimizer, learning_rate=TRAIN_LR,
                   warmup_steps=0, microbatches=mb, remat=True,
                   remat_policy="nothing", attn_impl="flash_jnp",
                   attn_chunk=1024)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    n_params = sum(p.numel() for p in leaves(params))
    # the optimizer's share of each step: CUDA events around the update
    # the step hands its optimizer (the step itself is unchanged)
    opt_events, real = [], loop_mod.make_optimizer

    def timed_optimizer(name, weight_decay=0.1):
        init_fn, update = real(name, weight_decay)

        def timed(p, g, s, lr, grad_scale=None):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = update(p, g, s, lr, grad_scale=grad_scale)
            ev[1].record()
            opt_events.append(ev)
            return out
        return init_fn, timed
    loop_mod.make_optimizer = timed_optimizer
    try:
        step_fn = loop_mod.make_train_step(cfg, rc, total_steps=100)
        opt_init = real(optimizer)[0]
    finally:
        loop_mod.make_optimizer = real
    state = opt_init(params)
    dc = DataConfig(seed=0, vocab=cfg.vocab, seq_len=seq,
                    global_batch=batch)
    batches = [batch_at_step(dc, i, device="cuda")
               for i in range(TRAIN_TIMED + 2)]
    counted = ("int8_gemm", "sweep_eval", "flash_attention",
               "decode_attention")
    for name in counted:
        reset_counts(getattr(kernels, name))

    def sample(t):
        flat = t.detach().reshape(-1)
        return flat[::max(1, flat.numel() // TRAIN_SAMPLE)][
            :TRAIN_SAMPLE].clone()
    before = [sample(p) for p in leaves(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step_fn(params, state, batches[0], 0)
    loss0, gnorm0 = m["loss"].item(), m["gnorm"].item()
    warm_s = time.perf_counter() - t0
    # every leaf's f32 second moment moved (each leaf had a gradient and
    # an update); every leaf a step of ~lr can move in bf16 moved
    still = sum(not bool(sample(v).any()) for v in leaves(state["v"]))
    moved = [not torch.equal(b, sample(p))
             for b, p in zip(before, leaves(params))]
    pinned = [p.dtype == torch.bfloat16 and bool(
        (b.float().abs() >= TRAIN_BF16_MOVES).all())
        for b, p in zip(before, leaves(params))]
    unchanged = sum(not mv and not pin for mv, pin in zip(moved, pinned))
    n_pinned = sum(not mv and pin for mv, pin in zip(moved, pinned))
    del before
    ms, losses, gnorms = [], [loss0], [gnorm0]
    for i in range(1, TRAIN_TIMED + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        params, state, m = step_fn(params, state, batches[i], i)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(m["loss"].item())
        gnorms.append(m["gnorm"].item())
    opt_ms = [a.elapsed_time(b) for a, b in opt_events[1:TRAIN_TIMED + 1]]
    peak_alloc = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_res = torch.cuda.max_memory_reserved() / 2 ** 30
    prof = profile_window(torch, lambda: step_fn(
        params, state, batches[TRAIN_TIMED + 1], TRAIN_TIMED + 1))
    launches = {name: getattr(kernels, name).launches for name in counted}
    # the autograd graph of a short forward: no SelectBackward0 into a
    # stacked (per-period) leaf
    short = {k: v[:1, :TRAIN_GRAPH_SEQ] for k, v in batches[0].items()}
    loss, _ = loss_fn(params, short, cfg, rc)
    selects = select_into(loss, {id(t) for t in leaves(params["slots"])})
    del loss

    step_ms = sum(ms) / len(ms)
    opt_mean = sum(opt_ms) / len(opt_ms)
    tokens = batch * seq
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    flops = roofline.model_flops(cfg, shape)
    tflops = flops / (step_ms / 1e3) / 1e12
    # the analytic roofline of this step on one card (no collective term;
    # the model FLOPs stand in for a counted FLOP total)
    roof = roofline.Roofline(
        arch, shape.name, "1 card", 1, hlo_flops=flops,
        hlo_bytes=0.0, collective_bytes=0.0, model_flops_total=flops,
        hbm_bytes=roofline.analytic_hbm_bytes(
            cfg, shape, 1, optimizer=optimizer, microbatches=mb, tp=1))
    idle = (1 - prof["busy_ms"] / prof["wall_ms"] if prof["busy_ms"] > 0
            else None)
    depth = (f"{layers} layers" if layers == full
             else f"{layers} of its {full} layers")
    # random logits of std s = TRAIN_INIT_STD·sqrt(d_model) (the final
    # norm's output has unit RMS): cross entropy ~ ln(vocab) + s^2 / 2
    expect0 = math.log(cfg.vocab) + TRAIN_INIT_STD ** 2 * cfg.d_model / 2
    print(f"train ({label}) {arch}, {depth}, {n_params / 1e9:.3f} B params "
          f"bf16, {optimizer}, batch {batch} x seq {seq}"
          f"{f' in {mb} microbatches' if mb > 1 else ''}, remat "
          f"'nothing', flash_jnp chunk 1024, lr {TRAIN_LR}: step-0 loss "
          f"{loss0!r} (ln vocab {math.log(cfg.vocab)!r} + the init's "
          f"logit variance / 2 = {expect0!r}), losses {losses!r}, gnorms "
          f"{gnorms!r}; warm-up step {warm_s!r} s [{card}]")
    print(f"train ({label}) timed over {TRAIN_TIMED} steps (CUDA events, "
          f"steps {ms!r} ms): {step_ms!r} ms/step = forward + backward "
          f"{step_ms - opt_mean!r} ms + optimizer {opt_mean!r} ms "
          f"({opt_ms!r}); {tokens / (step_ms / 1e3)!r} tokens/s; model "
          f"{flops / 1e12!r} TFLOP/step (6·N·tokens + causal attention x3, "
          f"N = {cfg.active_param_count()}) -> {tflops!r} TFLOP/s = "
          f"{tflops / (BF16_OPS_PER_S / 1e12):.2%} of the H100 SXM's "
          f"dense bf16 989 TFLOP/s; peak allocated {peak_alloc!r} GiB, "
          f"reserved {peak_res!r} GiB [{card}]")
    roof_share = roof.step_time_s / (step_ms / 1e3)
    print(f"train ({label}) roofline (launch/roofline.py, one card): "
          f"compute {roof.compute_s!r} s (model FLOPs at "
          f"{roofline.PEAK_FLOPS:g} FLOP/s), memory {roof.memory_s!r} s "
          f"(analytic HBM bytes {roof.hbm_bytes!r} at {roofline.HBM_BW:g} "
          f"B/s), collective {roof.collective_s!r} s; bottleneck "
          f"{roof.bottleneck}, bound {roof.step_time_s!r} s/step against "
          f"{step_ms / 1e3!r} s measured ({roof_share:.1%} of the bound) "
          f"[{card}]")
    if prof["busy_ms"] > 0:
        print(f"train ({label}) traced step (profiler on): wall "
              f"{prof['wall_ms']!r} ms, device busy {prof['busy_ms']!r} ms, "
              f"idle share {idle!r}")
        for name, us in prof["kernels"][:8]:
            print(f"  device {us / 1e3!r} ms ({us / 1e3 / prof['busy_ms']:.1%}"
                  f"): {name[:100]}")
    else:
        print(f"train ({label}) traced step: the profiler recorded no device "
              f"time (idle share not measured)")
    print(f"train ({label}) checks: after step 1, leaves whose second "
          f"moment stayed 0: {still}; leaves unmoved: {unchanged} of "
          f"{len(moved)} ({n_pinned} more unmoved whose sampled |p| all reach "
          f"2^7·lr = {TRAIN_BF16_MOVES}, where a bf16 step of ~lr rounds "
          f"away); kernel launches over the steps {launches}; "
          f"SelectBackward0 into a stacked leaf: {selects}")
    finite = all(math.isfinite(v) for v in losses + gnorms)
    if (not finite or abs(loss0 - expect0) > 0.5 or unchanged or still
            or any(launches.values()) or selects):
        raise RuntimeError(f"training ({label}) {arch} failed its checks")
    del params, state, batches, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"label": label, "arch": arch, "layers": layers,
            "params": n_params, "step_ms": step_ms, "opt_ms": opt_mean,
            "tokens_per_s": tokens / (step_ms / 1e3), "tflops": tflops,
            "roofline_s": roof.step_time_s,
            "peak_alloc_gib": peak_alloc, "peak_reserved_gib": peak_res,
            "idle_share": idle}


def train_parity_and_resume(torch, card: str) -> None:
    """Phase 30d: one f32 step of reduced qwen2-7b widened to d_model 256
    on the card against the same step on the CPU; then the train CLI as a
    subprocess, crashed at step TRAIN_CLI_FAIL and rerun, against an
    uninterrupted run of the same flags."""
    import shutil

    from repro_torch.configs import ARCHS, RunConfig, reduced
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_tree
    cfg = dataclasses.replace(reduced(ARCHS[ARCH]), **TRAIN_WIDE)
    rc = RunConfig(learning_rate=1e-3, warmup_steps=0, remat=True,
                   attn_impl="flash_jnp", attn_chunk=16)
    cpu = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card_params = map_tree(lambda t: t.to("cuda", copy=True), cpu)
    b = batch_at_step(DataConfig(seed=0, vocab=cfg.vocab, seq_len=64,
                                 global_batch=4), 0, device="cpu")
    step = make_train_step(cfg, rc)
    _, _, mc = step(cpu, adamw_init(cpu), b, 0)
    _, _, mg = step(card_params, adamw_init(card_params),
                    {k: v.to("cuda") for k, v in b.items()}, 0)
    d_loss = abs(mg["loss"].item() - mc["loss"].item()) / mc["loss"].item()
    d_gnorm = abs(mg["gnorm"].item() - mc["gnorm"].item()) / mc["gnorm"].item()
    worst, flips, n = 0.0, 0, 0
    for pc, pg in zip(leaves(cpu), leaves(card_params)):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        worst = max(worst, diff.max().item())
        flips += int((diff > 1e-6 * pc.detach().abs().max()).sum())
        n += diff.numel()
    print(f"train (d) one f32 step of {cfg.name} at d_model "
          f"{cfg.d_model} on the card against the CPU: loss rel "
          f"{d_loss!r} (tol {TRAIN_LOSS_TOL}), gnorm rel {d_gnorm!r} (tol "
          f"{TRAIN_GNORM_TOL}); updated params max|d| {worst!r} (bound 2·lr "
          f"= {2 * rc.learning_rate}: Adam's first step is ~lr·sign(g), so "
          f"an element whose gradient is ~0 may move the other way), {flips} "
          f"of {n} elements beyond 1e-6·max|p| (at most "
          f"{TRAIN_FLIP_SHARE:.0e} of them) [{card}]")
    if (d_loss > TRAIN_LOSS_TOL or d_gnorm > TRAIN_GNORM_TOL
            or worst > 2 * rc.learning_rate * (1 + 1e-3)
            or flips > TRAIN_FLIP_SHARE * n):
        raise RuntimeError("the train step on the card differs from the CPU")

    shutil.rmtree(os.path.join(HERE, TRAIN_CKPT), ignore_errors=True)
    flags = ["--smoke", "--steps", str(TRAIN_CLI_STEPS)]
    cli = [sys.executable, "-m", "repro_torch.launch.train", *flags,
           "--ckpt-dir", TRAIN_CKPT, "--ckpt-every", str(TRAIN_CLI_EVERY)]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    crash = subprocess.run(cli + ["--fail-at", str(TRAIN_CLI_FAIL)],
                           capture_output=True, text=True, cwd=HERE,
                           env=env, timeout=600)
    want = f"injected node failure at step {TRAIN_CLI_FAIL}"
    if crash.returncode == 0 or want not in crash.stderr:
        raise RuntimeError(f"the crashed train CLI exited "
                           f"{crash.returncode}:\n{crash.stderr[-3000:]}")
    rerun = subprocess.run(cli, capture_output=True, text=True, cwd=HERE,
                           env=env, timeout=600)
    if rerun.returncode != 0:
        raise RuntimeError(f"the resumed train CLI exited "
                           f"{rerun.returncode}:\n{rerun.stderr[-3000:]}")
    out = json.loads(rerun.stdout)
    cli_s = time.perf_counter() - t0
    _, full = train_cli.run(train_cli.parse_args(flags))
    resumed_at = (TRAIN_CLI_FAIL // TRAIN_CLI_EVERY) * TRAIN_CLI_EVERY
    same = (out["loss_first"] == full.losses[resumed_at]
            and out["loss_last"] == full.losses[-1])
    print(f"train (d) CLI `python -m repro_torch.launch.train "
          f"{' '.join(cli[3:])}`: --fail-at {TRAIN_CLI_FAIL} exited "
          f"{crash.returncode} ({want}), the rerun exited 0 resumed from "
          f"{out['resumed_from']} with loss_first {out['loss_first']!r} > "
          f"loss_last {out['loss_last']!r}, keys {sorted(out)}; "
          f"{cli_s:.1f} s for both; an uninterrupted in-process run of the "
          f"same flags: losses at steps {resumed_at} and "
          f"{TRAIN_CLI_STEPS - 1} {full.losses[resumed_at]!r}, "
          f"{full.losses[-1]!r}: bit for bit {same} [{card}]")
    if (out["resumed_from"] != resumed_at
            or not out["loss_last"] < out["loss_first"] or not same):
        raise RuntimeError("the resumed train CLI differs from the "
                           "uninterrupted run")


def train_phase(torch, card: str) -> list[dict]:
    """Phase 30: training on the card (see the module docstring)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"train: {held!r} GiB allocated before the training runs (at most "
          f"{FREED_GIB})")
    if held > FREED_GIB:
        raise RuntimeError(f"{held} GiB still allocated before training")
    t0 = time.perf_counter()
    runs = [train_case(torch, card, *case) for case in TRAIN_CASES]
    train_parity_and_resume(torch, card)
    print(f"train: phase 30 took {time.perf_counter() - t0:.1f} s")
    return runs


# --- the distributed layer (phase 31) -------------------------------------------

DIST_CHUNK_ROWS = 512        # the golden grid streams through >= 2 chunks
DIST_RANKS = 2               # gloo ranks sharing the card in 31(b)
DIST_TIMEOUT = 300           # seconds a 31(b) rank may take
PSUM_LAYERS = 8              # 31(c): qwen2-7b's parameter shapes at 8 layers
PSUM_CALLS = 3               # timed compressed_psum calls after a warm-up
PSUM_CHECKED = ("embed", "slots/0/mlp/w_gate")   # leaves held against gloo
DIST_OUT = os.path.join("build", "chip_smoke", "dist")   # gitignored


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def verdict_rows(entries, decisions) -> list:
    return [[arch, sname, prec, g.label, d.best_energy, d.best_throughput,
             str(int(d.use_cim)), d.where]
            for (arch, sname, prec, g), d in zip(entries, decisions)]


def sweep_rank_worker() -> int:
    """One rank of phase 31(b) (`chip_smoke.py --sweep-rank`, REPRO_*
    from the parent): a gloo group on the CPU, its shard of every golden
    grid tile scored by the sweep kernel on cuda:0, the output columns
    gathered on the host; writes its rows and telemetry to
    $DIST_WORKER_OUT.<rank>."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core import (gemms_of_model, phase_gemms_of_model,
                                  plan_workload)
    from repro_torch.launch import distributed as dist
    sweep = importlib.import_module("repro_torch.kernels.sweep_eval"
                                    ).sweep_eval
    t0 = time.perf_counter()
    if not dist.initialize(device="cpu"):
        raise RuntimeError("31(b): no multi-rank gloo group")
    engine = dist.distributed_engine(chunk_rows=DIST_CHUNK_ROWS,
                                     device="cuda")
    entries = list(golden_grid(ARCHS, SHAPES, gemms_of_model,
                               phase_gemms_of_model))
    sweep.launches = 0
    decisions = plan_workload([g for *_, g in entries], backend="pallas",
                              engine=engine)
    torch.cuda.synchronize()
    info = engine.cache_info()
    payload = {"rows": verdict_rows(entries, decisions),
               "launches": sweep.launches, "chunks": info["chunks"],
               "distributed": info["distributed"],
               "engine_device": str(engine.device),
               "backend": tdist.get_backend(),
               "seconds": time.perf_counter() - t0}
    rank = tdist.get_rank()
    tdist.destroy_process_group()
    with open(f"{os.environ['DIST_WORKER_OUT']}.{rank}", "w") as f:
        json.dump(payload, f)
    return 0


def gloo_ranks_on_card(card: str, golden) -> dict:
    """Phase 31(b): DIST_RANKS gloo ranks sharing the card, as
    subprocesses (waited on with a timeout, killed in `finally`)."""
    from repro_torch.launch import distributed as dist
    os.makedirs(os.path.join(HERE, DIST_OUT), exist_ok=True)
    out = os.path.join(HERE, DIST_OUT, "rank")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               DIST_WORKER_OUT=out,
               **{dist.ENV_COORDINATOR: f"127.0.0.1:{free_port()}",
                  dist.ENV_NUM_PROCESSES: str(DIST_RANKS)})
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(DIST_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sweep-rank"],
                env=dict(env, **{dist.ENV_PROCESS_ID: str(i)}), cwd=HERE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=DIST_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"31(b): a rank exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    pays = []
    for i in range(DIST_RANKS):
        with open(f"{out}.{i}") as f:
            pays.append(json.load(f))
    half = None
    for i, pay in enumerate(pays):
        rows = [tuple(r) for r in pay["rows"]]
        diffs = [j for j, (a, b) in enumerate(zip(rows, golden)) if a != b]
        c, d = pay["chunks"], pay["distributed"]
        half = (c["rows"] + c["padded_rows"]) // DIST_RANKS
        print(f"31(b) rank {i} of {DIST_RANKS} ({pay['backend']} group, "
              f"engine on {pay['engine_device']}): {len(rows)} verdicts, "
              f"{len(diffs)} differ from tests/golden/planner_verdicts.csv; "
              f"{c['evaluated']} chunks, {c['rows']} rows + "
              f"{c['padded_rows']} padding; shard_balance "
              f"{d and d['shard_balance']}; sweep_eval launches "
              f"{pay['launches']}; {pay['seconds']!r} s in the rank "
              f"[{card}]")
        if (diffs or len(rows) != len(golden) or c["evaluated"] < 2
                or not d or d["shard_balance"] != {
                    str(j): half for j in range(DIST_RANKS)}
                or pay["launches"] == 0 or pay["backend"] != "gloo"):
            raise RuntimeError(f"31(b): rank {i} failed its checks")
    if any(p["rows"] != pays[0]["rows"] for p in pays):
        raise RuntimeError("31(b): the ranks planned differently")
    wall = time.perf_counter() - t0
    print(f"31(b) {DIST_RANKS} gloo ranks sharing the card: identical plans "
          f"on every rank; {wall!r} s wall, processes included [{card}]")
    return {"launches": sum(p["launches"] for p in pays), "wall_s": wall}


def psum_on_card(torch, card: str) -> dict:
    """Phase 31(c): compressed_psum at world 1 under NCCL on a bf16 tree
    of qwen2-7b's parameter shapes at PSUM_LAYERS layers; two leaves held
    bit for bit against the same call under gloo on the CPU."""
    import gc
    import torch.distributed as tdist

    from repro_torch.configs import ARCHS
    from repro_torch.models import init
    from repro_torch.optim.grad_compress import (compressed_psum,
                                                 init_error_state)
    from repro_torch.tree import flatten_with_paths, leaves
    cfg = dataclasses.replace(ARCHS[ARCH], n_layers=PSUM_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    grads = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                 device="cuda")
    errors = init_error_state(grads)
    n_el = sum(t.numel() for t in leaves(grads))
    n_leaves = len(list(leaves(grads)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    red, errors = compressed_psum(grads, errors)         # warm-up
    del red
    ms = []
    for _ in range(PSUM_CALLS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        red, errors = compressed_psum(grads, errors)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        del red
    flat_g, flat_e = flatten_with_paths(grads), flatten_with_paths(errors)
    cpu_g = {k: flat_g[k].to("cpu", copy=True) for k in PSUM_CHECKED}
    cpu_e = {k: flat_e[k].to("cpu", copy=True) for k in PSUM_CHECKED}
    calls, real = [0], tdist.all_reduce

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    tdist.all_reduce = counting
    try:
        red, errors = compressed_psum(grads, errors)
        torch.cuda.synchronize()
        card_calls = calls[0]
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        gloo = tdist.new_group(backend="gloo")
        t0 = time.perf_counter()
        want_r, want_e = compressed_psum(cpu_g, cpu_e, group=gloo)
        cpu_s = time.perf_counter() - t0
    finally:
        tdist.all_reduce = real
    got_r, got_e = flatten_with_paths(red), flatten_with_paths(errors)
    same = {k: bool(torch.equal(got_r[k].cpu(), want_r[k])
                    and torch.equal(got_e[k].cpu(), want_e[k]))
            for k in PSUM_CHECKED}
    mean_ms = sum(ms) / len(ms)
    wire = 4 * n_el + 4 * n_leaves
    hbm = (2 + 4 + 4 + 4) * n_el         # read g, e; write reduced, new e
    bound_ms = 1e3 * hbm / HBM_BYTES_PER_S
    print(f"31(c) compressed_psum, world 1 under NCCL, on {ARCH}'s parameter "
          f"shapes at {PSUM_LAYERS} layers ({n_el} bf16 elements, "
          f"{n_leaves} leaves): {mean_ms!r} ms per call (CUDA events, calls "
          f"{ms!r}); on the wire {wire} B (int32 codes, 4 B/element, + one "
          f"f32 scale per leaf); HBM bytes bound {bound_ms!r} ms ({hbm} B: "
          f"bf16 grads and f32 residuals read, f32 means and residuals "
          f"written, at 3.35 TB/s), {bound_ms / mean_ms:.1%} of it; peak "
          f"{peak!r} GiB above the {held / 2 ** 30!r} GiB of grads and "
          f"residuals; all_reduce calls in one call {card_calls} (2 per leaf: "
          f"{2 * n_leaves}) [{card}]")
    print(f"31(c) against the same call under gloo on the CPU ({cpu_s!r} s "
          f"for {', '.join(PSUM_CHECKED)}): reduced and new residual bit for "
          f"bit {same}")
    del grads, errors, red, cpu_g, cpu_e, want_r, want_e, got_r, got_e
    del flat_g, flat_e
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()) or card_calls != 2 * n_leaves:
        raise RuntimeError("31(c): compressed_psum on the card differs")
    return {"ms": mean_ms, "bound_ms": bound_ms, "wire_bytes": wire,
            "peak_gib": peak}


def distributed_phase(torch, card: str, entries, golden, golden_spec,
                      golden_front) -> dict:
    """Phase 31: the distributed layer on the card (see the module
    docstring).  Returns the row-sharded sweep's launch counts."""
    import torch.distributed as tdist

    from repro_torch.core import SweepEngine, plan_workload, run_campaign
    from repro_torch.launch import distributed as dist
    sweep = importlib.import_module("repro_torch.kernels.sweep_eval"
                                    ).sweep_eval
    t_phase = time.perf_counter()
    env = {dist.ENV_COORDINATOR: f"127.0.0.1:{free_port()}",
           dist.ENV_NUM_PROCESSES: "1", dist.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    gemms = [g for *_, g in entries]
    launches = 0
    try:
        # (a) a world of 1 under NCCL
        multi = dist.initialize()
        print(f"31(a) initialize() from REPRO_*: backend "
              f"{tdist.get_backend()}, world {tdist.get_world_size()}, rank "
              f"device {dist.rank_device()}, multi-process {multi}")
        if tdist.get_backend() != "nccl" or multi:
            raise RuntimeError("31(a): expected a world of 1 under NCCL")
        for backend in ("vectorized", "pallas"):
            engine = dist.distributed_engine(chunk_rows=DIST_CHUNK_ROWS)
            sweep.launches = 0          # the row-sharded path starts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decisions = plan_workload(gemms, backend=backend, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = sweep.launches          # ... and ends here
            if backend == "pallas":
                launches += n
            got = [tuple(r) for r in verdict_rows(entries, decisions)]
            plain = plan_workload(gemms, backend=backend, engine=SweepEngine(
                mesh=None, chunk_rows=DIST_CHUNK_ROWS, device="cuda"))
            same_plain = got == [tuple(r) for r in verdict_rows(entries,
                                                                plain)]
            diffs = [i for i, (a, b) in enumerate(zip(got, golden)) if a != b]
            info = engine.cache_info()
            print(f"31(a) distributed_engine(chunk_rows={DIST_CHUNK_ROWS}) "
                  f"backend={backend}: {len(got)} verdicts, {len(diffs)} "
                  f"differ from tests/golden/planner_verdicts.csv, equal to "
                  f"the unsharded engine {same_plain}; {wall!r} s cold; mesh "
                  f"{engine.mesh.device_type} x {engine.n_shards}; chunks "
                  f"{info['chunks']}; distributed {info['distributed']}; "
                  f"sweep_eval launches {n} [{card}]")
            if (diffs or len(got) != len(golden) or not same_plain
                    or info["chunks"]["evaluated"] < 2
                    or (backend == "pallas") != (n > 0)):
                raise RuntimeError(f"31(a): the row-sharded plan failed "
                                   f"({backend})")
        engine = dist.distributed_engine(chunk_rows=DIST_CHUNK_ROWS)
        sweep.launches = 0
        t0 = time.perf_counter()
        result = run_campaign(golden_spec, engine=engine, backend="pallas",
                              block_points=256, group_by="gemm")
        wall = time.perf_counter() - t0
        n = sweep.launches
        launches += n
        same = result.csv_text() == golden_front
        print(f"31(a) golden campaign through the row-sharded engine "
              f"(pallas): front byte-equal to tests/golden/campaign_front.csv "
              f"{same}; {wall!r} s, {engine.cache_info()['chunks']['evaluated']}"
              f" chunks, sweep_eval launches {n} [{card}]")
        if not same or n == 0:
            raise RuntimeError("31(a): the row-sharded campaign front differs")
        psum = psum_on_card(torch, card)            # (c)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ranks = gloo_ranks_on_card(card, golden)        # (b)
    print(f"distributed: phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return {"world1_launches": launches, "gloo_launches": ranks["launches"],
            "psum": psum}


# --- the dry run and the GEMM's block report (phase 32) ------------------------

# (a)'s cells (arch, shape, mesh), traced in parallel subprocesses of the
# dry-run CLI on the card machine's CPU (the dry run uses no card)
DRY_CELLS = (("mamba2-780m", "decode_32k", "single"),
             ("qwen2-7b", "train_4k", "single"),
             ("qwen2-7b", "prefill_32k", "single"),
             ("qwen2-7b", "decode_32k", "single"),
             ("qwen2-7b", "train_4k", "multi"),
             ("qwen2-moe-a2.7b", "decode_32k", "single"),
             ("musicgen-large", "decode_32k", "single"),
             ("llama-3.2-vision-90b", "decode_32k", "single"),
             ("jamba-1.5-large-398b", "decode_32k", "single"))
DRY_BUDGET_S = 300           # (a)'s wall budget, all cells together
DRY_OUT = os.path.join(HERE, "build", "chip_smoke", "dryrun")   # gitignored
# (b): the JAX package's autotune_report shapes, its block-test shapes
# (tests/test_decode_hotpath.py:305-308) and a square prefill GEMM
BLOCK_SHAPES = ((8, 512, 256), (8, 256, 2048), (1024, 1024, 1024),
                (4096, 128, 512), (1, 512, 256), (64, 1024, 1024),
                (256, 128, 512), (4096, 96, 768), (7, 130, 96),
                (4096, 4096, 4096))
# (c): phase 30 (b)'s cell (qwen2-7b's width at 8 layers, AdamW, batch 8
# x 1024 in 2 microbatches)
DRY_CARD_CASE = TRAIN_CASES[1]
DRY_CARD_TIMED = 3


def dry_cells(card: str) -> list[dict]:
    """32 (a): every DRY_CELLS cell through `python -m
    repro_torch.launch.dryrun`, all started together, within
    DRY_BUDGET_S; each must report status ok."""
    from repro_torch.launch.report import dryrun_table
    os.makedirs(DRY_OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    procs = []
    try:
        for arch, shape, mesh in DRY_CELLS:
            log = open(os.path.join(DRY_OUT, f"{arch}.{shape}.{mesh}.log"),
                       "w")
            procs.append(((arch, shape, mesh), log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--force", "--out",
                 DRY_OUT], env=env, cwd=HERE, stdout=log,
                stderr=subprocess.STDOUT)))
        for _, log, p in procs:
            p.wait(timeout=max(1.0, DRY_BUDGET_S
                               - (time.perf_counter() - t0)))
            log.close()
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    cells = []
    for (arch, shape, mesh), _, p in procs:
        path = os.path.join(DRY_OUT, f"{arch}.{shape}.{mesh}.json")
        if p.returncode != 0 or not os.path.exists(path):
            raise RuntimeError(f"32(a): the dry run of {arch} x {shape} x "
                               f"{mesh} exited {p.returncode}")
        with open(path) as f:
            c = json.load(f)
        cells.append(c)
        if c["status"] != "ok":
            raise RuntimeError(f"32(a): {arch} x {shape} x {mesh}: "
                               f"{c.get('error')}")
        mem, coll, r = (c["memory_analysis"], c["collectives"],
                        c["roofline"])
        by_type = {k: (v["count"], v["bytes"]) for k, v in
                   coll["by_type_at_last_unroll"].items()}
        line = (f"32(a) {arch} x {shape} x {mesh} ({c['chips']} ranks, "
                f"{c['run_config']}): trace {c['trace_s']!r} s; per rank "
                f"{c['cost_analysis']['flops']!r} FLOPs, "
                f"{c['cost_analysis']['bytes_accessed']!r} bytes accessed, "
                f"collectives {coll['collective_bytes']!r} B {by_type}; "
                f"arguments {mem['argument_size_in_bytes']} B, temp "
                f"{mem['temp_size_in_bytes']} B; bottleneck "
                f"{r['bottleneck']}, roofline fraction "
                f"{r['roofline_fraction']!r}; redistributions "
                f"{c['redistributions']}")
        if "planner" in c:
            pl = c["planner"]
            line += (f"; planner n_gemms {pl['summary']['n_gemms']}, "
                     f"cim_routed_fraction {pl['cim_routed_fraction']!r}")
        print(line)
    print(dryrun_table(cells))
    print(f"32(a) {len(cells)} dry-run cells in {wall:.1f} s (budget "
          f"{DRY_BUDGET_S} s, all started together on the host's CPU; no "
          f"cell cut)")
    return cells


def block_report(torch, card: str) -> dict:
    """32 (b): `autotune_report()` at BLOCK_SHAPES, each shape run once
    with int8 and once with e4m3 weights against the plain version, the
    designs launched equal to the report's; then each int8 shape timed as
    phase 3 times its shapes.  Returns the kernel line's entry."""
    from repro_torch.kernels.autotune import autotune_report
    gemm_mod = importlib.import_module("repro_torch.kernels.int8_gemm")
    int8_gemm, int8_gemm_ref = gemm_mod.int8_gemm, gemm_mod.int8_gemm_ref
    rows = autotune_report(BLOCK_SHAPES)
    reset_counts(int8_gemm)                 # the block report's path
    errs, want_designs = [], {d: 0 for d in int8_gemm.launches_by_design}
    for r in rows:
        m, n, k = r["shape"]
        for weights in ("int8", "fp8"):
            gen = torch.Generator(device="cuda").manual_seed(m + 31 * n + k)
            x = torch.randn((m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            q, s = gemm_weight(torch, weights, k, n, gen)
            before = dict(int8_gemm.launches_by_design)
            got = int8_gemm(x, q, s)
            ran = {d: c - before[d] for d, c in
                   int8_gemm.launches_by_design.items() if c != before[d]}
            want = int8_gemm_ref(x, q, s)
            torch.cuda.synchronize()
            ref_max = want.abs().max().item()
            err = (got - want).abs().max().item()
            errs.append(err)
            want_designs[r["design"]] += 1
            ok = (ran == {r["design"]: 1} and err <= TOL * ref_max
                  and bool(torch.isfinite(got).all().item()))
            print(f"32(b) ({m}, {n}, {k}) {weights}: design {r['design']} "
                  f"blocks {r['blocks']} splits {r['splits']} smem "
                  f"{r['smem_kib']!r} KiB grid {r['grid_blocks']} blocks; "
                  f"launched {ran}; max|Δ| {err!r} (≤ {TOL}·{ref_max!r}) "
                  f"[{card}]")
            if not ok:
                raise RuntimeError(f"32(b): int8_gemm at ({m}, {n}, {k}) "
                                   f"{weights} failed the block report")
    launches = int8_gemm.launches
    by_design = dict(int8_gemm.launches_by_design)
    by_format = dict(int8_gemm.launches_by_format)
    if by_design != want_designs:
        raise RuntimeError(f"32(b): launches by design {by_design} != the "
                           f"report's {want_designs}")
    timed = [check_kernel(torch, int8_gemm, int8_gemm_ref, m, k, n,
                          torch.bfloat16) for m, n, k in
             (r["shape"] for r in rows)]
    total = {key: sum(t[key] for t in timed) for key in (
        "ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "library_ms",
        "device_ms", "library_device_ms")}
    print(f"32(b) {len(rows)} shapes x 2 weight formats: launches "
          f"{launches}, by design {by_design}, by format {by_format} "
          f"(before the timing below); int8 summed over "
          f"the shapes: kernel {total['ms']!r} ms (device "
          f"{total['device_ms']!r}), plain {total['plain_ms']!r}, bound "
          f"{total['bound_ms']!r}, torch.matmul {total['library_ms']!r} "
          f"[{card}]")
    return {
        "name": "int8_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_gemm.cu",
        "replaces": "src/repro/kernels/int8_gemm.py:33",
        "launches": launches,
        "max_abs_err": max(errs + [t["max_abs_err"] for t in timed]),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
        "device_ms": total["device_ms"],
        "library_device_ms": total["library_device_ms"],
        "path": "block report",
        "design": "+".join(d for d, c in want_designs.items() if c),
        "weights": "int8 and float8_e4m3fn",
        "work": f"one call at each of the {len(rows)} shapes of "
                f"autotune_report(BLOCK_SHAPES) with each weight format "
                f"(launches); times summed over the shapes with int8 "
                f"weights"}


def dry_vs_card(torch, card: str) -> dict:
    """32 (c): the dry run's per-rank accounting (`dryrun.trace_step`, at a
    mesh of one rank of a fake group) against one real step of phase 30
    (b)'s cell on the card counted by FlopCounterMode: equal FLOPs; the
    Roofline bound from the dry run's counts beside the measured ms/step."""
    import gc

    import torch.distributed as tdist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS, RunConfig, ShapeConfig
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import init
    from repro_torch.optim import make_optimizer
    from repro_torch.train.loop import make_train_step
    _, arch, layers, optimizer, batch, seq, mb = DRY_CARD_CASE
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
    shape = ShapeConfig(f"train_{seq}", seq, batch, "train")
    rc = RunConfig(optimizer=optimizer, learning_rate=TRAIN_LR,
                   warmup_steps=0, microbatches=mb, remat=True,
                   remat_policy="nothing", attn_impl="flash_jnp",
                   attn_chunk=1024)
    dryrun.fake_group()
    try:
        dry = dryrun.trace_step(cfg, shape, small_mesh(1, 1), rc)
    finally:
        tdist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    state = make_optimizer(optimizer)[0](params)
    dc = DataConfig(seed=0, vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    batches = [batch_at_step(dc, i, device="cuda")
               for i in range(DRY_CARD_TIMED + 1)]
    step_fn = make_train_step(cfg, rc, total_steps=100)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        params, state, m = step_fn(params, state, batches[0], 0)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    card_peak = torch.cuda.max_memory_allocated()
    ms = []
    for i in range(1, DRY_CARD_TIMED + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        params, state, m = step_fn(params, state, batches[i], i)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    step_ms = sum(ms) / len(ms)
    roof = roofline.Roofline(
        arch, shape.name, "1 rank", 1, hlo_flops=dry["flops"],
        hlo_bytes=dry["bytes"], collective_bytes=0.0,
        model_flops_total=roofline.model_flops(cfg, shape),
        hbm_bytes=roofline.analytic_hbm_bytes(
            cfg, shape, 1, optimizer=optimizer, microbatches=mb, tp=1))
    print(f"32(c) {arch} at {layers} layers, {optimizer}, batch {batch} x "
          f"{seq} in {mb} microbatches: dry run (one rank, trace "
          f"{dry['trace_s']!r} s) {dry['flops']!r} FLOPs, "
          f"{dry['bytes']!r} bytes accessed, temp "
          f"{dry['memory']['temp_size_in_bytes']} B; FlopCounterMode over "
          f"one real step on the card {real_flops!r} FLOPs; equal "
          f"{dry['flops'] == real_flops}")
    mem = dry["memory"]
    dry_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"32(c) memory: dry run argument {mem['argument_size_in_bytes']} "
          f"B + temp {mem['temp_size_in_bytes']} B = {dry_peak} B; the "
          f"card's step: held {held} B before it (parameters, optimizer "
          f"state, {len(batches)} batches), max_memory_allocated "
          f"{card_peak} B during it, {card_peak - held} B above what it "
          f"held; dry / card peak {dry_peak / card_peak:.3f}")
    print(f"32(c) Roofline of the dry run's counts (launch/roofline.py): "
          f"compute {roof.compute_s!r} s, memory {roof.memory_s!r} s "
          f"(analytic; counted bytes give {roof.memory_s_xla!r} s), "
          f"bottleneck {roof.bottleneck}, bound {roof.step_time_s * 1e3!r} "
          f"ms/step against {step_ms!r} ms/step measured (CUDA events, "
          f"steps {ms!r}) = {roof.step_time_s * 1e3 / step_ms:.1%} of the "
          f"bound [{card}]")
    del params, state, batches, step_fn, m
    gc.collect()
    torch.cuda.empty_cache()
    if dry["flops"] != real_flops or real_flops <= 0:
        raise RuntimeError(f"32(c): the dry run counts {dry['flops']} FLOPs,"
                           f" the card's step {real_flops}")
    return {"dry_flops": dry["flops"], "step_ms": step_ms,
            "bound_ms": roof.step_time_s * 1e3, "dry_peak_bytes": dry_peak,
            "card_peak_bytes": card_peak}


def dryrun_phase(torch, card: str) -> dict:
    """Phase 32: the dry run's cells, the block report on the card, and
    the dry run's count against a real step (see the module docstring)."""
    t0 = time.perf_counter()
    cells = dry_cells(card)
    block = block_report(torch, card)
    versus = dry_vs_card(torch, card)
    print(f"dryrun: phase 32 took {time.perf_counter() - t0:.1f} s")
    return {"cells": cells, "block": block, "versus": versus}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--sweep-rank"]:
        return sweep_rank_worker()
    sys.path.insert(0, os.path.join(HERE, "src"))
    if sys.argv[1:] == ["--mla"]:
        mla_kernels = mla_phase(torch, card_line())
        print(json.dumps({"kernels": mla_kernels}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--moe"]:
        moe_kernels = moe_phase(torch, card_line())
        print(json.dumps({"kernels": moe_kernels}))
        print(card_line())
        return 0
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
    from repro_torch.models import (forward, init, n_periods, period_slots,
                                    route_trace)
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
    step_shapes = {}
    for _, k, n, cnt in projection_calls(cfg, period_slots, n_periods):
        step_shapes[(k, n)] = step_shapes.get((k, n), 0) + cnt
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
    ft = time_flash(torch, ops, fa_mod, H, KV, dh)
    flash_ms, flash_dev_ms = ft["ms"], ft["device_ms"]
    flash_plain_ms, flash_lib_ms = ft["plain_ms"], ft["library_ms"]
    flash_lib_dev_ms = ft["library_device_ms"]
    flash_ops_ms, flash_bytes_ms = ft["ops_ms"], ft["bytes_ms"]
    flash_bound_ms = ft["bound_ms"]
    print(f"flash_attention timing at (1, {PREFILL}, {H}/{KV}, {dh}) bf16 "
          f"causal (one prefill layer): {ft['line']}; per {L}-layer forward "
          f"{L * flash_ms!r} ms [{card}]")

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
    # the paged design at the engine cells' attention
    prows = check_paged(torch, ops, da_mod)
    for r in prows:
        print(f"paged_decode_attention (b, S, bs, H, KV, d, window) = "
              f"{r['case']}, ragged lengths, design {r['design']}: max|d|="
              f"{r['max_abs_err']!r}, max |d|/bound={r['worst']!r} "
              f"{'ok' if r['ok'] else 'FAIL'}")
    if not all(r["ok"] and r["design"] == "paged" for r in prows):
        raise RuntimeError(f"paged_decode_attention disagrees with its plain "
                           f"version ({ATTN_TOL_DOC}) or ran another design: "
                           f"{[r for r in prows if not r['ok']]}")
    paged_times = {}
    for case in PAGED_CASES:
        for full in (False, True):
            t = paged_times[case, full] = time_paged(torch, da_mod, case,
                                                     full)
            print(f"{t['line']} [{card}]")

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

    trace_steps(torch, gated, prompt, "gated", card)

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

    bitwise = graphed_vs_eager(torch, gated, prompt, 5)
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
    trace_steps(torch, kv_sess, prompt, "int8-KV gated", card)
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
        trace_steps(torch, sess, prompt, f"{precision} gated", card)
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
    reset_counts(da_mod.paged_decode_attention)
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
    # its main path: every attention layer of every step (a replay, or a
    # capture's warm-up) on the paged design, no strip gathered
    cb_paged = dict(da_mod.paged_decode_attention.launches_by_design)
    cb_paged_expected = (cb_all["steps"] + new_caps) * L
    print(f"engine, all at once: paged_decode_attention launches "
          f"{da_mod.paged_decode_attention.launches} by design {cb_paged} "
          f"(expected ({cb_all['steps']} steps + {new_caps} captures) x {L} "
          f"attention layers = {cb_paged_expected})")
    if cb_paged != {"paged": cb_paged_expected} or (
            da_mod.paged_decode_attention.launches != cb_paged_expected):
        raise RuntimeError(f"the engine launched the paged kernel "
                           f"{cb_paged}, expected {cb_paged_expected}")

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
    paged_before = da_mod.paged_decode_attention.launches
    cb_kv, kv_streams, _ = cb_run(kv_eng, cb_requests(), None,
                                  "int8 KV cache, all at once")
    if da_mod.paged_decode_attention.launches != paged_before:
        raise RuntimeError("the int8 KV pool reached the paged kernel: it "
                           "takes decode_attend")
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

    fam_kernels = families(torch, card)     # phases 18-28
    paper_run = paper_phase(torch, card)    # phase 29
    train_phase(torch, card)                # phase 30
    dist_run = distributed_phase(torch, card, entries, golden, golden_spec,
                                 golden_front)      # phase 31
    dry_run = dryrun_phase(torch, card)             # phase 32
    mla_kernels = mla_phase(torch, card)            # phase 33
    moe_kernels = moe_phase(torch, card)            # phase 34

    # --- 35. result lines ----------------------------------------------------
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
                f"decode_32k); launches: one call of the TPU contract's "
                f"public wrapper ops.decode_attention (the engine's steps "
                f"run the paged design, the next entries)"}]
    for case in PAGED_CASES:
        t = paged_times[case, False]
        kernels.append({
            "name": "paged_decode_attention", "route": "cuda",
            "path": "ops.paged_decode_attention in the engine's decode step",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "none: the engine's decode attention, which the JAX "
                        "package leaves to XLA (models/attention.py:"
                        "decode_attend over the gathered strips)",
            "launches": (cb_paged["paged"] if case[3] == cfg.n_heads
                         else None),
            "max_abs_err": max(r["max_abs_err"] for r in prows
                               if r["case"][:6] == case),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "full_length": {k: paged_times[case, True][k] for k in (
                "ms", "device_ms", "bound_ms", "plain_ms", "library_ms")},
            "design": "paged",
            "work": f"one call at (b, S, bs, H, KV, d) = {case} bf16, "
                    f"ragged lengths ({t['valid_positions']} valid "
                    f"positions; full_length: every slot at S)"
                    + (f"; launches counted over phase 16 (a)'s engine run "
                       f"({L} per step)" if case[3] == cfg.n_heads else
                       "; launches: the qwen2-moe-a2.7b continuous "
                       "batching entry (phase 21)")})
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
                f"served on the card)"}, {
        "name": "sweep_eval", "route": "cuda",
        "path": "paper experiments",
        "source": "src/repro_torch/kernels/csrc/sweep_eval.cu",
        "replaces": "src/repro/kernels/sweep_eval.py:58",
        "launches": paper_run["launches"],
        "max_abs_err": 0.0,
        "ms": sweep_ms, "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": ("bytes" if sweep_bytes_ms >= sweep_ops_ms
                     else "operations"),
        "library_ms": None,
        "work": f"phase 6's launch on {n_big} rows (times and bound); "
                f"launches counted over launch/paper.py's seven artefacts "
                f"with backend='pallas' (Figs. 9-13 scored on the card, "
                f"{paper_run['wall_s']!r} s for all seven)"}]
    kernels += [{
        "name": "sweep_eval", "route": "cuda", "path": "row-sharded sweep",
        "source": "src/repro_torch/kernels/csrc/sweep_eval.cu",
        "replaces": "src/repro/kernels/sweep_eval.py:58",
        "launches": dist_run["world1_launches"] + dist_run["gloo_launches"],
        "launches_world1_nccl": dist_run["world1_launches"],
        "launches_gloo_ranks": dist_run["gloo_launches"],
        "max_abs_err": 0.0,
        "ms": sweep_ms, "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": ("bytes" if sweep_bytes_ms >= sweep_ops_ms
                     else "operations"),
        "library_ms": None,
        "work": f"phase 6's launch on {n_big} rows (times and bound); "
                f"launches counted over phase 31: the golden plan "
                f"(pallas) and campaign through distributed_engine("
                f"chunk_rows={DIST_CHUNK_ROWS}) at a world of 1 under NCCL, "
                f"plus both gloo ranks' shards of the golden plan"}]
    kernels += fam_kernels
    kernels.append(dry_run["block"])
    kernels += mla_kernels + moe_kernels
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
