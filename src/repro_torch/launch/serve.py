"""Serving CLI: batched generation with KV caches, on the card (the port
of the JAX package's `repro/launch/serve.py`, same flags, defaults and
JSON report keys).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --smoke --batch 4 --prompt-len 16 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --smoke --batch 8 --quantize

--arch takes every family (qwen2-7b, qwen2-moe-a2.7b, mamba2-780m,
jamba-1.5-large-398b, musicgen-large, llama-3.2-vision-90b, ...).  An
audio arch serves (batch, prompt-len, n_codebooks) prompts; a vlm arch
holds its n_image_tokens of image K/V per cross slot (never filled, as
in the JAX package), and its traffic mode is refused by the engine, as
the JAX package's is.

--quantize runs the planner-gated INT8 session (verdicts routed into the
decode step, which runs as one CUDA graph) and reports the per-label
route report plus gated-vs-ungated steady decode tokens/s.

--requests N switches to the continuous-batching traffic mode: N
synthetic ragged requests (seeded by --seed, so runs are reproducible)
arrive as an open-loop Poisson process at --arrival-rate req/s and are
served by the slot-scheduled, paged-KV request engine
(repro_torch.serving.ContinuousBatchingEngine); the report carries
per-request TTFT / queue wait / tokens/s plus engine-level queue depth,
slot occupancy, KV-block usage and eviction counts.

--adaptive (traffic mode, implies --quantize) puts the shape-bucketed
plan service (repro_torch.core.plan_service) beside the engine: every
step the live (active slots, max position) point is bucketed, and a
verdict change hot-swaps the decode plan between captured variants.
--bucket-edges overrides the lattice ("b1,b2,..:l1,l2,.."); --refresh-
every N re-plans a bucket in the background after every N lookups.

The report is printed as JSON (`launch/report.py` renders its engine
telemetry).  The run is on the card; --device cpu runs it on the CPU
(the one flag the JAX package's CLI lacks).  In a multi-process group
(`launch.distributed.initialize`, REPRO_* env vars) the fixed-batch
report adds a "distributed" block (`distributed_info()`: which rank
printed it, and the topology) beside the per-rank cache counters, as the
JAX package's does.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import ARCHS, RunConfig, reduced
from ..models import init
from ..serving import (CIM_ROUTE, ContinuousBatchingEngine, DecodeCore,
                       ServeSession, cim_fraction, poisson_arrivals,
                       synthetic_requests)
from ..serving.core import token_shape
from . import distributed as dist


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def block_size_error(block_size: int, device, kv_cache_dtype: str) -> str:
    """Why traffic mode refuses `--block-size` on `device`, or "": a bf16
    block pool on the card is read by the paged decode kernel, whose
    blocks hold a multiple of PAGED_ROWS rows (other caches keep
    `decode_attend`, which takes any block size)."""
    from ..kernels.paged import PAGED_ROWS
    if (torch.device(device).type != "cuda" or kv_cache_dtype != "bfloat16"
            or block_size % PAGED_ROWS == 0):
        return ""
    return (f"--block-size {block_size}: a bfloat16 KV cache on the card is "
            f"read by the paged decode kernel, whose blocks hold a multiple "
            f"of {PAGED_ROWS} rows")


def steady_decode_tokens_per_s(sessions, prompt, n_tokens: int,
                               repeats: int = 3,
                               warmup: int = 0) -> list[float]:
    """Steady-state decode throughput per session, best of `repeats`
    timed samples of `n_tokens` decode steps each.

    Each session's prefill captures its step (on a CUDA core) and fills
    the cache, so every timed token is a pure decode step; `warmup`
    extra untimed decode steps per session soak residual first-call
    costs.  Samples alternate across the sessions so transient
    contention degrades all of them alike.  Each sample ends in a device
    synchronize (host clock around synchronized work)."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    for s in sessions:
        s.reset()
        s.prefill(prompt)
    tok = torch.zeros(token_shape(sessions[0].cfg, prompt.shape[0]),
                      dtype=torch.long, device=sessions[0].device)

    def sample(s, n):
        _sync(s.device)
        t0 = time.perf_counter()
        for _ in range(n):
            _, s.cache = s.core.step(s.cache, tok, s.pos)
        _sync(s.device)
        return time.perf_counter() - t0

    if warmup:
        for s in sessions:
            sample(s, warmup)
    best = [float("inf")] * len(sessions)
    for _ in range(repeats):
        for i, s in enumerate(sessions):
            best[i] = min(best[i], sample(s, n_tokens))
    return [prompt.shape[0] * n_tokens / b for b in best]


def run_traffic(cfg, rc, params, args) -> dict:
    """Continuous-batching traffic mode: synthetic open-loop arrivals
    through the slot-scheduled paged-KV engine (optionally with the
    shape-bucketed adaptive plan service); returns the serve report."""
    from ..core.plan_service import BucketLattice, PlanService
    quantize = args.quantize or args.adaptive
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 1)
    core = DecodeCore(cfg, rc, params, quantize=quantize,
                      plan_batch=args.slots, plan_max_len=max_len,
                      device=args.device)
    service = None
    if args.adaptive:
        lattice = (BucketLattice.parse(args.bucket_edges)
                   if args.bucket_edges
                   else BucketLattice.for_engine(args.slots, max_len))
        service = PlanService(cfg, lattice,
                              refresh_every=args.refresh_every,
                              device=args.device)
    engine = ContinuousBatchingEngine(
        core, n_slots=args.slots, max_len=max_len,
        block_size=args.block_size, n_kv_blocks=args.kv_blocks,
        seed=args.seed, plan_service=service)
    reqs = synthetic_requests(
        cfg, args.requests, seed=args.seed,
        prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
        new_tokens=(max(1, args.new_tokens // 2), args.new_tokens),
        temperature=args.temperature)
    arrivals = poisson_arrivals(args.requests, args.arrival_rate,
                                seed=args.seed)
    telemetry = engine.run(reqs, arrivals)
    if service is not None:
        service.drain()              # settle background refreshes
        telemetry["adaptive"] = engine._adaptive_telemetry()
    report = {
        "arch": cfg.name,
        "mode": "continuous-batching",
        "requests": args.requests,
        "arrival_rate_req_per_s": args.arrival_rate,
        "seed": args.seed,
        "adaptive": args.adaptive,
        "traffic": telemetry,
        "planner_cache": core.plan_cache_telemetry,
    }
    if quantize:
        routes = core.route_report(args.slots, engine.max_len)
        report["gating"] = {
            "routes": routes,
            "cim_routed": sum(r["route"] == CIM_ROUTE
                              for r in routes.values()),
            "cim_routed_fraction": cim_fraction(routes),
        }
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a model: fixed-batch demo (default) or "
                    "continuous-batching synthetic traffic "
                    "(--requests N).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt length (traffic mode: the max of the "
                         "ragged range [prompt-len/2, prompt-len])")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="tokens to generate (traffic mode: the max of "
                         "the ragged range [new-tokens/2, new-tokens])")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-cache-dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds weights AND the synthetic traffic "
                         "(request shapes, arrival process, sampling) — "
                         "same seed, same run")
    ap.add_argument("--quantize", action="store_true",
                    help="INT8 weights + planner-gated kernel routing "
                         "inside the decode step")
    # --- continuous-batching traffic mode ---
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic traffic mode: number of requests to "
                         "serve through the continuous-batching engine "
                         "(0 = legacy fixed-batch demo)")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="open-loop Poisson arrival rate in requests/s "
                         "(0 = all requests arrive at t=0)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (the fixed batch size the "
                         "scheduler packs requests into)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged-KV block size in tokens (on the card "
                         "a multiple of 8 with a bfloat16 KV cache)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="KV pool capacity in blocks (default: full "
                         "provisioning, slots * ceil(max-len/block-"
                         "size))")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request length cap in traffic mode "
                         "(0 = prompt-len + new-tokens + 1)")
    ap.add_argument("--adaptive", action="store_true",
                    help="traffic mode: consult the shape-bucketed plan "
                         "service each step and hot-swap the decode plan "
                         "on verdict flips (implies --quantize)")
    ap.add_argument("--bucket-edges", default="",
                    help="adaptive bucket lattice as 'b1,b2,..:l1,l2,..' "
                         "(batch edges : length edges; empty = power-of-"
                         "two edges over slots x max-len)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="adaptive: background re-plan a bucket after "
                         "every N lookups (0 = never refresh)")
    ap.add_argument("--device", default="cuda",
                    help="where to run: the card, or 'cpu'")
    args = ap.parse_args(argv)
    if args.adaptive and args.requests <= 0:
        ap.error("--adaptive needs traffic mode (--requests N)")
    refusal = block_size_error(args.block_size, args.device,
                               args.kv_cache_dtype)
    if args.requests > 0 and refusal:
        ap.error(refusal)

    dist.initialize(device=args.device)      # no-op when unconfigured
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    rc = RunConfig(attn_impl="naive", remat=False,
                   kv_cache_dtype=args.kv_cache_dtype)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init(gen, cfg, device=args.device)
    if args.requests > 0:
        print(json.dumps(run_traffic(cfg, rc, params, args), indent=1))
        return
    nimg = cfg.vision.n_image_tokens if cfg.family == "vlm" else 0
    max_len = args.prompt_len + args.new_tokens + 1
    sess = ServeSession(cfg, rc, params, max_len=max_len,
                        batch=args.batch, n_image_tokens=nimg,
                        quantize=args.quantize, device=args.device)
    shape = token_shape(cfg, args.batch)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len)
                           + shape[2:], generator=gen, device=args.device)
    _sync(args.device)
    t0 = time.perf_counter()
    out = sess.generate(prompt, n_new=args.new_tokens,
                        temperature=args.temperature, seed=args.seed)
    _sync(args.device)
    dt = time.perf_counter() - t0
    plan = sess.kernel_plan
    report = {
        "arch": cfg.name, "generated_shape": list(out.shape),
        "tokens_per_s": args.batch * args.new_tokens / dt,
        "sample_row": [int(x) for x in out[0].reshape(-1)[:16].tolist()],
        # what/when/where gates + the sweep engine's plan-cache telemetry
        "kernel_plan": {lab: bool(d.use_cim) for lab, d in plan.items()},
        "planner_cache": sess.plan_cache_telemetry,
    }
    info = dist.distributed_info()
    if info["processes"] > 1:
        # a multi-process run: record which rank printed this report and
        # the topology next to its cache counters
        report["distributed"] = info
    if args.quantize:
        # per-label routes + gated-vs-ungated decode throughput: the
        # ungated session keeps the same INT8 weights, so the steady
        # delta is the verdict-driven kernel routing (both sessions are
        # warmed: the capture is excluded)
        routes = sess.route_report()
        ungated = ServeSession(cfg, rc, sess.params, max_len=max_len,
                               batch=args.batch, n_image_tokens=nimg,
                               quantize=True, gated=False,
                               device=args.device)
        tps_g, tps_u = steady_decode_tokens_per_s(
            (sess, ungated), prompt, args.new_tokens)
        report["gating"] = {
            "routes": routes,
            "cim_routed": sum(r["route"] == CIM_ROUTE
                              for r in routes.values()),
            "cim_routed_fraction": cim_fraction(routes),
            "tokens_per_s_gated": tps_g,
            "tokens_per_s_ungated": tps_u,
        }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
