"""Multi-pod dry run (deliverable e) on torch: every (arch x input-shape
x mesh) cell traced on the production meshes — 16x16 single pod and
2x16x16 multi-pod — with no storage and no card (the port of the JAX
package's `launch/dryrun.py`, under its names, CLI flags and JSON keys).

The JAX package lowers and compiles the step on 512 placeholder host
devices and reads XLA's memory and cost analyses.  The port runs the
same step once, in one process, on a fake process group of 512 ranks
(`torch.testing`'s FakeStore, backend "fake": collectives return at once
and move nothing): parameters, optimizer state, batch and cache are
"meta" DTensors placed by `sharding.rules` (`param_specs`, `batch_specs`,
`cache_specs`, `to_named`), and DTensor partitions each op.  The model's
redistribution points (`sharding.constraints`) stand where GSPMD needed
none: the FSDP all-gather of each layer's weights, heads over "model"
where they divide it (else the projection replicated over it), and the
JAX package's q/k/v and residual constraints under the same RunConfig
fields.  `launch.trace_analysis.StepRecorder` watches rank 0's local ops:

* FLOPs and bytes accessed, per rank (on its local shards);
* collective bytes by type, per rank (`collective_stats`);
* memory: argument and output bytes are the local shard bytes of the
  step's inputs and outputs (outputs placed as the JAX package's
  out_shardings place them); temp bytes are the peak of live
  intermediates over the trace (a dispatch mode tracking each storage a
  local op creates; `MemTracker` was not used);
* the roofline (`launch.roofline.Roofline`, the H100's rates) from those
  counts and the analytic `model_flops` / `analytic_hbm_bytes`.

The port's layer loop is a Python loop, so one traced pass counts every
layer: the JAX package's partial-unroll compiles and their extrapolation
work around XLA counting a scanned body once and have no counterpart
("unroll_points" is []; `--fast` skips nothing and is kept so the JAX
package's command lines run).  Train cells run under autograd, the
others under `torch.no_grad` (inference-mode tensors cannot become
DTensors).  Decode cells also record the planner's verdicts, the sweep
cache's telemetry and the routes of the plan-gated step
(`serving.decode_routes`); their planner runs on the CPU sweep engine,
as the JAX package's dry run plans on its host: the dry run needs no
card at all.

`--all` traces each cell in a process of its own (DTensor's dispatch
cache outlives a cell).  Importing this module initializes nothing;
`lower_cell` creates the fake group when no default group exists and
refuses a real one (NCCL, gloo): a dry run must not issue a real
collective.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \\
      --mesh single --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, RunConfig
from ..configs.base import ModelConfig, ShapeConfig
from ..models import forward
from ..optim import make_optimizer
from ..serving.engine import make_serve_step
from ..sharding.constraints import record_redistributions
from ..sharding.rules import (P, batch_specs, cache_specs, param_specs,
                              to_named, to_placements)
from ..train.loop import make_train_step
from . import specs as S
from .mesh import make_production_mesh, single_pod_mesh_from
from .roofline import Roofline, analytic_hbm_bytes, model_flops
from .trace_analysis import StepRecorder, collective_stats, op_census

WORLD = 512          # the JAX package's placeholder host device count


def run_config_for(cfg: ModelConfig, shape: ShapeConfig,
                   overrides: dict | None = None) -> RunConfig:
    """Per-cell runtime policy (recorded in the cell JSON)."""
    params = cfg.param_count()
    opt = "adafactor" if params > 100e9 else "adamw"
    micro = 4 if (shape.kind == "train" and cfg.d_model >= 5120) else 1
    # int8 KV cache when a bf16 cache would not fit per-device HBM
    kv_dtype = "bfloat16"
    if shape.kind == "decode":
        n_attn = (cfg.n_layers // cfg.attn_every
                  if cfg.family == "hybrid" else cfg.n_layers)
        if cfg.family == "ssm":
            n_attn = 0
        cache_bytes = (2 * n_attn * shape.global_batch * shape.seq_len
                       * cfg.n_kv_heads * cfg.head_dim() * 2)
        if cache_bytes / 256 > 6e9:
            kv_dtype = "int8"
    rc = RunConfig(optimizer=opt, microbatches=micro, remat=True,
                   fsdp=True, kv_cache_dtype=kv_dtype,
                   attn_impl="flash_jnp", attn_chunk=2048)
    if overrides:
        rc = dataclasses.replace(rc, **overrides)
    return rc


def fake_group() -> None:
    """Make the default process group a fake one of WORLD ranks, unless
    a fake group of at least that size is already the default.  Raises
    when a real group (NCCL, gloo) is the default group."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"the default process group is a real one ({backend}); the "
                f"dry run traces on a fake group: destroy it first")
        if dist.get_world_size() < WORLD:
            raise RuntimeError(f"the fake group has "
                               f"{dist.get_world_size()} ranks, the dry "
                               f"run needs {WORLD}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


_MESHES: dict = {}


def _mesh(kind: str):
    """(mesh, chips): the 2x16x16 production mesh over all 512 ranks, or
    the 16x16 single pod over the first 256 (one of each per group)."""
    key = (id(dist.group.WORLD), kind)
    if key not in _MESHES:
        _MESHES[key] = ((make_production_mesh(multi_pod=True), 512)
                        if kind == "multi" else
                        (single_pod_mesh_from(range(dist.get_world_size())),
                         256))
    return _MESHES[key]


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _stand_in(t: torch.Tensor, named):
    """A meta DTensor of t's global shape and dtype, placed as `named`
    says: its local tensor is this rank's shard, on "meta"."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local_shape, _ = compute_local_shape_and_global_offset(
        t.shape, named.mesh, named.placements)
    local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, named.mesh, named.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _stand_ins(mesh, specs, shapes):
    return _zip_map(_stand_in, shapes, to_named(mesh, specs, shapes))


def _replicated(mesh, t):
    return _stand_in(t, to_named(mesh, P(*([None] * t.ndim))))


def _place(t, mesh, spec=None):
    """Redistribute a step output as the JAX package's out_shardings
    place it: replicated (None), or by a PartitionSpec."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    pl = (to_placements(spec, mesh) if spec is not None
          else (Replicate(),) * mesh.ndim)
    return t.redistribute(mesh, pl)


def _build(cfg: ModelConfig, shape: ShapeConfig, mesh, rc: RunConfig):
    """(run, args): `run()` runs the cell's step once on `args`, the
    meta DTensor stand-ins, and returns its outputs placed as the JAX
    package's out_shardings place them."""
    pshapes = S.param_shapes(cfg)
    params = _stand_ins(mesh, param_specs(pshapes, cfg, rc), pshapes)

    if shape.kind == "train":
        opt_init, _ = make_optimizer(rc.optimizer, rc.weight_decay)
        oshapes = opt_init(pshapes)
        opt = _stand_ins(mesh, param_specs(oshapes, cfg, rc), oshapes)
        binput = S.train_input_specs(cfg, shape)
        batch = _stand_ins(mesh, batch_specs(binput, mesh), binput)
        step_no = _replicated(mesh, S.sds((), torch.int32))
        step = make_train_step(cfg, rc)

        def run():
            p, o, metrics = step(params, opt, batch, step_no)
            return p, o, {k: _place(v, mesh) for k, v in metrics.items()}
        return run, (params, opt, batch, step_no)
    if shape.kind == "prefill":
        binput = S.prefill_input_specs(cfg, shape)
        batch = _stand_ins(mesh, batch_specs(binput, mesh), binput)
        spec = None
        if rc.shard_loss:
            # served logits stay batch+vocab sharded (the JAX package's
            # out_shardings under shard_loss)
            ba = tuple(a for a in rc.batch_axes.split(",") if a)
            ba = ba if len(ba) > 1 else ba[0]
            spec = (P(ba, None, None, "model") if cfg.family == "audio"
                    else P(ba, None, "model"))

        def run():
            with torch.no_grad():
                logits, _ = forward(params, batch["tokens"], cfg, rc,
                                    image_embeds=batch.get("image_embeds"))
            return _place(logits, mesh, spec)
        return run, (params, batch)
    dins = S.decode_input_specs(cfg, rc, shape)
    cache = _stand_ins(mesh, cache_specs(dins["cache"], mesh, cfg),
                       dins["cache"])
    tokens = _stand_ins(mesh, batch_specs({"t": dins["tokens"]}, mesh),
                        {"t": dins["tokens"]})["t"]
    pos = _replicated(mesh, dins["pos"])
    step = make_serve_step(cfg, rc)

    def run():
        with torch.no_grad():
            logits, new_cache = step(params, cache, tokens, pos)
        return _place(logits, mesh), new_cache
    return run, (params, cache, tokens, pos)


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rc: RunConfig) -> dict:
    """Run one cell's step on meta DTensors over `mesh` and count what
    this rank does: {"flops", "bytes", "collectives" (collective_stats),
    "op_census", "memory" (argument / output / temp bytes),
    "redistributions" ({"point: placements": count}), "lower_s",
    "trace_s"}.  The per-rank accounting of `lower_cell`, for any mesh
    (a mesh of one rank counts what one card runs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    run, args = _build(cfg, shape, mesh, rc)
    t_build = time.perf_counter() - t0
    recorder = StepRecorder()
    recorder.exclude(args)
    t1 = time.perf_counter()
    with implicit_replication(), record_redistributions() as points, \
            recorder:
        out = run()
    t_trace = time.perf_counter() - t1
    records = recorder.records
    return {
        "flops": float(recorder.flops),
        "bytes": float(recorder.bytes_accessed),
        "collectives": collective_stats(records),
        "op_census": op_census(records),
        "memory": {"argument_size_in_bytes": _local_bytes(args),
                   "output_size_in_bytes": _local_bytes(out),
                   "temp_size_in_bytes": int(recorder.peak_temp_bytes)},
        "redistributions": dict(collections.Counter(
            f"{p['point']}: {p['placements']}" for p in points)),
        "lower_s": t_build, "trace_s": t_trace,
    }


def _planner_telemetry(cfg: ModelConfig, shape: ShapeConfig,
                       rc: RunConfig) -> dict:
    """What/when/where verdict summary + sweep-cache telemetry + executed
    kernel routes for a decode cell (the JAX package's block): the
    serving engine consults the same batched planner on every plan build,
    so the hit/miss delta recorded here is what production traffic over
    this cell's shapes would see.  The routes block runs the plan-gated
    quantized decode step on "meta" (serving.decode_routes) and records
    which projections take the CiM INT8 kernel and which the plain
    matmul."""
    from ..core.llm_workloads import gemms_of_model
    from ..core.planner import plan_workload, summarize
    from ..core.sweep import default_engine, measured_cache_delta
    from ..quant import KernelPlanTable
    from ..serving import cim_fraction, decode_routes
    engine = default_engine("cpu")
    decisions, tel = measured_cache_delta(
        lambda: plan_workload(gemms_of_model(cfg, shape),
                              backend="vectorized", engine=engine),
        engine)
    table = KernelPlanTable.from_decisions(decisions, model_name=cfg.name)
    nimg = cfg.vision.n_image_tokens if cfg.family == "vlm" else 0
    routes = decode_routes(cfg, rc, table, batch=shape.global_batch,
                           max_len=shape.seq_len, n_image_tokens=nimg)
    return {"summary": summarize(decisions),
            "plan_hits": tel["plan_hits"],
            "plan_misses": tel["plan_misses"],
            "cache": tel["engine"],
            "routes": routes,
            "cim_routed_fraction": cim_fraction(routes)}


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               rc_overrides: dict | None = None,
               skip_cost_passes: bool = False) -> dict:
    """Trace one cell on its production mesh and return its JSON record.
    `skip_cost_passes` is accepted for the JAX package's signature and
    skips nothing (one traced pass counts every layer)."""
    del skip_cost_passes
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if not S.cell_is_runnable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §5)"}
    fake_group()
    mesh, chips = _mesh(mesh_kind)
    rc = run_config_for(cfg, shape, rc_overrides)
    counts = trace_step(cfg, shape, mesh, rc)
    coll = counts["collectives"]
    rf = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops=counts["flops"], hlo_bytes=counts["bytes"],
        collective_bytes=coll["collective_bytes"],
        model_flops_total=model_flops(cfg, shape),
        hbm_bytes=analytic_hbm_bytes(
            cfg, shape, chips, optimizer=rc.optimizer,
            microbatches=rc.microbatches,
            kv_cache_bytes_per_el=1 if rc.kv_cache_dtype == "int8" else 2))
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "chips": chips,
        "run_config": {"optimizer": rc.optimizer,
                       "microbatches": rc.microbatches,
                       "kv_cache_dtype": rc.kv_cache_dtype,
                       "fsdp": rc.fsdp, **(rc_overrides or {})},
        # no compile: the traced step takes its place
        "lower_s": round(counts["lower_s"], 1),
        "compile_s": round(counts["trace_s"], 1),
        "trace_s": counts["trace_s"],
        "cost_pass_s": 0.0,
        "unroll_points": [],
        "memory_analysis": counts["memory"],
        "cost_analysis": {"flops": counts["flops"],
                          "bytes_accessed": counts["bytes"]},
        "collectives": {"collective_bytes": coll["collective_bytes"],
                        "by_type_at_last_unroll": coll["by_type"]},
        "op_census": counts["op_census"],
        "redistributions": counts["redistributions"],
        "roofline": rf.row(),
    }
    if shape.kind == "decode":
        res["planner"] = _planner_telemetry(cfg, shape, rc)
    return res


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="kept for the JAX package's command lines; skips "
                         "nothing (one traced pass counts every layer)")
    ap.add_argument("--rc", default="",
                    help="JSON RunConfig overrides (perf iterations)")
    ap.add_argument("--tag", default="", help="suffix for variant runs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.rc) if args.rc else None

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = (["single", "multi"] if args.all else [args.mesh])
    for arch, shape in cells:
        for mesh_kind in meshes:
            tag = f"-{args.tag}" if args.tag else ""
            path = os.path.join(args.out,
                                f"{arch}.{shape}.{mesh_kind}{tag}.json")
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {path}")
                continue
            if len(cells) * len(meshes) > 1:
                # one process per cell: DTensor's dispatch cache can hand
                # a cell an op's output spec from an earlier cell (torch
                # 2.13 keys topk without its k)
                subprocess.run([sys.executable, "-m",
                                "repro_torch.launch.dryrun", "--arch", arch,
                                "--shape", shape, "--mesh", mesh_kind,
                                "--out", args.out, "--force", "--rc",
                                args.rc, "--tag", args.tag], check=False)
                continue
            print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...",
                  flush=True)
            try:
                res = lower_cell(arch, shape, mesh_kind, overrides,
                                 skip_cost_passes=args.fast)
            except Exception as e:       # record the failure, keep going
                res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            status = res["status"]
            extra = ""
            if status == "ok":
                r = res["roofline"]
                extra = (f" bottleneck={r['bottleneck']}"
                         f" frac={r['roofline_fraction']:.3f}"
                         f" trace={res['trace_s']:.1f}s")
            print(f"[done] {arch} x {shape} x {mesh_kind}: "
                  f"{status}{extra}", flush=True)


if __name__ == "__main__":
    main()
