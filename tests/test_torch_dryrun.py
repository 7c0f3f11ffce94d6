"""The port's dry run, its trace analysis and `decode_routes`, on the CPU.

* `launch.trace_analysis.collective_stats`: the three collectives of
  tests/test_dryrun_cell.py:16-21 (all-gather bf16[16,4096], all-reduce
  f32[128], collective-permute f32[2,2]) issued on a fake group of 16
  ranks give the JAX package's `by_type` and `collective_bytes` for its
  HLO text, and `op_census` counts the local ops;
* `run_config_for` equal to the JAX package's on every ARCHS x SHAPES
  pair (the JAX module sets XLA_FLAGS when imported, so it is read in a
  subprocess);
* `serving.decode_routes` and `cim_fraction` equal to
  `repro.serving.decode_routes` on the reduced config of every family,
  under one plan table with both routes in it;
* mamba2-780m x decode_32k x single through the port's CLI: status ok,
  256 chips, a bottleneck named, every planner assertion of
  tests/test_dryrun_cell.py:88-95, the planner summary and routes equal
  to the JAX package's (through `repro.core.planner` and
  `repro.serving.decode_routes`), and the per-rank argument bytes equal
  to the JAX package's 72,762,080 B less the 4-byte `pos`, which the SSM
  step never reads (XLA drops the unused argument; PERF.md);
* qwen2-7b x prefill_32k x single traces (28 heads on a 16-way "model"
  axis: q and kv replicated over it);
* the dry run's per-rank accounting at a mesh of one rank counts the
  FLOPs `FlopCounterMode` counts over the same train step run for real
  on the CPU (what the smoke's phase 32 (c) holds on the card);
* at a reduced qwen2-7b train cell, the per-rank FLOPs on fake meshes of
  2 data, 2 model and 2x2 ranks are the one-rank count over the ranks
  (every matmul, recompute included, is split; none runs on a partial
  input it should have reduced);
* the output of a collective counts toward the peak of live temps;
* over DTensors on four gloo ranks (a 2x2 mesh, vocab over "model"), the
  loss's redistribution points (`logsumexp`, `pick_last`, `grad_placed`)
  give the plain loss and its gradient;
* with plain tensors every redistribution point of
  `sharding.constraints` returns its input, or the plain op's result.

Each fake-group case runs in a subprocess (`python
tests/test_torch_dryrun.py <mode> <out>`): a fake default group would
outlive the test.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER_TIMEOUT = 300
FAMILY_ARCHS = ("qwen2-7b", "qwen2-moe-a2.7b", "mamba2-780m",
                "jamba-1.5-large-398b", "llama-3.2-vision-90b",
                "musicgen-large")
REF_HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(%x), dimensions={0}
  %ar = f32[128]{0} all-reduce(%y), to_apply=%sum
  %cp = f32[2,2]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %dot = f32[4,4]{1,0} dot(%a, %b)
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _worker(mode: str, out, *extra) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                           str(out), *extra], env=_env(), cwd=REPO,
                          capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_collective_output_counts_toward_peak(tmp_path):
    got = _worker("collectives", tmp_path / "coll.json")
    # the all-gathered bf16[16, 4096] is the largest storage made inside
    assert got["peak_temp_bytes"] >= 16 * 4096 * 2


def test_collective_stats_matches_reference(tmp_path):
    from repro.launch.hlo_analysis import collective_stats as jstats
    got = _worker("collectives", tmp_path / "coll.json")
    want = jstats(REF_HLO)
    assert got["stats"] == json.loads(json.dumps(want))
    assert got["stats"]["collective_bytes"] == 16 * 4096 * 2 + 2 * 128 * 4 + 16
    assert got["census"]["dot"] == 1 and got["census"]["fusion"] == 0


def test_run_config_for_matches_reference(tmp_path):
    from repro_torch.configs import ARCHS, SHAPES
    got = _worker("runconfig", tmp_path / "rc.json")
    assert got["cells"] == len(ARCHS) * len(SHAPES) == 40
    assert got["mismatches"] == []


def _plan_tables(cfg, shape):
    """One plan table in each package, from the port's planner with every
    other label's gate flipped (so both routes occur)."""
    from repro.quant import KernelPlanTable as JTable
    from repro.quant.plan_table import PlanEntry as JEntry
    from repro_torch.core.llm_workloads import gemms_of_model
    from repro_torch.core.planner import plan_workload
    from repro_torch.quant import KernelPlanTable
    from repro_torch.quant.plan_table import PlanEntry
    table = KernelPlanTable.from_decisions(
        plan_workload(gemms_of_model(cfg, shape), device="cpu"),
        model_name=cfg.name)
    rows = [(lab, (not e.use_cim) if i % 2 else e.use_cim, e.what, e.where)
            for i, (lab, e) in enumerate(table.entries)]
    return (KernelPlanTable(tuple((lab, PlanEntry(u, w, wh))
                                  for lab, u, w, wh in rows)),
            JTable(tuple((lab, JEntry(u, w, wh)) for lab, u, w, wh in rows)))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_routes_match_reference(arch):
    from repro.configs import ARCHS as JARCHS
    from repro.configs import RunConfig as JRunConfig
    from repro.configs.base import reduced as jreduced
    from repro.serving import cim_fraction as jcim_fraction
    from repro.serving import decode_routes as jdecode_routes
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.serving import cim_fraction, decode_routes
    cfg, jcfg = reduced(ARCHS[arch]), jreduced(JARCHS[arch])
    shape = ShapeConfig("decode_small", 32, 4, "decode")
    table, jtable = _plan_tables(cfg, shape)
    nimg = cfg.vision.n_image_tokens if cfg.family == "vlm" else 0
    got = decode_routes(cfg, RunConfig(), table, batch=4, max_len=32,
                        n_image_tokens=nimg)
    want = jdecode_routes(jcfg, JRunConfig(), jtable, batch=4, max_len=32,
                          n_image_tokens=nimg)
    assert got == want and len(got) > 1
    assert cim_fraction(got) == jcim_fraction(want)
    assert 0.0 < cim_fraction(got) < 1.0 or cfg.family in ("moe", "audio")


def test_mamba2_decode_cell_through_cli(tmp_path):
    from repro.configs import ARCHS as JARCHS
    from repro.configs import SHAPES as JSHAPES
    from repro.core.llm_workloads import gemms_of_model as jgemms
    from repro.core.planner import plan_workload as jplan
    from repro.core.planner import summarize as jsummarize
    from repro.quant import KernelPlanTable as JTable
    from repro.serving import cim_fraction as jcim_fraction
    from repro.serving import decode_routes as jdecode_routes
    from repro_torch.launch.dryrun import run_config_for
    from repro_torch.configs import ARCHS, SHAPES
    arch, shape, mesh = "mamba2-780m", "decode_32k", "single"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--fast", "--out",
         str(tmp_path)], env=_env(), cwd=REPO, capture_output=True,
        text=True, timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.load(open(tmp_path / f"{arch}.{shape}.{mesh}.json"))
    assert out["status"] == "ok", out
    assert out["chips"] == 256 and out["unroll_points"] == []
    for key in ("memory_analysis", "cost_analysis", "collectives",
                "op_census", "roofline", "planner", "run_config"):
        assert key in out
    assert out["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert out["cost_analysis"]["flops"] > 0
    assert out["collectives"]["collective_bytes"] > 0
    p = out["planner"]
    assert p["summary"]["n_gemms"] > 0
    assert p["plan_hits"] + p["plan_misses"] > 0
    assert p["cache"]["size"] > 0
    assert p["cache"]["backends"]["vectorized"]["misses"] > 0
    assert "pallas_fallback" in p["cache"]
    # the JAX package's planner and routes, computed without its dry run
    jcfg, jshape = JARCHS[arch], JSHAPES[shape]
    decisions = jplan(jgemms(jcfg, jshape), backend="vectorized")
    assert p["summary"] == json.loads(json.dumps(jsummarize(decisions)))
    rc = run_config_for(ARCHS[arch], SHAPES[shape])
    from repro.configs import RunConfig as JRunConfig
    jrc = JRunConfig(**dataclasses.asdict(rc))
    routes = jdecode_routes(jcfg, jrc, JTable.from_decisions(
        decisions, model_name=jcfg.name), batch=jshape.global_batch,
        max_len=jshape.seq_len)
    assert p["routes"] == routes
    assert p["cim_routed_fraction"] == jcim_fraction(routes)
    # per-rank argument bytes: the JAX package's 72,762,080 B plus the
    # int32 pos (4 B), an input XLA drops because the SSM step never
    # reads it
    assert out["memory_analysis"]["argument_size_in_bytes"] == 72762080 + 4
    from repro_torch.launch.report import dryrun_table
    assert "| mamba2-780m | decode_32k | single | ok |" in dryrun_table([out])


def test_qwen2_prefill_uneven_heads_traces(tmp_path):
    out = _worker("cell", tmp_path / "cell.json", "qwen2-7b", "prefill_32k",
                  "single")
    assert out["status"] == "ok", out.get("error")
    assert out["redistributions"]["q: replicated"] == 28
    assert out["redistributions"]["kv: replicated"] == 56
    assert out["cost_analysis"]["flops"] > 0
    assert out["memory_analysis"]["temp_size_in_bytes"] > 0
    assert out["collectives"]["by_type_at_last_unroll"]["all-gather"][
        "count"] > 0


def test_one_rank_flops_equal_flop_counter(tmp_path):
    got = _worker("onerank", tmp_path / "one.json")
    assert got["dry_flops"] > 0
    assert got["dry_flops"] == got["real_flops"]


MESHES = ((2, 1), (1, 2), (2, 2))


@pytest.mark.parametrize("data,model", MESHES)
def test_mesh_flops_split_evenly(tmp_path, data, model):
    got = _worker("meshes", tmp_path / "meshes.json", str(data), str(model))
    assert got["one"] > 0
    assert got["flops"] * data * model == got["one"]


def test_loss_points_on_four_gloo_ranks(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "loss",
         str(tmp_path / f"loss{r}.json"), str(r), str(tmp_path / "store")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=WORKER_TIMEOUT)
        assert p.returncode == 0, err[-3000:]
    for r in range(4):
        got = json.load(open(tmp_path / f"loss{r}.json"))
        assert got["points"] == ["logsumexp", "gold logit", "loss"]
        assert got["ce_err"] <= 1e-6 and got["grad_err"] <= 1e-7


def test_redistribution_points_pass_plain_tensors():
    from repro_torch.configs import RunConfig
    from repro_torch.sharding import constraints as C
    g = torch.Generator().manual_seed(0)
    t = torch.randn(2, 3, 8, generator=g)
    q, k, v = (torch.randn(2, 3, 4, 2, generator=g) for _ in range(3))
    rc = RunConfig(shard_heads=True, sp_residual=True)
    assert C.gather_fsdp(t) is t
    tree = {"a": t, "b": [t]}
    assert C.gather_fsdp(tree)["a"] is t and C.gather_fsdp(tree)["b"][0] is t
    assert C.reduce_partial(t) is t
    assert C.grad_placed(t) is t
    assert torch.equal(C.logsumexp(t), torch.logsumexp(t, dim=-1))
    assert C.replicate_over_model(t) is t
    assert C.constrain_residual(t, rc) is t
    assert C.constrain_residual(t, RunConfig()) is t
    for a, b in zip(C.constrain_qkv(q, k, v, rc), (q, k, v)):
        assert a is b
    assert torch.equal(C.split_heads(t, 4, 2), t.reshape(2, 3, 4, 2))
    assert torch.equal(C.merge_heads(q), q.reshape(2, 3, 8))
    assert torch.equal(C.einsum("bqhd,bkhd->bhqk", q, k),
                       torch.einsum("bqhd,bkhd->bhqk", q, k))
    fn = lambda a, b: a * 2 + b                           # noqa: E731
    assert torch.equal(C.on_local_shards(fn, q, k), fn(q, k))
    assert torch.equal(C.cumsum(t, 1), torch.cumsum(t, 1))
    assert torch.equal(C.batch_rows(q, 2, 1), q[1:2])
    ids = torch.tensor([[1, 7, 0], [3, 3, 5]])
    assert torch.equal(C.pick_last(t, ids),
                       torch.gather(t, -1, ids[..., None])[..., 0])
    rows = torch.randn(4, 8, generator=g)
    i0, i1 = torch.tensor([0, 2, 2, 1]), torch.tensor([1, 0, 3, 3])
    want_rows = torch.zeros(3, 4, 8)
    want_rows[i0, i1] = rows
    assert torch.equal(C.put_rows((3, 4, 8), (i0, i1), rows), want_rows)
    dest, want = torch.zeros(2, 5, 3), torch.zeros(2, 5, 3)
    src = torch.ones(2, 1, 3)
    idx = torch.tensor([3])
    assert C.index_copy_(dest, 1, idx, src) is dest
    assert torch.equal(dest, want.index_copy_(1, idx, src))


# --- worker modes (run as `python tests/test_torch_dryrun.py MODE OUT`) ----


def _dump(payload, out):
    with open(out, "w") as f:
        json.dump(payload, f)


def _worker_collectives(out):
    import torch.distributed as tdist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.trace_analysis import (StepRecorder,
                                                   collective_stats,
                                                   op_census)
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=16)
    group = tdist.group.WORLD
    x = torch.ones(1, 4096, dtype=torch.bfloat16)
    y = torch.ones(128, dtype=torch.float32)
    z = torch.ones(2, 2, dtype=torch.float32)
    rec = StepRecorder()
    with rec:
        funcol.all_gather_tensor(x, 0, group).wait()
        funcol.all_reduce(y, "sum", group).wait()
        # funcol's permute splits dim 0 by numel: the 2x2 goes flat
        funcol.permute_tensor(z.reshape(-1), [(i + 1) % 16
                                              for i in range(16)],
                              group).wait()
        torch.ones(4, 4) @ torch.ones(4, 4)
    _dump({"stats": collective_stats(rec.records),
           "census": op_census(rec.records),
           "peak_temp_bytes": rec.peak_temp_bytes}, out)
    tdist.destroy_process_group()


def _worker_runconfig(out):
    import dataclasses as dc
    from repro.configs import ARCHS as JARCHS
    from repro.configs import SHAPES as JSHAPES
    from repro.launch.dryrun import run_config_for as jrun_config_for
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.dryrun import run_config_for
    mismatches, n = [], 0
    for a in ARCHS:
        for s in SHAPES:
            n += 1
            got = dc.asdict(run_config_for(ARCHS[a], SHAPES[s]))
            want = dc.asdict(jrun_config_for(JARCHS[a], JSHAPES[s]))
            over = {"microbatches": 2, "shard_heads": True}
            got2 = dc.asdict(run_config_for(ARCHS[a], SHAPES[s], over))
            want2 = dc.asdict(jrun_config_for(JARCHS[a], JSHAPES[s], over))
            if got != want or got2 != want2:
                mismatches.append([a, s])
    _dump({"cells": n, "mismatches": mismatches}, out)


def _worker_cell(out, arch, shape, mesh):
    from repro_torch.launch.dryrun import lower_cell
    _dump(lower_cell(arch, shape, mesh), out)


def _reduced_train_cell():
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-7b"]),
                              compute_dtype="float32",
                              param_dtype="float32")
    shape = ShapeConfig("train_small", 64, 4, "train")
    rc = dataclasses.replace(dryrun.run_config_for(cfg, shape),
                             microbatches=2, attn_chunk=32)
    return cfg, shape, rc


def _worker_meshes(out, data, model):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import small_mesh
    cfg, shape, rc = _reduced_train_cell()
    dryrun.fake_group()
    one = dryrun.trace_step(cfg, shape, small_mesh(1, 1), rc)
    got = dryrun.trace_step(cfg, shape, small_mesh(int(data), int(model)),
                            rc)
    _dump({"one": one["flops"], "flops": got["flops"]}, out)


def _worker_loss(out, rank, store):
    import torch.distributed as tdist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.sharding import constraints as C
    tdist.init_process_group("gloo", store=tdist.FileStore(store, 4),
                             rank=int(rank), world_size=4)
    try:
        g = torch.Generator().manual_seed(0)
        logits = torch.randn(4, 6, 16, generator=g)
        targets = torch.randint(0, 16, (4, 6), generator=g)
        want_lf = logits.clone().requires_grad_()
        want = torch.mean(torch.logsumexp(want_lf, -1) - torch.gather(
            want_lf, -1, targets[..., None])[..., 0])
        want.backward()
        mesh = small_mesh(2, 2)
        lf = distribute_tensor(logits, mesh, [Shard(0), Shard(2)])
        lf.requires_grad_()
        tg = distribute_tensor(targets, mesh, [Shard(0), Shard(0)])
        with C.record_redistributions() as points:
            ce = torch.mean(C.grad_placed(C.logsumexp(lf)
                                          - C.pick_last(lf, tg)))
        ce.backward()
        _dump({"points": [p["point"] for p in points],
               "ce_err": abs(ce.full_tensor() - want).item(),
               "grad_err": (lf.grad.full_tensor()
                            - want_lf.grad).abs().max().item()}, out)
    finally:
        tdist.destroy_process_group()


def _worker_onerank(out):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import small_mesh
    from repro_torch.models import init
    from repro_torch.optim import make_optimizer
    from repro_torch.train.loop import make_train_step
    cfg, shape, rc = _reduced_train_cell()
    dryrun.fake_group()
    counts = dryrun.trace_step(cfg, shape, small_mesh(1, 1), rc)
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = make_optimizer(rc.optimizer, rc.weight_decay)[0](params)
    batch = next(DataIterator(DataConfig(vocab=cfg.vocab, seq_len=64,
                                         global_batch=4), device="cpu"))
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, rc)(params, opt, batch, 0)
    _dump({"dry_flops": counts["flops"],
           "real_flops": fc.get_total_flops()}, out)


if __name__ == "__main__":
    {"collectives": _worker_collectives, "runconfig": _worker_runconfig,
     "cell": _worker_cell, "onerank": _worker_onerank,
     "meshes": _worker_meshes, "loss": _worker_loss}[sys.argv[1]](
        *sys.argv[2:])
