"""The port's launch tooling against the JAX package's, on the CPU.

* `launch.specs`: the train / prefill / decode input stand-ins and the
  parameter tree, shapes and dtypes equal to the JAX package's
  `jax.eval_shape` stand-ins for every ARCHS x SHAPES cell that
  `cell_is_runnable` admits, all on "meta" (no storage);
* `launch.roofline`: `model_flops` and `analytic_hbm_bytes` exactly equal
  to the JAX package's on that grid (and over chips, optimizer,
  microbatches, KV bytes and TP), and `Roofline` on the H100's constants
  with the JAX package's terms;
* `launch.report`: every table string-equal to the JAX package's on the
  JAX package's own test dicts (tests/test_sweep.py:398,
  tests/test_distributed_sweep.py:166), on the committed
  BENCH_serve.json and campaign report, on cells carrying the port's
  Roofline rows, and on the port's engine telemetry.
"""
import json
import os

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs

from repro_torch.configs import ARCHS, SHAPES, RunConfig
from repro_torch.core import GEMM, SweepEngine, plan_workload
from repro_torch.core.sweep import measured_cache_delta
from repro_torch.launch import report, roofline, specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if specs.cell_is_runnable(ARCHS[a], SHAPES[s])]


def _key(p):
    return str(p.key) if hasattr(p, "key") else str(p.idx)


def _ours(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_ours(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _same_shapes(ours, ref) -> int:
    a = _ours(ours)
    leaves, _ = jax.tree_util.tree_flatten_with_path(ref)
    b = {"/".join(_key(p) for p in path): x for path, x in leaves}
    assert set(a) == set(b)
    for k, t in a.items():
        assert t.is_meta, k                       # no storage allocated
        assert tuple(t.shape) == tuple(b[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(b[k].dtype), k
    return len(a)


def test_cell_is_runnable_matches_reference():
    for a in ARCHS:
        for s in SHAPES:
            assert specs.cell_is_runnable(ARCHS[a], SHAPES[s]) == \
                jspecs.cell_is_runnable(JARCHS[a], JSHAPES[s])
    assert ("mamba2-780m", "long_500k") in CELLS
    assert ("qwen2-7b", "long_500k") not in CELLS


@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_equal_reference(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    n = _same_shapes(specs.param_shapes(cfg), jspecs.param_shapes(jcfg))
    assert n > 3
    for a, s in CELLS:
        if a != arch:
            continue
        shape, jshape = SHAPES[s], JSHAPES[s]
        _same_shapes(specs.train_input_specs(cfg, shape),
                     jspecs.train_input_specs(jcfg, jshape))
        _same_shapes(specs.prefill_input_specs(cfg, shape),
                     jspecs.prefill_input_specs(jcfg, jshape))
        _same_shapes(specs.decode_input_specs(cfg, RunConfig(), shape),
                     jspecs.decode_input_specs(jcfg, JRunConfig(), jshape))
    assert specs.sds((2, 3), torch.int32).is_meta


def test_model_flops_and_hbm_bytes_equal_reference():
    n = 0
    for a, s in CELLS:
        cfg, shape = ARCHS[a], SHAPES[s]
        jcfg, jshape = JARCHS[a], JSHAPES[s]
        assert roofline.model_flops(cfg, shape) == \
            jroofline.model_flops(jcfg, jshape), (a, s)
        assert roofline._n_attn_layers(cfg) == jroofline._n_attn_layers(jcfg)
        for chips in (1, 256, 512):
            for opt in ("adamw", "adafactor"):
                for mb in (1, 2):
                    for kvb in (1, 2):
                        for tp in (1, 16):
                            kw = dict(optimizer=opt, microbatches=mb,
                                      kv_cache_bytes_per_el=kvb, tp=tp)
                            assert roofline.analytic_hbm_bytes(
                                cfg, shape, chips, **kw) == \
                                jroofline.analytic_hbm_bytes(
                                    jcfg, jshape, chips, **kw), (a, s, kw)
                            n += 1
    for a in ARCHS:
        for s, b in ((4096, 2), (2048, 1), (777, 3)):
            for causal in (True, False):
                assert roofline._attn_flops(ARCHS[a], s, b, causal) == \
                    jroofline._attn_flops(JARCHS[a], s, b, causal)
            assert roofline._decode_attn_flops(ARCHS[a], s, b) == \
                jroofline._decode_attn_flops(JARCHS[a], s, b)
    assert n == len(CELLS) * 48


def test_roofline_on_the_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    kw = dict(arch="qwen2-7b", shape="train_4k", mesh="single",
              hlo_flops=2e15, hlo_bytes=4e12, collective_bytes=9e10,
              model_flops_total=1.5e15, hbm_bytes=1e12)
    one = roofline.Roofline(chips=1, **kw)
    assert one.compute_s == 2e15 / 989e12
    assert one.memory_s == 1e12 / 3.35e12
    assert one.memory_s_xla == 4e12 / 3.35e12
    assert one.collective_s == 9e10 / 450e9
    assert one.bottleneck == "compute"
    assert one.step_time_s == one.compute_s
    assert one.useful_flops_fraction == 1.5e15 / 2e15
    assert one.roofline_fraction == (1.5e15 / 989e12) / one.compute_s
    many = roofline.Roofline(chips=8, **kw)
    assert many.collective_s == 9e10 / 450e9
    assert roofline.Roofline(chips=1, **dict(
        kw, collective_bytes=0.0)).collective_s == 0.0   # one card
    ref = jroofline.Roofline(chips=8, **kw)
    assert list(many.row()) == list(ref.row())    # the same row keys
    assert many.useful_flops_fraction == ref.useful_flops_fraction


# --- report ------------------------------------------------------------------


def _cell(engine_cache: dict) -> dict:
    return {"status": "ok", "arch": "a", "shape": "s", "mesh": "single",
            "planner": {"summary": {"cim_fraction": 0.5,
                                    "energy_gain_x": 2.0},
                        "plan_hits": 3, "plan_misses": 4,
                        "cache": engine_cache}}


def _both(fn_name, *args):
    ours = getattr(report, fn_name)(*args)
    ref = getattr(jreport, fn_name)(*args)
    assert ours == ref, (fn_name, ours, ref)
    return ours


def test_report_planner_cache_and_shard_balance_tables():
    """The JAX package's own test dicts: chunk and shard telemetry,
    per-backend breakdown with a fallback marker, legacy cells."""
    distributed = {"processes": 2, "process_index": 0,
                   "global_devices": 2, "local_devices": 1,
                   "mesh_devices": 2,
                   "shard_balance": {"0": 2304, "1": 2304}}
    cache = {"hits": 7, "misses": 9, "size": 16,
             "chunks": {"chunk_rows": 512, "evaluated": 9,
                        "rows": 4403, "padded_rows": 205},
             "distributed": distributed}
    assert "chunks=9@512rows" in _both("planner_cache_table", [_cell(cache)])
    balance = _both("shard_balance_table", [_cell(cache)])
    assert "p0:2304 p1:2304" in balance and "7h/9m" in balance
    legacy = {"hits": 1, "misses": 2, "size": 3}
    assert "size=3" in _both("planner_cache_table", [_cell(legacy)])
    assert "no distributed" in _both(
        "shard_balance_table",
        [_cell(legacy), _cell({**cache, "distributed": None})])
    base = {"status": "ok", "arch": "a", "shape": "s", "mesh": "single"}
    planner = {"summary": {"cim_fraction": 0.5, "energy_gain_x": 2.0},
               "plan_hits": 3, "plan_misses": 4,
               "cim_routed_fraction": 0.25,
               "cache": {"hits": 7, "misses": 9, "size": 16,
                         "backends": {"vectorized": {"hits": 5,
                                                     "misses": 6},
                                      "pallas": {"hits": 2, "misses": 3}},
                         "pallas_fallback": "gpu: no lowering"}}
    table = _both("planner_cache_table", [{**base, "planner": planner}])
    assert "vectorized:5h/6m" in table and "pallas→xla" in table
    assert _both("planner_cache_table", []) == \
        "(no decode cells with planner telemetry)"


def test_report_on_the_port_engine_telemetry():
    """A decode cell built from the port's own engine: measured_cache_delta
    and cache_info (chunks with padded_rows, distributed None, the port's
    device and kernel keys) render as the JAX package renders them."""
    eng = SweepEngine(chunk_rows=64, device="cpu")
    gemms = [GEMM(8, 3584, 3584), GEMM(8, 512, 3584)]
    _, tel = measured_cache_delta(
        lambda: plan_workload(gemms, engine=eng, backend="pallas"), eng)
    _, tel = measured_cache_delta(
        lambda: plan_workload(gemms, engine=eng), eng)
    cell = {"status": "ok", "arch": "qwen2-7b", "shape": "decode_32k",
            "mesh": "single",
            "planner": {"summary": {"cim_fraction": 0.25,
                                    "energy_gain_x": 1.5},
                        "plan_hits": tel["plan_hits"],
                        "plan_misses": tel["plan_misses"],
                        "cache": tel["engine"]}}
    table = _both("planner_cache_table", [cell])
    assert "pallas:" in table and "@64rows" in table
    assert "no distributed" in _both("shard_balance_table", [cell])
    dist_cell = json.loads(json.dumps(cell))
    dist_cell["planner"]["cache"]["distributed"] = {
        "processes": 2, "process_index": 1, "global_devices": 2,
        "local_devices": 1, "mesh_devices": 2,
        "shard_balance": {"0": 512, "1": 512}}
    assert "p1/2" in _both("shard_balance_table", [dist_cell])


def _roofline_cells() -> list[dict]:
    cells = []
    for i, (a, s) in enumerate(CELLS[:6]):
        cfg, shape = ARCHS[a], SHAPES[s]
        flops = roofline.model_flops(cfg, shape)
        r = roofline.Roofline(
            a, s, "single", 256, hlo_flops=flops / 200.0,
            hlo_bytes=3e11 * (i + 1), collective_bytes=1e9 * i,
            model_flops_total=flops,
            hbm_bytes=roofline.analytic_hbm_bytes(cfg, shape, 256))
        cells.append({"status": "ok", "arch": a, "shape": s,
                      "mesh": "single", "compile_s": 1.5 * i,
                      "memory_analysis": {"argument_size_in_bytes":
                                          int(2e9) * i},
                      "roofline": r.row()})
    cells.append({"status": "skipped", "arch": "qwen2-7b",
                  "shape": "long_500k", "mesh": "single"})
    cells.append({"status": "error", "arch": "x", "shape": "y",
                  "mesh": "multi", "error": "lowering failed: " + "e" * 80})
    return cells


def test_report_dryrun_roofline_and_summary(tmp_path):
    cells = _roofline_cells()
    assert "ERROR: lowering failed" in _both("dryrun_table", cells)
    assert "**" in _both("roofline_table", cells, "single")
    _both("roofline_table", cells, "multi")
    assert report.summarize(cells) == jreport.summarize(cells)
    assert [report.fmt_s(x) for x in (2.5, 0.02, 3e-5)] == \
        [jreport.fmt_s(x) for x in (2.5, 0.02, 3e-5)]
    for name, cell in (("a.s.single", cells[0]), ("a.s.single-xyz", cells[1]),
                       ("b.s.multi", cells[2]), ("nodots", cells[3])):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(cell, f)
    for tag in ("", "xyz"):
        assert report.load_cells(str(tmp_path), tag) == \
            jreport.load_cells(str(tmp_path), tag)
    assert len(report.load_cells(str(tmp_path))) == 2


def test_report_serve_and_campaign_tables():
    with open(os.path.join(REPO, "BENCH_serve.json")) as f:
        bench = json.load(f)
    assert "TTFT" in _both("serve_traffic_table", bench)
    _both("serve_step_breakdown_table", bench)
    assert "forced-flip" in _both("serve_adaptive_table", bench)
    for fn in ("serve_traffic_table", "serve_step_breakdown_table",
               "serve_adaptive_table"):
        assert _both(fn, {}).startswith("(no ")
    assert _both("serve_step_breakdown_table",
                 {"traffic": {"curves": []}}).startswith("(no ")
    with open(os.path.join(REPO, "results", "campaign",
                           "campaign_report.json")) as f:
        campaign = json.load(f)
    assert "certification" in _both("campaign_table", campaign)
    # the empty report names each package's own campaign CLI
    assert report.campaign_table({}) == jreport.campaign_table({}).replace(
        "repro.launch", "repro_torch.launch")
