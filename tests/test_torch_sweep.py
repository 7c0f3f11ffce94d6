"""The port's sweep engine and batched planner, on the CPU.

* every row of tests/golden/planner_verdicts.csv (the full 1338-row
  grid) on both batched backends;
* engine Metrics equal to the JAX package's engine (CiM exactly; the
  baseline to the f32 rounding tests/test_torch_vectorized.py states);
* chunked streaming against the whole batch, bit for bit, over >= 2
  chunks, with groups that span chunks;
* the LRU, the per-backend keyspaces and the counters under threads;
* `measured_cache_delta`, and `DecodeCore.plan_cache_telemetry` with
  routes equal to the scalar plan's.
"""
import csv
import dataclasses
import os
import threading

import pytest
import torch

from repro.core.gemm import GEMM as JaxGEMM
from repro.core.planner import standard_configs as jax_standard_configs
from repro.core.sweep import SweepEngine as JaxSweepEngine

from repro_torch.configs import ARCHS, SHAPES, RunConfig, reduced
from repro_torch.core import (GEMM, default_engine, gemms_of_model,
                              phase_gemms_of_model, plan_workload,
                              plan_workload_by_phase, standard_configs)
from repro_torch.core.cost_model import evaluate
from repro_torch.core.baseline import evaluate_baseline
from repro_torch.core.sweep import (SweepEngine, measured_cache_delta,
                                    sweep_evaluate, sweep_evaluate_baseline)
from repro_torch.models import init
from repro_torch.quant import KernelPlanTable
from repro_torch.serving import DecodeCore, ServeSession

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "planner_verdicts.csv")
# the grid of tests/test_golden_verdicts.py
GRID_SHAPES = ("train_4k", "decode_32k")
PHASE_SEQ_LEN, PHASE_BATCH = 2048, 8
PRECISIONS = {"int8": (8, False), "int4": (4, False), "fp8": (8, True)}
FIELDS = ("arch", "shape", "precision", "label", "M", "N", "K",
          "best_energy", "best_throughput", "use_cim", "where")
N_GRID = 1338


def _grid():
    for arch, mc in ARCHS.items():
        workloads = [(s, gemms_of_model(mc, SHAPES[s])) for s in GRID_SHAPES]
        phases = phase_gemms_of_model(mc, PHASE_SEQ_LEN, PHASE_BATCH)
        workloads += [(f"phase-{ph}", gs) for ph, gs in phases.items()]
        for sname, gemms in workloads:
            for g in gemms:
                for tok, (bits, fp) in PRECISIONS.items():
                    yield (arch, sname, tok,
                           g if (g.bits == bits and g.fp == fp)
                           else g.scaled(bits=bits, fp=fp))


@pytest.fixture(scope="module")
def cpu_engine():
    """One CPU engine for the golden grid: the baseline keyspace is shared
    by both backends, as in the reference."""
    return SweepEngine(device="cpu")


@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
def test_golden_verdicts_full_grid(backend, cpu_engine):
    with open(GOLDEN) as f:
        golden = list(csv.DictReader(f))
    entries = list(_grid())
    decisions = plan_workload([g for *_, g in entries], backend=backend,
                              engine=cpu_engine)
    got = [{"arch": arch, "shape": sname, "precision": prec,
            "label": g.label, "M": str(g.M), "N": str(g.N), "K": str(g.K),
            "best_energy": d.best_energy,
            "best_throughput": d.best_throughput,
            "use_cim": str(int(d.use_cim)), "where": d.where}
           for (arch, sname, prec, g), d in zip(entries, decisions)]
    assert len(golden) == len(got) == N_GRID
    diffs = [(i, k, want[k], have[k])
             for i, (want, have) in enumerate(zip(golden, got))
             for k in FIELDS if want[k] != have[k]]
    assert not diffs, diffs[:25]
    info = cpu_engine.cache_info()
    assert info["backends"][backend]["misses"] > 0
    assert info["pallas_fallback"] is None and info["kernel"] == "plain"


GEMMS = [(8, 3584, 3584, 8, False), (4096, 512, 3584, 4, False),
         (1, 152064, 3584, 8, True), (2048, 18944, 3584, 8, False),
         (7, 3, 5, 4, False), (1, 1, 1, 8, False)]


def _fields(m):
    d = dataclasses.asdict(m)
    d.pop("mapping")
    d.pop("energy_breakdown_pj")
    return d


@pytest.mark.parametrize("order_mode", ["exact", "greedy"])
@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
def test_engine_metrics_match_reference_engine(backend, order_mode):
    ours = SweepEngine(device="cpu")
    ref = JaxSweepEngine(mesh=None)
    cfgs, jcfgs = standard_configs(), jax_standard_configs()
    gs = [GEMM(m, n, k, bits=b, fp=fp) for m, n, k, b, fp in GEMMS]
    jgs = [JaxGEMM(m, n, k, bits=b, fp=fp) for m, n, k, b, fp in GEMMS]
    got = ours.cim_metrics([(g, c) for g in gs for c in cfgs.values()],
                           order_mode, backend)
    want = ref.cim_metrics([(g, c) for g in jgs for c in jcfgs.values()],
                           order_mode, backend)
    for a, b in zip(got, want):
        assert _fields(a) == _fields(b)
        assert dataclasses.asdict(a.mapping) == dataclasses.asdict(
            b.mapping) if a.mapping is not None else b.mapping is None
    for a, b in zip(ours.baseline_metrics(gs), ref.baseline_metrics(jgs)):
        fa, fb = _fields(a), _fields(b)
        for k in fa:
            assert fa[k] == pytest.approx(fb[k], rel=1e-6, abs=0.0), k


def _workload():
    mc = ARCHS["mistral-nemo-12b"]
    return (gemms_of_model(mc, SHAPES["train_4k"])
            + gemms_of_model(mc, SHAPES["decode_32k"]))


@pytest.mark.parametrize("chunk_rows", [7, 512])
def test_chunked_equals_whole_batch(chunk_rows):
    gemms = _workload()
    cfgs = list(standard_configs().values())
    pairs = [(g, c) for g in gemms for c in cfgs]
    whole = SweepEngine(device="cpu")
    chunked = SweepEngine(device="cpu", chunk_rows=chunk_rows)
    for om in ("exact", "greedy"):
        for backend in ("vectorized", "pallas"):
            a = whole.cim_metrics(pairs, om, backend)
            b = chunked.cim_metrics(pairs, om, backend)
            assert [_fields(x) for x in a] == [_fields(x) for x in b]
            assert [x.mapping for x in a] == [x.mapping for x in b]
    a, b = whole.baseline_metrics(gemms), chunked.baseline_metrics(gemms)
    assert [_fields(x) for x in a] == [_fields(x) for x in b]
    info = chunked.cache_info()["chunks"]
    assert info["chunk_rows"] == chunk_rows and info["evaluated"] >= 2
    assert info["rows"] <= info["evaluated"] * chunk_rows
    assert info["rows"] == whole.cache_info()["chunks"]["rows"]


def test_lru_eviction_and_backend_keyspaces():
    eng = SweepEngine(cache_size=4, device="cpu")
    c = standard_configs()["Digital-6T@RF"]
    gs = [GEMM(8 * (i + 1), 64, 64) for i in range(6)]
    eng.cim_metrics([(g, c) for g in gs])
    info = eng.cache_info()
    assert info["size"] == 4 and info["misses"] == 6 and info["hits"] == 0
    eng.cim_metrics([(gs[-1], c)])                  # most recent: a hit
    eng.cim_metrics([(gs[0], c)])                   # evicted: a miss
    eng.cim_metrics([(gs[-1], c)], backend="pallas")  # own keyspace
    info = eng.cache_info()
    assert info["backends"]["vectorized"] == {"hits": 1, "misses": 7}
    assert info["backends"]["pallas"] == {"hits": 0, "misses": 1}
    eng.cache_clear()
    info = eng.cache_info()
    assert info["size"] == info["hits"] == info["misses"] == 0
    assert info["backends"] == {} and info["chunks"]["evaluated"] == 0
    with pytest.raises(ValueError):
        eng.cim_metrics([(gs[0], c)], backend="bogus")
    with pytest.raises(ValueError):
        SweepEngine(chunk_rows=0, device="cpu")


def test_counters_under_threads():
    eng = SweepEngine(device="cpu")
    gemms = [GEMM(m, 512, 512) for m in (1, 8, 64, 512)]
    per_thread, errors = {}, []

    def work(i):
        try:
            for _ in range(3):
                plan_workload(gemms, engine=eng)
            per_thread[i] = eng.thread_cache_counts()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    lookups = 3 * (len(gemms) + len(gemms) * len(standard_configs()))
    assert all(h + m == lookups for h, m in per_thread.values())
    info = eng.cache_info()
    assert info["hits"] + info["misses"] == 6 * lookups
    assert sum(m for _, m in per_thread.values()) == info["misses"]
    assert info["size"] == len(gemms) * (1 + len(standard_configs()))


def test_measured_cache_delta():
    eng = SweepEngine(device="cpu")
    gemms = [GEMM(8, 3584, 3584), GEMM(8, 3584, 512)]
    n = len(gemms) * (1 + len(standard_configs()))
    d1, tel1 = measured_cache_delta(
        lambda: plan_workload(gemms, engine=eng), eng)
    d2, tel2 = measured_cache_delta(
        lambda: plan_workload(gemms, engine=eng), eng)
    assert (tel1["plan_hits"], tel1["plan_misses"]) == (0, n)
    assert (tel2["plan_hits"], tel2["plan_misses"]) == (n, 0)
    assert tel2["engine"]["hits"] == n and tel2["engine"]["size"] == n
    assert [d.best_energy for d in d1] == [d.best_energy for d in d2]


def test_single_query_helpers_and_default_engine():
    g = GEMM(512, 1024, 1024)
    c = standard_configs()["Analog-6T@SMEM-B"]
    assert sweep_evaluate(g, c, device="cpu").energy_pj == pytest.approx(
        evaluate(g, c).energy_pj, rel=1e-5)
    assert sweep_evaluate_baseline(g, device="cpu").time_ns == \
        pytest.approx(evaluate_baseline(g).time_ns, rel=1e-5)
    assert default_engine("cpu") is default_engine(torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_engine()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SweepEngine()


def _core(batch):
    cfg = reduced(ARCHS["qwen2-7b"])
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return DecodeCore(cfg, RunConfig(), params, quantize=True,
                      plan_batch=batch, plan_max_len=16, device="cpu")


def test_decode_core_plan_cache_telemetry_and_routes():
    default_engine("cpu").cache_clear()
    core = _core(8)
    tel = core.plan_cache_telemetry
    assert tel["plan_misses"] > 0 and tel["plan_hits"] >= 0
    assert tel["engine"]["device"] == "cpu"
    assert tel["engine"]["backends"]["vectorized"]["misses"] > 0
    again = _core(8).plan_cache_telemetry
    assert again["plan_misses"] == 0
    assert again["plan_hits"] == tel["plan_hits"] + tel["plan_misses"]
    # the batched plan routes exactly as the scalar planner's
    scalar = plan_workload_by_phase(
        phase_gemms_of_model(core.cfg, 16, 8), backend="scalar")
    for ph, ds in scalar.items():
        want = KernelPlanTable.from_decisions(ds, model_name=core.cfg.name)
        assert core.phase_verdict_tables[ph].digest == want.digest, ph
    session = ServeSession(core.cfg, RunConfig(), core.params, max_len=16,
                           batch=8, quantize=False, device="cpu")
    assert session.plan_cache_telemetry["plan_misses"] == 0
