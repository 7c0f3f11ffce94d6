"""The port's scalar cost model and planner against the JAX package's.

* every qwen2-7b row of tests/golden/planner_verdicts.csv, exactly (the
  full 1338-row grid is a slow case: the scalar backend takes ~40 s);
* `KernelPlanTable.digest` of the full-width qwen2-7b serving tables
  against the JAX package's vectorized planner;
* `Metrics` of the cost-model calibration cases, exactly (the cost
  model is a copy of the JAX package's pure-Python modules, so any
  difference is a porting fault, not rounding).
"""
import csv
import dataclasses
import os

import pytest

from repro.core.cost_model import evaluate as jax_evaluate
from repro.core.baseline import evaluate_baseline as jax_evaluate_baseline
from repro.core.gemm import GEMM as JaxGEMM
from repro.core.llm_workloads import (
    phase_gemms_of_model as jax_phase_gemms_of_model)
from repro.core.planner import (plan_workload_by_phase as jax_plan_by_phase,
                                standard_configs as jax_standard_configs)
from repro.configs import ARCHS as JAX_ARCHS
from repro.quant import KernelPlanTable as JaxKernelPlanTable

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import (GEMM, evaluate, evaluate_baseline,
                              gemms_of_model, phase_gemms_of_model,
                              plan_workload, plan_workload_by_phase,
                              standard_configs)
from repro_torch.quant import KernelPlanTable

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "planner_verdicts.csv")
# the grid of tests/test_golden_verdicts.py
GRID_SHAPES = ("train_4k", "decode_32k")
PHASE_SEQ_LEN, PHASE_BATCH = 2048, 8
PRECISIONS = {"int8": (8, False), "int4": (4, False), "fp8": (8, True)}
FIELDS = ("arch", "shape", "precision", "label", "M", "N", "K",
          "best_energy", "best_throughput", "use_cim", "where")


def _grid(archs):
    for arch in archs:
        mc = ARCHS[arch]
        workloads = [(s, gemms_of_model(mc, SHAPES[s])) for s in GRID_SHAPES]
        phases = phase_gemms_of_model(mc, PHASE_SEQ_LEN, PHASE_BATCH)
        workloads += [(f"phase-{ph}", gs) for ph, gs in phases.items()]
        for sname, gemms in workloads:
            for g in gemms:
                for tok, (bits, fp) in PRECISIONS.items():
                    yield (arch, sname, tok,
                           g if (g.bits == bits and g.fp == fp)
                           else g.scaled(bits=bits, fp=fp))


def _rows(archs):
    entries = list(_grid(archs))
    decisions = plan_workload([g for *_, g in entries], backend="scalar")
    return [{"arch": arch, "shape": sname, "precision": prec,
             "label": g.label, "M": str(g.M), "N": str(g.N), "K": str(g.K),
             "best_energy": d.best_energy,
             "best_throughput": d.best_throughput,
             "use_cim": str(int(d.use_cim)), "where": d.where}
            for (arch, sname, prec, g), d in zip(entries, decisions)]


def _assert_golden(archs, n_expected):
    with open(GOLDEN) as f:
        golden = [r for r in csv.DictReader(f) if r["arch"] in archs]
    got = _rows(archs)
    assert len(golden) == len(got) == n_expected
    diffs = [(i, k, want[k], have[k])
             for i, (want, have) in enumerate(zip(golden, got))
             for k in FIELDS if want[k] != have[k]]
    assert not diffs, diffs[:25]


def test_golden_verdicts_qwen2_7b_scalar():
    _assert_golden(("qwen2-7b",), 120)


@pytest.mark.slow
def test_golden_verdicts_full_grid_scalar():
    _assert_golden(tuple(ARCHS), 1338)


def test_unported_backends_raise():
    g = [GEMM(8, 64, 64)]
    for backend in ("vectorized", "pallas"):
        with pytest.raises(NotImplementedError, match="slice 2"):
            plan_workload(g, backend=backend)
    with pytest.raises(ValueError):
        plan_workload(g, backend="bogus")


def test_full_width_qwen2_7b_plan_digests_match_reference():
    """The tables a full-width qwen2-7b session serves with (plan batch 8,
    plan max_len 33) equal the JAX DecodeCore's vectorized tables."""
    name = "qwen2-7b"
    ours = {ph: KernelPlanTable.from_decisions(ds, model_name=name)
            for ph, ds in plan_workload_by_phase(
                phase_gemms_of_model(ARCHS[name], 33, 8)).items()}
    ref = {ph: JaxKernelPlanTable.from_decisions(ds, model_name=name)
           for ph, ds in jax_plan_by_phase(
               jax_phase_gemms_of_model(JAX_ARCHS[name], 33, 8),
               backend="vectorized").items()}
    assert set(ours) == set(ref) == {"prefill", "decode"}
    for ph in ours:
        assert ours[ph].digest == ref[ph].digest, ph
    projections = ("Wq", "Wk", "Wv", "Wo", "mlp-gate", "mlp-up",
                   "mlp-down", "lm_head")
    assert all(ours["decode"].use_cim(lab) for lab in projections)


# (M, N, K) of the cases in tests/test_core.py and tests/test_calibration.py
CASES = [(4096, 4096, 4096), (8192, 8192, 8192), (2048, 2048, 2048),
         (512, 1024, 1024), (1, 4096, 4096), (512, 32, 256),
         (256, 512, 512), (512, 512, 512), (32, 512, 512),
         (1024, 2048, 1024), (1, 1000, 2048), (16, 16, 16),
         (12544, 64, 147), (512, 512, 1024)]


def _fields(obj):
    """A dataclass (and the dataclasses inside it) as plain values, so
    objects of the two packages' classes compare field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    return obj


@pytest.mark.parametrize("mnk", CASES, ids=lambda t: "x".join(map(str, t)))
def test_metrics_exactly_equal(mnk):
    ours_cfgs, ref_cfgs = standard_configs(), jax_standard_configs()
    assert list(ours_cfgs) == list(ref_cfgs)
    g, jg = GEMM(*mnk), JaxGEMM(*mnk)
    assert _fields(evaluate_baseline(g)) == _fields(jax_evaluate_baseline(jg))
    for name in ours_cfgs:
        for mode in ("exact", "greedy"):
            assert (_fields(evaluate(g, ours_cfgs[name], mode))
                    == _fields(jax_evaluate(jg, ref_cfgs[name], mode))), \
                (name, mode)
