"""The paper's own experiments: one function per figure and table.

  PYTHONPATH=src python -m repro_torch.launch.paper --backend pallas \
      --out runs/paper
  PYTHONPATH=src python -m repro_torch.launch.paper --device cpu

The port of the JAX package's `benchmarks/paper_benches.py`: the same
seven functions, with the same parameters, each returning `(rows,
derived)` — the rows behind the artefact and its headline metrics:

  fig2_gemm_landscape               Fig. 2   ops vs algorithmic reuse
  fig7_table2_mapping_vs_heuristic  Fig. 7 + Table II  the priority
                                    mapper against random search
  fig9_primitive_scatter            Fig. 9   the four primitives at RF
  fig10_dimension_sweeps            Fig. 10  metric trends vs M, N, K
  fig11_12_memory_levels            Fig. 11/12  RF vs SMEM-A/B vs the
                                    tensor-core baseline
  fig13_square_gemms                Fig. 13  square GEMMs, all primitives
  table6_workload_characteristics   Table VI  MACs and reuse

Fig. 7 stays on the scalar cost model, as in the JAX package: its
derived metric is the scalar mapper's runtime against the heuristic
search's.  The sweeps of Figs. 9-13 score each figure's CiM points in one
batch through the sweep engine (`SweepEngine.cim_metrics`) on `device`:
`backend="pallas"` runs the hand-written sweep kernel on the card (its
plain version on the CPU), `backend="vectorized"` the eager torch spec;
the tensor-core baseline rows run the engine's torch baseline on both.
The JAX package asks its engine one point at a time; a batch gives each
point the same result.

The CLI writes `<name>.csv` and `<name>.derived.json` for each function
into `--out` (default `runs/paper`, listed in .gitignore; it never writes
`results/`), and prints one `name,seconds,derived` line per function.
It runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import time

from ..core import (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T, GEMM,
                    REAL_WORKLOADS, CiMSystemConfig, configb_count, evaluate,
                    random_search, square_sweep, synthetic_dataset)
from ..core.gemm import geomean
from ..core.sweep import CIM_BACKENDS, default_engine

PRIMS = {"Analog-6T": ANALOG_6T, "Analog-8T": ANALOG_8T,
         "Digital-6T": DIGITAL_6T, "Digital-8T": DIGITAL_8T}
D6_RF = CiMSystemConfig(prim=DIGITAL_6T, cim_level="RF")
# derived fields that are wall times of this run, not results
RUNTIME_FIELDS = ("runtime_ours_s", "runtime_heuristic_s", "runtime_ratio")


def _cim(pairs, backend, device, engine):
    """Metrics of every (GEMM, config) pair, exact order mode, in one
    engine call."""
    if backend not in CIM_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{CIM_BACKENDS}")
    engine = engine or default_engine(device)
    return engine.cim_metrics(pairs, "exact", backend)


def _baseline(gemms, device, engine):
    return (engine or default_engine(device)).baseline_metrics(gemms)


def fig2_gemm_landscape():
    """Fig. 2: ops vs algorithmic reuse for the real ML workloads."""
    rows = []
    for wl, gemms in REAL_WORKLOADS.items():
        for g in gemms:
            rows.append({"workload": wl, "M": g.M, "N": g.N, "K": g.K,
                         "ops": g.ops, "algorithmic_reuse":
                         round(g.algorithmic_reuse, 3),
                         "count": g.count})
    bert = [r for r in rows if r["workload"] == "BERT-Large"]
    return rows, {"n_gemms": len(rows),
                  "bert_max_reuse": max(r["algorithmic_reuse"]
                                        for r in bert)}


def fig7_table2_mapping_vs_heuristic(n_shapes: int = 24, seed: int = 0):
    """Fig. 7 + Table II: priority mapper vs random heuristic search, both
    on the scalar cost model (host only)."""
    shapes = synthetic_dataset(n_shapes, seed=seed) \
        + REAL_WORKLOADS["BERT-Large"] + REAL_WORKLOADS["DLRM"]
    rows = []
    t_ours = t_heur = 0.0
    for g in shapes:
        t0 = time.perf_counter()
        ours = evaluate(g, D6_RF)
        t_ours += time.perf_counter() - t0
        t0 = time.perf_counter()
        found = random_search(g, D6_RF, seed=seed, max_valid=150,
                              max_consecutive_invalid=20_000)
        t_heur += time.perf_counter() - t0
        h = found.best
        rows.append({
            "M": g.M, "N": g.N, "K": g.K,
            "tops_w_gain": ours.tops_per_w / h.tops_per_w,
            "gflops_gain": ours.gflops / h.gflops,
            "util_gain": ours.utilization / max(h.utilization, 1e-9),
        })
    derived = {
        "tops_w_gain_geomean": geomean(r["tops_w_gain"] for r in rows),
        "gflops_gain_geomean": geomean(r["gflops_gain"] for r in rows),
        "util_gain_geomean": geomean(r["util_gain"] for r in rows),
        "runtime_ours_s": round(t_ours, 3),
        "runtime_heuristic_s": round(t_heur, 3),
        "runtime_ratio": t_heur / max(t_ours, 1e-9),
    }
    return rows, derived


def fig9_primitive_scatter(n: int = 120, seed: int = 1, *,
                           backend: str = "vectorized", device="cuda",
                           engine=None):
    """Fig. 9: energy-efficiency vs throughput per primitive @ RF."""
    shapes = synthetic_dataset(n, seed=seed)
    keys = [(pname, g) for pname in PRIMS for g in shapes]
    mets = _cim([(g, CiMSystemConfig(prim=PRIMS[p], cim_level="RF"))
                 for p, g in keys], backend, device, engine)
    rows = [{"primitive": p, "M": g.M, "N": g.N, "K": g.K,
             "tops_per_w": m.tops_per_w, "gflops": m.gflops,
             "utilization": m.utilization}
            for (p, g), m in zip(keys, mets)]
    best = {p: max(r["tops_per_w"] for r in rows if r["primitive"] == p)
            for p in PRIMS}
    gf = {p: max(r["gflops"] for r in rows if r["primitive"] == p)
          for p in PRIMS}
    return rows, {"best_tops_w": best, "max_gflops": gf}


def fig10_dimension_sweeps(*, backend: str = "vectorized", device="cuda",
                           engine=None):
    """Fig. 10: metric trends vs weight/input/output matrix shapes."""
    sizes = [16, 32, 64, 128, 256, 512, 1024, 2048]
    keys = ([("weight", X, M, GEMM(M, X, X)) for X in sizes for M in sizes]
            + [("input", X, N, GEMM(X, N, X)) for X in sizes for N in sizes]
            + [("output", X, K, GEMM(X, X, K)) for X in sizes
               for K in sizes])
    mets = _cim([(g, D6_RF) for *_, g in keys], backend, device, engine)
    rows = [{"sweep": sweep, "X": X, "var": var,
             "tops_per_w": m.tops_per_w, "gflops": m.gflops,
             "utilization": m.utilization}
            for (sweep, X, var, _), m in zip(keys, mets)]
    w512 = [r for r in rows if r["sweep"] == "weight" and r["X"] == 512]
    peak_m = max(w512, key=lambda r: r["tops_per_w"])
    out256 = [r for r in rows if r["sweep"] == "output"
              and r["var"] == 256]
    return rows, {"weight512_best_M": peak_m["var"],
                  "weight512_best_topsw": peak_m["tops_per_w"],
                  "k256_mean_topsw": statistics.mean(
                      r["tops_per_w"] for r in out256)}


def fig11_12_memory_levels(*, backend: str = "vectorized", device="cuda",
                           engine=None):
    """Fig. 11/12: real workloads at RF vs SMEM (configA/B) vs baseline."""
    cfgs = {
        "RF": CiMSystemConfig(prim=DIGITAL_6T, cim_level="RF"),
        "SMEM-A": CiMSystemConfig(
            prim=DIGITAL_6T, cim_level="SMEM",
            n_prims=CiMSystemConfig(prim=DIGITAL_6T,
                                    cim_level="RF").resolved_n_prims()),
        "SMEM-B": CiMSystemConfig(prim=DIGITAL_6T, cim_level="SMEM",
                                  n_prims=configb_count(DIGITAL_6T)),
    }
    work = [(wl, g) for wl, gemms in REAL_WORKLOADS.items() for g in gemms]
    bases = _baseline([g for _, g in work], device, engine)
    mets = iter(_cim([(g, c) for _, g in work for c in cfgs.values()],
                     backend, device, engine))
    rows = []
    for (wl, g), base in zip(work, bases):
        row = {"workload": wl, "M": g.M, "N": g.N, "K": g.K,
               "baseline_tops_w": base.tops_per_w,
               "baseline_gflops": base.gflops}
        for name in cfgs:
            m = next(mets)
            row[f"{name}_tops_w"] = m.tops_per_w
            row[f"{name}_gflops"] = m.gflops
            row[f"{name}_util"] = m.utilization
        rows.append(row)
    bert = [r for r in rows if r["workload"] == "BERT-Large"]
    derived = {
        "bert_rf_vs_baseline_topsw": geomean(
            r["RF_tops_w"] / r["baseline_tops_w"] for r in bert),
        "smemB_vs_rf_gflops": geomean(
            r["SMEM-B_gflops"] / r["RF_gflops"] for r in rows
            if r["M"] > 1),
        "max_energy_gain": max(
            max(r["RF_tops_w"], r["SMEM-B_tops_w"]) / r["baseline_tops_w"]
            for r in rows),
        "max_throughput_gain": max(
            r["SMEM-B_gflops"] / r["baseline_gflops"] for r in rows),
    }
    return rows, derived


def fig13_square_gemms(*, backend: str = "vectorized", device="cuda",
                       engine=None):
    """Appendix Fig. 13: square GEMMs, all primitives + tensor core."""
    gemms = square_sweep(64, 8192)
    points = [(pname, level, CiMSystemConfig(prim=prim, cim_level=level,
                                             n_prims=np_))
              for pname, prim in PRIMS.items()
              for level, np_ in (("RF", None),
                                 ("SMEM", configb_count(prim)))]
    bases = _baseline(gemms, device, engine)
    mets = iter(_cim([(g, c) for g in gemms for *_, c in points], backend,
                     device, engine))
    rows = []
    for g, base in zip(gemms, bases):
        row = {"X": g.M, "Tcore_fj_mac": 2e3 * base.energy_pj / g.ops,
               "Tcore_gflops": base.gflops}
        for pname, level, _ in points:
            m = next(mets)
            row[f"{pname}@{level}_fj_mac"] = 2 * m.fj_per_op
            row[f"{pname}@{level}_gflops"] = m.gflops
        rows.append(row)
    big = rows[-1]
    return rows, {
        "a2_rf_fj_mac_at_8192": big["Analog-8T@RF_fj_mac"],
        "a1_rf_fj_mac_at_8192": big["Analog-6T@RF_fj_mac"],
        "d1_rf_gflops_at_8192": big["Digital-6T@RF_gflops"],
        "a1_rf_gflops_at_8192": big["Analog-6T@RF_gflops"],
    }


def table6_workload_characteristics():
    """Table VI: #MACs and algorithmic reuse (exact transcription check)."""
    rows = []
    for wl, gemms in REAL_WORKLOADS.items():
        for g in gemms:
            rows.append({"workload": wl, "M": g.M, "N": g.N, "K": g.K,
                         "macs": g.macs,
                         "reuse": round(g.algorithmic_reuse, 3)})
    bert = next(r for r in rows if r["workload"] == "BERT-Large"
                and r["M"] == 512 and r["N"] == 1024 and r["K"] == 1024)
    return rows, {"bert_macs": bert["macs"], "bert_reuse": bert["reuse"]}


# name -> (function, whether it scores a sweep on the engine)
ARTEFACTS = {
    "fig2_gemm_landscape": (fig2_gemm_landscape, False),
    "fig7_table2_mapping_vs_heuristic": (fig7_table2_mapping_vs_heuristic,
                                         False),
    "fig9_primitive_scatter": (fig9_primitive_scatter, True),
    "fig10_dimension_sweeps": (fig10_dimension_sweeps, True),
    "fig11_12_memory_levels": (fig11_12_memory_levels, True),
    "fig13_square_gemms": (fig13_square_gemms, True),
    "table6_workload_characteristics": (table6_workload_characteristics,
                                        False),
}


def run_all(*, backend: str = "vectorized", device="cuda",
            engine=None) -> dict:
    """name -> (rows, derived, seconds) for each artefact, the sweeps
    scored on `backend` and `device`."""
    out = {}
    for name, (fn, sweeps) in ARTEFACTS.items():
        kw = (dict(backend=backend, device=device, engine=engine)
              if sweeps else {})
        t0 = time.perf_counter()
        rows, derived = fn(**kw)
        out[name] = (rows, derived, time.perf_counter() - t0)
    return out


def main(argv=None) -> None:
    """The CLI: every artefact's `<name>.csv` (the rows) and
    `<name>.derived.json` into --out, in the formats of the JAX package's
    benchmark runner."""
    ap = argparse.ArgumentParser(
        description="Reproduce the paper's figures and tables.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--backend", choices=CIM_BACKENDS, default="vectorized",
                    help="CiM row evaluator of the sweeps (Figs. 9-13): the "
                         "sweep kernel (pallas) or the torch spec")
    ap.add_argument("--out", default=os.path.join("runs", "paper"),
                    help="directory for <name>.csv and <name>.derived.json")
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run: the card, or 'cpu'")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    print("name,seconds,derived")
    for name, (rows, derived, dt) in run_all(
            backend=args.backend, device=args.device).items():
        with open(os.path.join(args.out, f"{name}.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        with open(os.path.join(args.out, f"{name}.derived.json"), "w") as f:
            json.dump(derived, f, indent=1, default=str)
        print(f"{name},{dt:.3f},{json.dumps(derived, default=str)!r}")


if __name__ == "__main__":
    main()
