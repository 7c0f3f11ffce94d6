"""What/When/Where planner — the paper's three questions as a decision layer.

For every GEMM of a workload it evaluates:
  * the tensor-core baseline,
  * each CiM primitive at RF (iso-area count),
  * each CiM primitive at SMEM configA (RF count) and configB (16x),
and reports the winner per objective.  In the serving stack this gates
kernel selection: GEMMs whose best option is CiM-like (weight-stationary,
large M, K within reduction reach) run the hand-written INT8 GEMM kernel;
memory-bound M=1 decode GEMMs stay on the standard path (the paper's
"when NOT to CiM" takeaway).

Backends (`decide` / `plan_workload` / `plan_workload_by_phase` accept
backend="vectorized"|"pallas"|"scalar"):
  * "vectorized" (default): the batched sweep engine (core/sweep.py) —
    all GEMMs x configs x candidate mappings scored in one device pass
    through vectorized.evaluate_flat, with an LRU result cache;
  * "pallas": the same sweep with the CiM rows on the hand-written sweep
    kernel (kernels/sweep_eval.py; CUDA C++ on the card);
  * "scalar": the per-call Python cost model, the reference the batched
    backends are held to.
The batched backends run on `engine` when one is given, else on the
default engine of `device` ("cuda" unless the caller passes "cpu").  All
backends apply the same eligibility and "when" rules (`make_decision`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from .baseline import evaluate_baseline
from .cost_model import Metrics, evaluate
from .gemm import GEMM
from .loopnest import check_order_mode
from .memory import CiMSystemConfig, configb_count
from .primitives import (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T,
                         CiMPrimitive)

DEFAULT_PRIMS = (ANALOG_6T, ANALOG_8T, DIGITAL_6T, DIGITAL_8T)


PLANNER_BACKENDS = ("vectorized", "pallas", "scalar")


def _check_args(backend: str, order_mode: str) -> None:
    """Shared argument validation: every backend accepts exactly the same
    (backend, order_mode) combinations."""
    if backend not in PLANNER_BACKENDS:
        raise ValueError(f"unknown planner backend {backend!r}; "
                         f"expected one of {PLANNER_BACKENDS}")
    check_order_mode(order_mode)


def standard_configs(prims: Sequence[CiMPrimitive] = DEFAULT_PRIMS
                     ) -> dict[str, CiMSystemConfig]:
    """The paper's evaluated integration points."""
    cfgs: dict[str, CiMSystemConfig] = {}
    for p in prims:
        cfgs[f"{p.name}@RF"] = CiMSystemConfig(prim=p, cim_level="RF")
        cfgs[f"{p.name}@SMEM-A"] = CiMSystemConfig(
            prim=p, cim_level="SMEM",
            n_prims=CiMSystemConfig(prim=p, cim_level="RF").resolved_n_prims())
        cfgs[f"{p.name}@SMEM-B"] = CiMSystemConfig(
            prim=p, cim_level="SMEM", n_prims=configb_count(p))
    return cfgs


@dataclasses.dataclass(frozen=True)
class Decision:
    """Per-GEMM what/when/where verdict."""
    gemm: GEMM
    baseline: Metrics
    options: dict            # config name -> Metrics
    best_energy: str         # config name (or "baseline")
    best_throughput: str
    use_cim: bool            # paper's "when": does any CiM option beat the
                             # baseline in energy without losing throughput
                             # by more than 2x?

    @property
    def what(self) -> str:
        return self.best_energy

    @property
    def where(self) -> str:
        name = self.best_energy
        return name.split("@")[-1] if "@" in name else "PE"

    @property
    def chosen(self) -> Metrics:
        """Metrics of the deployable (eligible min-energy) option."""
        if self.best_energy == "baseline":
            return self.baseline
        return self.options[self.best_energy]


def make_decision(gemm: GEMM, base: Metrics, options: dict,
                  throughput_floor: float = 0.5) -> Decision:
    """Apply the what/when rules to already-evaluated options.

    Shared by every backend, so they cannot drift.  The deployable
    choice ("what") is the most energy-efficient option among those
    keeping >= `throughput_floor` of the baseline's throughput (a CiM
    deployment that collapses performance is not a win — paper §VI-A's
    latency/parallelism trade-off)."""
    all_opts = dict(options)
    all_opts["baseline"] = base
    eligible = {n: m for n, m in all_opts.items()
                if m.gflops >= throughput_floor * base.gflops}
    best_e = max(eligible, key=lambda n: eligible[n].tops_per_w)
    best_t = max(all_opts, key=lambda n: all_opts[n].gflops)
    # "when": only deploy CiM for a *meaningful* energy win (paper Tab. V:
    # low-reuse GEMVs show ~0 gain and lose throughput — not worth it)
    use_cim = (best_e != "baseline"
               and eligible[best_e].tops_per_w > 1.15 * base.tops_per_w)
    return Decision(gemm=gemm, baseline=base, options=options,
                    best_energy=best_e, best_throughput=best_t,
                    use_cim=use_cim)


def decide(gemm: GEMM, configs: dict[str, CiMSystemConfig] | None = None,
           order_mode: str = "exact",
           throughput_floor: float = 0.5,
           backend: str = "vectorized", engine=None,
           device="cuda") -> Decision:
    """What/when/where for one GEMM (batched backends on `engine`, else
    on the default engine of `device`)."""
    _check_args(backend, order_mode)
    configs = configs or standard_configs()
    if backend != "scalar":
        from .sweep import decide_batched
        return decide_batched(gemm, configs, order_mode, throughput_floor,
                              engine=engine, backend=backend, device=device)
    base = evaluate_baseline(gemm)
    options = {name: evaluate(gemm, cfg, order_mode)
               for name, cfg in configs.items()}
    return make_decision(gemm, base, options, throughput_floor)


def plan_workload(gemms: Iterable[GEMM],
                  configs: dict[str, CiMSystemConfig] | None = None,
                  order_mode: str = "exact",
                  backend: str = "vectorized", engine=None,
                  device="cuda") -> list[Decision]:
    """Per-GEMM decisions for a whole workload: one batched sweep (on
    `engine`, else the default engine of `device`), or decide() per GEMM
    for backend="scalar"."""
    _check_args(backend, order_mode)
    if backend != "scalar":
        from .sweep import plan_workload_batched
        return plan_workload_batched(gemms, configs, order_mode,
                                     engine=engine, backend=backend,
                                     device=device)
    return [decide(g, configs, order_mode, backend=backend)
            for g in gemms]


def plan_workload_by_phase(phase_gemms: dict,
                           configs: dict[str, CiMSystemConfig] | None = None,
                           order_mode: str = "exact",
                           backend: str = "vectorized", engine=None,
                           device="cuda"
                           ) -> dict[str, list[Decision]]:
    """Per-phase what/when/where plans: {"prefill": [...], "decode": [...]}.

    The paper's When answer is phase-dependent — prefill GEMMs carry
    M = seq_len reuse while decode GEMMs collapse to M = batch — so a
    single plan over a mixed workload mis-gates one phase or the other.
    Each phase is planned independently over its own GEMM set (one
    batched sweep per phase, one result cache across phases).

    Raises ValueError on a phase with zero GEMMs: an empty phase plan
    would silently gate *nothing* for that phase (every lookup would
    KeyError at trace time at best, or — with a permissive table — run
    ungated), which is indistinguishable from a deliberate all-baseline
    verdict.  Callers that legitimately have no GEMMs for a phase must
    omit the phase, not pass an empty list."""
    _check_args(backend, order_mode)
    if not phase_gemms:
        raise ValueError("plan_workload_by_phase() needs at least one phase")
    plans: dict[str, list[Decision]] = {}
    for phase, gemms in phase_gemms.items():
        gemms = list(gemms)
        if not gemms:
            raise ValueError(
                f"phase {phase!r} has zero eligible GEMMs — an empty "
                "phase plan would silently disable gating for that phase; "
                "omit the phase instead of passing an empty workload")
        plans[phase] = plan_workload(gemms, configs, order_mode,
                                     backend=backend, engine=engine,
                                     device=device)
    return plans


def summarize(decisions: Sequence[Decision]) -> dict:
    """Aggregate what/when/where statistics over a workload.

    energy_gain_x compares the baseline against each GEMM's *deployable*
    option — d.options[d.best_energy], the eligible winner decide() would
    actually pick — not the unconstrained min-energy option, which could
    be a config the throughput floor rules out.

    Raises ValueError on an empty decision list: an all-zero aggregate
    is indistinguishable from a real workload where CiM never wins, and
    campaign certification legitimately produces empty contract-filtered
    subsets that must be reported as such, not as zeros."""
    if not decisions:
        raise ValueError(
            "summarize() needs at least one Decision — an empty list "
            "would silently aggregate to all zeros (campaign "
            "certification filters can produce empty subsets; report "
            "them explicitly instead)")
    n = len(decisions)
    cim_frac = sum(d.use_cim for d in decisions) / max(1, n)
    wheres: dict[str, int] = {}
    whats: dict[str, int] = {}
    for d in decisions:
        wheres[d.where] = wheres.get(d.where, 0) + 1
        whats[d.what] = whats.get(d.what, 0) + 1
    # energy-weighted gain vs baseline, over the eligible winners
    e_base = sum(d.baseline.energy_pj * d.gemm.count for d in decisions)
    e_best = sum(d.chosen.energy_pj * d.gemm.count for d in decisions)
    return {"n_gemms": n, "cim_fraction": cim_frac, "where": wheres,
            "what": whats,
            "energy_gain_x": e_base / e_best if e_best else 0.0}
