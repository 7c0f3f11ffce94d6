"""Design-space campaigns: streaming Pareto-frontier exploration.

The planner answers one question per (GEMM, config); the paper's real
product is the *map* — energy/throughput/area frontiers across CiM
prototype, cache level, and workload.  This module turns the batched
sweep engine into that map at scale:

  * `CampaignSpec` enumerates a design grid **lazily** — CiM prototype
    x cache level x primitive-budget scale x input-driver serialization
    x K:N balance threshold (the mapping-config axes) x DRAM order mode
    x precision x workload GEMM.  Grids of 100k+ points are walked as a
    generator; nothing materializes the cross product.
  * `run_campaign` streams the points in bounded blocks through
    `SweepEngine.cim_metrics`; an engine built with `chunk_rows=N`
    additionally bounds every *device* batch — peak memory is
    O(block + chunk + front), never O(grid).
  * Declarative **constraint contracts** (`Constraint`, e.g.
    "time_ns<=2e6" — a latency budget per decode step — or
    "area_bytes<=1e5" — an SRAM macro area cap) filter candidates
    before front reduction and are carried into the result's provenance.
  * Survivors reduce to multi-objective Pareto fronts over
    (energy_pj, time_ns, area_bytes) with the vectorized dominance
    mask + cross-chunk merging of `core.pareto`, grouped either
    per workload cell (objectives aggregated over the cell's GEMMs,
    count-weighted — "which design for this model/phase") or per GEMM
    ("which design for this shape").
  * `certify_point` / `certify_front` re-evaluate a chosen front row
    from scratch **through the planner** (`plan_workload_batched` on a
    fresh engine) and assert the recorded objectives reproduce bitwise
    and the contracts still hold — the deployment gate for a design
    picked off a frontier CSV.

Precision is a first-class What axis: `precisions` accepts the tokens
4 / 8 / "fp8" (normalized by `parse_precision` to canonical
"int4"/"int8"/"fp8"), flowing into `GEMM.bits`/`GEMM.fp` and from
there into the per-precision CiM cost factors
(`primitives.precision_factors`: analog ADC/DAC scaling + column
parallelism, digital bit-serial latency).  INT8 remains the Table-IV
calibration identity.

This is the port of the JAX package's `core/campaign.py`: the same grid,
contracts, fronts and certification, on the port's sweep engine (one
device: "cuda" unless the caller passes "cpu") and its torch Pareto
reduction.  `launch.campaign` is the CLI; tests/test_torch_campaign.py
holds the port's front CSV to tests/golden/campaign_front.csv byte for
byte on both batched backends.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from ..configs import ARCHS, SHAPES
from .gemm import GEMM
from .llm_workloads import gemms_of_model
from .loopnest import check_order_mode
from .memory import RF, CiMSystemConfig, configb_count, \
    iso_area_primitive_count
from .pareto import ParetoAccumulator, pareto_mask_np
from .primitives import PRIMITIVES, SUPPORTED_BITS
from .sweep import SweepEngine, plan_workload_batched

# The campaign's objective triple, all minimized.
OBJECTIVES = ("energy_pj", "time_ns", "area_bytes")

# Cache-level axis values: RF iso-area, SMEM at the RF count (configA),
# SMEM at 16x (configB) — planner.standard_configs' three integration
# points, here scaled by the primitive-budget axis.
CIM_LEVELS = ("RF", "SMEM-A", "SMEM-B")

GROUP_MODES = ("workload", "gemm")

# Metrics a constraint contract may bound (workload-mode rows carry the
# count-weighted aggregates, gemm-mode rows the per-GEMM values).
CONSTRAINT_METRICS = ("energy_pj", "time_ns", "area_bytes", "gflops",
                     "tops_per_w")

FRONT_FIELDS = ("group", "index", "label", "M", "N", "K", "precision",
                "prototype", "cim_level", "scale", "serialize",
                "kn_threshold", "order_mode", "config", "n_prims",
                "n_gemms", "energy_pj", "time_ns", "area_bytes",
                "gflops", "tops_per_w")


def parse_precision(token) -> tuple[int, bool, str]:
    """Normalize one precision-axis token to (bits, fp, canonical name).

    Accepts ints (4, 8) and strings ("4", "8", "int4", "int8", "fp8");
    the canonical names ("int4" / "int8" / "fp8") are what front CSVs
    carry in their `precision` column."""
    t = str(token).strip().lower()
    if t in ("fp8", "float8", "f8"):
        return 8, True, "fp8"
    if t.startswith("int"):
        t = t[3:]
    try:
        bits = int(t)
    except ValueError:
        raise ValueError(f"unknown precision token {token!r}: expected "
                         f"one of {SUPPORTED_BITS} or 'fp8'") from None
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported integer precision INT{bits} "
                         f"(supported: {SUPPORTED_BITS}, plus 'fp8')")
    return bits, False, f"int{bits}"


def area_proxy_bytes(cfg: CiMSystemConfig) -> float:
    """SRAM macro area proxy of one config: primitive count x capacity x
    the prototype's area overhead vs plain SRAM (paper Table IV), in
    iso-capacity byte-equivalents.  The third campaign objective — the
    silicon budget a frontier point spends for its energy/latency."""
    p = cfg.prim
    return float(cfg.resolved_n_prims() * p.capacity_bytes
                 * p.area_overhead)


def build_config(prototype: str, level: str, scale: float = 1.0,
                 serialize: bool = True,
                 kn_threshold: int = 4) -> CiMSystemConfig:
    """One grid config: `prototype` at `level` with `scale` x the
    level's iso-area primitive budget (SMEM-B scales the 16x configB
    count), the given input-driver serialization, and the mapping
    algorithm's K:N balance threshold."""
    if prototype not in PRIMITIVES:
        raise ValueError(f"unknown CiM prototype {prototype!r}; expected "
                         f"one of {sorted(PRIMITIVES)}")
    if level not in CIM_LEVELS:
        raise ValueError(f"unknown cache level {level!r}; expected one "
                         f"of {CIM_LEVELS}")
    if not scale > 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    prim = PRIMITIVES[prototype]
    base = (configb_count(prim) if level == "SMEM-B"
            else iso_area_primitive_count(RF, prim))
    n = max(1, int(round(scale * base)))
    return CiMSystemConfig(
        prim=prim, cim_level="RF" if level == "RF" else "SMEM",
        n_prims=n, serialize_primitives=serialize,
        kn_balance_threshold=kn_threshold)


def config_label(prototype: str, level: str, scale: float,
                 serialize: bool, kn_threshold: int) -> str:
    return (f"{prototype}@{level}:x{scale:g}:"
            f"{'ser' if serialize else 'par'}:kn{kn_threshold}")


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One declarative constraint contract: `metric op bound`.

    metric: one of CONSTRAINT_METRICS; op: "<=" or ">=".  Contracts
    filter candidate rows *before* front reduction (`run_campaign`) and
    are re-asserted by the certification gate on freshly re-evaluated
    metrics (`certify_point`)."""

    metric: str
    op: str
    bound: float

    def __post_init__(self):
        if self.metric not in CONSTRAINT_METRICS:
            raise ValueError(f"unknown constraint metric {self.metric!r};"
                             f" expected one of {CONSTRAINT_METRICS}")
        if self.op not in ("<=", ">="):
            raise ValueError(f"unknown constraint op {self.op!r}; "
                             f"expected '<=' or '>='")
        if not np.isfinite(self.bound):
            raise ValueError(f"constraint bound must be finite, "
                             f"got {self.bound}")

    @classmethod
    def parse(cls, text: str) -> "Constraint":
        """Parse "metric<=bound" / "metric>=bound" (the CLI syntax)."""
        for op in ("<=", ">="):
            if op in text:
                metric, _, bound = text.partition(op)
                try:
                    return cls(metric.strip(), op, float(bound))
                except ValueError as e:
                    # non-numeric bound or unknown metric: re-raise with
                    # the original text for a self-describing CLI error
                    raise ValueError(
                        f"bad constraint {text!r}: {e}") from e
        raise ValueError(f"bad constraint {text!r}: expected "
                         f"'metric<=bound' or 'metric>=bound'")

    def spec(self) -> str:
        return f"{self.metric}{self.op}{self.bound:g}"

    def check(self, value: float) -> bool:
        return value <= self.bound if self.op == "<=" \
            else value >= self.bound

    def mask(self, cols: dict) -> np.ndarray:
        """(n,) bool over columnar metric arrays."""
        v = np.asarray(cols[self.metric], np.float64)
        return v <= self.bound if self.op == "<=" else v >= self.bound


class CampaignUnit(NamedTuple):
    """One design-axis combination (everything but the workload GEMM).

    `precision` is the canonical token ("int4"/"int8"/"fp8");
    `bits`/`fp` are the parsed element-format pair applied to the
    workload GEMMs."""
    unit_index: int
    precision: str
    prototype: str
    level: str
    scale: float
    serialize: bool
    kn_threshold: int
    order_mode: str
    config: str                  # label
    cfg: CiMSystemConfig
    area_bytes: float
    bits: int = 8
    fp: bool = False


class CampaignPoint(NamedTuple):
    """One grid point: a workload GEMM under one design unit."""
    index: int                   # global grid-enumeration index
    group: str                   # "arch/shape"
    group_key: tuple             # (workload_idx, gemm_idx) — gemm mode
    gemm: GEMM
    unit: CampaignUnit


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Declarative grid: the cross product of every axis below, per
    workload GEMM.  Enumeration (`iter_points`) is lazy and
    deterministic — workload-major, GEMM-major, design-unit-minor —
    and the enumeration index is each point's canonical identity (front
    CSVs sort by it, which is what makes output independent of block
    and chunk boundaries)."""

    workloads: tuple[tuple[str, str], ...] = (
        ("mistral-nemo-12b", "decode_32k"),)
    prototypes: tuple[str, ...] = ("Analog-6T", "Analog-8T",
                                   "Digital-6T", "Digital-8T")
    levels: tuple[str, ...] = CIM_LEVELS
    scales: tuple[float, ...] = (1.0,)
    serialize_modes: tuple[bool, ...] = (True,)
    kn_thresholds: tuple[int, ...] = (4,)
    order_modes: tuple[str, ...] = ("exact",)
    # precision-axis tokens: 4 / 8 / "fp8" (see parse_precision)
    precisions: tuple = (8,)

    def __post_init__(self):
        if not self.workloads:
            raise ValueError("spec needs at least one workload cell")
        for arch, shape in self.workloads:
            if arch not in ARCHS:
                raise ValueError(f"unknown arch {arch!r}; expected one "
                                 f"of {sorted(ARCHS)}")
            if shape not in SHAPES:
                raise ValueError(f"unknown shape {shape!r}; expected "
                                 f"one of {sorted(SHAPES)}")
        for om in self.order_modes:
            check_order_mode(om)
        for p in self.precisions:
            parse_precision(p)       # raises on unknown tokens
        # axis validation via build_config (raises on bad values)
        for proto in self.prototypes:
            for level in self.levels:
                for s in self.scales:
                    build_config(proto, level, s)

    def units(self) -> list[CampaignUnit]:
        """The per-GEMM design-axis combinations, in enumeration order
        (precision-major ... order-mode-minor).

        The input-driver serialization axis only differentiates
        RF-level configs — it is a no-op in the cost model at SMEM — so
        non-RF levels take the first serialize mode only, keeping the
        grid free of duplicate points (duplicates are exact objective
        ties and would all land on the front together)."""
        out: list[CampaignUnit] = []
        for prec in self.precisions:
            bits, fp, tok = parse_precision(prec)
            for proto in self.prototypes:
                for level in self.levels:
                    for scale in self.scales:
                        sers = self.serialize_modes if level == "RF" \
                            else self.serialize_modes[:1]
                        for ser in sers:
                            for kn in self.kn_thresholds:
                                cfg = build_config(proto, level, scale,
                                                   ser, kn)
                                for om in self.order_modes:
                                    out.append(CampaignUnit(
                                        len(out), tok, proto,
                                        level, float(scale), bool(ser),
                                        int(kn), om,
                                        config_label(proto, level,
                                                     scale, ser, kn),
                                        cfg, area_proxy_bytes(cfg),
                                        bits, fp))
        return out

    def workload_gemms(self) -> list[tuple[str, list[GEMM]]]:
        """[(group name, GEMMs)] per workload cell — small (hundreds of
        GEMMs), unlike the full grid."""
        return [(f"{arch}/{shape}",
                 gemms_of_model(ARCHS[arch], SHAPES[shape]))
                for arch, shape in self.workloads]

    @property
    def n_units(self) -> int:
        n_rf = sum(1 for lv in self.levels if lv == "RF")
        n_other = len(self.levels) - n_rf
        per_level = (n_rf * len(self.serialize_modes)
                     + n_other * min(1, len(self.serialize_modes)))
        return (len(self.precisions) * len(self.prototypes) * per_level
                * len(self.scales) * len(self.kn_thresholds)
                * len(self.order_modes))

    @property
    def n_points(self) -> int:
        n_gemms = sum(len(gs) for _, gs in self.workload_gemms())
        return n_gemms * self.n_units

    def iter_points(self) -> Iterator[CampaignPoint]:
        """Lazy grid walk — the only full-grid traversal anywhere; no
        list of all points ever exists."""
        units = self.units()
        index = 0
        for wi, (group, gemms) in enumerate(self.workload_gemms()):
            for gi, g in enumerate(gemms):
                for u in units:
                    gemm = g if (g.bits == u.bits and g.fp == u.fp) \
                        else g.scaled(bits=u.bits, fp=u.fp)
                    yield CampaignPoint(index, group, (wi, gi), gemm, u)
                    index += 1

    def describe(self) -> dict:
        """Provenance block: every axis plus the grid digest (reports
        and bench artifacts embed it, so a frontier CSV names the exact
        grid that produced it)."""
        return {
            "workloads": [list(w) for w in self.workloads],
            "prototypes": list(self.prototypes),
            "levels": list(self.levels),
            "scales": list(self.scales),
            "serialize_modes": list(self.serialize_modes),
            "kn_thresholds": list(self.kn_thresholds),
            "order_modes": list(self.order_modes),
            "precisions": list(self.precisions),
            "n_units": self.n_units,
            "n_points": self.n_points,
            "digest": self.digest(),
        }

    def digest(self) -> str:
        """Stable sha256 of the grid axes (not the evaluations)."""
        d = dataclasses.asdict(self)
        text = repr(sorted(d.items()))
        return hashlib.sha256(text.encode()).hexdigest()[:16]


def _fmt(v) -> str:
    """Deterministic CSV cell formatting: full-precision repr for
    floats (the objectives are float32-exact values — repr round-trips
    them bitwise), plain str otherwise."""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _unit_cells(u: CampaignUnit) -> dict:
    return {"precision": u.precision, "prototype": u.prototype,
            "cim_level": u.level, "scale": u.scale,
            "serialize": int(u.serialize),
            "kn_threshold": u.kn_threshold, "order_mode": u.order_mode,
            "config": u.config,
            "n_prims": u.cfg.resolved_n_prims()}


@dataclasses.dataclass
class CampaignResult:
    """Fronts + accounting of one campaign run.

    `front` rows are dicts over FRONT_FIELDS, already in canonical order
    (group enumeration order, then point/unit index); `csv_text()` is
    byte-deterministic — the golden test and the bench determinism gate
    compare it verbatim."""

    spec: CampaignSpec
    group_by: str
    backend: str
    contracts: tuple[Constraint, ...]
    front: list[dict]
    stats: dict
    device: str = "cuda"         # the engine's device

    def csv_text(self) -> str:
        lines = [",".join(FRONT_FIELDS)]
        for row in self.front:
            lines.append(",".join(_fmt(row[f]) for f in FRONT_FIELDS))
        return "\n".join(lines) + "\n"

    def write_csv(self, path: str) -> str:
        text = self.csv_text()
        with open(path, "w", newline="") as f:
            f.write(text)
        return hashlib.sha256(text.encode()).hexdigest()

    def report(self) -> dict:
        return {
            "group_by": self.group_by,
            "backend": self.backend,
            "device": self.device,
            "contracts": [c.spec() for c in self.contracts],
            "front_rows": len(self.front),
            "spec": self.spec.describe(),
            "stats": self.stats,
        }


def _metric_cols(mets, units) -> dict:
    """Columnar per-point metrics for constraint masks + objectives."""
    return {
        "energy_pj": np.asarray([m.energy_pj for m in mets], np.float64),
        "time_ns": np.asarray([m.time_ns for m in mets], np.float64),
        "area_bytes": np.asarray([u.area_bytes for u in units],
                                 np.float64),
        "gflops": np.asarray([m.gflops for m in mets], np.float64),
        "tops_per_w": np.asarray([m.tops_per_w for m in mets],
                                 np.float64),
    }


def run_campaign(spec: CampaignSpec,
                 contracts: Sequence[Constraint] = (),
                 engine: SweepEngine | None = None,
                 backend: str = "vectorized",
                 block_points: int = 4096,
                 group_by: str = "workload",
                 device="cuda") -> CampaignResult:
    """Stream the grid through the sweep engine and reduce to fronts.

    Points are buffered in blocks of at most `block_points` and
    evaluated via `engine.cim_metrics` (an engine constructed with
    `chunk_rows=N` further tiles each device call — pass one to bound
    device memory; the default engine here is a new engine on `device`
    streaming 4096-row chunks).
    Rows failing any constraint contract are dropped before reduction
    and counted per contract in `stats`.

    group_by="workload": objectives are count-weighted sums over each
    workload cell's GEMMs per design unit — one front per cell over the
    design units ("which design for this model/phase").
    group_by="gemm": one front per workload GEMM over the design units,
    folded incrementally through `ParetoAccumulator` as blocks complete
    (a GEMM's units routinely span block boundaries — this is the
    cross-chunk merge path).
    """
    if group_by not in GROUP_MODES:
        raise ValueError(f"unknown group_by {group_by!r}; expected one "
                         f"of {GROUP_MODES}")
    if block_points < 1:
        raise ValueError(f"block_points must be >= 1, "
                         f"got {block_points}")
    contracts = tuple(contracts)
    engine = engine or SweepEngine(chunk_rows=4096, device=device)

    n_invalid = 0
    filtered = {c.spec(): 0 for c in contracts}
    points_evaluated = 0

    # group_by="gemm" state: one accumulator + surviving-row meta per
    # GEMM, pruned as rows fall off the front (memory stays O(fronts))
    accs: dict[tuple, ParetoAccumulator] = {}
    metas: dict[tuple, dict[int, dict]] = {}
    group_names: dict[tuple, str] = {}
    # group_by="workload" state: count-weighted running sums per
    # (group, unit) — O(groups x units), grid-size independent
    agg: dict[tuple[int, int], list] = {}

    def eval_block(block: list[CampaignPoint]) -> list:
        """Metrics for a block, point order preserved (cim_metrics takes
        one order_mode per call, so split/reassemble by order mode)."""
        mets: list = [None] * len(block)
        for om in spec.order_modes:
            ix = [i for i, p in enumerate(block)
                  if p.unit.order_mode == om]
            if not ix:
                continue
            got = engine.cim_metrics(
                [(block[i].gemm, block[i].unit.cfg) for i in ix],
                om, backend)
            for i, m in zip(ix, got):
                mets[i] = m
        return mets

    def fold_block(block: list[CampaignPoint]) -> None:
        nonlocal n_invalid, points_evaluated
        mets = eval_block(block)
        points_evaluated += len(block)
        units = [p.unit for p in block]
        cols = _metric_cols(mets, units)
        ok = np.isfinite(cols["energy_pj"]) & np.isfinite(cols["time_ns"])
        n_invalid += int((~ok).sum())

        if group_by == "workload":
            # contracts apply to the *aggregated* rows later; here just
            # fold the per-point sums
            for p, m, valid in zip(block, mets, ok):
                wi = p.group_key[0]
                st = agg.get((wi, p.unit.unit_index))
                if st is None:
                    st = [0.0, 0.0, 0.0, 0, True, p.unit]
                    agg[(wi, p.unit.unit_index)] = st
                c = p.gemm.count
                st[0] += m.energy_pj * c
                st[1] += m.time_ns * c
                st[2] += m.ops * c
                st[3] += 1
                st[4] = st[4] and bool(valid)
            return

        # group_by="gemm": constraint-filter, then stream into the
        # per-GEMM accumulators
        keep = ok.copy()
        for c in contracts:
            m = c.mask(cols)
            filtered[c.spec()] += int((keep & ~m).sum())
            keep &= m
        by_group: dict[tuple, list[int]] = {}
        for i, p in enumerate(block):
            if keep[i]:
                by_group.setdefault(p.group_key, []).append(i)
            group_names.setdefault(p.group_key, p.group)
        for gk, ix in by_group.items():
            acc = accs.get(gk)
            if acc is None:
                acc = accs[gk] = ParetoAccumulator(len(OBJECTIVES))
                metas[gk] = {}
            pts = np.stack([[cols["energy_pj"][i], cols["time_ns"][i],
                             cols["area_bytes"][i]] for i in ix]
                           ).astype(np.float32)
            idx = [block[i].index for i in ix]
            acc.update(pts, idx)
            meta = metas[gk]
            for i in ix:
                p, m, u = block[i], mets[i], block[i].unit
                meta[p.index] = {
                    "group": p.group, "index": p.index,
                    "label": p.gemm.label, "M": p.gemm.M, "N": p.gemm.N,
                    "K": p.gemm.K, **_unit_cells(u), "n_gemms": 1,
                    "energy_pj": m.energy_pj, "time_ns": m.time_ns,
                    "area_bytes": u.area_bytes, "gflops": m.gflops,
                    "tops_per_w": m.tops_per_w,
                }
            live = set(int(i) for i in acc.front()[1])
            metas[gk] = {i: r for i, r in meta.items() if i in live}

    block: list[CampaignPoint] = []
    for point in spec.iter_points():
        block.append(point)
        if len(block) >= block_points:
            fold_block(block)
            block = []
    if block:
        fold_block(block)

    units = spec.units()
    front_rows: list[dict] = []
    n_groups = 0

    if group_by == "workload":
        wg = spec.workload_gemms()
        for wi, (group, gemms) in enumerate(wg):
            rows = []
            for u in units:
                st = agg.get((wi, u.unit_index))
                if st is None or not st[4]:   # invalids counted per GEMM
                    continue
                e, t, ops, n_g = st[0], st[1], st[2], st[3]
                rows.append({
                    "group": group, "index": u.unit_index, "label": "",
                    "M": "", "N": "", "K": "", **_unit_cells(u),
                    "n_gemms": n_g, "energy_pj": e, "time_ns": t,
                    "area_bytes": u.area_bytes,
                    "gflops": ops / t if t else 0.0,
                    "tops_per_w": ops / e if e else 0.0,
                })
            if not rows:
                continue
            n_groups += 1
            cols = {m: np.asarray([r[m] for r in rows], np.float64)
                    for m in CONSTRAINT_METRICS}
            keep = np.ones(len(rows), bool)
            for c in contracts:
                m = c.mask(cols)
                filtered[c.spec()] += int((keep & ~m).sum())
                keep &= m
            rows = [r for r, k in zip(rows, keep) if k]
            if not rows:
                continue
            pts = np.asarray([[r[o] for o in OBJECTIVES] for r in rows],
                             np.float32)
            mask = pareto_mask_np(pts)
            front_rows += [r for r, k in zip(rows, mask) if k]
    else:
        for gk in sorted(accs):
            _, idx = accs[gk].front()
            n_groups += 1
            front_rows += [metas[gk][int(i)] for i in idx]

    stats = {
        "n_points": spec.n_points,
        "points_evaluated": points_evaluated,
        "n_invalid": n_invalid,
        "constraint_filtered": filtered,
        "n_groups": n_groups,
        "front_rows": len(front_rows),
        "engine_chunks": engine.cache_info()["chunks"],
    }
    return CampaignResult(spec=spec, group_by=group_by, backend=backend,
                          contracts=contracts, front=front_rows,
                          stats=stats, device=str(engine.device))


# --- certification gate ------------------------------------------------------


def _row_gemms(row: dict, spec: CampaignSpec) -> list[GEMM]:
    """The GEMMs behind one front row: the single GEMM of a gemm-mode
    row, or the whole workload cell of a workload-mode row."""
    arch, _, shape = row["group"].partition("/")
    bits, fp, _ = parse_precision(row["precision"])
    if row["label"] != "" and row["M"] != "":
        return [GEMM(int(row["M"]), int(row["N"]), int(row["K"]),
                     bits=bits, fp=fp, label=row["label"])]
    gemms = gemms_of_model(ARCHS[arch], SHAPES[shape])
    return [g if (g.bits == bits and g.fp == fp)
            else g.scaled(bits=bits, fp=fp) for g in gemms]


def certify_point(row: dict,
                  contracts: Sequence[Constraint] = (),
                  backend: str = "vectorized",
                  engine: SweepEngine | None = None,
                  device="cuda") -> dict:
    """Re-evaluate one front row from scratch and gate it for deployment.

    The row's GEMMs run through the planner (`plan_workload_batched`)
    on a *fresh* engine on `device` (unless `engine` is given) — no
    shared LRU, so the recorded objectives are
    genuinely recomputed — and the gate asserts (a) the re-aggregated
    energy/time reproduce the row **bitwise** (the sweep kernels are
    deterministic; any difference means the cost model or grid drifted
    since the campaign ran) and (b) every constraint contract still
    holds on the recomputed metrics.  The planner block reports how
    many of the row's GEMMs the when-rule would actually deploy on this
    config, plus `planner.summarize` over the contract-passing subset —
    which can be empty, in which case summarize's empty-input
    ValueError is recorded instead of an all-zero aggregate.
    """
    u_cfg = build_config(row["prototype"], row["cim_level"],
                         float(row["scale"]), bool(int(row["serialize"])),
                         int(row["kn_threshold"]))
    area = area_proxy_bytes(u_cfg)
    label = row["config"]
    gemms = _row_gemms(row, CampaignSpec())
    engine = engine or SweepEngine(device=device)
    decisions = plan_workload_batched(
        gemms, configs={label: u_cfg}, order_mode=row["order_mode"],
        engine=engine, backend=backend)

    energy = time = ops = 0.0
    per_gemm_pass: list[bool] = []
    for d in decisions:
        m = d.options[label]
        energy += m.energy_pj * d.gemm.count
        time += m.time_ns * d.gemm.count
        ops += m.ops * d.gemm.count
        cols = {"energy_pj": m.energy_pj, "time_ns": m.time_ns,
                "area_bytes": area, "gflops": m.gflops,
                "tops_per_w": m.tops_per_w}
        per_gemm_pass.append(all(c.check(cols[c.metric])
                                 for c in contracts))

    recomputed = {"energy_pj": energy, "time_ns": time,
                  "area_bytes": area,
                  "gflops": ops / time if time else 0.0,
                  "tops_per_w": ops / energy if energy else 0.0}
    recorded = {k: float(row[k]) for k in recomputed}
    bitwise_ok = all(recomputed[k] == recorded[k] for k in recomputed)

    checks = [{"constraint": c.spec(),
               "ok": bool(c.check(recomputed[c.metric]))}
              for c in contracts]
    contracts_ok = all(c["ok"] for c in checks)

    from .planner import summarize
    passing = [d for d, ok in zip(decisions, per_gemm_pass) if ok]
    summary_err = None
    try:
        summary = summarize(passing)
    except ValueError as e:
        # every GEMM of this row fails some contract — report the
        # condition instead of an all-zero aggregate
        summary, summary_err = None, str(e)

    return {
        "group": row["group"], "config": label,
        "order_mode": row["order_mode"],
        "n_gemms": len(gemms),
        "bitwise_ok": bitwise_ok,
        "recorded": recorded,
        "recomputed": recomputed,
        "contracts": checks,
        "contracts_ok": contracts_ok,
        "certified": bitwise_ok and contracts_ok,
        "planner": {
            "n_use_cim": sum(d.use_cim for d in decisions),
            "contract_passing_gemms": len(passing),
            "filtered_summary": summary,
            "filtered_summary_error": summary_err,
        },
    }


def certify_front(result: CampaignResult,
                  objectives: Sequence[str] = ("energy_pj",),
                  backend: str | None = None,
                  max_groups: int | None = None,
                  device=None) -> dict:
    """Certify each group's champion row per objective (the min row —
    the design point a user would pick off the frontier).  One fresh
    engine (on `device`, by default the campaign's) is shared across the
    certifications so repeated baselines are swept once.  Returns
    per-point reports + an overall `ok` (an empty front certifies
    nothing and is not ok)."""
    for o in objectives:
        if o not in CONSTRAINT_METRICS:
            raise ValueError(f"unknown certification objective {o!r}; "
                             f"expected one of {CONSTRAINT_METRICS}")
    backend = backend or result.backend
    groups: dict[str, list[dict]] = {}
    for row in result.front:
        groups.setdefault(row["group"], []).append(row)
    names = list(groups)
    if max_groups is not None:
        names = names[:max_groups]
    engine = SweepEngine(device=device or result.device)
    points, seen = [], set()
    for name in names:
        for obj in objectives:
            row = min(groups[name], key=lambda r: float(r[obj]))
            key = (name, row["index"], row.get("label", ""))
            if key in seen:
                continue
            seen.add(key)
            points.append(certify_point(row, result.contracts, backend,
                                        engine))
    return {
        "objectives": list(objectives),
        "groups_certified": len(names),
        "points": points,
        "ok": bool(points) and all(p["certified"] for p in points),
    }
