"""Shape-bucketed plan service: online What/When/Where under live traffic
(the port of the JAX package's `repro/core/plan_service.py`, under the
same names).

The paper's verdict depends on the GEMM shape, and under live traffic the
shapes are not static: the N dimension of every decode GEMM moves with the
active-slot count (ragged batches joining and leaving) and the positions
grow token by token.  A `KernelPlanTable` frozen once at session build
time is therefore stale the moment occupancy changes — the batch-1 vs
batch-1024 asymmetry is exactly the paper's "when" axis.

This module makes the planner a *service* beside the model server:

  * `BucketLattice` quantizes an incoming decode operating point
    (active-slot count, max position) onto a small grid of buckets —
    each bucket edge is the representative shape its plan is computed
    at, and lookups snap *up* to the nearest edge so a bucket's plan is
    always computed at a shape at least as large as any point it serves;
  * `PlanService` answers `lookup(n_active, max_pos)` with that bucket's
    versioned `KernelPlanTable`.  Plans are built through the batched
    sweep backends (`planner.plan_workload`, so the thread-safe
    `SweepEngine` LRU makes repeat bucket builds nearly free), memoized
    per bucket, and — with `refresh_every=N` — re-planned after every N
    lookups, either synchronously or on a background thread
    (`background=True`): serving never blocks on a refresh, it keeps the
    previous table until the new one lands.  A refresh whose table
    differs from the cached one is a **verdict flip**; the serving layer
    (`repro_torch.serving.ContinuousBatchingEngine`) hot-swaps between
    already-captured decode steps when it observes one.

The planner runs on `device` ("cuda" unless the caller passes "cpu"):
the sweep engine of that device, and with backend="pallas" the
hand-written sweep kernel.  A background refresh does that device work
while the serving thread may be capturing a new plan variant as a CUDA
graph; in CUDA's default (global) capture mode no other thread may copy
to or from the host during a capture, so every refresh holds
`repro_torch.serving.graphs.capture_lock`, which each capture holds too:
refreshes and captures are serialized (a refresh waits for a capture,
which is rare and off the decode hot path, and the other way round).

Telemetry (`telemetry()`): per-bucket hit/miss/build/flip counters,
build latencies, table digests, and the service-wide lookup hit rate.
`plan_fn` is injectable so tests can force deterministic verdict flips
without faking traffic shapes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from ..configs.base import ModelConfig, ShapeConfig
from ..quant.plan_table import KernelPlanTable


def _pow2_edges(top: int) -> tuple[int, ...]:
    """1, 2, 4, ... capped at (and always including) `top`."""
    edges, e = [], 1
    while e < top:
        edges.append(e)
        e *= 2
    edges.append(top)
    return tuple(edges)


@dataclasses.dataclass(frozen=True)
class BucketLattice:
    """The bucket grid: ascending active-slot and max-position edges.

    A point (n_active, max_pos) maps to the smallest edge >= it on each
    axis (points beyond the top edge clamp to it), so every bucket's
    representative shape dominates the points it serves — the plan is
    never computed at a smaller GEMM than the one being decoded."""
    batch_edges: tuple[int, ...]
    len_edges: tuple[int, ...]

    def __post_init__(self):
        for name, edges in (("batch_edges", self.batch_edges),
                            ("len_edges", self.len_edges)):
            if not edges:
                raise ValueError(f"{name} must not be empty")
            if any(e < 1 for e in edges):
                raise ValueError(f"{name} must be positive, got {edges}")
            if any(a >= b for a, b in zip(edges, edges[1:])):
                raise ValueError(
                    f"{name} must be strictly ascending, got {edges}")

    @classmethod
    def for_engine(cls, n_slots: int, max_len: int) -> "BucketLattice":
        """Power-of-two edges covering an engine's slot/length geometry —
        the default lattice `launch.serve --adaptive` builds."""
        return cls(_pow2_edges(max(1, n_slots)),
                   _pow2_edges(max(1, max_len)))

    @classmethod
    def parse(cls, spec: str) -> "BucketLattice":
        """Parse a `--bucket-edges` CLI spec: "b1,b2,..:l1,l2,.."
        (batch edges, then length edges, colon-separated)."""
        try:
            b_part, l_part = spec.split(":")
            batch = tuple(int(x) for x in b_part.split(",") if x)
            lens = tuple(int(x) for x in l_part.split(",") if x)
        except ValueError:
            raise ValueError(
                f"bad bucket-edges spec {spec!r}: expected "
                f"'b1,b2,..:l1,l2,..' (e.g. '1,2,4:64,256')") from None
        return cls(batch, lens)

    @property
    def n_buckets(self) -> int:
        return len(self.batch_edges) * len(self.len_edges)

    @staticmethod
    def _snap_up(edges: tuple[int, ...], v: int) -> int:
        for e in edges:
            if v <= e:
                return e
        return edges[-1]

    def bucket_of(self, n_active: int, max_pos: int) -> tuple[int, int]:
        """The (batch_edge, len_edge) bucket serving this operating
        point.  max_pos is the deepest active position (0 for a batch of
        fresh slots) — it snaps as a *length*, i.e. max_pos + 1."""
        return (self._snap_up(self.batch_edges, max(1, n_active)),
                self._snap_up(self.len_edges, max(1, max_pos + 1)))


class _BucketRecord:
    """Mutable per-bucket state (guarded by the service lock)."""

    def __init__(self):
        self.table: KernelPlanTable | None = None
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.flips = 0
        self.flipped_labels: tuple[str, ...] = ()
        self.age = 0              # lookups since the table was (re)built
        self.refreshing = False   # a refresh is in flight
        self.last_build_s: float | None = None


class PlanService:
    """Shape-bucketed verdict server: bucket -> versioned KernelPlanTable.

    `lookup(n_active, max_pos)` quantizes the operating point onto the
    lattice and returns `(bucket, table)`.  A bucket's first lookup
    builds its plan synchronously (there is nothing to serve yet);
    afterwards lookups are dictionary hits, and every `refresh_every`
    hits the bucket is re-planned — on a daemon thread when
    `background=True` (the default: serving keeps the stale table until
    the fresh one lands) or inline otherwise (deterministic, what tests
    and the benchmark use).  A refresh that changes the table counts as
    a verdict flip and records the flipped labels.

    plan_fn(shape) -> list[planner.Decision] defaults to the batched
    sweep planner over `gemms_of_model(cfg, shape)` on `device`; inject
    it to force deterministic flips or stub the planner.
    """

    def __init__(self, cfg: ModelConfig, lattice: BucketLattice,
                 refresh_every: int = 0, backend: str = "vectorized",
                 plan_fn: Callable | None = None, background: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 device: Any = "cuda"):
        if refresh_every < 0:
            raise ValueError(
                f"refresh_every must be >= 0 (0 = never), "
                f"got {refresh_every}")
        self.cfg = cfg
        self.lattice = lattice
        self.refresh_every = refresh_every
        self.backend = backend
        self.background = background
        self.clock = clock
        self.device = device
        self._plan_fn = plan_fn or self._default_plan_fn
        self._lock = threading.Lock()     # stats + table installs
        self._build_lock = threading.Lock()  # serializes first builds
        self._buckets: dict[tuple[int, int], _BucketRecord] = {}
        self._threads: list[threading.Thread] = []

    # --- planning ---------------------------------------------------------

    def plan_shape(self, bucket: tuple[int, int]) -> ShapeConfig:
        """The representative decode shape a bucket's plan is computed
        at: batch = the bucket's slot edge, seq_len = its length edge."""
        b, l = bucket
        return ShapeConfig(f"bucket-b{b}-l{l}", l, b, "decode")

    def _default_plan_fn(self, shape: ShapeConfig):
        from .llm_workloads import gemms_of_model
        from .planner import plan_workload
        return plan_workload(gemms_of_model(self.cfg, shape),
                             backend=self.backend, device=self.device)

    def _build(self, bucket: tuple[int, int]
               ) -> tuple[KernelPlanTable, float]:
        from ..serving.graphs import capture_lock
        t0 = self.clock()
        with capture_lock:              # never beside a graph capture
            decisions = self._plan_fn(self.plan_shape(bucket))
        table = KernelPlanTable.from_decisions(decisions,
                                               model_name=self.cfg.name)
        return table, self.clock() - t0

    def _refresh(self, bucket: tuple[int, int]) -> None:
        """Re-plan one bucket and install the result; a changed table is
        a verdict flip (flipped labels recorded for telemetry)."""
        table, dt = self._build(bucket)
        with self._lock:
            rec = self._buckets[bucket]
            old = rec.table
            rec.table = table
            rec.builds += 1
            rec.last_build_s = dt
            rec.age = 0
            rec.refreshing = False
            if old is not None and old != table:
                rec.flips += 1
                rec.flipped_labels = old.flips(table)

    # --- the serving-side API ---------------------------------------------

    def lookup(self, n_active: int, max_pos: int
               ) -> tuple[tuple[int, int], KernelPlanTable]:
        """(bucket, table) for one decode operating point.  First lookup
        of a bucket builds its plan synchronously; later lookups serve
        the memoized table, scheduling a refresh every `refresh_every`
        hits (background or inline per the service mode)."""
        bucket = self.lattice.bucket_of(n_active, max_pos)
        refresh_due = False
        with self._lock:
            rec = self._buckets.setdefault(bucket, _BucketRecord())
            if rec.table is None:
                rec.misses += 1
            else:
                rec.hits += 1
                rec.age += 1
                if (self.refresh_every
                        and rec.age >= self.refresh_every
                        and not rec.refreshing):
                    rec.refreshing = True
                    refresh_due = True
        if rec.table is None:
            # cold bucket: nothing to serve yet, so the build is
            # synchronous (serialized so concurrent cold lookups of one
            # bucket plan it once)
            with self._build_lock:
                if rec.table is None:
                    self._refresh(bucket)
        elif refresh_due:
            if self.background:
                t = threading.Thread(target=self._refresh, args=(bucket,),
                                     daemon=True)
                with self._lock:
                    self._threads = [x for x in self._threads
                                     if x.is_alive()] + [t]
                t.start()
            else:
                self._refresh(bucket)
        with self._lock:
            return bucket, rec.table

    def drain(self, timeout_s: float = 30.0) -> None:
        """Join in-flight background refreshes (tests / clean shutdown)."""
        with self._lock:
            threads = list(self._threads)
        deadline = time.perf_counter() + timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                raise RuntimeError("background plan refresh did not "
                                   f"finish within {timeout_s}s")

    # --- telemetry --------------------------------------------------------

    @property
    def verdict_flips(self) -> int:
        with self._lock:
            return sum(r.flips for r in self._buckets.values())

    def telemetry(self) -> dict:
        """Per-bucket hit/miss/build/flip counters + table digests, and
        the service-wide lookup hit rate — embedded in the serving
        engine's telemetry() `adaptive` block and the adaptive bench."""
        with self._lock:
            buckets = {}
            hits = misses = 0
            for (b, l), rec in sorted(self._buckets.items()):
                hits += rec.hits
                misses += rec.misses
                buckets[f"b{b}xl{l}"] = {
                    "batch_edge": b,
                    "len_edge": l,
                    "hits": rec.hits,
                    "misses": rec.misses,
                    "builds": rec.builds,
                    "flips": rec.flips,
                    "flipped_labels": list(rec.flipped_labels),
                    "refresh_in_flight": rec.refreshing,
                    "last_build_s": rec.last_build_s,
                    "table_digest": (rec.table.digest
                                     if rec.table is not None else None),
                }
            total = hits + misses
            return {
                "lattice": {"batch_edges": list(self.lattice.batch_edges),
                            "len_edges": list(self.lattice.len_edges)},
                "refresh_every": self.refresh_every,
                "backend": self.backend,
                "background": self.background,
                "lookups": total,
                "hit_rate": hits / total if total else None,
                "verdict_flips": sum(r.flips
                                     for r in self._buckets.values()),
                "buckets": buckets,
            }
