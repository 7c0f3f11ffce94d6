"""Batched What/When/Where sweep engine (the planner's fast path).

`planner.decide` answers the paper's three questions one scalar
cost-model call at a time.  This module flattens a whole workload —
every GEMM, every config, every candidate mapping — into two row batches
(CiM rows and baseline tile rows) and scores each in one device pass:

  * backend="vectorized": the CiM rows run `vectorized.evaluate_flat`,
    the spec as eager torch ops on the engine's device;
  * backend="pallas": the CiM rows run the hand-written sweep kernel
    (`kernels/sweep_eval.py`, CUDA C++ on the card; its plain torch
    version for a CPU engine).  The name is the JAX package's, so every
    call and CLI flag reads the same in the port; there is no fallback
    from it, so `cache_info()["pallas_fallback"]` is always None;
  * the tensor-core baseline rows run `vectorized.evaluate_baseline_flat`
    for both backends.

Results are memoized in an LRU keyed by (backend, GEMM shape, system
config, order_mode), so repeated queries (every serving core asks about
the same GEMMs) touch no device.  The cache and the hit/miss counters —
per engine, per calling thread and per backend keyspace — are guarded by
a lock.

`SweepEngine(chunk_rows=N)` bounds every device pass to N rows: the grid
is generated group by group (a group is one query's candidate rows) and
streamed through the kernel in tiles, with a cross-chunk running
reduction per group that keeps the first index on ties, so the result is
bit for bit the whole-batch one; `cache_info()["chunks"]` counts them.

Row mesh: `SweepEngine(mesh=...)` takes a 1-D `DeviceMesh` of ranks
(`launch.mesh.row_mesh`, `launch.distributed.global_row_mesh`).  Every
rank enumerates the same tiles SPMD; each tile is padded (by repeating
its first row) to a multiple of the mesh size, each rank scores its
contiguous row shard on its own device (`device`), and the (11, n/w)
outputs are all-gathered (`launch.distributed.gather_rows`), stripped of
the padding and folded by the identical reduction on every rank.  Rows
are independent, so the result is bit for bit the unsharded engine's.
The JAX package also pads every tile to a power of two to bound its jit
retraces; nothing here is traced, so `cache_info()["chunks"]
["padded_rows"]` counts only the alignment padding (0 without a mesh).
A mesh holding other ranks adds `cache_info()["distributed"]`: the
topology and the cumulative per-rank shard balance.  The ranks of a
mesh must issue the same queries in the same order; a sharded engine
is not for concurrent threads.  So `default_engine`, which each rank's
serving and plan service use for its own traffic, is never sharded.

Not ported: the JAX package's jit registry (`jit_cache_clear`,
`jit_kernel_count`: nothing here is jitted) and its VMEM-sized block
autotune.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np
import torch

from .baseline import evaluate_baseline
from .cost_model import Metrics, evaluate, metrics_from_row
from .gemm import GEMM
from .loopnest import check_order_mode
from .mapping import candidate_mappings
from .memory import CiMSystemConfig
from .vectorized import (BASE_FLAT_FIELDS, FLAT_FIELDS, MAP_FIELDS,
                         SWEEP_OUT_FIELDS, config_row,
                         enumerate_baseline_space, evaluate_baseline_flat,
                         evaluate_flat, precision_row)

_OUT_KEYS = ("energy_pj", "time_ns", "compute_ns", "dram_ns", "smem_ns",
             "utilization", "dram_bytes", "smem_bytes", "valid")

# The result-cache/counter buckets a CiM query can resolve to; the
# baseline keyspace is "baseline".
CIM_BACKENDS = ("vectorized", "pallas")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" on a torch without a CUDA
    device raises (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the sweep engine runs on 'cuda' by default and "
                           "this torch has no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the sweep engine runs on cuda or cpu, got {dev}")
    return dev


def _gemm_key(g: GEMM):
    return (g.M, g.N, g.K, g.bits, g.fp)


def _cfg_key(cfg: CiMSystemConfig):
    p = cfg.prim
    return (p.name, p.Rp, p.Cp, p.Rh, p.Ch, p.capacity_bytes, p.latency_ns,
            p.mac_energy_pj, cfg.cim_level, cfg.resolved_n_prims(),
            cfg.serialize_primitives, cfg.kn_balance_threshold)


def _pad_len(n: int, shards: int = 1) -> int:
    """n rounded up to a multiple of the shard count, so the row axis
    splits evenly."""
    return -(-n // shards) * shards


def _auto_mesh():
    """The global row mesh when this process belongs to a group of more
    than one rank, else None (the unsharded path)."""
    from ..launch import distributed as dist
    if dist.distributed_info()["processes"] > 1:
        return dist.global_row_mesh()
    return None


def _run_sharded(fn, host: np.ndarray, mesh, device) -> np.ndarray:
    """Score the (F, n) host matrix over `mesh`: pad it to a multiple of
    the mesh size by repeating row 0, run this rank's row shard (its
    `Shard(0)` slice from `host_local_to_global`) through `fn` on
    `device`, all-gather the output rows and drop the padding."""
    from ..launch import distributed as dist
    n = host.shape[1]
    m = _pad_len(n, mesh.size())
    if m != n:
        host = np.concatenate([host, np.repeat(host[:, :1], m - n, 1)], 1)
    shard = dist.host_local_to_global({"rows": host.T}, mesh)["rows"]
    local = fn(shard.to_local().to(device).T.contiguous())
    out = dist.gather_rows({f: local[j] for j, f in
                            enumerate(SWEEP_OUT_FIELDS)}, mesh)
    return np.stack([out[f][:n] for f in SWEEP_OUT_FIELDS])


def _cat_cols(parts: list[dict]) -> dict:
    """Concatenate columnar row-group slices into one flat batch."""
    if len(parts) == 1:
        return dict(parts[0])
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _iter_chunks(groups, chunk_rows: int | None):
    """The streaming enumerator: walk `groups` — an iterable of (gid,
    cols), cols a dict of equal-length (n,) numpy columns — and yield
    evaluation tiles of at most `chunk_rows` rows.

    Yields (batch, segments): `batch` is the concatenated columns,
    `segments` is [(gid, group_offset, lo, hi)] mapping each slice of the
    tile back to its group (a group larger than a tile spans several).
    chunk_rows=None yields one tile holding everything.  Groups are
    consumed lazily."""
    parts: list[dict] = []
    segs: list[tuple] = []
    filled = 0
    for gid, cols in groups:
        n = len(next(iter(cols.values())))
        off = 0
        while off < n:
            take = (n - off if chunk_rows is None
                    else min(n - off, chunk_rows - filled))
            parts.append({k: v[off:off + take] for k, v in cols.items()})
            segs.append((gid, off, filled, filled + take))
            filled += take
            off += take
            if chunk_rows is not None and filled >= chunk_rows:
                yield _cat_cols(parts), segs
                parts, segs, filled = [], [], 0
    if filled:
        yield _cat_cols(parts), segs


def candidate_cols(gemm: GEMM, cfg: CiMSystemConfig, order_mode: str):
    """(mappings, cols): the candidate mappings of one (GEMM, config)
    query and their FLAT_FIELDS rows as (n,) f32 numpy columns."""
    maps = candidate_mappings(gemm, cfg, order_mode)
    crow = {"M": gemm.M, "N": gemm.N, "K": gemm.K,
            **precision_row(gemm), **config_row(cfg)}
    cols = {f: np.full(len(maps), float(v), np.float32)
            for f, v in crow.items()}
    for f in MAP_FIELDS:
        cols[f] = np.asarray([getattr(mp, f) for mp in maps], np.float32)
    return maps, cols


def _cim_fn(kernel: str, order_mode: str):
    """(24, n) field matrix on the device -> (11, n) output matrix in
    SWEEP_OUT_FIELDS order."""
    from ..kernels.sweep_eval import sweep_eval   # kernels import core
    if kernel == "pallas":
        return lambda rows: sweep_eval(rows, order_mode=order_mode)

    def run(rows):
        out = evaluate_flat({f: rows[i] for i, f in enumerate(FLAT_FIELDS)},
                            order_mode=order_mode)
        return torch.stack([out[f].to(torch.float32)
                            for f in SWEEP_OUT_FIELDS])
    return run


def _base_fn(rows):
    out = evaluate_baseline_flat(
        {f: rows[i] for i, f in enumerate(BASE_FLAT_FIELDS)})
    return torch.stack([out[f].to(torch.float32) for f in SWEEP_OUT_FIELDS])


class SweepEngine:
    """Whole-workload batched planner evaluation with an LRU result cache.

    cim_metrics / baseline_metrics return the Metrics the scalar cost
    model produces (within float32 tolerance), evaluating every uncached
    (GEMM, config) pair of a query in one device pass (or one per chunk
    of `chunk_rows` rows).  `device` defaults to "cuda"; a CPU engine
    passes device="cpu".

    mesh: "auto" (default) is the global row mesh when this process
    belongs to a process group of more than one rank, and None (the
    unsharded path) otherwise; None forces the unsharded path; an
    explicit 1-D `DeviceMesh` is always honored — a one-rank mesh too,
    which runs the sharded path for parity testing."""

    def __init__(self, cache_size: int = 16384, mesh="auto",
                 chunk_rows: int | None = None, device="cuda"):
        if chunk_rows is not None and chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1 or None, "
                             f"got {chunk_rows}")
        self.device = resolve_device(device)
        self.cache_size = cache_size
        self.chunk_rows = chunk_rows
        self._mesh = mesh
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self._local = threading.local()   # per-thread hit/miss counters
        self.hits = 0
        self.misses = 0
        self._backend_counts: dict = {}
        self._chunks_evaluated = 0
        self._rows_evaluated = 0
        self._rows_padded = 0

    @property
    def mesh(self):
        """The resolved row mesh ("auto" is resolved at first use, not at
        construction)."""
        if isinstance(self._mesh, str):
            if self._mesh != "auto":
                raise ValueError(f"mesh must be 'auto', None or a "
                                 f"DeviceMesh, got {self._mesh!r}")
            self._mesh = _auto_mesh()
        return self._mesh

    @property
    def n_shards(self) -> int:
        return self.mesh.size() if self.mesh is not None else 1

    # --- cache plumbing ---------------------------------------------------
    def _get(self, key, bucket: str):
        with self._lock:
            counts = self._backend_counts.setdefault(
                bucket, {"hits": 0, "misses": 0})
            if key in self._cache:
                self._cache.move_to_end(key)
                self.hits += 1
                counts["hits"] += 1
                self._local.hits = getattr(self._local, "hits", 0) + 1
                return self._cache[key]
            self.misses += 1
            counts["misses"] += 1
            self._local.misses = getattr(self._local, "misses", 0) + 1
            return None

    def thread_cache_counts(self) -> tuple[int, int]:
        """(hits, misses) accrued by the CALLING thread only — monotonic,
        unaffected by cache_clear (see measured_cache_delta)."""
        tl = self._local
        return getattr(tl, "hits", 0), getattr(tl, "misses", 0)

    def _put(self, key, value):
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    def cache_info(self) -> dict:
        """Size + hit/miss totals, the per-backend breakdown (vectorized /
        pallas / baseline keyspaces), `pallas_fallback` (always None: the
        port never falls back from the kernel), the device and kernel
        mode, the streaming accounting under "chunks" (tiles evaluated,
        real and padding rows), and "distributed": None, or on a mesh
        holding other ranks the topology (`distributed_info()`), the mesh
        size and the cumulative per-rank row shard balance."""
        from ..kernels.sweep_eval import kernel_status
        with self._lock:
            info = {"size": len(self._cache), "max_size": self.cache_size,
                    "hits": self.hits, "misses": self.misses,
                    "backends": {b: dict(c) for b, c in
                                 self._backend_counts.items()},
                    "pallas_fallback": None,
                    "device": str(self.device),
                    "kernel": kernel_status(self.device)["mode"],
                    "chunks": {"chunk_rows": self.chunk_rows,
                               "evaluated": self._chunks_evaluated,
                               "rows": self._rows_evaluated,
                               "padded_rows": self._rows_padded},
                    "distributed": None}
        from ..launch import distributed as dist
        if dist.is_multihost(self.mesh):
            c = info["chunks"]
            info["distributed"] = {
                **dist.distributed_info(),
                "mesh_devices": self.mesh.size(),
                "shard_balance": dist.shard_balance(
                    c["rows"] + c["padded_rows"], self.mesh)}
        return info

    def cache_clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.hits = self.misses = 0
            self._backend_counts = {}
            self._chunks_evaluated = 0
            self._rows_evaluated = 0
            self._rows_padded = 0

    # --- streaming evaluation --------------------------------------------
    def _stream_batches(self, fn, fields, groups, update) -> None:
        """Fold a lazily-enumerated grid through `fn` tile by tile: each
        tile's columns form one (len(fields), n) matrix, scored on the
        device (over the row mesh, `_run_sharded`, when there is one), the
        (11, n) result comes back as host columns, and
        `update(gid, group_offset, out, lo, hi)` folds each segment into
        the caller's running per-group reduction."""
        mesh = self.mesh
        for cols, segs in _iter_chunks(groups, self.chunk_rows):
            n = len(next(iter(cols.values())))
            host = np.stack([np.asarray(cols[f], np.float32) for f in fields])
            if mesh is None:
                res = fn(torch.from_numpy(host).to(self.device)).cpu().numpy()
            else:
                res = _run_sharded(fn, host, mesh, self.device)
            out = {f: res[j] for j, f in enumerate(SWEEP_OUT_FIELDS)}
            out["valid"] = out["valid"] > 0.5
            with self._lock:
                self._chunks_evaluated += 1
                self._rows_evaluated += n
                if mesh is not None:
                    self._rows_padded += _pad_len(n, mesh.size()) - n
            for gid, off, lo, hi in segs:
                update(gid, off, out, lo, hi)

    # --- CiM options ------------------------------------------------------
    def cim_metrics(self, pairs: Sequence[tuple[GEMM, CiMSystemConfig]],
                    order_mode: str = "exact",
                    backend: str = "vectorized") -> list[Metrics]:
        """Metrics for each (GEMM, config) pair: the min-energy candidate
        mapping (first on ties), scored on the device (==
        cost_model.evaluate).  Both order modes select the DRAM order
        per row in the kernel.  Each backend has its own result-cache
        keyspace, so backend parity tests measure the kernel, not the
        LRU."""
        check_order_mode(order_mode)
        if backend not in CIM_BACKENDS:
            raise ValueError(f"unknown sweep backend {backend!r}; "
                             f"expected one of {CIM_BACKENDS}")
        keys = [("cim", backend, _gemm_key(g), _cfg_key(c), order_mode)
                for g, c in pairs]
        results: dict = {}
        todo: OrderedDict = OrderedDict()      # key -> (gemm, cfg)
        for key, (g, c) in zip(keys, pairs):
            hit = self._get(key, backend)
            if hit is not None:
                results[key] = hit
            else:
                todo.setdefault(key, (g, c))

        if todo:
            best: dict = {}          # key -> [energy, out_row, mapping]
            # candidate lists of groups still in flight, dropped as soon
            # as a group completes (host memory holds O(chunk) mappings)
            live: dict = {}          # key -> [maps, rows_remaining]

            def groups():
                for key, (g, c) in todo.items():
                    maps, cols = candidate_cols(g, c, order_mode)
                    live[key] = [maps, len(maps)]
                    yield key, cols

            def update(key, off, out, lo, hi):
                # min-energy valid row; strict < keeps the first index on
                # ties, within a tile (np.argmin) and across tiles alike
                entry = live[key]
                e = np.where(out["valid"][lo:hi],
                             out["energy_pj"][lo:hi], np.inf)
                i = int(np.argmin(e))
                st = best.get(key)
                if np.isfinite(e[i]) and (st is None or e[i] < st[0]):
                    best[key] = [e[i], {k: out[k][lo + i]
                                        for k in _OUT_KEYS},
                                 entry[0][off + i]]
                entry[1] -= hi - lo
                if entry[1] == 0:              # group fully reduced
                    del live[key]

            self._stream_batches(_cim_fn(backend, order_mode), FLAT_FIELDS,
                                 groups(), update)
            for key, (g, c) in todo.items():
                st = best.get(key)
                if st is None:                 # should not happen: mappings
                    met = evaluate(g, c, order_mode)   # are pre-validated
                else:
                    met = metrics_from_row(g.ops, st[1], mapping=st[2])
                self._put(key, met)
                results[key] = met
        return [results[k] for k in keys]

    # --- tensor-core baseline --------------------------------------------
    def baseline_metrics(self, gemms: Sequence[GEMM]) -> list[Metrics]:
        """Baseline Metrics per GEMM: the full tile grid scored on the
        device, lexicographic (time, energy) winner (==
        evaluate_baseline)."""
        keys = [("base", _gemm_key(g)) for g in gemms]
        results: dict = {}
        todo: OrderedDict = OrderedDict()
        for key, g in zip(keys, gemms):
            hit = self._get(key, "baseline")
            if hit is not None:
                results[key] = hit
            else:
                todo.setdefault(key, g)

        if todo:
            best: dict = {}          # key -> [time, energy, out_row]

            def groups():
                for key, g in todo.items():
                    yield key, enumerate_baseline_space(g)

            def update(key, off, out, lo, hi):
                # lexicographic (time, energy) among valid rows, first
                # index on ties; strict-improvement replacement keeps it
                # across tiles (earlier tiles hold earlier rows)
                ok = out["valid"][lo:hi]
                t = np.where(ok, out["time_ns"][lo:hi], np.inf)
                tmin = t.min()
                if not np.isfinite(tmin):
                    return                       # no valid row in segment
                cand = np.where(t == tmin,
                                np.where(ok, out["energy_pj"][lo:hi],
                                         np.inf), np.inf)
                i = int(np.argmin(cand))
                st = best.get(key)
                if (st is None or tmin < st[0]
                        or (tmin == st[0] and cand[i] < st[1])):
                    best[key] = [tmin, cand[i],
                                 {k: out[k][lo + i] for k in _OUT_KEYS}]

            self._stream_batches(_base_fn, BASE_FLAT_FIELDS, groups(),
                                 update)
            for key, g in todo.items():
                st = best.get(key)
                met = (evaluate_baseline(g) if st is None
                       else metrics_from_row(g.ops, st[2]))
                self._put(key, met)
                results[key] = met
        return [results[k] for k in keys]


# One shared engine per device type, built at first use (importing this
# module touches no card): serving cores, campaigns' certification and
# the planner reuse each other's results.
_ENGINES: dict[str, SweepEngine] = {}
_ENGINES_LOCK = threading.Lock()


def default_engine(device="cuda") -> SweepEngine:
    """The process-wide engine for `device`'s type ("cuda" or "cpu").

    It is unsharded (mesh None) in a process group too: each rank plans
    its own traffic with it (a serving rank's plan service plans the
    buckets its traffic reaches, and re-plans them from background
    threads), so its queries are not the same on every rank, as a
    sharded engine's must be.  SPMD callers take the row mesh through
    `launch.distributed.distributed_engine`."""
    dev = resolve_device(device)
    with _ENGINES_LOCK:
        eng = _ENGINES.get(dev.type)
        if eng is None:
            eng = _ENGINES[dev.type] = SweepEngine(mesh=None, device=dev)
        return eng


def cache_info(device="cuda") -> dict:
    """`cache_info()` of the default engine of `device`'s type (the JAX
    package's module-level call, on its one default engine)."""
    return default_engine(device).cache_info()


def cache_clear(device="cuda") -> None:
    """Empty the default engine's result cache and zero its counters."""
    default_engine(device).cache_clear()


def measured_cache_delta(fn, engine: SweepEngine | None = None):
    """Run `fn()` (a plan build against `engine`, by default the default
    CUDA engine) and return (result, telemetry): the engine's hit/miss
    delta attributed to this call through its per-thread counters, plus
    the engine-wide totals.  `fn` must do its engine queries on the
    calling thread, which plan_workload does."""
    engine = engine or default_engine()
    h0, m0 = engine.thread_cache_counts()
    result = fn()
    h1, m1 = engine.thread_cache_counts()
    return result, {
        "plan_hits": h1 - h0,
        "plan_misses": m1 - m0,
        "engine": engine.cache_info(),
    }


def sweep_evaluate(gemm: GEMM, cfg: CiMSystemConfig,
                   order_mode: str = "exact", device="cuda") -> Metrics:
    """Cached batched equivalent of cost_model.evaluate."""
    return default_engine(device).cim_metrics([(gemm, cfg)], order_mode)[0]


def sweep_evaluate_baseline(gemm: GEMM, device="cuda") -> Metrics:
    """Cached batched equivalent of baseline.evaluate_baseline."""
    return default_engine(device).baseline_metrics([gemm])[0]


def plan_workload_batched(gemms: Iterable[GEMM],
                          configs: dict[str, CiMSystemConfig] | None = None,
                          order_mode: str = "exact",
                          throughput_floor: float = 0.5,
                          engine: SweepEngine | None = None,
                          backend: str = "vectorized",
                          device="cuda"):
    """Batched planner.plan_workload: one device pass per kind (CiM /
    baseline) on `engine` (default: the default engine of `device`),
    then exactly the eligibility and "when" rules of planner.decide.
    backend picks the CiM row evaluator; the baseline rows are shared by
    both backends, so verdicts can only differ through the CiM rows."""
    from .planner import make_decision, standard_configs
    engine = engine or default_engine(device)
    gemms = list(gemms)
    configs = configs or standard_configs()
    names = list(configs)
    bases = engine.baseline_metrics(gemms)
    pairs = [(g, configs[name]) for g in gemms for name in names]
    mets = engine.cim_metrics(pairs, order_mode, backend)
    decisions = []
    for i, g in enumerate(gemms):
        opts = {name: mets[i * len(names) + j]
                for j, name in enumerate(names)}
        decisions.append(make_decision(g, bases[i], opts, throughput_floor))
    return decisions


def decide_batched(gemm: GEMM,
                   configs: dict[str, CiMSystemConfig] | None = None,
                   order_mode: str = "exact",
                   throughput_floor: float = 0.5,
                   engine: SweepEngine | None = None,
                   backend: str = "vectorized",
                   device="cuda"):
    """plan_workload_batched for one GEMM."""
    return plan_workload_batched([gemm], configs, order_mode,
                                 throughput_floor, engine, backend,
                                 device)[0]
