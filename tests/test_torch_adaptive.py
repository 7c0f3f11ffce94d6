"""Online adaptive planning in the port, on the CPU: the port's form of
tests/test_adaptive_planning.py, on reduced qwen2-7b (dense) in place of
the mamba fixture.

* `BucketLattice` — snap-up bucketing, clamping, `for_engine`, `parse`,
  validation, as the JAX package's;
* `PlanService` — cold miss then warm hits, `refresh_every` refreshes,
  verdict-flip detection with an injected `plan_fn`, background drain;
  the default planner builds the reference's table (equal digest); a
  background refresh waits while a capture holds `capture_lock`;
* `DecodeCore.batch_step_for` — one step object per distinct plan table
  in an LRU bounded by `max_plan_variants`;
* the engine — token-exact against the frozen-plan engine when no
  verdict flips, and a forced mid-run flip hot-swaps the plan
  (`plan_variants` == the distinct plans served).
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core.plan_service import BucketLattice as JaxBucketLattice
from repro.core.plan_service import PlanService as JaxPlanService

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.core import BucketLattice, PlanService
from repro_torch.models import init
from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                 synthetic_requests)
from repro_torch.serving.graphs import capture_lock

RC = RunConfig(attn_impl="naive", remat=False, kv_cache_dtype="float32")
MAX_LEN = 24
BLOCK = 4
N_SLOTS = 2


@pytest.fixture(scope="module")
def dense():
    import torch
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-7b"]),
                              param_dtype="float32", compute_dtype="float32")
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    core = DecodeCore(cfg, RC, params, quantize=True, plan_batch=N_SLOTS,
                      plan_max_len=MAX_LEN, device="cpu")
    return cfg, params, core


def _engine(core, service=None, **kw):
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BLOCK)
    return ContinuousBatchingEngine(core, plan_service=service, **kw)


def _requests(cfg, n=3):
    return synthetic_requests(cfg, n, seed=0, prompt_len=(3, 6),
                              new_tokens=(4, 8))


def _streams(engine):
    return {r.rid: [int(t) for t in r.tokens] for r in engine.completed}


# --- BucketLattice ----------------------------------------------------------

def test_lattice_snaps_up_and_clamps():
    lat = BucketLattice((1, 2, 4), (8, 16, 24))
    assert lat.bucket_of(1, 0) == (1, 8)
    assert lat.bucket_of(1, 7) == (1, 8)       # position 7 needs length 8
    assert lat.bucket_of(1, 8) == (1, 16)
    assert lat.bucket_of(3, 20) == (4, 24)
    assert lat.bucket_of(99, 999) == (4, 24)   # beyond the top: clamp
    assert lat.bucket_of(0, -3) == (1, 8)
    assert lat.n_buckets == 9


def test_lattice_matches_reference_everywhere():
    """Every operating point of an engine's lattice lands in the bucket
    the JAX package's lattice picks, and each bucket dominates it."""
    ours, ref = BucketLattice.for_engine(8, 65), JaxBucketLattice.for_engine(
        8, 65)
    assert (ours.batch_edges, ours.len_edges) == (ref.batch_edges,
                                                  ref.len_edges)
    for n in range(0, 10):
        for pos in range(0, 70):
            b, l = ours.bucket_of(n, pos)
            assert (b, l) == ref.bucket_of(n, pos)
            if 1 <= n <= 8 and pos < 65:
                assert b >= n and l >= pos + 1


def test_lattice_for_engine_pow2_edges():
    lat = BucketLattice.for_engine(4, 24)
    assert lat.batch_edges == (1, 2, 4)
    assert lat.len_edges == (1, 2, 4, 8, 16, 24)
    assert BucketLattice.for_engine(3, 10).batch_edges == (1, 2, 3)


def test_lattice_parse_roundtrip_and_errors():
    lat = BucketLattice.parse("1,2,4:8,24")
    assert (lat.batch_edges, lat.len_edges) == ((1, 2, 4), (8, 24))
    for bad in ("1,2,4", "1,x:8"):
        with pytest.raises(ValueError, match="bucket-edges spec"):
            BucketLattice.parse(bad)


def test_lattice_validation():
    with pytest.raises(ValueError, match="must not be empty"):
        BucketLattice((), (8,))
    with pytest.raises(ValueError, match="must be positive"):
        BucketLattice((0, 2), (8,))
    with pytest.raises(ValueError, match="strictly ascending"):
        BucketLattice((1, 2), (8, 8))


# --- PlanService ------------------------------------------------------------

def _decision(label, use_cim, what="baseline", where="PE"):
    gemm = dataclasses.make_dataclass("G", ["label"])(label)
    return dataclasses.make_dataclass(
        "D", ["gemm", "use_cim", "what", "where"])(gemm, use_cim, what, where)


def _stub_plan_fn(flip_on_build=None):
    """Planner stub: one fixed verdict set, toggling Wq from the
    `flip_on_build`-th build (0-indexed) of each shape onward."""
    builds = {}

    def plan_fn(shape):
        n = builds.get(shape.name, 0)
        builds[shape.name] = n + 1
        flip = flip_on_build is not None and n >= flip_on_build
        return [_decision("Wq", not flip), _decision("lm_head", False)]

    return plan_fn


def test_service_miss_then_hits(dense):
    cfg, _, _ = dense
    svc = PlanService(cfg, BucketLattice((2,), (24,)), background=False,
                      plan_fn=_stub_plan_fn(), device="cpu")
    b1, t1 = svc.lookup(1, 3)
    b2, t2 = svc.lookup(2, 10)
    assert b1 == b2 == (2, 24)
    assert t1 is t2                      # memoized, not rebuilt
    tel = svc.telemetry()
    assert tel["lookups"] == 2
    rec = tel["buckets"]["b2xl24"]
    assert (rec["misses"], rec["hits"], rec["builds"]) == (1, 1, 1)
    assert rec["table_digest"] == t1.digest
    assert tel["hit_rate"] == 0.5 and tel["verdict_flips"] == 0


def test_service_refresh_and_flip_detection(dense):
    cfg, _, _ = dense
    svc = PlanService(cfg, BucketLattice((2,), (24,)), refresh_every=2,
                      background=False, plan_fn=_stub_plan_fn(1),
                      device="cpu")
    _, t0 = svc.lookup(1, 1)             # miss: build 0
    _, t1 = svc.lookup(1, 1)             # hit 1
    _, t2 = svc.lookup(1, 1)             # hit 2 -> inline refresh: flip
    assert t1 == t0 and t2 != t0
    assert svc.verdict_flips == 1
    rec = svc.telemetry()["buckets"]["b2xl24"]
    assert rec["flips"] == 1 and rec["flipped_labels"] == ["Wq"]
    assert rec["builds"] == 2
    assert svc.lookup(1, 1)[1] == t2


def test_service_background_refresh_drains(dense):
    cfg, _, _ = dense
    svc = PlanService(cfg, BucketLattice((2,), (24,)), refresh_every=1,
                      background=True, plan_fn=_stub_plan_fn(1),
                      device="cpu")
    svc.lookup(1, 1)
    svc.lookup(1, 1)                     # schedules the background refresh
    svc.drain()
    assert svc.verdict_flips == 1
    assert svc.lookup(1, 1)[1].use_cim("Wq") is False


def test_background_refresh_waits_for_a_capture(dense):
    """A refresh does its planner work under `capture_lock`: while a
    capture holds the lock, the refresh cannot land."""
    cfg, _, _ = dense
    started = threading.Event()
    inner = _stub_plan_fn(1)

    def plan_fn(shape):
        started.set()
        return inner(shape)

    svc = PlanService(cfg, BucketLattice((2,), (24,)), refresh_every=1,
                      background=True, plan_fn=plan_fn, device="cpu")
    svc.lookup(1, 1)                     # cold build, inline
    started.clear()
    with capture_lock:                   # a capture in progress
        svc.lookup(1, 1)                 # schedules the refresh
        assert not started.wait(0.3)     # ... which waits
        assert svc.verdict_flips == 0
    svc.drain(timeout_s=30)
    assert started.is_set() and svc.verdict_flips == 1


def test_service_rejects_negative_refresh(dense):
    cfg, _, _ = dense
    with pytest.raises(ValueError, match="refresh_every"):
        PlanService(cfg, BucketLattice((2,), (24,)), refresh_every=-1,
                    device="cpu")


@pytest.mark.parametrize("bucket", [(N_SLOTS, MAX_LEN), (1, 8)])
def test_service_default_planner_builds_reference_table(dense, bucket):
    """The un-stubbed service plans through the batched sweep: the same
    table (digest) as the JAX package's service for the same bucket, and
    the core's frozen plan at the core's own planning shape."""
    cfg, _, core = dense
    lat = BucketLattice((bucket[0],), (bucket[1],))
    _, table = PlanService(cfg, lat, background=False, device="cpu").lookup(
        bucket[0], bucket[1] - 1)
    jcfg = jax_reduced(JAX_ARCHS["qwen2-7b"])
    _, want = JaxPlanService(jcfg, JaxBucketLattice(*map(tuple, (
        (bucket[0],), (bucket[1],)))), background=False).lookup(
        bucket[0], bucket[1] - 1)
    assert table.digest == want.digest
    if bucket == (N_SLOTS, MAX_LEN):
        assert table == core.plan_table


# --- DecodeCore bounded variant cache ---------------------------------------

def test_core_variant_cache_bounded_and_keyed_by_table(dense):
    cfg, params, _ = dense
    core = DecodeCore(cfg, RC, params, quantize=True, plan_batch=N_SLOTS,
                      plan_max_len=MAX_LEN, max_plan_variants=2,
                      device="cpu")
    base = core.plan_table
    fn0 = core.batch_step_for(base)
    assert core.batch_step_for(base) is fn0          # same table, same fn
    assert core.batch_step is fn0
    flipped = base.with_flip(base.labels[0])
    fn1 = core.batch_step_for(flipped)
    assert fn1 is not fn0 and fn1.plan == flipped
    assert core.plan_variants == 2 and core.plan_evictions == 0
    third = flipped.with_flip(base.labels[-1])
    core.batch_step_for(third)                       # evicts base (LRU)
    assert core.plan_variants == 2 and core.plan_evictions == 1
    assert core.batch_step_for(base) is not fn0      # made anew
    assert core.plan_variants == 2 and core.plan_evictions == 2


def test_core_rejects_nonpositive_variant_bound(dense):
    cfg, params, _ = dense
    with pytest.raises(ValueError, match="max_plan_variants"):
        DecodeCore(cfg, RC, params, quantize=True, plan_batch=N_SLOTS,
                   plan_max_len=MAX_LEN, max_plan_variants=0, device="cpu")


# --- engine integration ------------------------------------------------------

def test_engine_requires_gated_core_for_adaptive(dense):
    cfg, params, _ = dense
    ungated = DecodeCore(cfg, RC, params, quantize=False, device="cpu")
    svc = PlanService(cfg, BucketLattice((N_SLOTS,), (MAX_LEN,)),
                      background=False, device="cpu")
    with pytest.raises(ValueError, match="plan-gated core"):
        _engine(ungated, service=svc)


def test_adaptive_token_exact_when_no_flips(dense):
    """Over a single-bucket lattice at the frozen planning shape every
    lookup returns the frozen plan: token-identical to the frozen-plan
    engine, zero swaps."""
    cfg, _, core = dense
    frozen = _engine(core)
    frozen.run(_requests(cfg), None)
    svc = PlanService(cfg, BucketLattice((N_SLOTS,), (MAX_LEN,)),
                      background=False, device="cpu")
    eng = _engine(core, service=svc)
    t = eng.run(_requests(cfg), None)
    assert _streams(eng) == _streams(frozen)
    ad = t["adaptive"]
    assert ad["plan_swaps"] == 0
    assert ad["service"]["verdict_flips"] == 0
    assert ad["active_plan_digest"] == core.plan_table.digest


def test_forced_flip_swaps_plans(dense):
    """A mid-run verdict flip hot-swaps the decode plan: the engine
    serves a second variant, and the variants equal the distinct tables
    served; the swapped-in plan (lm_head on the GEMM kernel's plain
    version here) keeps every stream in range."""
    cfg, params, _ = dense
    core = DecodeCore(cfg, RC, params, quantize=True, plan_batch=N_SLOTS,
                      plan_max_len=MAX_LEN, device="cpu")
    base = core.plan_table

    def plan_fn(shape, _n=[0]):
        _n[0] += 1
        entries = base if _n[0] == 1 else base.with_flip("lm_head")
        return [_decision(lab, e.use_cim, e.what, e.where)
                for lab, e in entries.entries]

    svc = PlanService(cfg, BucketLattice((N_SLOTS,), (MAX_LEN,)),
                      refresh_every=3, background=False, plan_fn=plan_fn,
                      device="cpu")
    eng = _engine(core, service=svc)
    t = eng.run(_requests(cfg, n=4), None)
    ad = t["adaptive"]
    assert t["aggregate"]["completed"] == 4
    assert ad["plan_swaps"] >= 1 and ad["service"]["verdict_flips"] >= 1
    assert ad["active_plan_digest"] == base.with_flip("lm_head").digest
    assert ad["swap_latency_s"]["count"] == ad["plan_swaps"]
    assert core.plan_variants == 2
    assert all(0 <= tok < cfg.vocab
               for s in _streams(eng).values() for tok in s)
    assert np.isfinite(t["aggregate"]["engine_tokens_per_s"])
