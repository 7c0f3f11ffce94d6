"""The port's continuous-batching engine on the CPU: the port's form of
tests/test_serving_batching.py, on reduced qwen2-7b (dense: the paged KV
path) in place of the mamba fixtures, with f32 params.

The engine contract: any ragged request stream — join at full
occupancy, evict-on-EOS mid-scan, single-lane traffic — produces, per
request, exactly the tokens the fixed-batch `ServeSession(batch=1)`
produces for that request alone, and greedy streams token for token
equal to the JAX package's `ContinuousBatchingEngine` on the same
converted params and the same `synthetic_requests`.  First-token logits
against the session: within 1e-5 · max|ref| (f32; the paged strip and
the contiguous cache sum attention over other lengths).  On a CPU core
the step runs eagerly, so the capture counters are None
(tests/test_torch_cuda.py holds them on the card).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.models import init as jax_init
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import DecodeCore as JaxDecodeCore
from repro.serving import synthetic_requests as jax_synthetic_requests

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving import (BlockAllocator, ContinuousBatchingEngine,
                                 DecodeCore, Request, ServeSession,
                                 poisson_arrivals, synthetic_requests)

KW = dict(param_dtype="float32", compute_dtype="float32")
RC = RunConfig(attn_impl="naive", remat=False, kv_cache_dtype="float32")
JRC = JaxRunConfig(attn_impl="naive", remat=False, kv_cache_dtype="float32")
MAX_LEN = 24
BLOCK = 4          # small so prompts cross block edges
TOL = 1e-5


@pytest.fixture(scope="module")
def attn():
    """A quantized core over reduced qwen2-7b, and the reference's params
    it was converted from."""
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **KW)
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **KW)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jp, "cpu")
    core = DecodeCore(cfg, RC, params, quantize=True, plan_batch=4,
                      plan_max_len=MAX_LEN, device="cpu")
    return cfg, params, core, jcfg, jp


def _engine(core, n_slots, **kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BLOCK)
    return ContinuousBatchingEngine(core, n_slots=n_slots, **kw)


def _legacy_tokens(cfg, params, prompt, n_new):
    s = ServeSession(cfg, RC, params, max_len=MAX_LEN, batch=1,
                     quantize=True, device="cpu")
    return s.generate(np.asarray(prompt)[None], n_new).numpy().reshape(-1)


def _streams(engine):
    return {r.rid: [int(t) for t in r.tokens] for r in engine.completed}


# --- BlockAllocator ----------------------------------------------------------

def test_allocator_all_or_nothing_and_reuse():
    a = BlockAllocator(4)
    first = a.alloc(3)
    assert len(first) == 3 and a.free_blocks == 1
    assert a.alloc(2) is None          # exhaustion: nothing is handed out
    assert a.free_blocks == 1
    a.free(first)
    again = a.alloc(4)
    assert a.free_blocks == 0
    assert set(first) <= set(again)      # freed ids are reused, not grown
    assert set(again) == set(range(4))
    assert a.peak_in_use == 4


def test_allocator_rejects_double_free():
    a = BlockAllocator(4)
    blocks = a.alloc(2)
    a.free(blocks)
    with pytest.raises(ValueError, match="double-free"):
        a.free(blocks)                       # already back in the pool
    assert a.free_blocks == 4                # state untouched by the raise
    fresh = a.alloc(1)
    with pytest.raises(ValueError, match="double-free"):
        a.free(fresh + fresh)                # duplicate within one call
    assert a.in_use == 1
    a.free(fresh)
    assert a.free_blocks == 4
    assert a.peak_in_use == 2


def test_allocator_rejects_foreign_ids():
    a = BlockAllocator(4)
    held = a.alloc(2)
    for bad in ([-1], [4], [99]):
        with pytest.raises(ValueError, match=r"outside pool \[0, 4\)"):
            a.free(bad)
    with pytest.raises(ValueError):
        a.free([held[0], 7])                 # the valid id rides along
    assert a.in_use == 2                     # ... and was NOT freed
    a.free(held)
    assert a.free_blocks == 4


# --- admission ---------------------------------------------------------------

def test_submit_rejects_horizon_beyond_max_len(attn):
    cfg, _, core, _, _ = attn
    eng = _engine(core, n_slots=2)
    r = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=MAX_LEN)
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(r)


def test_pool_exhaustion_blocks_admission(attn):
    cfg, _, core, _, _ = attn
    # the pool holds exactly one request's horizon: the second must queue
    # until the first evicts and frees its blocks
    blocks_per_req = math.ceil((4 + 4) / BLOCK)
    eng = _engine(core, n_slots=2, n_kv_blocks=blocks_per_req)
    reqs = synthetic_requests(cfg, 2, seed=3, prompt_len=(4, 4),
                              new_tokens=(4, 4))
    eng.run(reqs, None)
    assert len(eng.completed) == 2
    a, b = sorted(eng.completed, key=lambda r: r.t_admit)
    assert b.t_admit >= a.t_done          # serialized by pool pressure
    assert eng.allocator.peak_in_use == blocks_per_req
    assert eng.allocator.free_blocks == blocks_per_req   # all reclaimed


# --- slot scheduling ---------------------------------------------------------

def test_join_at_full_occupancy(attn):
    """Three requests into two slots: the third queues, then takes the
    first freed slot mid-run, and still matches its solo session."""
    cfg, params, core, _, _ = attn
    eng = _engine(core, n_slots=2)
    reqs = synthetic_requests(cfg, 3, seed=1, prompt_len=(3, 5),
                              new_tokens=(4, 8))
    t = eng.run(reqs, None)
    assert t["aggregate"]["completed"] == 3
    assert t["aggregate"]["queue_depth_max"] >= 1
    last = max(eng.completed, key=lambda r: r.t_admit)
    first_done = min(r.t_done for r in eng.completed)
    assert last.t_admit > last.t_submit        # it waited in the queue
    assert last.t_admit >= first_done          # ...until a slot freed
    want = _legacy_tokens(cfg, params, last.prompt, last.max_new_tokens)
    assert np.array_equal(np.asarray(last.tokens), want)


def test_evict_on_eos_mid_scan(attn):
    """Learn a greedy stream, re-run with one of its tokens as EOS: that
    request stops early with done_reason='eos' while the other slot
    decodes on to max_tokens."""
    cfg, _, core, _, _ = attn
    probe = _engine(core, n_slots=1)
    probe.run(synthetic_requests(cfg, 1, seed=2, prompt_len=(4, 4),
                                 new_tokens=(8, 8)), None)
    stream = [int(t) for t in probe.completed[0].tokens]
    eos = stream[2]
    assert eos not in stream[:2]               # the third token stops it
    prompt = probe.completed[0].prompt
    eng = _engine(core, n_slots=2)
    eng.submit(Request(rid="eos", prompt=prompt, max_new_tokens=8,
                       eos_id=eos))
    eng.submit(Request(rid="full", prompt=prompt, max_new_tokens=8))
    eng.drain()
    by_rid = {r.rid: r for r in eng.completed}
    assert by_rid["eos"].done_reason == "eos"
    assert [int(t) for t in by_rid["eos"].tokens] == stream[:3]
    assert by_rid["full"].done_reason == "max_tokens"
    assert [int(t) for t in by_rid["full"].tokens] == stream
    assert by_rid["full"].t_done > by_rid["eos"].t_done
    assert eng.telemetry()["aggregate"]["eos_evictions"] == 1


def test_single_request_matches_legacy(attn):
    cfg, params, core, _, _ = attn
    eng = _engine(core, n_slots=1)
    eng.run(synthetic_requests(cfg, 1, seed=5, prompt_len=(6, 6),
                               new_tokens=(10, 10)), None)
    r = eng.completed[0]
    want = _legacy_tokens(cfg, params, r.prompt, r.max_new_tokens)
    assert np.array_equal(np.asarray(r.tokens), want)


@pytest.mark.parametrize("pipeline", [True, False])
def test_continuous_matches_fixed_batch(attn, pipeline):
    """Tokens and first-token logits of every request, through slot churn
    and across block boundaries, against the session serving it alone;
    the pipelined and the synchronous loop alike."""
    cfg, params, core, _, _ = attn
    eng = _engine(core, n_slots=3, record_logits=True, pipeline=pipeline)
    reqs = synthetic_requests(cfg, 5, seed=7, prompt_len=(4, 9),
                              new_tokens=(5, 12))
    t = eng.run(reqs, None)
    assert t["aggregate"]["completed"] == 5
    assert t["aggregate"]["decode_step_breakdown"]["pipelined"] == pipeline
    legacy = ServeSession(cfg, RC, params, max_len=MAX_LEN, batch=1,
                          quantize=True, device="cpu")
    for r in eng.completed:
        prompt = np.asarray(r.prompt)[None]
        legacy.reset()
        ref = legacy.prefill(prompt)[0, -1].float().numpy()
        legacy.reset()
        want = legacy.generate(prompt, r.max_new_tokens).numpy().reshape(-1)
        assert np.array_equal(np.asarray(r.tokens), want), r.rid
        assert np.abs(np.asarray(r.first_logits) - ref).max() <= (
            TOL * np.abs(ref).max())


def test_greedy_streams_equal_the_reference_engine(attn):
    """The same converted params and the same synthetic requests (numpy's
    RandomState in both packages) through both engines: every greedy
    stream token for token, and the same queueing (completion order)."""
    cfg, _, core, jcfg, jp = attn
    kw = dict(seed=11, prompt_len=(3, 9), new_tokens=(4, 12))
    jcore = JaxDecodeCore(jcfg, JRC, jp, quantize=True, plan_batch=4,
                          plan_max_len=MAX_LEN)
    assert jcore.plan_table.digest == core.plan_table.digest
    jeng = JaxEngine(jcore, n_slots=3, max_len=MAX_LEN, block_size=BLOCK)
    jeng.run(jax_synthetic_requests(jcfg, 6, **kw), None)
    eng = _engine(core, n_slots=3)
    reqs = synthetic_requests(cfg, 6, **kw)
    for ours, ref in zip(reqs, jax_synthetic_requests(jcfg, 6, **kw)):
        assert np.array_equal(ours.prompt, ref.prompt)
        assert ours.max_new_tokens == ref.max_new_tokens
    eng.run(reqs, None)
    want = {r.rid: [int(t) for t in r.tokens] for r in jeng.completed}
    assert _streams(eng) == want
    assert len({tuple(s) for s in want.values()}) == 6
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]
    assert eng.steps == jeng.steps


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_telemetry_has_the_reference_keys(attn):
    cfg, _, core, jcfg, jp = attn
    eng = _engine(core, n_slots=2)
    t = eng.run(synthetic_requests(cfg, 2, seed=3, prompt_len=(3, 5),
                                   new_tokens=(3, 5)), None)
    jcore = JaxDecodeCore(jcfg, JRC, jp, quantize=True, plan_batch=4,
                          plan_max_len=MAX_LEN)
    jt = JaxEngine(jcore, n_slots=2, max_len=MAX_LEN, block_size=BLOCK).run(
        jax_synthetic_requests(jcfg, 2, seed=3, prompt_len=(3, 5),
                               new_tokens=(3, 5)), None)
    assert _keys(t["aggregate"]) == _keys(jt["aggregate"])
    assert sorted(t) == sorted(jt)
    assert sorted(t["requests"][0]) == sorted(jt["requests"][0])
    # a CPU core runs the step eagerly: no capture to count
    assert t["aggregate"]["decode_executables"] is None
    assert t["aggregate"]["kv_donation_ok"] is None
    assert core.decode_executables is None
    assert core.batch_decode_executables is None


def test_telemetry_handles_request_without_first_token(attn):
    cfg, _, core, _, _ = attn
    eng = _engine(core, n_slots=2)
    eng.run(synthetic_requests(cfg, 2, seed=3, prompt_len=(3, 5),
                               new_tokens=(3, 5)), None)
    ghost = Request(rid="ghost", prompt=np.arange(3, dtype=np.int32),
                    max_new_tokens=4)
    ghost.state, ghost.done_reason = "done", "max_tokens"
    ghost.t_submit, ghost.t_done = 0.0, 1.0
    eng.completed.append(ghost)
    t = eng.telemetry()
    g = {r["rid"]: r for r in t["requests"]}["ghost"]
    assert g["ttft_s"] is None and g["queue_wait_s"] is None
    assert g["decode_tokens_per_s"] is None
    real = [r["ttft_s"] for r in t["requests"] if r["rid"] != "ghost"]
    assert min(real) <= t["aggregate"]["ttft_p50_s"] <= max(real)


def test_phase_split_gating_serves_both_tables(attn):
    """With a prefill table that differs from the decode table, pure
    prefill steps run under the prefill table and the rest under the
    decode table: both variants live in the core's cache."""
    cfg, params, _, _, _ = attn
    core = DecodeCore(cfg, RC, params, quantize=True, plan_batch=4,
                      plan_max_len=MAX_LEN, device="cpu")
    core.prefill_plan_table = core.plan_table.with_flip("lm_head")
    eng = _engine(core, n_slots=2)
    t = eng.run(synthetic_requests(cfg, 3, seed=4, prompt_len=(4, 6),
                                   new_tokens=(3, 6)), None)
    gating = t["aggregate"]["phase_gating"]
    assert gating["enabled"] and gating["phase_switches"] >= 2
    assert gating["phase_steps"]["prefill"] >= 4
    assert core.plan_variants == 2


def test_temperature_request_is_synchronous_and_seeded(attn):
    cfg, _, core, _, _ = attn
    runs = []
    for _ in range(2):
        eng = _engine(core, n_slots=2, seed=5)
        eng.run(synthetic_requests(cfg, 3, seed=6, prompt_len=(3, 5),
                                   new_tokens=(4, 6), temperature=1.0),
                poisson_arrivals(3, 0.0))
        assert not eng._pipelined
        runs.append(_streams(eng))
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab for s in runs[0].values() for t in s)


def test_poisson_arrivals_as_reference():
    from repro.serving import poisson_arrivals as jax_poisson
    assert poisson_arrivals(5, 4.0, seed=0) == jax_poisson(5, 4.0, seed=0)
    assert poisson_arrivals(3, 0.0) == [0.0] * 3


def test_engine_runs_on_the_card_by_default(attn):
    """A core built without `device=` means the card; on a CPU-only torch
    it raises instead of serving on the CPU."""
    cfg, params, _, _, _ = attn
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeCore(cfg, RC, params, quantize=True)


@pytest.mark.parametrize("mode", [
    ["--requests", "3", "--slots", "2", "--arrival-rate", "0"],
    ["--batch", "2"]], ids=["traffic", "fixed-batch"])
def test_serve_cli_report_has_the_reference_keys(mode, capsys, monkeypatch):
    """`python -m repro_torch.launch.serve` with the reference CLI's flags
    prints a JSON report with the reference's keys, in traffic and in
    fixed-batch mode, and the same route report."""
    import json
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2-7b", "--smoke", "--quantize", "--prompt-len",
            "6", "--new-tokens", "4"] + mode
    serve.main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jax_serve.main()
    ref = json.loads(capsys.readouterr().out)
    assert sorted(ours) == sorted(ref)
    assert ours["gating"]["routes"] == ref["gating"]["routes"]
    if "traffic" in ref:
        assert _keys(ours["traffic"]["aggregate"]) == _keys(
            ref["traffic"]["aggregate"])
        assert ours["traffic"]["aggregate"]["completed"] == 3
    else:
        assert sorted(ours["gating"]) == sorted(ref["gating"])
        assert ours["generated_shape"] == ref["generated_shape"] == [2, 4]
