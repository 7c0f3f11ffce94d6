"""The moe, ssm and hybrid families end to end against the JAX package, on
the CPU, at `reduced(...)` of qwen2-moe-a2.7b, llama4-scout-17b-a16e
(top-1 routing, GQA, a sliding window with MoE), mamba2-780m and
jamba-1.5-large-398b (a period that mixes attention and mamba slots and
dense and MoE FFNs).

Params come from the reference's `init`, converted with
`params_from_jax`; tokens from numpy seeds.  Logits are held relative
to the reference's largest magnitude: f32 within 1e-5 (the same f32 sums
in another order; `test_torch_model.py`'s bound); bf16 within 2**-5, not
the dense model's 2**-6 (measured: up to 1.6% at some position for
mamba2 and scout, whose blocks round more bf16 intermediates), and a MoE
forward may have one position of 32 beyond it, a token whose top-k
expert choice flips on a bf16 near-tie (measured: 17.5% at one position
of jamba).  Where a mamba slot runs the paged, masked step, its conv
carry is bf16 also under f32 compute, as in the reference, so an f32
value that differs in its last bit can round to a neighbouring bf16
value: those comparisons hold within one bf16 ulp, 2**-8.  Greedy
streams of the INT8-gated
`ServeSession` and `ContinuousBatchingEngine` token for token (f32, at
batch 8, where the planner gates `ssm-BCdt` onto the kernel route for
the mamba slots); route reports label for label.  On the CPU the
gated label runs the kernel's plain version, the reference its Pallas
kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward, init as jax_init
from repro.models import init_cache as jax_init_cache
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models.model import period_slots as jax_period_slots
from repro.quant import quantize_model_params as jax_quantize
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import DecodeCore as JaxDecodeCore
from repro.serving import ServeSession as JaxServeSession
from repro.serving import synthetic_requests as jax_synthetic_requests

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import (decode_step, forward, init, init_cache,
                                init_paged_cache, period_slots)
from repro_torch.models.layers import CIM_ROUTE
from repro_torch.quant import quantize_model_params
from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                 ServeSession, synthetic_requests)

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "mamba2-780m",
                "jamba-1.5-large-398b")
MAMBA_ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
CARRY_TOL = 2.0 ** -8          # one bf16 ulp of the paged conv carry
BATCH, PROMPT, NEW, MAX_LEN = 8, 6, 6, 16
BLOCK = 4


def _rc(dtype, jax_side=False):
    cls = JaxRunConfig if jax_side else RunConfig
    return cls(attn_impl="naive", remat=False, kv_cache_dtype=dtype)


def _configs(arch, dtype="float32", capacity=None):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch]), **kw)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **kw)
    if capacity is not None and cfg.moe:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, cfg))
    return jcfg, cfg


def _params(arch, dtype="float32", capacity=None):
    jcfg, cfg = _configs(arch, dtype, capacity)
    jp = jax_init(jax.random.PRNGKey(11), jcfg)
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _close(got, want, tol, outliers=0):
    """max|got - want| <= tol · max|want| at every position (the last
    axis is one position's values) but at most `outliers` of them."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(-1)
    assert (err > tol * scale).sum() <= outliers, (err.max(), scale)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_and_caches_match_reference_layout(arch):
    """The port's own init, and both caches, have the reference's tree,
    shapes and dtypes (bf16 params)."""
    jcfg, cfg = _configs(arch, "bfloat16")
    ours = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = params_from_jax(jax_init(jax.random.PRNGKey(0), jcfg), "cpu")
    assert _shapes(ours) == _shapes(ref)
    rc, jrc = _rc("bfloat16"), _rc("bfloat16", jax_side=True)
    for got, want in (
            (init_cache(cfg, rc, 3, 8, device="cpu"),
             jax_init_cache(jcfg, jrc, 3, 8)),
            (init_paged_cache(cfg, rc, 3, 5, BLOCK, device="cpu"),
             jax_init_paged_cache(jcfg, jrc, 3, 5, BLOCK))):
        assert _shapes(got) == _shapes(params_from_jax(want, "cpu"))
    assert [(s.mixer, s.ffn) for s in period_slots(cfg)] == [
        (s.mixer, s.ffn) for s in jax_period_slots(jcfg)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_matches_reference(arch, dtype):
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, (2, 16))
    jl, jaux = jax_forward(jp, jnp.asarray(toks), jcfg,
                           _rc(dtype, jax_side=True))
    tl, taux = forward(tp, torch.tensor(toks), cfg, _rc(dtype))
    flips = 1 if dtype == "bfloat16" and cfg.moe else 0
    _close(tl, jl, TOL[dtype], outliers=flips)
    assert abs(float(taux) - float(jaux)) <= TOL[dtype] * abs(float(jaux))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode logits against the full forward (the port's
    form of tests/test_models.py:test_decode_matches_forward; MoE
    capacity raised so the forward drops no token), f32 within 1e-4 ·
    max|forward| (the chunked scan and the recurrence sum in other
    orders), and each step against the reference's step within 1e-5."""
    jcfg, cfg, jp, tp = _params(arch, capacity=8.0)
    toks = _tokens(cfg, (2, 12), seed=1)
    rc, jrc = _rc("float32"), _rc("float32", jax_side=True)
    full, _ = forward(tp, torch.tensor(toks), cfg, rc)
    cache = init_cache(cfg, rc, 2, 16, device="cpu")
    jcache = jax_init_cache(jcfg, jrc, 2, 16)
    steps = []
    for t in range(12):
        lg, cache = decode_step(tp, cache, torch.tensor(toks[:, t:t + 1]), t,
                                cfg, rc)
        jl, jcache = jax_decode_step(jp, jcache, jnp.asarray(
            toks[:, t:t + 1]), jnp.int32(t), jcfg, jrc)
        _close(lg, jl, TOL["float32"])
        steps.append(lg[:, 0])
    _close(torch.stack(steps, dim=1), full.numpy(), 1e-4)
    for ours, ref in zip(cache, jcache):
        for key in ours:
            _close(ours[key], ref[key], TOL["float32"])


def _sessions(arch):
    jcfg, cfg, jp, tp = _params(arch)
    jrc, rc = _rc("float32", jax_side=True), _rc("float32")
    ours = ServeSession(cfg, rc, tp, max_len=MAX_LEN, batch=BATCH,
                        quantize=True, device="cpu")
    ref = JaxServeSession(jcfg, jrc, jp, max_len=MAX_LEN, batch=BATCH,
                          quantize=True)
    return cfg, ours, ref


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gated_serve_streams_and_routes_equal_reference(arch):
    """INT8-gated `ServeSession` at batch 8: the same plan tables, the
    same route report (labels and routes), greedy streams token for
    token."""
    cfg, ours, ref = _sessions(arch)
    assert ours.plan_table.digest == ref.plan_table.digest
    assert ours.prefill_plan_table.digest == ref.prefill_plan_table.digest
    rr = ours.route_report()
    assert rr == ref.route_report()
    gated = {lab for lab, r in rr.items() if r["route"] == CIM_ROUTE}
    assert gated == ({"ssm-BCdt"} if arch in MAMBA_ARCHS else set())
    assert all(r["route"] != CIM_ROUTE for lab, r in rr.items()
               if lab.startswith(("expert-", "shared-")))
    prompt = _tokens(cfg, (BATCH, PROMPT), seed=2)
    got = ours.generate(torch.tensor(prompt), NEW).numpy()
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_paged_masked_step_matches_reference(arch):
    """The continuous-batching step (ragged positions, an active mask, a
    block pool) on the same block tables: logits, pools and the mamba
    state and conv carry, inactive slots' rows unchanged."""
    jcfg, cfg, jp, tp = _params(arch)
    jp, tp = jax_quantize(jp), quantize_model_params(tp)
    rc, jrc = _rc("float32"), _rc("float32", jax_side=True)
    n, blocks, mb = 4, 9, 2
    cache = init_paged_cache(cfg, rc, n, blocks, BLOCK, device="cpu")
    jcache = jax_init_paged_cache(jcfg, jrc, n, blocks, BLOCK)
    tables = np.array([[0, 1], [2, 3], [4, 5], [0, 1]], np.int32)
    active = np.array([True, True, False, True])
    pos = np.zeros(n, np.int32)
    rng = np.random.default_rng(3)
    tol = CARRY_TOL if any("state" in e for e in cache) else TOL["float32"]
    for step in range(6):
        toks = rng.integers(0, cfg.vocab, (n, 1))
        act = active if step else np.array([True, True, True, False])
        lg, cache = decode_step(
            tp, cache, torch.tensor(toks), torch.tensor(pos), cfg, rc,
            active=torch.tensor(act), block_tables=torch.tensor(tables))
        jl, jcache = jax_decode_step(
            jp, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos), jcfg,
            jrc, active=jnp.asarray(act), block_tables=jnp.asarray(tables))
        for i in np.flatnonzero(act):
            _close(lg[i], np.asarray(jl)[i], tol)
        if step == 0:       # slot 2 goes inactive: its state must freeze
            frozen = [(e["state"][:, 2].clone(), e["conv"][:, 2].clone())
                      for e in cache if "state" in e]
        pos = pos + act
        assert mb * BLOCK > pos.max()
    for ours, ref in zip(cache, jcache):
        for key in ours:
            _close(ours[key], ref[key], tol)
    for e, (st, cv) in zip([e for e in cache if "state" in e], frozen):
        assert torch.equal(e["state"][:, 2], st)
        assert torch.equal(e["conv"][:, 2], cv)
        assert e["state"][:, 3].any()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_engine_streams_equal_reference_engine(arch):
    """More requests than slots through both engines: a slot that frees
    takes the next request, its mamba state and conv carry zeroed in
    place first; every greedy stream token for token, and the same
    completion order."""
    jcfg, cfg, jp, tp = _params(arch)
    jrc, rc = _rc("float32", jax_side=True), _rc("float32")
    core = DecodeCore(cfg, rc, tp, quantize=True, plan_batch=BATCH,
                      plan_max_len=MAX_LEN, device="cpu")
    jcore = JaxDecodeCore(jcfg, jrc, jp, quantize=True, plan_batch=BATCH,
                          plan_max_len=MAX_LEN)
    assert core.plan_table.digest == jcore.plan_table.digest
    kw = dict(seed=5, prompt_len=(2, 6), new_tokens=(2, 8))
    eng = ContinuousBatchingEngine(core, n_slots=3, max_len=MAX_LEN,
                                   block_size=BLOCK)
    jeng = JaxEngine(jcore, n_slots=3, max_len=MAX_LEN, block_size=BLOCK)
    reqs = synthetic_requests(cfg, 7, **kw)
    jeng.run(jax_synthetic_requests(jcfg, 7, **kw), None)
    eng.run(reqs, None)
    want = {r.rid: [int(t) for t in r.tokens] for r in jeng.completed}
    assert {r.rid: [int(t) for t in r.tokens] for r in eng.completed} == want
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]
    assert eng.evictions >= 4 and eng.steps == jeng.steps


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_joining_slot_state_is_zeroed_in_place(arch):
    _, cfg, _, tp = _params(arch)
    core = DecodeCore(cfg, _rc("float32"), tp, quantize=True,
                      plan_batch=BATCH, plan_max_len=MAX_LEN, device="cpu")
    eng = ContinuousBatchingEngine(core, n_slots=2, max_len=MAX_LEN,
                                   block_size=BLOCK)
    entries = [e for e in eng.cache if "state" in e]
    ptrs = [(e["state"].data_ptr(), e["conv"].data_ptr()) for e in entries]
    for e in entries:
        e["state"].fill_(1.0)
        e["conv"].fill_(1.0)
    eng._reset_slot_state(1)
    for e, p in zip(entries, ptrs):
        assert (e["state"].data_ptr(), e["conv"].data_ptr()) == p
        assert not e["state"][:, 1].any() and not e["conv"][:, 1].any()
        assert bool((e["state"][:, 0] == 1).all())
