"""The runtime What axis on the port's serving path against the JAX
package's: INT4 and FP8 weights through `ServeSession(precision=...)`,
and the int8 KV cache (`RunConfig(kv_cache_dtype="int8")`).

* INT4 / FP8 serving — the port's counterpart of
  tests/test_phase_gating.py::test_gated_vs_ungated_parity_lowbit (whose
  mamba2-780m the port lacks), on reduced qwen2-7b widened to d_model 256,
  d_ff 512, head_dim 64 and vocab 512: at that width the planner gates
  every projection at batch 8 in both phases (at d_model 64 it gates
  none), so the gated session runs every label on the kernel route and
  the ungated one every label on the dequant route.  f32 params and
  compute, parameters converted from the reference's.  Gated and ungated
  logits agree at the reference's rtol = atol = 5e-2; greedy streams are
  equal between them and token-exact against the reference's
  ServeSession (whose gated route runs its Pallas kernel in interpret
  mode); the prefill logits match the reference's within 1e-5 of its
  largest logit (the same f32 products in another order).
* int8 KV cache — `_quantize_kv` codes and scales are bitwise equal to
  the reference's, on bf16 rows where the quotient at the row's max
  rounds to 128 (XLA's convert saturates it to 127; the port clamps).
  `decode_step` logits match within 1e-5 of the largest logit in f32 and
  2**-6 in bf16 (as tests/test_torch_model.py), the dequantized caches
  within the same bounds, and greedy streams are token-exact in f32.
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
from repro.models import init as jax_init, init_cache as jax_init_cache
from repro.models import model as jax_model
from repro.serving import ServeSession as JaxServeSession

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import int8_gemm
from repro_torch.models import decode_step, init_cache
from repro_torch.models import model as t_model
from repro_torch.models.layers import (CIM_FP8_ROUTE, CIM_INT4_ROUTE,
                                       DEQUANT_FP8_ROUTE, DEQUANT_INT4_ROUTE)
from repro_torch.serving import ServeSession, cim_fraction

F32_TOL = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
GATE_TOL = 5e-2              # tests/test_phase_gating.py's gated vs ungated
WIDE = dict(d_model=256, d_ff=512, d_head=64, vocab=512)
ROUTES = {"int4": (CIM_INT4_ROUTE, DEQUANT_INT4_ROUTE),
          "fp8": (CIM_FP8_ROUTE, DEQUANT_FP8_ROUTE)}
BATCH, PROMPT, NEW = 8, 5, 4
MAX_LEN = PROMPT + NEW + 1


def _cfgs(dtype="float32", **widths):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **widths)
    return (dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw),
            dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **kw))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _prompt(vocab, batch=BATCH):
    return np.random.default_rng(1).integers(0, vocab, (batch, PROMPT))


# --- INT4 / FP8 serving ----------------------------------------------------

@pytest.fixture(scope="module", params=["int4", "fp8"])
def lowbit(request):
    """(precision, reference params, port gated / ungated sessions)."""
    precision = request.param
    jcfg, tcfg = _cfgs(**WIDE)
    jp = jax_init(jax.random.PRNGKey(4), jcfg)
    sessions = {g: ServeSession(tcfg, RunConfig(kv_cache_dtype="float32"),
                                params_from_jax(jp, "cpu"), max_len=MAX_LEN,
                                batch=BATCH, quantize=True, gated=g,
                                precision=precision, device="cpu")
                for g in (True, False)}
    return precision, jcfg, jp, sessions


def test_lowbit_routes_gated_and_ungated(lowbit):
    precision, _, _, ts = lowbit
    cim, dequant = ROUTES[precision]
    gated, ungated = ts[True].route_report(), ts[False].route_report()
    assert len(gated) == 8 and len(ungated) == 8
    assert {r["route"] for r in gated.values()} == {cim}
    assert {r["route"] for r in ungated.values()} == {dequant}
    # cim_fraction counts the INT8 kernel route only, as the reference's
    assert cim_fraction(gated) == 0.0


def test_lowbit_gated_vs_ungated_parity(lowbit):
    """Same low-bit weights, routing the only difference: prefill logits
    within the reference's 5e-2 and equal greedy streams."""
    _, _, _, ts = lowbit
    prompt = _prompt(ts[True].cfg.vocab)
    lg = ts[True].prefill(prompt).numpy()
    lu = ts[False].prefill(prompt).numpy()
    np.testing.assert_allclose(lg, lu, rtol=GATE_TOL, atol=GATE_TOL)
    for s in ts.values():
        s.reset()
    out_g = ts[True].generate(prompt, NEW)
    out_u = ts[False].generate(prompt, NEW)
    assert torch.equal(out_g, out_u)
    for s in ts.values():
        s.reset()


def test_lowbit_matches_reference_serve_session(lowbit):
    """Routes, prefill logits and the gated greedy stream against the
    reference's gated session (its kernel route in Pallas interpret)."""
    precision, jcfg, jp, ts = lowbit
    js = JaxServeSession(jcfg, JaxRunConfig(kv_cache_dtype="float32"), jp,
                         max_len=MAX_LEN, batch=BATCH, quantize=True,
                         precision=precision)
    assert ts[True].route_report() == js.route_report()
    assert ts[True].plan_table.digest == js.plan_table.digest
    prompt = _prompt(jcfg.vocab)
    want = np.asarray(js.prefill(jnp.asarray(prompt, jnp.int32)), np.float32)
    got = ts[True].prefill(prompt)
    _close(got, want, F32_TOL)
    js.reset()
    ts[True].reset()
    want_tok = np.asarray(js.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got_tok = ts[True].generate(prompt, NEW)
    ts[True].reset()
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    assert len(np.unique(want_tok)) > BATCH          # real choices


def test_lowbit_serve_launches_nothing_on_cpu(lowbit):
    """On CPU tensors the gated route takes the kernel's plain version."""
    _, _, _, ts = lowbit
    before = (int8_gemm.launches, dict(int8_gemm.launches_by_format))
    ts[True].generate(_prompt(ts[True].cfg.vocab)[:, :2], 1)
    ts[True].reset()
    assert (int8_gemm.launches, int8_gemm.launches_by_format) == before


# --- the int8 KV cache -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_kv_bitwise(dtype):
    """Codes and scales equal bit for bit, at the shape the trap was found
    at; in bf16 the input holds rows whose max quotient rounds to 128."""
    t = jnp.asarray(np.random.default_rng(0).standard_normal(
        (8, 33, 4, 128)), dtype)
    jq, js = jax_model._quantize_kv(t)
    tq, ts = t_model._quantize_kv(params_from_jax(t, "cpu"))
    if dtype == "bfloat16":
        scale = jnp.max(jnp.abs(t), axis=-1, keepdims=True) / 127.0 + 1e-8
        assert int((jnp.round(t / scale) == 128).sum()) > 0
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.view(torch.int16).numpy(),
                          np.asarray(js).view(np.int16))
    want = jax_model._dequantize_kv(jq, js)
    got = t_model._dequantize_kv(tq, ts)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


def test_int8_cache_layout_as_reference():
    jcfg, tcfg = _cfgs()
    jc = jax_init_cache(jcfg, JaxRunConfig(kv_cache_dtype="int8"), 3, 6)
    tc = init_cache(tcfg, RunConfig(kv_cache_dtype="int8"), 3, 6,
                    device="cpu")
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert sorted(a) == sorted(b) == ["k", "k_scale", "v", "v_scale"]
        for key in a:
            assert tuple(a[key].shape) == b[key].shape
            assert str(a[key].dtype).split(".")[-1] == str(b[key].dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_int8_kv_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jrc, trc = (JaxRunConfig(kv_cache_dtype="int8"),
                RunConfig(kv_cache_dtype="int8"))
    jp = jax_init(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jp, "cpu")
    b, steps = 3, 5
    jcache = jax_init_cache(jcfg, jrc, b, steps + 2)
    tcache = init_cache(tcfg, trc, b, steps + 2, device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (steps, b, 1))
    for pos in range(steps):
        jl, jcache = jax_decode_step(jp, jcache, jnp.asarray(tokens[pos],
                                                             jnp.int32),
                                     jnp.int32(pos), jcfg, jrc)
        tl, tcache = decode_step(tp, tcache, torch.tensor(tokens[pos]), pos,
                                 tcfg, trc)
        _close(tl, jl, TOL[dtype])
        for key in ("k", "v"):
            _close(t_model._dequantize_kv(tcache[0][key],
                                          tcache[0][f"{key}_scale"]),
                   jax_model._dequantize_kv(jcache[0][key],
                                            jcache[0][f"{key}_scale"]),
                   TOL[dtype])
    assert tcache[0]["k"].dtype == torch.int8
    assert bool((tcache[0]["k"][:, :, steps:] == 0).all())


@pytest.mark.parametrize("quantize", [False, True])
def test_int8_kv_greedy_streams_token_exact(quantize):
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    js = JaxServeSession(jcfg, JaxRunConfig(kv_cache_dtype="int8"), jp,
                         max_len=MAX_LEN + 4, batch=4, quantize=quantize)
    ts = ServeSession(tcfg, RunConfig(kv_cache_dtype="int8"),
                      params_from_jax(jp, "cpu"), max_len=MAX_LEN + 4, batch=4,
                      quantize=quantize, device="cpu")
    prompt = _prompt(tcfg.vocab, 4)
    want = np.asarray(js.generate(jnp.asarray(prompt, jnp.int32), NEW + 4))
    got = ts.generate(prompt, NEW + 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4
