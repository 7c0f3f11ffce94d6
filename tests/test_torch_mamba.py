"""The port's mamba2 SSD mixer against the JAX package, on the CPU.

`segsum`, `ssd_chunked` (with and without an initial state),
`ssd_decode_step`, `_causal_conv` (with and without a carry) and
`mamba_apply` in both modes are fed the same numpy inputs as the
reference's functions.  Tolerance: 1e-5 · max|ref| in f32 (the same f32
sums in another order); bf16 `mamba_apply` within 2**-6 · max|ref|
(each framework rounds its bf16 intermediates at its own places).  The
chunked scan equals the step-by-step recurrence (the duality, as
tests/test_models.py holds it for the reference), and a length the chunk
does not divide raises ValueError where the reference asserts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import mamba2 as jm
from repro.quant import quantize_model_params as jax_quantize

from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import mamba2 as tm
from repro_torch.models import route_trace
from repro_torch.models.layers import DEQUANT_ROUTE, FLOAT_ROUTE

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _close(got, want, tol=TOL["float32"]):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _ssd_inputs(seed, b=2, l=16, h=4, p=8, g=2, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.2).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, A, B, C, s0


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    want = np.asarray(jm.segsum(jnp.asarray(x)))
    got = tm.segsum(torch.tensor(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state, chunk):
    x, dt, A, B, C, s0 = _ssd_inputs(1)
    (jx, jdt, jA, jB, jC, js0), (tx, tdt, tA, tB, tC, ts0) = _both(
        (x, dt, A, B, C, s0))
    jy, jfin = jm.ssd_chunked(jx, jdt, jA, jB, jC, chunk,
                              init_state=js0 if with_state else None)
    ty, tfin = tm.ssd_chunked(tx, tdt, tA, tB, tC, chunk,
                              init_state=ts0 if with_state else None)
    _close(ty, jy)
    _close(tfin, jfin)
    assert ty.dtype == torch.float32 and tfin.dtype == torch.float32


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, s0 = _ssd_inputs(2)
    (jx, jdt, jA, jB, jC, js0), (tx, tdt, tA, tB, tC, ts0) = _both(
        (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], s0))
    jy, jst = jm.ssd_decode_step(js0, jx, jdt, jA, jB, jC)
    ty, tst = tm.ssd_decode_step(ts0, tx, tdt, tA, tB, tC)
    _close(ty, jy)
    _close(tst, jst)


def test_chunked_matches_stepwise():
    """The port's form of tests/test_models.py's duality test: the chunked
    scan equals the token-by-token recurrence."""
    x, dt, A, B, C, _ = _ssd_inputs(3, b=1, l=16, h=2, p=4, g=1, n=8)
    tx, tdt, tA, tB, tC = (torch.tensor(a) for a in (x, dt, A, B, C))
    y_chunk, fin = tm.ssd_chunked(tx, tdt, tA, tB, tC, chunk=4)
    st = torch.zeros((1, 2, 8, 4))
    ys = []
    for t in range(16):
        yt, st = tm.ssd_decode_step(st, tx[:, t], tdt[:, t], tA, tB[:, t],
                                    tC[:, t])
        ys.append(yt)
    torch.testing.assert_close(y_chunk, torch.stack(ys, dim=1), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(fin, st, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_reference(with_carry, dtype):
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.5).astype(np.float32)
    carry = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jy, jc = jm._causal_conv(jnp.asarray(xs, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(carry, jdt) if with_carry else None)
    ty, tc = tm._causal_conv(torch.tensor(xs).to(tdt),
                             torch.tensor(w).to(tdt),
                             torch.tensor(carry).to(tdt) if with_carry
                             else None)
    assert ty.dtype == tdt and tc.dtype == tdt
    _close(ty, jy, TOL[dtype])
    _close(tc, jc, 0.0)                  # the carry is a copy of inputs


def _mixer(dtype, quantize):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["mamba2-780m"]), **kw)
    cfg = dataclasses.replace(reduced(ARCHS["mamba2-780m"]), **kw)
    jp = jm.mamba_init(jax.random.PRNGKey(5), jcfg, jnp.dtype(dtype))
    if quantize:
        jp = jax_quantize(jp)
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba_apply_matches_reference(mode, dtype, quantize):
    jcfg, cfg, jp, tp = _mixer(dtype, quantize)
    rng = np.random.default_rng(6)
    b = 2
    l = 1 if mode == "decode" else 32
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    kw_j, kw_t = {}, {}
    if mode == "decode":
        sst, scv = tm.mamba_cache_shapes(cfg, b)
        assert (sst, scv) == jm.mamba_cache_shapes(jcfg, b)
        st = rng.standard_normal(sst).astype(np.float32)
        cv = rng.standard_normal(scv).astype(np.float32)
        kw_j = dict(state=jnp.asarray(st),
                    conv_carry=jnp.asarray(cv, jnp.bfloat16), decode=True)
        kw_t = dict(state=torch.tensor(st),
                    conv_carry=torch.tensor(cv).to(torch.bfloat16),
                    decode=True)
    jy, (jst, jcv) = jm.mamba_apply(jp, jnp.asarray(x, jdt), jcfg, **kw_j)
    with route_trace() as records:
        ty, (tst, tcv) = tm.mamba_apply(tp, torch.tensor(x).to(tdt), cfg,
                                        **kw_t)
    assert ty.dtype == tdt and tst.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])
    _close(tcv, jcv, TOL[dtype])
    labels = [r["label"] for r in records]
    assert labels == ["ssm-z", "ssm-x"] + ["ssm-BCdt"] * 3 + ["ssm-out"]
    assert {r["route"] for r in records} == {
        DEQUANT_ROUTE if quantize else FLOAT_ROUTE}


def test_softplus_is_jax_formula():
    """torch's softplus returns x above its threshold; the port computes
    JAX's log1p(exp(-|x|)) + max(x, 0) everywhere."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert np.array_equal(tm._softplus(torch.tensor(x)).numpy(), want)


def test_unchunkable_length_raises_where_reference_asserts():
    x, dt, A, B, C, _ = _ssd_inputs(7, l=10)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk=4)
    with pytest.raises(ValueError, match="not a multiple"):
        tm.ssd_chunked(*(torch.tensor(a) for a in (x, dt, A, B, C)),
                       chunk=4)
    # mamba_apply: chunk = min(cfg.ssm.chunk, l) = 32 does not divide 40
    jcfg, cfg, jp, tp = _mixer("float32", quantize=False)
    xs = np.zeros((1, 40, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jm.mamba_apply(jp, jnp.asarray(xs), jcfg)
    with pytest.raises(ValueError, match="not a multiple"):
        tm.mamba_apply(tp, torch.tensor(xs), cfg)
