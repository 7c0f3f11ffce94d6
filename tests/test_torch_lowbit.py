"""The port's low-bit weight formats (`repro_torch.quant.lowbit`: packed
INT4 and scaled FP8 e4m3) against the JAX package's `repro.quant.lowbit`.

Tolerances: quantized bytes and scales, unpacked nibbles, dequantized
weights and whole quantized parameter trees are compared bitwise (the
same f32 operations on both sides; the e4m3 cast rounds to nearest even
in both frameworks).  Contractions are compared in f32 at 1e-5 of the
reference's largest magnitude (the same f32 products summed in another
order; the reference's gated route runs its Pallas kernel in interpret
mode, which upcasts the weight tile to f32 and scales after the sum,
the port's plain version dequantizes first), and in bf16 at 2**-8 of it
(the bf16 half-ulp: the frameworks round their bf16 results at
different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.models import init as jax_init
from repro.quant import lowbit as jax_lowbit

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import int8_gemm
from repro_torch.quant import lowbit as t_lowbit
from repro_torch.serving import DecodeCore

F32_RTOL = 1e-5
BF16_TOL = 2.0 ** -8
# 2-D, odd K, and stacked (layers, K, N) leaves
SHAPES = [(96, 80), (33, 40), (3, 33, 24)]


def _close(got, want, tol_rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol_rel, atol=tol_rel * scale)


def _bits(a):
    """The bytes of a torch tensor or a JAX/numpy array, as uint8."""
    if torch.is_tensor(a):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _weight(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                                   # an all-zero channel
    return w


def _ref_quantize(fn, w):
    """The reference quantizer on (K, N), vmapped over leading axes as
    its `quantize_model_params_lowbit` does."""
    for _ in range(w.ndim - 2):
        fn = jax.vmap(fn)
    return fn(jnp.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_weight_fp8_bitwise(shape, dtype):
    w = jnp.asarray(_weight(shape), dtype)
    jq, js = _ref_quantize(jax_lowbit.quantize_weight_fp8, w)
    tq, ts = t_lowbit.quantize_weight_fp8(params_from_jax(w, "cpu"))
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    # no NaN code (0x7F / 0xFF) is ever written
    assert not np.isin(_bits(tq) & 0x7F, [0x7F]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_weight_int4_bitwise(shape, dtype):
    w = jnp.asarray(_weight(shape, 1), dtype)
    jq, js = _ref_quantize(jax_lowbit.quantize_weight_int4, w)
    tq, ts = t_lowbit.quantize_weight_int4(params_from_jax(w, "cpu"))
    k = shape[-2]
    assert tq.dtype == torch.int8 and tq.shape[-2] == (k + 1) // 2
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(_bits(ts), _bits(js))


def test_fp8_cast_matches_on_ties():
    """Every exact tie between two neighbouring finite e4m3 values, the
    next f32 above and below each, both signs: torch's cast to
    float8_e4m3fn gives the reference's bytes (round half to even)."""
    codes = np.arange(256, dtype=np.uint8)
    codes = codes[(codes & 0x7F) != 0x7F]                  # 254 finite codes
    vals = np.sort(np.unique(np.abs(
        codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32))))
    mids = ((vals[:-1].astype(np.float64) + vals[1:]) / 2).astype(np.float32)
    assert np.all(mids.astype(np.float64) * 2 == vals[:-1].astype(
        np.float64) + vals[1:])                           # exact ties
    x = np.concatenate([mids, np.nextafter(mids, np.float32(np.inf)),
                        np.nextafter(mids, np.float32(0))])
    x = np.concatenate([x, -x])
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    got = torch.from_numpy(x).to(torch.float8_e4m3fn)
    assert len(mids) == vals.size - 1 >= 120
    assert np.array_equal(_bits(got), want.view(np.uint8))


@pytest.mark.parametrize("k", [32, 31])
def test_unpack_int4_all_bytes(k):
    """All 256 byte values, 2-D and with stacked leading axes."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for arr in (packed, np.stack([packed, packed[::-1]])):
        want = jax_lowbit.unpack_int4(jnp.asarray(arr), k)
        got = t_lowbit.unpack_int4(torch.from_numpy(arr.copy()), k)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(33, 10), (8, 5), (2, 7, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pack_int4_matches_and_round_trips(shape):
    q = np.random.default_rng(3).integers(-8, 8, shape).astype(np.int8)
    want = jax_lowbit.pack_int4(jnp.asarray(q))
    got = t_lowbit.pack_int4(torch.from_numpy(q))
    assert np.array_equal(got.numpy(), np.asarray(want))
    back = t_lowbit.unpack_int4(got, shape[-2])
    assert np.array_equal(back.numpy(), q)


@pytest.mark.parametrize("precision", ["int4", "fp8"])
def test_dequantize_weight_bitwise(precision):
    w = jnp.asarray(_weight((40, 24), 5))
    if precision == "int4":
        jq, js = jax_lowbit.quantize_weight_int4(w)
        want = jax_lowbit.dequantize_weight_int4(jq, js, 40)
        got = t_lowbit.dequantize_weight_int4(*params_from_jax((jq, js),
                                                               "cpu"), 40)
    else:
        jq, js = jax_lowbit.quantize_weight_fp8(w)
        want = jax_lowbit.dequantize_weight_fp8(jq, js)
        got = t_lowbit.dequantize_weight_fp8(*params_from_jax((jq, js),
                                                              "cpu"))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(want))


def _reduced_params(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw)
    return jax_init(jax.random.PRNGKey(3), jcfg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["int8", "int4", "fp8"])
def test_quantize_model_params_lowbit_bitwise(precision, dtype):
    """The same tree, leaf by leaf and bit for bit, from the same float
    parameters; quantizing it again leaves it as it is."""
    jp = _reduced_params(dtype)
    want = dict(_flat(params_from_jax(
        jax_lowbit.quantize_model_params_lowbit(jp, precision), "cpu")))
    tree = t_lowbit.quantize_model_params_lowbit(params_from_jax(jp, "cpu"),
                                                 precision)
    got = dict(_flat(tree))
    assert got.keys() == want.keys()
    key = {"int8": "q", "int4": "q4", "fp8": "qf8"}[precision]
    assert sum(p.endswith(f"/{key}") for p in got) == 8
    for path, leaf in got.items():
        assert leaf.dtype == want[path].dtype, path
        assert np.array_equal(_bits(leaf), _bits(want[path])), path
    again = dict(_flat(t_lowbit.quantize_model_params_lowbit(tree,
                                                             precision)))
    assert all(again[p] is leaf for p, leaf in got.items())


def test_params_from_jax_carries_fp8_bit_exact():
    jp = jax_lowbit.quantize_model_params_lowbit(_reduced_params(), "fp8")
    tp = params_from_jax(jp, "cpu")
    ref = dict(_flat(jp))
    n = 0
    for path, leaf in _flat(tp):
        if path.endswith("/qf8"):
            n += 1
            assert leaf.dtype == torch.float8_e4m3fn
            assert np.array_equal(_bits(leaf), _bits(ref[path]))
    assert n == 8


def _x(shape, dtype, seed):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["int4", "fp8"])
def test_dequant_contract_matches(precision, dtype):
    x = _x((2, 3, 65), dtype, 6)                      # odd K for int4
    w = jnp.asarray(_weight((65, 48), 7))
    if precision == "int4":
        jq, js = jax_lowbit.quantize_weight_int4(w)
        want = jax_lowbit.dequant_contract_int4(x, jq, js)
        fn = t_lowbit.dequant_contract_int4
    else:
        jq, js = jax_lowbit.quantize_weight_fp8(w)
        want = jax_lowbit.dequant_contract_fp8(x, jq, js)
        fn = t_lowbit.dequant_contract_fp8
    got = fn(*params_from_jax((x, jq, js), "cpu"))
    assert str(got.dtype).endswith(dtype) and got.shape == (2, 3, 48)
    _close(got, want, F32_RTOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["int4", "fp8"])
def test_planned_linear_matches_pallas_interpret(precision, dtype):
    """The gated routes against the reference's, whose Pallas kernel runs
    in interpret mode; the port's wrapper takes its plain version on the
    CPU and launches nothing."""
    x = _x((2, 4, 128), dtype, 8)
    w = jnp.asarray(_weight((128, 256), 9))
    if precision == "int4":
        jq, js = jax_lowbit.quantize_weight_int4(w)
        want = jax_lowbit.planned_linear_int4(x, jq, js, interpret=True)
        fn = t_lowbit.planned_linear_int4
    else:
        jq, js = jax_lowbit.quantize_weight_fp8(w)
        want = jax_lowbit.planned_linear_fp8(x, jq, js, interpret=True)
        fn = t_lowbit.planned_linear_fp8
    before = int8_gemm.launches
    got = fn(*params_from_jax((x, jq, js), "cpu"))
    assert int8_gemm.launches == before
    assert str(got.dtype).endswith(dtype) and got.shape == (2, 4, 256)
    _close(got, want, F32_RTOL if dtype == "float32" else BF16_TOL)


def test_planned_linear_on_meta_gives_the_shape():
    """The shape-only trace behind `route_report` runs both routes on
    "meta" tensors."""
    x = torch.empty((3, 1, 64), device="meta")
    packed = torch.empty((32, 40), dtype=torch.int8, device="meta")
    qf = torch.empty((64, 40), dtype=torch.float8_e4m3fn, device="meta")
    s = torch.empty(40, device="meta")
    for y in (t_lowbit.planned_linear_int4(x, packed, s),
              t_lowbit.planned_linear_fp8(x, qf, s)):
        assert y.device.type == "meta" and y.shape == (3, 1, 40)


def test_int8_gemm_takes_fp8_and_rejects_other_weight_types():
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.standard_normal((5, 64)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((64, 24)), dtype=torch.float32)
    qf, s = t_lowbit.quantize_weight_fp8(w)
    assert torch.equal(int8_gemm(x, qf, s),
                       x @ (qf.float() * s))
    for bad in (torch.float8_e5m2, torch.float16, torch.uint8):
        with pytest.raises(TypeError):
            int8_gemm(x, qf.float().to(bad), s)


def test_weight_format_as_reference():
    leaves = [jnp.zeros((2, 2)), {"q": 0, "scale": 0}, {"q4": 0, "scale": 0},
              {"qf8": 0, "scale": 0}, {"scale": 0}, {}]
    for leaf in leaves:
        assert t_lowbit.weight_format(leaf) == jax_lowbit.weight_format(leaf)
    assert [t_lowbit.weight_format(v) for v in leaves] == [
        None, "int8", "int4", "fp8", None, None]


def test_unknown_precision_raises_as_reference():
    jp = _reduced_params()
    with pytest.raises(ValueError, match="unknown precision"):
        jax_lowbit.quantize_model_params_lowbit(jp, "int2")
    tp = params_from_jax(jp, "cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        t_lowbit.quantize_model_params_lowbit(tp, "int2")
    cfg = reduced(ARCHS["qwen2-7b"])
    with pytest.raises(ValueError, match="unknown precision"):
        DecodeCore(cfg, RunConfig(), tp, quantize=True, precision="e5m2",
                   device="cpu")
    # the precision only matters for a quantized core (as in the reference)
    DecodeCore(cfg, RunConfig(), tp, quantize=False, precision="e5m2",
               device="cpu")
