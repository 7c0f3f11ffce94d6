"""The port's INT8 quantization, GEMM plain version, gated linear route and
plan table against the JAX package's.

Tolerances: quantized tensors and plan digests are compared bitwise.
Products are compared in f32 at rtol 1e-5 / atol 1e-5·max|ref| (the two
packages sum the same f32 products in different orders), and in bf16 at
the bf16 half-ulp (2**-8) of the output scale, since the frameworks may
round their bf16 results at different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, reduced as jax_reduced
from repro.core.llm_workloads import (
    phase_gemms_of_model as jax_phase_gemms_of_model)
from repro.core.planner import plan_workload_by_phase as jax_plan_by_phase
from repro.kernels import ops as jax_ops
from repro.models import init as jax_init
from repro.quant import KernelPlanTable as JaxKernelPlanTable
from repro.quant import int8 as jax_int8

from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import phase_gemms_of_model, plan_workload_by_phase
from repro_torch.kernels import int8_gemm, int8_gemm_ref
from repro_torch.quant import KernelPlanTable
from repro_torch.quant import int8 as t_int8

F32_RTOL = 1e-5
BF16_TOL = 2.0 ** -8


def _close(got, want, tol_rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol_rel,
                               atol=tol_rel * scale)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bitwise(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    w[:, 3] = 0.0                                    # an all-zero channel
    w[5, 7] = 0.5 * np.abs(w[:, 7]).max()            # near a .5 tie
    jw = jnp.asarray(w, dtype)
    jq, js = jax_int8.quantize_weight(jw)
    tq, ts = t_int8.quantize_weight(params_from_jax(jw, "cpu"))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_model_params_bitwise_on_stacked_tree():
    cfg = jax_reduced(JAX_ARCHS["qwen2-7b"])
    jp = jax_int8.quantize_model_params(
        jax_init(jax.random.PRNGKey(3), cfg))
    tp = t_int8.quantize_model_params(
        params_from_jax(jax_init(jax.random.PRNGKey(3), cfg), "cpu"))
    ref = params_from_jax(jp, "cpu")
    leaves = []

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), path
            leaves.append(path)
    walk(tp, ref, ())
    attn = tp["slots"][0]["attn"]["wq"]
    assert attn["q"].shape == (2, 64, 64) and attn["scale"].shape == (2, 64)
    assert tp["lm_head"]["q"].dtype == torch.int8
    assert len(leaves) > 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("materialize", [False, True])
def test_dequant_contract_matches(dtype, materialize):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 3, 64)), dtype)
    q, s = jax_int8.quantize_weight(
        jnp.asarray(rng.standard_normal((64, 48)), jnp.float32))
    want = jax_int8.dequant_contract(x, q, s, materialize=materialize)
    got = t_int8.dequant_contract(*(params_from_jax(a, "cpu")
                                    for a in (x, q, s)),
                                  materialize=materialize)
    assert str(got.dtype).endswith(dtype)
    _close(_np(got), want, F32_RTOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_gemm_ref_matches_pallas_interpret(m, dtype):
    rng = np.random.default_rng(m)
    x = jnp.asarray(rng.standard_normal((m, 256)), dtype)
    q, s = jax_int8.quantize_weight(
        jnp.asarray(rng.standard_normal((256, 384)), jnp.float32))
    want = jax_ops.int8_matmul(x, q, s, interpret=True)
    tx, tq, ts = (params_from_jax(a, "cpu") for a in (x, q, s))
    got = int8_gemm_ref(tx, tq, ts)
    assert got.dtype == torch.float32 and got.shape == (m, 384)
    _close(got.numpy(), want, F32_RTOL)


def test_int8_gemm_wrapper_on_cpu_and_meta():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; on meta tensors it only gives the output shape."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((5, 300)), dtype=torch.bfloat16)
    q = torch.tensor(rng.integers(-127, 128, (300, 1000)), dtype=torch.int8)
    s = torch.tensor(rng.random(1000), dtype=torch.float32)
    before = int8_gemm.launches
    assert torch.equal(int8_gemm(x, q, s), int8_gemm_ref(x, q, s))
    y = int8_gemm(x.to("meta"), q.to("meta"), s.to("meta"))
    assert y.device.type == "meta" and y.shape == (5, 1000)
    assert y.dtype == torch.float32
    assert int8_gemm.launches == before
    with pytest.raises(ValueError):
        int8_gemm(x, q[:299], s)
    with pytest.raises(TypeError):
        int8_gemm(x, q.float(), s)


@pytest.mark.parametrize("use_cim", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planned_linear_matches(use_cim, dtype):
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 4, 128)), dtype)
    q, s = jax_int8.quantize_weight(
        jnp.asarray(rng.standard_normal((128, 256)), jnp.float32))
    want = jax_int8.planned_linear(x, q, s, use_cim_path=use_cim,
                                   interpret=True)
    got = t_int8.planned_linear(*(params_from_jax(a, "cpu")
                                  for a in (x, q, s)), use_cim_path=use_cim)
    assert got.shape == (2, 4, 256) and str(got.dtype).endswith(dtype)
    _close(_np(got), want, F32_RTOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("batch", [2, 8, 128])
def test_plan_table_behaves_the_same(batch):
    name = "qwen2-7b-smoke"
    ours = plan_workload_by_phase(
        phase_gemms_of_model(reduced(ARCHS["qwen2-7b"]), 16, batch))
    ref = jax_plan_by_phase(
        jax_phase_gemms_of_model(jax_reduced(JAX_ARCHS["qwen2-7b"]), 16,
                                 batch), backend="vectorized")
    for ph in ("prefill", "decode"):
        t = KernelPlanTable.from_decisions(ours[ph], model_name=name)
        j = JaxKernelPlanTable.from_decisions(ref[ph], model_name=name)
        assert t.labels == j.labels and t.digest == j.digest
        assert t.ungated().digest == j.ungated().digest
        for lab in t.labels:
            tf, jf = t.with_flip(lab), j.with_flip(lab)
            assert tf.digest == jf.digest and tf.flips(t) == jf.flips(j)
        with pytest.raises(KeyError, match="known labels"):
            t.use_cim("no-such-label")
