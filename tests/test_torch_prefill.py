"""The port's prefill forward against the JAX package's on reduced
qwen2-7b (2 layers, d_model 64, 4 query and 2 kv heads of width 16, qkv
bias), batch 2 and 16 tokens.

* `forward` for each `attn_impl` ("naive", "flash_jnp", "pallas") with
  attn_chunk 8, so that sk = 16 > chunk and "pallas" reaches the flash
  kernel (the JAX side runs its Pallas kernel in interpret mode, the port
  the kernel's plain version), in f32 and bf16, on float params and on
  INT8 params under the prefill table forced all-CiM (every projection on
  the INT8 kernel: Pallas interpret mode on the JAX side);
* `make_prefill` under each package's own `DecodeCore.prefill_plan_table`;
* the port's `forward` against its own token-by-token `decode_step` (the
  counterpart of tests/test_models.py::test_decode_matches_forward).

Parameters come from the JAX `init`, converted with `params_from_jax`.
Tolerances are relative to the reference's largest logit: 1e-5 in f32 (the
same f32 sums in another order), 2**-6 in bf16 (each framework rounds its
bf16 intermediates at its own places, across two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.core.llm_workloads import (
    phase_gemms_of_model as jax_phase_gemms_of_model)
from repro.core.planner import plan_workload_by_phase as jax_plan_by_phase
from repro.models import forward as jax_forward, init as jax_init
from repro.quant import KernelPlanTable as JaxKernelPlanTable
from repro.quant import quantize_model_params as jax_quantize
from repro.serving import DecodeCore as JaxDecodeCore
from repro.serving import make_prefill as jax_make_prefill

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import phase_gemms_of_model, plan_workload_by_phase
from repro_torch.kernels import flash_attention, int8_gemm
from repro_torch.models import (decode_step, forward, init, init_cache,
                                route_trace)
from repro_torch.models.layers import CIM_ROUTE
from repro_torch.quant import KernelPlanTable, quantize_model_params
from repro_torch.serving import DecodeCore, make_prefill

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
BATCH, SEQ, CHUNK = 2, 16, 8


def _configs(dtype, impl="pallas"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    rc = dict(attn_impl=impl, attn_chunk=CHUNK, kv_cache_dtype=dtype)
    return (dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw),
            dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **kw),
            JaxRunConfig(**rc), RunConfig(**rc))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (BATCH, SEQ))


def _all_cim_prefill_tables(jcfg, tcfg):
    """Both planners' prefill tables at this shape (equal digests), with
    every label forced onto CiM."""
    t = KernelPlanTable.from_decisions(plan_workload_by_phase(
        phase_gemms_of_model(tcfg, SEQ, BATCH), backend="scalar")["prefill"],
        model_name=tcfg.name)
    j = JaxKernelPlanTable.from_decisions(jax_plan_by_phase(
        jax_phase_gemms_of_model(jcfg, SEQ, BATCH),
        backend="vectorized")["prefill"], model_name=tcfg.name)
    assert t.digest == j.digest
    for lab in t.labels:
        if not t.use_cim(lab):
            t, j = t.with_flip(lab), j.with_flip(lab)
    assert t.digest == j.digest
    return t, j


@pytest.mark.parametrize("impl", ["naive", "flash_jnp", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_float_params(dtype, impl):
    jcfg, tcfg, jrc, trc = _configs(dtype, impl)
    jp = jax_init(jax.random.PRNGKey(5), jcfg)
    tokens = _tokens(tcfg.vocab)
    want, jaux = jax_forward(jp, jnp.asarray(tokens, jnp.int32), jcfg, jrc)
    got, aux = forward(params_from_jax(jp, "cpu"), torch.from_numpy(tokens),
                       tcfg, trc)
    _close(got, want, TOL[dtype])
    assert aux == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_quantized_all_cim(dtype):
    jcfg, tcfg, jrc, trc = _configs(dtype, "pallas")
    jp = jax_quantize(jax_init(jax.random.PRNGKey(6), jcfg))
    tp = params_from_jax(jp, "cpu")
    tplan, jplan = _all_cim_prefill_tables(jcfg, tcfg)
    tokens = _tokens(tcfg.vocab)
    want, _ = jax_forward(jp, jnp.asarray(tokens, jnp.int32), jcfg, jrc,
                          plan=jplan)
    before = (flash_attention.launches, int8_gemm.launches)
    with route_trace() as records:
        got, _ = forward(tp, torch.from_numpy(tokens), tcfg, trc, plan=tplan)
    _close(got, want, TOL[dtype])
    routes = {r["label"]: r["route"] for r in records}
    assert len(routes) == 8 and set(routes.values()) == {CIM_ROUTE}
    assert len(records) == 7 * tcfg.n_layers + 1
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (flash_attention.launches, int8_gemm.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_prefill_under_the_cores_prefill_tables(dtype):
    jcfg, tcfg, jrc, trc = _configs(dtype, "pallas")
    jp = jax_init(jax.random.PRNGKey(7), jcfg)
    jcore = JaxDecodeCore(jcfg, jrc, jp, quantize=True, plan_batch=BATCH,
                          plan_max_len=SEQ)
    tcore = DecodeCore(tcfg, trc, params_from_jax(jp, "cpu"), quantize=True,
                       plan_batch=BATCH, plan_max_len=SEQ, device="cpu")
    assert tcore.prefill_plan_table.digest == jcore.prefill_plan_table.digest
    tokens = _tokens(tcfg.vocab)
    want = jax_make_prefill(jcfg, jrc, jcore.prefill_plan_table)(
        jcore.params, jnp.asarray(tokens, jnp.int32))
    got = make_prefill(tcfg, trc, tcore.prefill_plan_table)(
        tcore.params, torch.from_numpy(tokens))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_matches_own_decode_steps(impl):
    """Each position's forward logits equal the logits of feeding the
    tokens one by one through `decode_step` (f32: within 1e-5)."""
    _, tcfg, _, trc = _configs("float32", impl)
    params = init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab))
    full, _ = forward(params, tokens, tcfg, trc)
    cache = init_cache(tcfg, trc, BATCH, SEQ, device="cpu")
    steps = []
    for t in range(SEQ):
        lg, cache = decode_step(params, cache, tokens[:, t:t + 1], t, tcfg,
                                trc)
        steps.append(lg[:, 0])
    step_logits = torch.stack(steps, dim=1)
    scale = full.abs().max().item()
    assert (step_logits - full).abs().max().item() <= 1e-5 * scale
