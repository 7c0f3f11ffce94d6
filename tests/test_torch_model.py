"""The port's `decode_step` against the JAX package's on reduced qwen2-7b
(2 layers, d_model 64, qkv bias): logits and updated KV caches over
several positions, for float params (f32 and bf16), quantized params
under the planner's own table (every verdict is baseline at this size),
and quantized params under a table forced all-CiM (the JAX side runs the
Pallas kernel in interpret mode, the port the kernel's plain version).

Parameters come from the JAX `init`, converted with `params_from_jax`.
Tolerances are relative to the reference's largest magnitude: 1e-5 in
f32 (the same f32 sums in another order), 2**-6 in bf16 (each framework
rounds its bf16 intermediates at its own places, across two layers).
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
from repro.models import decode_step as jax_decode_step
from repro.models import init as jax_init, init_cache as jax_init_cache
from repro.quant import KernelPlanTable as JaxKernelPlanTable
from repro.quant import quantize_model_params as jax_quantize

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import phase_gemms_of_model, plan_workload_by_phase
from repro_torch.models import decode_step, init, init_cache, route_trace
from repro_torch.models.layers import CIM_ROUTE, DEQUANT_ROUTE, FLOAT_ROUTE
from repro_torch.quant import KernelPlanTable, quantize_model_params

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
BATCH, MAX_LEN, STEPS = 3, 8, 5


def _configs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw),
            dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **kw),
            JaxRunConfig(kv_cache_dtype=dtype), RunConfig(kv_cache_dtype=dtype))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _tables(jcfg, tcfg):
    """Decode tables of both planners for this shape; they must agree."""
    name = tcfg.name
    t = KernelPlanTable.from_decisions(plan_workload_by_phase(
        phase_gemms_of_model(tcfg, MAX_LEN, BATCH),
        backend="scalar")["decode"], model_name=name)
    j = JaxKernelPlanTable.from_decisions(jax_plan_by_phase(
        jax_phase_gemms_of_model(jcfg, MAX_LEN, BATCH),
        backend="vectorized")["decode"], model_name=name)
    assert t.digest == j.digest
    return t, j


def _all_cim(table):
    for lab in table.labels:
        if not table.use_cim(lab):
            table = table.with_flip(lab)
    return table


def _run_both(dtype, quantize, plan_kind):
    jcfg, tcfg, jrc, trc = _configs(dtype)
    jp = jax_init(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jp, "cpu")
    tplan = jplan = None
    if quantize:
        jp, tp = jax_quantize(jp), quantize_model_params(tp)
        tplan, jplan = _tables(jcfg, tcfg)
        if plan_kind == "all-cim":
            tplan, jplan = _all_cim(tplan), _all_cim(jplan)
            assert tplan.digest == jplan.digest
    jcache = jax_init_cache(jcfg, jrc, BATCH, MAX_LEN)
    tcache = init_cache(tcfg, trc, BATCH, MAX_LEN, device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab,
                                               (STEPS, BATCH, 1))
    routes = None
    for pos in range(STEPS):
        jl, jcache = jax_decode_step(jp, jcache, jnp.asarray(tokens[pos],
                                                             jnp.int32),
                                     jnp.int32(pos), jcfg, jrc, plan=jplan)
        with route_trace() as records:
            tl, tcache = decode_step(tp, tcache, torch.tensor(tokens[pos]),
                                     pos, tcfg, trc, plan=tplan)
        routes = {r["label"]: r["route"] for r in records}
        _close(tl, jl, TOL[dtype])
        for key in ("k", "v"):
            _close(tcache[0][key], jcache[0][key], TOL[dtype])
    return routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_float_params(dtype):
    routes = _run_both(dtype, quantize=False, plan_kind=None)
    assert set(routes.values()) == {FLOAT_ROUTE} and len(routes) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_quantized_natural_table(dtype):
    routes = _run_both(dtype, quantize=True, plan_kind="natural")
    assert set(routes.values()) == {DEQUANT_ROUTE}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_quantized_all_cim_table(dtype):
    routes = _run_both(dtype, quantize=True, plan_kind="all-cim")
    assert set(routes.values()) == {CIM_ROUTE} and len(routes) == 8


def test_init_shapes_and_dtypes_match_reference():
    jcfg, tcfg, _, _ = _configs("bfloat16")
    gen = torch.Generator(device="cpu").manual_seed(0)
    ours = init(gen, tcfg, device="cpu")
    ref = params_from_jax(jax_init(jax.random.PRNGKey(0), jcfg), "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert shapes(ours) == shapes(ref)
    again = init(torch.Generator(device="cpu").manual_seed(0), tcfg,
                 device="cpu")
    assert torch.equal(ours["slots"][0]["mlp"]["w_up"],
                       again["slots"][0]["mlp"]["w_up"])


def test_unported_paths_raise():
    _, tcfg, _, trc = _configs("float32")
    tp = quantize_model_params(
        init(torch.Generator().manual_seed(0), tcfg, device="cpu"))
    cache = init_cache(tcfg, trc, 2, 4, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    # the paged path is ported: ragged positions without a block pool
    # raise as in the JAX package, and a contiguous cache is no pool
    with pytest.raises(ValueError, match="block_tables"):
        decode_step(tp, cache, tok, torch.tensor([0, 1]), tcfg, trc)
    with pytest.raises(ValueError, match="spare block"):
        decode_step(tp, cache, tok, 0, tcfg, trc,
                    block_tables=torch.zeros((2, 1), dtype=torch.long))
    with pytest.raises(NotImplementedError):
        init(torch.Generator(), reduced(ARCHS["mamba2-780m"]), device="cpu")
