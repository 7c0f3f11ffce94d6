"""The port's MoE FFN and the stacked-weight `spec` contractions against
the JAX package, on the CPU.

`moe_apply` is held against each of the reference's two dispatch paths
on its own (the T <= C fast path, and the buffered scatter/gather, both
forced and reached by a token count above capacity, with drops): the
reference's two paths agree only to f32 rounding, so no bitwise claim is
made across them.  Params come from the reference's `moe_init`, converted
with `params_from_jax`; inputs from numpy seeds.  Tolerance: 1e-5 ·
max|ref| in f32 (the same f32 sums in another order), on the output and
the aux loss.

`dequant_contract` / `_int4` / `_fp8` are held against the reference's
functions on the same quantized bytes for every einsum spec of
tests/test_decode_hotpath.py and the fallback spec whose scale axis is
summed out (1e-5 · max|ref|), and the stacked quantizers bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init
from repro.quant import quantize_model_params as jax_quantize
from repro.quant.int8 import _epilogue_scale as jax_epilogue_scale
from repro.quant.int8 import dequant_contract as jax_dequant_contract
from repro.quant.lowbit import (
    dequant_contract_fp8 as jax_dequant_contract_fp8,
    dequant_contract_int4 as jax_dequant_contract_int4,
    quantize_model_params_lowbit as jax_quantize_lowbit)

from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import phase_gemms_of_model, plan_workload_by_phase
from repro_torch.models import route_trace
from repro_torch.models.layers import (CIM_ROUTE, DEQUANT_FP8_ROUTE,
                                       DEQUANT_INT4_ROUTE, DEQUANT_ROUTE,
                                       FLOAT_ROUTE, linear)
from repro_torch.models.moe import capacity, moe_apply, moe_init
from repro_torch.quant import (KernelPlanTable, quantize_model_params,
                               quantize_model_params_lowbit)
from repro_torch.quant.int8 import _epilogue_scale, dequant_contract
from repro_torch.quant.lowbit import (dequant_contract_fp8,
                                      dequant_contract_int4,
                                      quantize_weight_fp8,
                                      quantize_weight_int4)

TOL = 1e-5
KW = dict(param_dtype="float32", compute_dtype="float32")
MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
# (batch, seq, force_buffered): the fast path, the buffered path forced
# at the same T, and the buffered path at T above capacity (drops)
DISPATCH = [(1, 4, False), (1, 4, True), (2, 16, False)]


def _close(got, want, tol=TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _moe(arch, quantize):
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch]), **KW)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **KW)
    jp = jax_moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if quantize:
        jp = jax_quantize(jp)
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("b,l,force", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_each_reference_path(arch, b, l, force, quantize):
    jcfg, cfg, jp, tp = _moe(arch, quantize)
    x = np.random.default_rng(b * l).standard_normal(
        (b, l, cfg.d_model)).astype(np.float32)
    T = b * l
    assert capacity(cfg, T) == capacity(jcfg, T)
    # the fast path at T = 4; the buffered one forced, or above capacity
    assert (T <= capacity(cfg, T)) == (T == 4)
    jy, jaux = jax_moe_apply(jp, jnp.asarray(x), jcfg, force_buffered=force)
    with route_trace() as records:
        ty, taux = moe_apply(tp, torch.tensor(x), cfg, force_buffered=force)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
    want = DEQUANT_ROUTE if quantize else FLOAT_ROUTE
    assert {r["route"] for r in records} == {want}
    experts = [r["label"] for r in records if r["label"].startswith("expert")]
    assert experts == ["expert-gate", "expert-up", "expert-down"]


def test_moe_routing_conservation():
    """The port's form of tests/test_models.py's conservation test, on
    the port's own init: the output keeps x's shape, the aux loss is
    finite and non-negative."""
    cfg = reduced(ARCHS["qwen2-moe-a2.7b"])
    p = moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                 device="cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, aux = moe_apply(p, x, cfg)
    assert y.shape == x.shape
    assert torch.isfinite(aux) and aux >= 0
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (cfg.moe.n_experts, cfg.d_model,
                                 cfg.moe.expert_d_ff)


def test_moe_bf16_router_runs_in_f32():
    """A bf16 activation meets the f32 router as JAX promotes it (torch
    raises on mixed matmul dtypes): same routing, bf16 output."""
    jcfg, cfg, jp, tp = _moe("qwen2-moe-a2.7b", quantize=False)
    bf = {k: (v.to(torch.bfloat16) if k != "router" and torch.is_tensor(v)
              else v) for k, v in tp.items()}
    bf["shared"] = {k: v.to(torch.bfloat16) for k, v in tp["shared"].items()}
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2)).to(torch.bfloat16)
    y, aux = moe_apply(bf, x, cfg)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                       if a.dtype == jnp.float32 and a.ndim == 3 else a, jp)
    jbf["shared"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                 jp["shared"])
    jy, jaux = jax_moe_apply(jbf, jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16), jcfg)
    _close(y, jy, 2.0 ** -6)
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


# --- the spec contractions ---------------------------------------------------

SPECS = [
    # stacked MoE experts, both contraction directions (models/moe.py)
    ("ecd,edf->ecf", (3, 4, 16), (3,)),
    ("ecf,efd->ecd", (3, 4, 16), (3,)),
    # MoE decode fast path: all experts over the shared token batch
    ("td,edf->etf", (4, 16), (3,)),
    ("etf,efd->etd", (3, 4, 16), (3,)),
    # multi-head readout (the reference's audio head)
    ("bld,ndv->blnv", (2, 5, 16), (4,)),
    # a scale axis summed out of the output: the materializing fallback
    ("ab,cbd->ad", (4, 16), (3,)),
]


def _weights(fmt, stacked, seed):
    """A (stacked..., 16, 8) weight quantized by the port (bitwise the
    reference's quantizers, held below) and its bytes for both sides."""
    w = torch.randn((*stacked, 16, 8), generator=torch.Generator()
                    .manual_seed(seed))
    if fmt == "int8":
        leaf = quantize_model_params({"w_up": w})["w_up"]
        q, s = leaf["q"], leaf["scale"]
        jq = jnp.asarray(q.numpy())
    elif fmt == "int4":
        q, s = quantize_weight_int4(w)
        jq = jnp.asarray(q.numpy())
    else:
        q, s = quantize_weight_fp8(w)
        jq = jnp.asarray(q.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return q, s, jq, jnp.asarray(s.numpy())


CONTRACT = {"int8": (dequant_contract, jax_dequant_contract),
            "int4": (dequant_contract_int4, jax_dequant_contract_int4),
            "fp8": (dequant_contract_fp8, jax_dequant_contract_fp8)}


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("spec,x_shape,stacked", SPECS)
def test_dequant_contract_specs_match_reference(fmt, spec, x_shape, stacked):
    q, s, jq, js = _weights(fmt, stacked, seed=len(spec))
    x = np.random.default_rng(5).standard_normal(x_shape).astype(np.float32)
    ours, ref = CONTRACT[fmt]
    got = ours(torch.tensor(x), q, s, spec)
    want = ref(jnp.asarray(x), jq, js, spec)
    _close(got, want)
    fallback = spec == "ab,cbd->ad"
    assert (_epilogue_scale(spec, s) is None) == fallback
    assert (jax_epilogue_scale(spec, js) is None) == fallback
    if fmt == "int8":
        mat = dequant_contract(torch.tensor(x), q, s, spec, materialize=True)
        _close(got, mat.numpy())


def test_epilogue_scale_layout_matches_reference():
    s = torch.randn((3, 4, 8), generator=torch.Generator().manual_seed(0))
    for spec in ("btd,ledf->lbtef", "etf,efd->etd"):
        w_letters = spec.split(",")[1].split("->")[0]
        sc = s if len(w_letters) == 4 else s[0]
        got = _epilogue_scale(spec, sc)
        want = jax_epilogue_scale(spec, jnp.asarray(sc.numpy()))
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", ["int8", "int4", "fp8"])
def test_stacked_expert_leaf_quantizes_as_reference(precision):
    """A (layers, experts, K, N) leaf: the port quantizes one matrix at a
    time; the packing axis, the scale shape and every byte equal the
    reference's vmapped quantizer."""
    w = np.random.default_rng(7).standard_normal((2, 4, 64, 48)).astype(
        np.float32)
    ours = quantize_model_params_lowbit({"w_gate": torch.tensor(w)},
                                        precision)["w_gate"]
    ref = jax_quantize_lowbit({"w_gate": jnp.asarray(w)},
                              precision)["w_gate"]
    assert sorted(ours) == sorted(ref)
    for key in ours:
        got, want = ours[key], np.asarray(ref[key])
        assert tuple(got.shape) == want.shape
        if got.dtype == torch.float8_e4m3fn:
            got, want = got.view(torch.uint8), want.view(np.uint8)
        assert np.array_equal(got.numpy(), want)
    key = {"int8": "q", "int4": "q4", "fp8": "qf8"}[precision]
    assert ours[key].shape[-2] == (32 if precision == "int4" else 64)
    assert tuple(ours["scale"].shape) == (2, 4, 48)


# --- linear's routes for spec'd and stacked weights ---------------------------

@pytest.fixture(scope="module")
def all_cim():
    """The decode table of reduced qwen2-moe with every label gated on."""
    cfg = reduced(ARCHS["qwen2-moe-a2.7b"])
    table = KernelPlanTable.from_decisions(plan_workload_by_phase(
        phase_gemms_of_model(cfg, 16, 4), backend="scalar")["decode"],
        model_name=cfg.name)
    for lab in table.labels:
        if not table.use_cim(lab):
            table = table.with_flip(lab)
    return table


@pytest.mark.parametrize("precision,route", [
    ("int8", DEQUANT_ROUTE), ("int4", DEQUANT_INT4_ROUTE),
    ("fp8", DEQUANT_FP8_ROUTE)])
def test_linear_routes_spec_and_stacked_weights(all_cim, precision, route):
    """A gated label with a spec, or with a weight that is not 2-D, takes
    the dequant route (the kernel takes 2-D matmuls only); a 2-D weight
    without a spec under the same label takes the kernel route; a float
    weight with a spec is the plain einsum."""
    assert all_cim.use_cim("expert-gate")
    gen = torch.Generator().manual_seed(0)
    w3 = torch.randn((3, 16, 8), generator=gen)
    w2 = torch.randn((16, 8), generator=gen)
    q = quantize_model_params_lowbit({"w_gate": w3, "w_up": w2}, precision)
    x = torch.randn((4, 16), generator=gen)
    xe = torch.randn((3, 4, 16), generator=gen)
    with route_trace() as records:
        a = linear(q["w_gate"], x, "expert-gate", all_cim, spec="td,edf->etf")
        b = linear(q["w_gate"], xe, "expert-gate", all_cim)
        c = linear(q["w_up"], x, "expert-gate", all_cim)
        d = linear(w3, x, "expert-gate", all_cim, spec="td,edf->etf")
    kernel = {"int8": CIM_ROUTE, "int4": "cim-int4-pallas",
              "fp8": "cim-fp8-pallas"}[precision]
    assert [r["route"] for r in records] == [route, route, kernel,
                                             FLOAT_ROUTE]
    assert a.shape == (3, 4, 8) and b.shape == (3, 4, 8) and c.shape == (4, 8)
    assert torch.allclose(d, torch.einsum("td,edf->etf", x, w3))
    if precision == "int8":
        want = dequant_contract(x, q["w_gate"]["q"], q["w_gate"]["scale"],
                                "td,edf->etf", materialize=True)
        assert torch.allclose(a, want, atol=1e-5)
