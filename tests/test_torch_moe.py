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

The grouped expert kernels' plain version, `kernels/moe_experts.py:
moe_experts_ref`, is held in f32 at both MoE cells' expert shapes (60
experts top-4 by softmax; 64 top-6 by sigmoid, × routed_scale) at reduced
widths, against the T <= C einsum path (`dequant_contract(...,
materialize=True)`) and the reference's einsums (1e-5 · max|ref|), and
through `moe_apply` with the kernel branch taken on the CPU against the
reference's `moe_apply` (softmax) or the port's einsum branch (sigmoid).
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
from repro_torch.kernels import moe_experts, moe_experts_ref
from repro_torch.kernels.moe_experts import row_chunks
from repro_torch.models import moe as tmoe
from repro_torch.models import route_trace
from repro_torch.models.layers import (CIM_ROUTE, DEQUANT_FP8_ROUTE,
                                       DEQUANT_INT4_ROUTE, DEQUANT_ROUTE,
                                       FLOAT_ROUTE, linear)
from repro_torch.models.moe import capacity, moe_apply, moe_init, route
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


# --- the grouped expert kernels' plain version --------------------------------

# the MoE cells' expert shapes: (scoring, experts, top_k, routed_scale)
EXPERT_SHAPES = {"softmax-60-top4": ("softmax", 60, 4, 1.0),
                 "sigmoid-64-top6": ("sigmoid", 64, 6, 2.446)}
ROUTINGS = ("router", "idle", "one")


def _expert_cfgs(shape):
    """The reference's and the port's reduced qwen2-moe at an expert shape
    (f32, capacity as the cells': every T is T <= C)."""
    scoring, E, k, rs = EXPERT_SHAPES[shape]
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-moe-a2.7b"]),
                               **KW)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=E, top_k=k, capacity_factor=E / k))
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-moe-a2.7b"]), **KW)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=E, top_k=k, capacity_factor=E / k,
        scoring=scoring, routed_scale=rs))
    return jcfg, cfg


def _expert_params(shape):
    jcfg, cfg = _expert_cfgs(shape)
    jp = jax_quantize(jax_moe_init(jax.random.PRNGKey(11), jcfg,
                                   jnp.float32))
    tp = params_from_jax(jp, "cpu")
    if cfg.moe.scoring == "sigmoid":
        tp["score_bias"] = torch.randn(
            cfg.moe.n_experts, generator=torch.Generator().manual_seed(2))
    return jcfg, cfg, jp, tp


def _routing(tp, x, cfg, routing):
    """(T, k) expert ids: the port's router's; or with the first E // 4
    experts never chosen ("idle"); or expert 5 every token's first choice
    ("one")."""
    probs = route(tp, x, cfg)[0]
    if routing == "idle":
        probs[:, :cfg.moe.n_experts // 4] = -1.0
    elif routing == "one":
        probs[:, 5] = 2.0
    return probs.topk(cfg.moe.top_k, dim=-1).indices


def _experts(tp):
    return tp["w_gate"], tp["w_up"], tp["w_down"]


def _einsum_experts(x, ids, tp, contract):
    """The T <= C path's three contractions over every expert and token,
    each token's k outputs selected: (T, k, d)."""
    leaves = [(w["q"], w["scale"]) for w in _experts(tp)]
    g = contract(x, *leaves[0], "td,edf->etf")
    u = contract(x, *leaves[1], "td,edf->etf")
    return g, u, lambda h: contract(h, *leaves[2], "etf,efd->etd")


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("T", [1, 4, 32])
@pytest.mark.parametrize("shape", sorted(EXPERT_SHAPES))
def test_moe_experts_ref_matches_einsum_path(shape, T, routing):
    """f32: the grouped plain version against the einsum fast path with
    the canonical dequantized weight, at the same expert ids."""
    _, cfg, _, tp = _expert_params(shape)
    x = torch.tensor(np.random.default_rng(T).standard_normal(
        (T, cfg.d_model)).astype(np.float32))
    ids = _routing(tp, x, cfg, routing)
    got = moe_experts_ref(x, ids, *_experts(tp))
    g, u, down = _einsum_experts(
        x, ids, tp, lambda a, q, s, spec: dequant_contract(
            a, q, s, spec, materialize=True))
    eout = down(torch.nn.functional.silu(g) * u)
    want = torch.gather(eout.transpose(0, 1), 1,
                        ids[:, :, None].expand(*ids.shape, cfg.d_model))
    _close(got, want.numpy())
    if routing == "idle":
        assert not (ids < cfg.moe.n_experts // 4).any()
    if routing == "one":
        assert (ids == 5).any(-1).all()


@pytest.mark.parametrize("T", [1, 4, 32])
@pytest.mark.parametrize("shape", sorted(EXPERT_SHAPES))
def test_moe_experts_ref_matches_reference_einsums(shape, T):
    """f32: the grouped plain version against the reference's T <= C
    contractions (its `dequant_contract` on the same bytes) and its
    selection of each token's k outputs."""
    _, cfg, jp, tp = _expert_params(shape)
    x = np.random.default_rng(T + 1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    ids = _routing(tp, torch.tensor(x), cfg, "router")
    got = moe_experts_ref(torch.tensor(x), ids, *_experts(tp))
    jx = jnp.asarray(x)

    def jcontract(a, name, spec):
        return jax_dequant_contract(a, jp[name]["q"], jp[name]["scale"],
                                    spec)
    h = jax.nn.silu(jcontract(jx, "w_gate", "td,edf->etf")) * jcontract(
        jx, "w_up", "td,edf->etf")
    eout = jcontract(h, "w_down", "etf,efd->etd")
    want = jnp.take_along_axis(eout.transpose(1, 0, 2),
                               jnp.asarray(ids.numpy())[:, :, None], axis=1)
    _close(got, want)


@pytest.mark.parametrize("T", [1, 4, 32])
@pytest.mark.parametrize("shape", sorted(EXPERT_SHAPES))
def test_moe_apply_kernel_branch_matches_reference(shape, T, monkeypatch):
    """`moe_apply` with the grouped kernel branch taken on the CPU (where
    the wrapper runs the plain version), in f32: against the reference's
    `moe_apply` (softmax: the same router) or the port's einsum branch
    (sigmoid: the reference has no such router), with the three expert
    routes recorded as the einsum branch records them."""
    jcfg, cfg, jp, tp = _expert_params(shape)
    x = np.random.default_rng(T + 2).standard_normal(
        (1, T, cfg.d_model)).astype(np.float32)
    with route_trace() as plain_routes:
        plain, _ = moe_apply(tp, torch.tensor(x), cfg)
    monkeypatch.setattr(tmoe, "_grouped_kernel_takes", lambda *a: True)
    with route_trace() as records:
        y, aux = moe_apply(tp, torch.tensor(x), cfg)
    assert [r["route"] for r in records] == [
        r["route"] for r in plain_routes]
    assert [r["label"] for r in records if r["label"].startswith(
        "expert")] == ["expert-gate", "expert-up", "expert-down"]
    assert {r["callsite"].split(":")[0] for r in records
            if r["label"].startswith("expert")} == {"moe.py"}
    if cfg.moe.scoring == "softmax":
        jy, _ = jax_moe_apply(jp, jnp.asarray(x), jcfg)
        _close(y, jy)
    _close(y, plain.numpy())


@pytest.mark.parametrize("case", ["cpu", "meta", "float-leaf", "shape",
                                  "float-ids", "autograd"])
def test_moe_experts_wrapper_off_card(case):
    """Off the card the wrapper runs the plain version (CPU: the same
    bits, no launch counted) or returns an empty meta tensor, and refuses
    what no device takes."""
    _, cfg, _, tp = _expert_params("softmax-60-top4")
    x = torch.randn((4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    ids = _routing(tp, x, cfg, "router")
    before = (moe_experts.launches, dict(moe_experts.launches_by_design))
    if case == "cpu":
        assert torch.equal(moe_experts(x, ids, *_experts(tp)),
                           moe_experts_ref(x, ids, *_experts(tp)))
    elif case == "meta":
        meta = [{k: v.to("meta") for k, v in w.items()}
                for w in _experts(tp)]
        out = moe_experts(x.to("meta"), ids.to("meta"), *meta)
        assert out.device.type == "meta"
        assert tuple(out.shape) == (4, cfg.moe.top_k, cfg.d_model)
    elif case == "float-leaf":
        with pytest.raises(TypeError, match="INT8 leaves"):
            moe_experts(x, ids, tp["w_gate"]["q"].float(),
                        *_experts(tp)[1:])
    elif case == "shape":
        with pytest.raises(ValueError, match="w_down"):
            moe_experts(x, ids, tp["w_gate"], tp["w_up"], dict(
                tp["w_down"], q=tp["w_down"]["q"][:, :32]))
    elif case == "float-ids":
        with pytest.raises(TypeError, match="integers"):
            moe_experts(x, ids.float(), *_experts(tp))
    else:
        with pytest.raises(RuntimeError, match="no backward"):
            moe_experts(x.requires_grad_(), ids, *_experts(tp))
    assert (moe_experts.launches, moe_experts.launches_by_design) == before


@pytest.mark.parametrize("T,k,E,want", [
    (32, 4, 60, 1),      # the MoE cell: 2.1 rows an expert on average
    (128, 6, 64, 2),     # Moonlight's: 12 on average, up to ~60
    (1, 1, 16, 1), (8, 1, 16, 1),
    (512, 4, 60, 5),     # a long T <= C call: 34 on average
    (64, 8, 8, 2)])      # every expert takes every token: ceil(T / 32)
def test_row_chunks_cover_four_times_the_mean(T, k, E, want):
    """The blocks sharing an (expert, column tile): enough passes of 32
    rows for 4x the mean rows T k / E in one round, never more than an
    expert's T rows need."""
    assert row_chunks(T, k, E) == want


def _once_reordered(x, ids, w_gate, w_up, w_down, drop_last=False):
    """The plain version's function with each contraction summed in f32
    over 64-row pieces of K in reverse order (h and the output rounded
    once); `drop_last` leaves out the last piece of the down
    contraction."""
    def contract(a, w, e, drop=False):
        K = a.shape[1]
        starts = list(range(0, K, 64))[:-1 if drop else None]
        acc = torch.zeros((a.shape[0], w["q"].shape[2]))
        for i in starts[::-1]:
            acc = acc + a[:, i:i + 64].float() @ w["q"][e, i:i + 64].float()
        return acc * w["scale"][e].float()
    T, k = ids.shape
    out = torch.empty((T * k, x.shape[1]), dtype=x.dtype)
    flat = ids.reshape(-1)
    for e in range(w_gate["q"].shape[0]):
        rows = (flat == e).nonzero()[:, 0]
        if rows.numel():
            xe = x[rows // k]
            h = (torch.nn.functional.silu(contract(xe, w_gate, e))
                 * contract(xe, w_up, e)).to(x.dtype)
            out[rows] = contract(h, w_down, e, drop_last).to(x.dtype)
    return out.view(T, k, -1)


@pytest.mark.parametrize("variant", ["plain", "reordered", "twice-rounded",
                                     "dropped-piece"])
@pytest.mark.parametrize("shape", sorted(EXPERT_SHAPES))
def test_moe_experts_check_holds_one_rounding(shape, variant):
    """bf16 at d 512, f 384 (8 and 6 pieces of 64 rows): `moe_experts_check`
    passes the plain version and a sum in another f32 order rounded once,
    and refuses the twice-rounded dequant einsums (bf16 product, then the
    scale) and a down contraction that drops one 64-row piece of K: the
    whole-tensor RMS bound catches what the per-element bound lets
    through."""
    from repro_torch.kernels.moe_experts import (MOE_RMS_TOL,
                                                 moe_experts_check)
    _, E, k, _ = EXPERT_SHAPES[shape]
    d, f, T = 512, 384, 32
    gen = torch.Generator().manual_seed(E)

    def leaf(a, b):
        return {"q": torch.randint(-127, 128, (E, a, b), generator=gen,
                                   dtype=torch.int8),
                "scale": (1.0 + torch.rand((E, b), generator=gen))
                / (127 * a ** 0.5)}
    tp = {"w_gate": leaf(d, f), "w_up": leaf(d, f), "w_down": leaf(f, d)}
    x = torch.randn((T, d), generator=gen).to(torch.bfloat16)
    ids = torch.randn((T, E), generator=gen).topk(k, dim=-1).indices
    leaves = _experts(tp)
    if variant == "plain":
        got = moe_experts_ref(x, ids, *leaves)
    elif variant == "twice-rounded":
        g, u, down = _einsum_experts(x, ids, tp, dequant_contract)
        eout = down(torch.nn.functional.silu(g) * u)
        got = torch.gather(eout.transpose(0, 1), 1,
                           ids[:, :, None].expand(T, k, d))
    else:
        got = _once_reordered(x, ids, *leaves,
                              drop_last=variant == "dropped-piece")
    out = moe_experts_check(got, x, ids, *leaves)
    if variant in ("plain", "reordered"):
        assert out["ok"], out
        assert out["rms_rel"] <= MOE_RMS_TOL / 4, out
    else:
        assert not out["ok"], out
        assert out["rms_rel"] > 2 * MOE_RMS_TOL, out
