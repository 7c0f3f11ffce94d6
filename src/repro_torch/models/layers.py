"""Shared model layers as plain functions on torch tensors.

Parameters are plain dicts keyed like the JAX package's pytree, so each
leaf has the same path in both packages.

`linear` is the single projection execution layer: every dense projection
routes through it with a GEMM label, and a `KernelPlanTable`
(repro_torch.quant.plan_table) decides per label whether a quantized
projection (INT8, INT4 or FP8) runs the hand-written INT8 GEMM kernel or
the plain torch matmul — the What/When/Where verdicts applied as the
deployed dataflow.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
import threading

import torch
import torch.nn.functional as F

from .. import spans
from ..quant.int8 import dequant_contract, planned_linear
from ..quant.lowbit import (dequant_contract_fp8, dequant_contract_int4,
                            planned_linear_fp8, planned_linear_int4)
from ..sharding.constraints import einsum, split_heads
from ..tree import leaves


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --- the planner-gated projection execution layer ---------------------------

_ROUTE_TRACE = threading.local()    # .records, per-thread: concurrent
                                    # sessions may trace simultaneously

# route strings linear() records — the JAX package's strings, so route
# reports of the two packages compare (the CiM route runs the Hopper
# kernel here, not Pallas)
CIM_ROUTE = "cim-int8-pallas"
DEQUANT_ROUTE = "int8-dequant-xla"
CIM_INT4_ROUTE = "cim-int4-pallas"
DEQUANT_INT4_ROUTE = "int4-dequant-xla"
CIM_FP8_ROUTE = "cim-fp8-pallas"
DEQUANT_FP8_ROUTE = "fp8-dequant-xla"
FLOAT_ROUTE = "xla"

# the MoE expert contractions' labels
EXPERT_LABELS = ("expert-gate", "expert-up", "expert-down")


@contextlib.contextmanager
def route_trace():
    """Collect every `linear` routing decision made inside the block.

    Yields a list of {"label", "route", "callsite"} records, one per
    `linear` call (a step run on "meta" tensors yields the routes without
    any compute — this backs `DecodeCore.route_report`)."""
    prev = getattr(_ROUTE_TRACE, "records", None)
    _ROUTE_TRACE.records = []
    try:
        yield _ROUTE_TRACE.records
    finally:
        _ROUTE_TRACE.records = prev


def _record_route(label: str, route: str) -> None:
    records = getattr(_ROUTE_TRACE, "records", None)
    if records is not None:
        f = sys._getframe(2)        # the frame that called linear()
        records.append({
            "label": label, "route": route,
            "callsite": f"{os.path.basename(f.f_code.co_filename)}"
                        f":{f.f_lineno}"})


def linear(w, x, label: str, plan=None, spec: str | None = None):
    """y = x @ w — THE projection entry point, routed by the kernel plan.

    w is either a float weight tensor or a quantized leaf: {"q", "scale"}
    INT8, {"q4", "scale"} packed INT4 or {"qf8", "scale"} FP8
    (repro_torch.quant.quantize_model_params_lowbit); the key present is
    the format.  With a KernelPlanTable `plan`, a quantized 2-D
    projection whose label gates on runs the INT8 GEMM kernel
    (planned_linear, planned_linear_int4, planned_linear_fp8); every
    other quantized projection contracts against the raw weight in
    x.dtype with the scale in the epilogue.  `spec` is an optional einsum
    spec for a stacked weight (the MoE experts' `"td,edf->etf"`,
    `"ecd,edf->ecf"`, ...): the INT8 GEMM kernel takes only plain 2-D
    matmuls, so a spec or a weight that is not 2-D records the dequant
    route even when its label gates on.  (On the card, the MoE decode
    step's INT8 experts bypass `linear` for the grouped expert kernels,
    `models/moe.py`, and record the same dequant routes: the function is
    the dequant route's.)  Unknown labels raise KeyError from the plan
    table: model-side label drift must not silently disable gating."""
    # an expert contraction is charged to moe_apply's "moe.experts"
    with (spans.NO_SPAN if label in EXPERT_LABELS else spans.span("proj")):
        quantized = isinstance(w, dict)
        use_cim = bool(plan is not None and quantized
                       and plan.use_cim(label))
        if quantized:
            if "q4" in w:
                if use_cim and spec is None and w["q4"].ndim == 2:
                    _record_route(label, CIM_INT4_ROUTE)
                    return planned_linear_int4(x, w["q4"], w["scale"])
                _record_route(label, DEQUANT_INT4_ROUTE)
                return dequant_contract_int4(x, w["q4"], w["scale"], spec)
            if "qf8" in w:
                if use_cim and spec is None and w["qf8"].ndim == 2:
                    _record_route(label, CIM_FP8_ROUTE)
                    return planned_linear_fp8(x, w["qf8"], w["scale"])
                _record_route(label, DEQUANT_FP8_ROUTE)
                return dequant_contract_fp8(x, w["qf8"], w["scale"], spec)
            if use_cim and spec is None and w["q"].ndim == 2:
                _record_route(label, CIM_ROUTE)
                return planned_linear(x, w["q"], w["scale"],
                                      use_cim_path=True)
            _record_route(label, DEQUANT_ROUTE)
            return dequant_contract(x, w["q"], w["scale"], spec)
        _record_route(label, FLOAT_ROUTE)
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        return einsum(spec, x, w) if spec else x @ w


# --- tree size helpers ------------------------------------------------------

def count_params(tree) -> int:
    """Elements over every tensor of a (params) tree."""
    return sum(t.numel() for t in leaves(tree))


def param_bytes(tree) -> int:
    """Bytes over every tensor of a (params) tree."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


# --- initializers -----------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device="cuda"):
    return (torch.randn((vocab, d), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# --- norms -------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


# --- rotary embeddings --------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device="cuda"):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float = 1e6):
    """x: (..., seq, heads, d_head); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (d_head/2,)
    ang = positions[..., :, None].float() * freqs           # (.., s, d/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (.., s, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- MLP and attention projections -----------------------------------------------

def swiglu(params, x, plan=None, label_prefix: str = "mlp"):
    """Gated MLP with the "mlp-*" GEMM labels of gemms_of_model."""
    g = F.silu(linear(params["w_gate"], x, f"{label_prefix}-gate", plan))
    u = linear(params["w_up"], x, f"{label_prefix}-up", plan)
    return linear(params["w_down"], g * u, f"{label_prefix}-down", plan)


def qkv_proj(params, x, n_heads: int, n_kv: int, d_head: int, plan=None):
    """q, k, v as (..., heads, d_head) (`sharding.constraints.split_heads`:
    a plain tensor is only reshaped)."""
    q, k, v = (linear(params[w], x, lab, plan)
               for w, lab in (("wq", "Wq"), ("wk", "Wk"), ("wv", "Wv")))
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (split_heads(q, n_heads, d_head, "q"),
            split_heads(k, n_kv, d_head, "kv"),
            split_heads(v, n_kv, d_head, "kv"))


def attn_out_proj(params, o, plan=None, label: str = "Wo"):
    """Attention output projection ("Wo")."""
    return linear(params["wo"], o, label, plan)
