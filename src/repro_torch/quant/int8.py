"""INT8 post-training quantization (the paper's fixed evaluation precision)
+ the CiM-planner-gated quantized linear layer.

`quantize_model_params` converts the projection weights of a model to
int8 with per-output-channel scales; `planned_linear` consults the WWW
planner decision to route a projection through the hand-written INT8
GEMM kernel or keep it on the plain torch matmul — the paper's "when to
CiM" answer, enforced at runtime.

The int8 tensors are bitwise equal to the JAX package's: the scale is
`max|w| / 127 + 1e-12` in f32 and `torch.round` rounds half to even, as
`jnp.round` does.
"""
from __future__ import annotations

import torch

from ..kernels.int8_gemm import int8_gemm


def quantize_weight(w):
    """(K, N) -> (int8 (K, N), f32 (N,)) per-output-channel symmetric."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / 127.0 + 1e-12
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_weight(q, scale, dtype=torch.float32):
    """Per-output-channel dequant in `dtype` (the canonical expression —
    the numerical reference the fused contraction is tested against).
    Supports stacked leading axes: q (..., K, N) with scale (..., N)."""
    return q.to(dtype) * scale.to(dtype)[..., None, :]


def _epilogue_scale(spec: str, scale):
    """Permute and reshape a per-output-channel `scale` so it broadcasts
    against the *output* of `einsum(spec, x, q)`.

    The weight operand's second-to-last letter is the contracted input
    channel (the (..., K, N) weight convention); every other weight
    letter carries a scale axis.  Returns None when a scale axis does not
    survive into the output (the caller then materializes the dequantized
    weight)."""
    ins, out = spec.replace(" ", "").split("->")
    w_spec = ins.split(",")[1]
    k = w_spec[-2]
    s_letters = [c for c in w_spec if c != k]      # scale axis order
    if any(c not in out for c in s_letters):
        return None
    s = scale.permute([s_letters.index(c) for c in out if c in s_letters])
    dims = iter(s.shape)
    return s.reshape([next(dims) if c in s_letters else 1 for c in out])


def dequant_contract(x, q, scale, spec: str | None = None, *,
                     materialize: bool = False):
    """x · dequant(q, scale) with the per-output-channel scale fused into
    the matmul *epilogue*: contract against the raw int8 weight (cast to
    x.dtype — exact for int8 values) and scale the O(batch·d_out) output,
    instead of materializing the O(K·N) dequantized weight every call.

    `spec` is an optional einsum spec for a stacked weight (MoE experts
    `"ecd,edf->ecf"`, `"td,edf->etf"`, ...): the scale is permuted into
    the output's axis order (`_epilogue_scale`); a spec whose scale axis
    is summed out of the output materializes the weight instead.
    `materialize=True` keeps the canonical `dequantize_weight` expression
    — the parity reference the fused path is tested against."""
    if materialize:
        w = dequantize_weight(q, scale, x.dtype)
        return torch.einsum(spec, x, w) if spec else x @ w
    return _contract(x, q.to(x.dtype), scale, spec)


def _contract(x, q, scale, spec=None):
    """x · (q · scale) for a weight q already in x.dtype (int8, unpacked
    int4 or e4m3 values, all exact there): the scale in the epilogue, or,
    for a spec whose scale axis is summed out, folded into the weight
    first."""
    s = scale.to(x.dtype)
    if spec is None:
        return (x @ q) * (s if q.ndim == 2 else s[..., None, :])
    se = _epilogue_scale(spec, scale)
    if se is not None:
        return torch.einsum(spec, x, q) * se.to(x.dtype)
    return torch.einsum(spec, x, q * s[..., None, :])


def planned_linear(x, w_q, w_scale, use_cim_path: bool):
    """y = x @ dequant(w) — routed per the planner decision.

    use_cim_path=True  -> the hand-written INT8 GEMM kernel (f32
                          accumulation, output rounded to x.dtype in the
                          kernel's epilogue)
    use_cim_path=False -> plain torch matmul against the int8 weight in
                          x.dtype with the scale in the epilogue
    (the paper: never deploy CiM for M=1 / low-reuse GEMMs)."""
    if use_cim_path:
        lead = x.shape[:-1]
        y = int8_gemm(x.reshape(-1, x.shape[-1]), w_q, w_scale,
                      out_dtype=x.dtype)
        return y.reshape(*lead, w_q.shape[1])
    return dequant_contract(x, w_q, w_scale)


# weight-leaf names the runtime gate can quantize: every projection that
# `core.llm_workloads.gemms_of_model` emits a label for.  Norm scales,
# biases, convs, router and the embedding gather stay in float.
PROJECTION_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo",                      # attention projections
    "wkv_a", "wkv_b",                            # latent attention's
    "w_gate", "w_up", "w_down",                  # dense MLP / MoE experts
    "w_z", "w_x", "w_B", "w_C", "w_dt",          # mamba in-projections
    "out_proj",                                  # mamba out-projection
    "lm_head",
})


def quantize_tree(params, min_size: int = 1 << 16):
    """Quantize every 2-D weight leaf of at least `min_size` elements (a
    size threshold, where `quantize_model_params` walks by name).
    Returns the tree with those leaves replaced by {"q": int8, "scale":
    f32}; dicts, lists and tuples are walked."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, min_size) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, min_size) for v in params)
    if torch.is_tensor(params) and params.ndim == 2 and (
            params.numel() >= min_size):
        q, scale = quantize_weight(params)
        return {"q": q, "scale": scale}
    return params


def quantization_error(w) -> float:
    """Relative Frobenius error of the int8 round trip:
    ||dequant(quant(w)) - w|| / (||w|| + 1e-12), in f32."""
    q, s = quantize_weight(w)
    back = dequantize_weight(q, s)
    num = torch.linalg.vector_norm(back - w.float())
    den = torch.linalg.vector_norm(w.float()) + 1e-12
    return float(num / den)


def _quantize_stacked(w):
    """Quantize a (..., K, N) leaf one (K, N) matrix at a time, so no f32
    copy of the whole stacked leaf is ever made; scales are (..., N)."""
    if w.ndim == 2:
        return quantize_weight(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_stacked(w[i])
    return q, scale


def quantize_model_params(params):
    """INT8-quantize every projection weight of a model param tree.

    Walks nested dicts and lists by *name*: the leaf names in
    PROJECTION_WEIGHT_NAMES are exactly the weights the planner has
    verdicts for.  Stacked leaves keep their leading layer axes with
    per-(layer, channel) scales.  Each quantized leaf becomes a
    {"q": int8, "scale": f32} dict; already-quantized leaves pass
    through unchanged."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        if (name in PROJECTION_WEIGHT_NAMES and torch.is_tensor(node)
                and node.ndim >= 2):
            q, scale = _quantize_stacked(node)
            return {"q": q, "scale": scale}
        return node
    return walk(params)
