"""Mixture-of-Experts FFN with scatter/gather dispatch, in torch (the
port of the JAX package's `repro/models/moe.py`, under the same names).

Dispatch: top-k routing -> position-in-expert via cumsum -> scatter tokens
into an (E, C, d) buffer -> batched expert contractions -> weighted
gather-back.  Tokens beyond expert capacity are dropped (standard
capacity-factor MoE).

Routing: softmax over the experts, top-k, the k weights renormalised to
sum 1 (the JAX package's router); or, with `MoEConfig(scoring="sigmoid")`,
DeepSeek-V3's "noaux_tc" router: the top-k of sigmoid(logits) + a
per-expert bias that only selects, weighted by the sigmoid scores
without the bias, renormalised and multiplied by `routed_scale`.  Both
run in f32.

Decode exception, as in the JAX package: when the token count fits expert
capacity (T <= C, always true for a decode micro-batch) no token can be
dropped.  There, INT8 experts of a bf16 step on the card run the grouped
expert kernels (`kernels/moe_experts.py`, `csrc/moe_experts.cu`): each
routed expert's int8 weights read once, over its routed tokens only, two
launches a layer; every other case (float, INT4 or FP8 experts, f32 or
CPU or meta tensors) runs every expert over every token with one batched
contraction per weight and selects each token's top-k outputs, as the
JAX package does.

The expert weights are stacked (E, K, N) leaves.  Outside the kernel they
contract through `linear(..., spec=...)`, which takes the dequant route
for a quantized expert (the INT8 GEMM kernel takes plain 2-D matmuls
only), as in the JAX package; the kernel computes that route's function
(int8 weights decoded exactly, the scale after the f32 sum) and records
the same three routes.  Each token's k weighted expert outputs are summed
in k order, with no atomics, so a step replayed from a CUDA graph equals
the eager step bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import spans
from ..configs.base import ModelConfig
from ..kernels.moe_experts import moe_experts
from ..sharding.constraints import put_rows
from .layers import (DEQUANT_ROUTE, EXPERT_LABELS, _record_route, dense_init,
                     linear, swiglu)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device="cuda"):
    """One layer's MoE parameters from `gen`: an f32 router (d, E), the
    stacked experts (E, d, f) / (E, f, d) in `dtype`, the shared
    expert's SwiGLU where the config has one, and an f32 selection bias
    (E,), zeros, with sigmoid scoring."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.expert_d_ff

    def experts(k, n):
        return (torch.randn((E, k, n), generator=gen, device=device,
                            dtype=torch.float32) / k ** 0.5).to(dtype)

    p = {"router": dense_init(gen, d, E, torch.float32, device=device),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if m.n_shared_experts:
        sf = m.shared_d_ff
        p["shared"] = {"w_gate": dense_init(gen, d, sf, dtype, device=device),
                       "w_up": dense_init(gen, d, sf, dtype, device=device),
                       "w_down": dense_init(gen, sf, d, dtype, device=device)}
    if m.scoring == "sigmoid":
        p["score_bias"] = torch.zeros(E, dtype=torch.float32, device=device)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)      # round up to 8


def _one_hot(ids, n: int, dtype):
    """(...,) int -> (..., n) one-hot in `dtype` (a comparison: no host
    read of the ids, so it can be captured in a CUDA graph)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _sum_over_k(contrib):
    """(T, k, d) -> (T, d), summed in k order."""
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _grouped_kernel_takes(params, xt) -> bool:
    """Whether the T <= C path runs the grouped expert kernels: INT8
    expert leaves and bf16 tokens on a card."""
    return (xt.is_cuda and xt.dtype == torch.bfloat16
            and all(isinstance(params[n], dict) and "q" in params[n]
                    for n in ("w_gate", "w_up", "w_down")))


def _record_expert_routes() -> None:
    """The grouped kernels' route records: the three expert labels on the
    dequant route, whose function the kernels compute, with moe_apply as
    the callsite (this frame stands where linear() does)."""
    for label in EXPERT_LABELS:
        _record_route(label, DEQUANT_ROUTE)


def route(params, xt, cfg: ModelConfig):
    """(T, d) tokens -> (probs (T, E), gate_vals (T, k), expert_ids (T,
    k)), all f32 but the ids: the router's scores over the experts (the
    softmax, or the sigmoid scores), each token's k weights and experts
    in selection order."""
    m = cfg.moe
    # the router is an ungated f32 matmul (the JAX package promotes
    # bf16 @ f32 to f32; torch wants both operands in f32)
    logits = xt.float() @ params["router"].float()           # (T, E)
    if m.scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        choice = probs + params["score_bias"].float()
    elif m.scoring == "softmax":
        probs = choice = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"unknown MoE scoring {m.scoring!r}")
    expert_ids = torch.topk(choice, m.top_k, dim=-1, sorted=True)[1]
    gate_vals = torch.gather(probs, 1, expert_ids)
    total = gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_vals = gate_vals / total
    if m.routed_scale != 1.0:
        gate_vals = gate_vals * m.routed_scale
    return probs, gate_vals, expert_ids


def moe_apply(params, x, cfg: ModelConfig, plan=None, *,
              force_buffered: bool = False):
    """x: (b, l, d) -> (y, aux_loss).

    `force_buffered` disables the T <= C decode fast path, so both
    dispatch forms can be held against the reference's."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    b, l, d = x.shape
    T = b * l
    xt = x.reshape(T, d)
    C = capacity(cfg, T)

    with spans.span("moe.router"):
        probs, gate_vals, expert_ids = route(params, xt, cfg)
        w = gate_vals.to(x.dtype)

    with spans.span("moe.experts"):
        if T <= C and not force_buffered:
            # no expert can overflow: each token's k expert outputs
            if _grouped_kernel_takes(params, xt):
                _record_expert_routes()
                sel = moe_experts(xt, expert_ids, params["w_gate"],
                                  params["w_up"], params["w_down"])
            else:
                # every expert over every token, then the top-k outputs
                g = F.silu(linear(params["w_gate"], xt, "expert-gate", plan,
                                  spec="td,edf->etf"))
                u = linear(params["w_up"], xt, "expert-up", plan,
                           spec="td,edf->etf")
                eout = linear(params["w_down"], g * u, "expert-down", plan,
                              spec="etf,efd->etd")              # (E, T, d)
                sel = torch.gather(eout.transpose(0, 1), 1,
                                   expert_ids[:, :, None].expand(T, k, d))
            yt = _sum_over_k(sel * w[:, :, None])
        else:
            # position of each (token, k) assignment within its expert
            flat_ids = expert_ids.reshape(-1)                    # (T*k,)
            pos = torch.cumsum(_one_hot(flat_ids, E, torch.int32), dim=0) - 1
            pos_in_expert = torch.gather(pos, 1, flat_ids[:, None])[:, 0]
            keep = pos_in_expert < C
            tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
            # scatter tokens into (E, C, d); dropped assignments land in a
            # spare row C that is cut off (the reference adds zeros at C - 1)
            buf = put_rows((E, C + 1, d),
                           (flat_ids, torch.where(keep, pos_in_expert, C)),
                           xt[tok_idx])[:, :C]
            g = F.silu(linear(params["w_gate"], buf, "expert-gate", plan,
                              spec="ecd,edf->ecf"))
            u = linear(params["w_up"], buf, "expert-up", plan,
                       spec="ecd,edf->ecf")
            eout = linear(params["w_down"], g * u, "expert-down", plan,
                          spec="ecf,efd->ecd")                  # (E, C, d)
            # gather back with the routing weights (0 for dropped ones)
            back = eout[flat_ids, torch.where(keep, pos_in_expert, C - 1)]
            wk = (gate_vals.reshape(-1) * keep).to(x.dtype)
            yt = _sum_over_k((back * wk[:, None]).reshape(T, k, d))
    y = yt.reshape(b, l, d)

    if m.n_shared_experts:
        y = y + swiglu(params["shared"], x, plan, label_prefix="shared")

    # load-balancing aux loss (Switch-style)
    frac_tokens = _one_hot(expert_ids[:, 0], E, torch.float32).mean(0)
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum() * m.router_aux_loss
    return y, aux
