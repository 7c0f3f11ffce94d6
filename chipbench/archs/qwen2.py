"""The Qwen2 decoder, dense or with routed experts (qwen2-7b,
qwen2-moe-a2.7b): its weight layout, its plain reference and its
operation counts.

Weights.  The program's layout (`repro_torch.models.init`): one slot of
the period ("slots/0"), each leaf stacked over the layers; attention
`wq/wk/wv/wo` with the optional qkv bias, then a SwiGLU `mlp` or a `moe`
of stacked experts, an f32 router and an optional shared expert.  The
program's scales (projections 1 / sqrt(fan-in), embedding and head
0.02); norm scales are 1 + 0.1 N(0, 1) and the attention biases
0.1 N(0, 1), so that neither is an identity.

Reference, per layer: x += Wo(attn(rope(Wq h + bq), rope(Wk h + bk),
Wv h + bv)) with h = rmsnorm(x), causal softmax attention with each kv
head shared by n_heads / n_kv_heads query heads; then x += ffn(rmsnorm(x)),
ffn a SwiGLU (silu(h Wg) * (h Wu)) Wd, or for a MoE layer the top_k
experts of softmax(h R) weighted by their probabilities renormalised to
sum 1, plus the shared SwiGLU expert (ungated, as the port's model; no
expert capacity).  logits = rmsnorm(x) W_head.  RoPE rotates the two
halves of each head (theta from the configuration).  Every projection
goes through the INT8 (or the control's INT4) round trip of
`reference.dequantize`; the embedding, norms, biases and the router stay
as drawn.

Operations.  A token needs 2 operations per weight of every projection
it passes through (for a MoE layer its top-k routed experts and the
shared expert, plus the router), and attention needs 4 * heads *
head_dim operations per (query, key) pair it attends to (QK^T and PV).
The embedding is a gather and counts nothing.
"""
from __future__ import annotations

import torch

from chipbench import flops, reference
from chipbench.reference import dequantize, rmsnorm, swiglu

BF16 = torch.bfloat16


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def leaf_specs(m: dict) -> list[tuple[str, tuple, torch.dtype, float, float]]:
    """(path, shape, dtype, scale, shift) of every leaf, paths written as
    the keys from the root joined by "/" (slot 0 of the period: "slots/0")."""
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    dh = head_dim(m)
    specs = [("embed", (V, d), BF16, 0.02, 0.0),
             ("lm_head", (d, V), BF16, 0.02, 0.0),
             ("final_norm/scale", (d,), BF16, 0.1, 1.0)]
    s = "slots/0/"
    specs += [(s + "norm1/scale", (L, d), BF16, 0.1, 1.0),
              (s + "attn/wq", (L, d, H * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wk", (L, d, KV * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wv", (L, d, KV * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wo", (L, H * dh, d), BF16, (H * dh) ** -0.5, 0.0)]
    if m.get("qkv_bias"):
        specs += [(s + "attn/bq", (L, H * dh), BF16, 0.1, 0.0),
                  (s + "attn/bk", (L, KV * dh), BF16, 0.1, 0.0),
                  (s + "attn/bv", (L, KV * dh), BF16, 0.1, 0.0)]
    specs.append((s + "norm2/scale", (L, d), BF16, 0.1, 1.0))
    moe = m.get("moe")
    if moe:
        E, f = moe["n_experts"], moe["expert_d_ff"]
        specs += [(s + "moe/router", (L, d, E), torch.float32, d ** -0.5, 0.0),
                  (s + "moe/w_gate", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (s + "moe/w_up", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (s + "moe/w_down", (L, E, f, d), BF16, f ** -0.5, 0.0)]
        if moe["n_shared_experts"]:
            sf = moe["shared_d_ff"]
            specs += [(s + "moe/shared/w_gate", (L, d, sf), BF16, d ** -0.5,
                       0.0),
                      (s + "moe/shared/w_up", (L, d, sf), BF16, d ** -0.5,
                       0.0),
                      (s + "moe/shared/w_down", (L, sf, d), BF16,
                       sf ** -0.5, 0.0)]
    else:
        f = m["d_ff"]
        specs += [(s + "mlp/w_gate", (L, d, f), BF16, d ** -0.5, 0.0),
                  (s + "mlp/w_up", (L, d, f), BF16, d ** -0.5, 0.0),
                  (s + "mlp/w_down", (L, f, d), BF16, f ** -0.5, 0.0)]
    return specs


# -- the reference -----------------------------------------------------

def rope(x, theta: float):
    """x: (L, heads, d) at positions 0 .. L-1."""
    L, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v):
    """Causal softmax attention of one sequence: q (L, H, d), k and v
    (L, KV, d) -> (L, H * d)."""
    L, H, d = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / d ** 0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(L, H * d)


def moe(h, layer: dict, m: dict, bits: int):
    """Top-k routed experts (probabilities renormalised over the k) plus
    the shared expert, for the tokens h (T, d)."""
    cfg = m["moe"]
    probs = torch.softmax(h @ layer["router"].float(), dim=-1)
    vals, ids = torch.topk(probs, cfg["top_k"], dim=-1)
    vals = vals / vals.sum(-1, keepdim=True)
    y = reference.routed_experts(h, ids, vals, layer, bits,
                                 cfg["n_experts"])
    if cfg["n_shared_experts"]:
        sh = layer["shared"]
        y = y + swiglu(h, *(dequantize(sh[k], bits)
                            for k in ("w_gate", "w_up", "w_down")))
    return y


def final_hidden(m: dict, params: dict, seqs: list, reads: list,
                 bits: int = 8) -> list:
    """The normalised final hidden state (n_i, d_model) float32 at the
    positions reads[i] of each token sequence seqs[i] (1-D int tensors on
    the weights' device), one layer at a time over all sequences."""
    H, KV = m["n_heads"], m["n_kv_heads"]
    dh = head_dim(m)
    eps, theta = m["rmsnorm_eps"], m["rope_theta"]
    slot = params["slots"][0]
    with reference.no_tf32(), torch.inference_mode():
        xs = [params["embed"][s.long()].float() for s in seqs]
        for i in range(m["n_layers"]):
            lp = reference.layer(slot, i)
            ap = lp["attn"]
            wq, wk, wv, wo = (dequantize(ap[k], bits)
                              for k in ("wq", "wk", "wv", "wo"))
            for j, x in enumerate(xs):
                h = rmsnorm(x, lp["norm1"]["scale"], eps)
                q, k, v = h @ wq, h @ wk, h @ wv
                if "bq" in ap:
                    q, k, v = (q + ap["bq"].float(), k + ap["bk"].float(),
                               v + ap["bv"].float())
                L = x.shape[0]
                q = rope(q.view(L, H, dh), theta)
                k = rope(k.view(L, KV, dh), theta)
                xs[j] = x + attention(q, k, v.view(L, KV, dh)) @ wo
            del wq, wk, wv, wo
            if "mlp" in lp:
                mw = [dequantize(lp["mlp"][k], bits)
                      for k in ("w_gate", "w_up", "w_down")]
                for j, x in enumerate(xs):
                    xs[j] = x + swiglu(rmsnorm(x, lp["norm2"]["scale"], eps),
                                       *mw)
                del mw
            else:
                flat = torch.cat(xs)
                y = moe(rmsnorm(flat, lp["norm2"]["scale"], eps), lp["moe"],
                        m, bits)
                xs = list((flat + y).split([x.shape[0] for x in xs]))
        return [rmsnorm(x[r.long()], params["final_norm"]["scale"], eps)
                for x, r in zip(xs, reads)]


def head(params: dict, bits: int = 8):
    """The LM head's float32 weight (d_model, vocab) after the round trip."""
    return dequantize(params["lm_head"], bits)


# -- the operation counts ----------------------------------------------

def projection_shapes(m: dict) -> dict[str, tuple[int, int, int]]:
    """label -> (K, N, calls per forward position) of every projection a
    token passes through, under the program's GEMM labels."""
    d, dh, L = m["d_model"], head_dim(m), m["n_layers"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    out = {"Wq": (d, H * dh, L), "Wk": (d, KV * dh, L),
           "Wv": (d, KV * dh, L), "Wo": (H * dh, d, L),
           "lm_head": (d, m["vocab"], 1)}
    moe = m.get("moe")
    if moe:
        f, sf = moe["expert_d_ff"], moe["shared_d_ff"]
        out.update({"expert-gate": (d, f, L), "expert-up": (d, f, L),
                    "expert-down": (f, d, L)})
        if moe["n_shared_experts"]:
            out.update({"shared-gate": (d, sf, L), "shared-up": (d, sf, L),
                        "shared-down": (sf, d, L)})
    else:
        f = m["d_ff"]
        out.update({"mlp-gate": (d, f, L), "mlp-up": (d, f, L),
                    "mlp-down": (f, d, L)})
    return out


def matmul_params_per_token(m: dict, with_head: bool = True) -> int:
    """Weights one token multiplies by: every projection of every layer
    (a MoE layer: top_k routed experts, the shared expert and the f32
    router), and the LM head when its logits are needed."""
    total = 0
    for label, (k, n, calls) in projection_shapes(m).items():
        if label == "lm_head" and not with_head:
            continue
        if label.startswith("expert-"):
            calls *= m["moe"]["top_k"]
        total += k * n * calls
    if m.get("moe"):
        total += m["n_layers"] * m["d_model"] * m["moe"]["n_experts"]
    return total


def attention_flops(m: dict, context: int) -> float:
    """Operations of one query position attending to `context` keys, over
    every layer."""
    return 4.0 * m["n_layers"] * m["n_heads"] * head_dim(m) * context


def positions_flops(m: dict, start: int, stop: int,
                    head_from: int) -> float:
    """Operations of forward positions start .. stop - 1 of one sequence,
    the LM head counted at positions >= head_from."""
    if stop <= start:
        return 0.0
    n = stop - start
    with_head = max(0, stop - max(start, head_from))
    # sum of (p + 1) for p in [start, stop)
    keys = (stop * (stop + 1) - start * (start + 1)) // 2
    head = m["d_model"] * m["vocab"]
    return (2.0 * matmul_params_per_token(m, False) * n
            + 2.0 * head * with_head
            + 4.0 * m["n_layers"] * m["n_heads"] * head_dim(m) * keys)


def flash_call(m: dict, seq: int) -> tuple[float, float]:
    """(operations, bytes) of one layer's causal flash-attention call over
    a prompt of `seq` tokens: every query head at the head width, each kv
    head shared by n_heads / n_kv_heads of them."""
    return flops.flash_call(seq, m["n_heads"], m["n_kv_heads"], head_dim(m))
