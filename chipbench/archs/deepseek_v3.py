"""The DeepSeek-V3 decoder block (moonlight-16b-a3b): multi-head latent
attention, a sigmoid router with a selection-only bias over fine-grained
experts plus shared experts, and leading dense layers.  Its weight
layout, its plain reference and its operation counts.

Weights.  The program's layout (`repro_torch.models.init` with
`cfg.mla` and `cfg.moe.first_dense_layers`): the leading dense layers
under "lead", the MoE layers in slot 0 of the period ("slots/0"), each
leaf stacked over its layers.  Attention: `wq` (d, H * (nope + rope)),
`wkv_a` (d, latent + rope), `kv_norm` (latent,), `wkv_b` (latent, H *
(nope + v)), `wo` (H * v, d).  A lead layer has a SwiGLU `mlp` of width
d_ff; a MoE layer an f32 router (d, E), an f32 selection bias (E,), the
stacked experts and the shared experts as one SwiGLU of width
n_shared * expert_d_ff (a SwiGLU is a sum over its hidden units, so two
experts of width f are one of width 2 f).  The program's scales
(projections 1 / sqrt(fan-in), embedding and head 0.02); norm scales are
1 + 0.1 N(0, 1) and the selection bias 0.1 N(0, 1), so that none is an
identity and the bias moves the selection.

Reference, per layer, as published (HF modeling_deepseek.py with
q_lora_rank null), in the expanded form: h = rmsnorm(x); q = h W_q per
head [q_nope, q_pe]; [c, k_pe] = h W_kva, c = rmsnorm(c); q_pe and k_pe
roped (k_pe one head shared by all); [k_nope, v] = c W_kvb per head; k =
[k_nope, k_pe]; causal softmax attention at scale (nope + rope)^-0.5;
x += (attn) W_o.  Then x += ffn(rmsnorm(x)): a SwiGLU in a lead layer;
in a MoE layer the top_k experts of sigmoid(h R) + bias, weighted by
sigmoid(h R) (without the bias) renormalised to sum 1 and times
routed_scale, plus the shared SwiGLU (n_group = topk_group = 1, so the
group stage selects nothing away; no expert capacity).  logits =
rmsnorm(x) W_head.  RoPE rotates the two halves of each head (theta from
the configuration; HF rotates interleaved pairs, which on random weights
is a fixed permutation of W_q's and W_kva's rope columns).  Every
projection goes through the INT8 (or the control's INT4) round trip of
`reference.dequantize`; the embedding, norms, router and bias stay as
drawn.

Operations.  A token needs 2 operations per weight of every projection
it passes through (W_kvb's once per token, as in the absorbed decode
the program runs: q_nope W_UK and the output's W_UV use each weight
once), and for a MoE layer its top-k experts, the shared experts and the
router.  Attention is counted in the absorbed form of the decode step:
2 * H * (row + latent) operations per (query, key) pair, row = latent +
rope.  The embedding is a gather and counts nothing.
"""
from __future__ import annotations

import torch

from chipbench import reference
from chipbench.archs.qwen2 import rope
from chipbench.reference import dequantize, rmsnorm, swiglu

BF16 = torch.bfloat16


def _dims(m: dict) -> tuple[int, int, int, int, int]:
    """(latent, nope, rope, v, row) widths of the latent attention."""
    a = m["mla"]
    lat, nope, rp, v = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                        a["qk_rope_head_dim"], a["v_head_dim"])
    return lat, nope, rp, v, lat + rp


def _layers(m: dict) -> tuple[int, int]:
    """(leading dense layers, MoE layers)."""
    lead = m["moe"].get("first_dense_layers", 0)
    return lead, m["n_layers"] - lead


def leaf_specs(m: dict) -> list[tuple[str, tuple, torch.dtype, float, float]]:
    """(path, shape, dtype, scale, shift) of every leaf, paths written as
    the keys from the root joined by "/"."""
    d, V, H = m["d_model"], m["vocab"], m["n_heads"]
    lat, nope, rp, v, row = _dims(m)
    moe = m["moe"]
    lead, n_moe = _layers(m)
    specs = [("embed", (V, d), BF16, 0.02, 0.0),
             ("lm_head", (d, V), BF16, 0.02, 0.0),
             ("final_norm/scale", (d,), BF16, 0.1, 1.0)]
    for pre, L in (("lead/", lead), ("slots/0/", n_moe)):
        if not L:
            continue
        specs += [(pre + "norm1/scale", (L, d), BF16, 0.1, 1.0),
                  (pre + "attn/wq", (L, d, H * (nope + rp)), BF16, d ** -0.5,
                   0.0),
                  (pre + "attn/wkv_a", (L, d, row), BF16, d ** -0.5, 0.0),
                  (pre + "attn/kv_norm/scale", (L, lat), BF16, 0.1, 1.0),
                  (pre + "attn/wkv_b", (L, lat, H * (nope + v)), BF16,
                   lat ** -0.5, 0.0),
                  (pre + "attn/wo", (L, H * v, d), BF16, (H * v) ** -0.5,
                   0.0),
                  (pre + "norm2/scale", (L, d), BF16, 0.1, 1.0)]
        if pre == "lead/":
            f = m["d_ff"]
            specs += [(pre + "mlp/w_gate", (L, d, f), BF16, d ** -0.5, 0.0),
                      (pre + "mlp/w_up", (L, d, f), BF16, d ** -0.5, 0.0),
                      (pre + "mlp/w_down", (L, f, d), BF16, f ** -0.5, 0.0)]
            continue
        E, f, sf = moe["n_experts"], moe["expert_d_ff"], moe["shared_d_ff"]
        specs += [(pre + "moe/router", (L, d, E), torch.float32, d ** -0.5,
                   0.0),
                  (pre + "moe/w_gate", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (pre + "moe/w_up", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (pre + "moe/w_down", (L, E, f, d), BF16, f ** -0.5, 0.0),
                  (pre + "moe/shared/w_gate", (L, d, sf), BF16, d ** -0.5,
                   0.0),
                  (pre + "moe/shared/w_up", (L, d, sf), BF16, d ** -0.5,
                   0.0),
                  (pre + "moe/shared/w_down", (L, sf, d), BF16, sf ** -0.5,
                   0.0),
                  (pre + "moe/score_bias", (L, E), torch.float32, 0.1, 0.0)]
    return specs


# -- the reference -----------------------------------------------------

def attention(q, k, v):
    """Causal softmax attention of one sequence: q and k (L, H, dk), v
    (L, H, dv) -> (L, H * dv), scale dk^-0.5."""
    L, H, dk = q.shape
    s = torch.einsum("qhd,khd->hqk", q, k) / dk ** 0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(L, H * v.shape[-1])


def mla(x, ap: dict, m: dict, bits: int, norm_scale):
    """One sequence's latent attention with its output projection, x (L,
    d) -> (L, d), the expanded form."""
    H, eps, theta = m["n_heads"], m["rmsnorm_eps"], m["rope_theta"]
    lat, nope, rp, v, _ = _dims(m)
    wq, wkva, wkvb, wo = (dequantize(ap[k], bits)
                          for k in ("wq", "wkv_a", "wkv_b", "wo"))
    L = x.shape[0]
    h = rmsnorm(x, norm_scale, eps)
    q = (h @ wq).view(L, H, nope + rp)
    c, k_pe = (h @ wkva).split([lat, rp], dim=-1)
    c = rmsnorm(c, ap["kv_norm"]["scale"], eps)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k_pe = rope(k_pe[:, None, :], theta)
    kv = (c @ wkvb).view(L, H, nope + v)
    k = torch.cat([kv[..., :nope], k_pe.expand(L, H, rp)], dim=-1)
    return attention(q, k, kv[..., nope:]) @ wo


def route(h, layer: dict, m: dict):
    """(ids, weights) of the top_k experts of each token h (T, d): chosen
    by sigmoid(h R) + bias, weighted by sigmoid(h R), renormalised and
    scaled."""
    cfg = m["moe"]
    scores = torch.sigmoid(h @ layer["router"].float())
    choice = scores + layer["score_bias"].float()
    ids = torch.topk(choice, cfg["top_k"], dim=-1).indices
    vals = scores.gather(1, ids)
    vals = vals / vals.sum(-1, keepdim=True)
    return ids, vals * cfg["routed_scale"]


def moe(h, layer: dict, m: dict, bits: int):
    """The routed experts plus the shared experts, for the tokens h (T,
    d)."""
    ids, vals = route(h, layer, m)
    y = reference.routed_experts(h, ids, vals, layer, bits,
                                 m["moe"]["n_experts"])
    sh = layer["shared"]
    return y + swiglu(h, *(dequantize(sh[k], bits)
                           for k in ("w_gate", "w_up", "w_down")))


def final_hidden(m: dict, params: dict, seqs: list, reads: list,
                 bits: int = 8) -> list:
    """The normalised final hidden state (n_i, d_model) float32 at the
    positions reads[i] of each token sequence seqs[i] (1-D int tensors on
    the weights' device), one layer at a time over all sequences."""
    eps = m["rmsnorm_eps"]
    lead, n_moe = _layers(m)
    order = ([(params["lead"], i) for i in range(lead)]
             + [(params["slots"][0], i) for i in range(n_moe)])
    with reference.no_tf32(), torch.inference_mode():
        xs = [params["embed"][s.long()].float() for s in seqs]
        for tree, i in order:
            lp = reference.layer(tree, i)
            xs = [x + mla(x, lp["attn"], m, bits, lp["norm1"]["scale"])
                  for x in xs]
            if "mlp" in lp:
                mw = [dequantize(lp["mlp"][k], bits)
                      for k in ("w_gate", "w_up", "w_down")]
                xs = [x + swiglu(rmsnorm(x, lp["norm2"]["scale"], eps), *mw)
                      for x in xs]
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
    d, H = m["d_model"], m["n_heads"]
    lat, nope, rp, v, row = _dims(m)
    lead, n_moe = _layers(m)
    L = lead + n_moe
    moe = m["moe"]
    f, sf = moe["expert_d_ff"], moe["shared_d_ff"]
    return {"Wq": (d, H * (nope + rp), L), "Wkva": (d, row, L),
            "Wkvb": (lat, H * (nope + v), L), "Wo": (H * v, d, L),
            "mlp-gate": (d, m["d_ff"], lead), "mlp-up": (d, m["d_ff"], lead),
            "mlp-down": (m["d_ff"], d, lead),
            "expert-gate": (d, f, n_moe), "expert-up": (d, f, n_moe),
            "expert-down": (f, d, n_moe),
            "shared-gate": (d, sf, n_moe), "shared-up": (d, sf, n_moe),
            "shared-down": (sf, d, n_moe),
            "lm_head": (d, m["vocab"], 1)}


def matmul_params_per_token(m: dict, with_head: bool = True) -> int:
    """Weights one token multiplies by: every projection of every layer
    (a MoE layer: top_k routed experts, the shared experts and the f32
    router), and the LM head when its logits are needed."""
    total = 0
    for label, (k, n, calls) in projection_shapes(m).items():
        if label == "lm_head" and not with_head:
            continue
        if label.startswith("expert-"):
            calls *= m["moe"]["top_k"]
        total += k * n * calls
    return total + _layers(m)[1] * m["d_model"] * m["moe"]["n_experts"]


def pair_flops(m: dict) -> float:
    """Operations of one (query, key) pair over every layer, absorbed:
    the scores over the row and the latent output, per head."""
    lat, _, _, _, row = _dims(m)
    return 2.0 * m["n_layers"] * m["n_heads"] * (row + lat)


def positions_flops(m: dict, start: int, stop: int,
                    head_from: int) -> float:
    """Operations of forward positions start .. stop - 1 of one sequence,
    the LM head counted at positions >= head_from."""
    if stop <= start:
        return 0.0
    n = stop - start
    with_head = max(0, stop - max(start, head_from))
    keys = (stop * (stop + 1) - start * (start + 1)) // 2
    return (2.0 * matmul_params_per_token(m, False) * n
            + 2.0 * m["d_model"] * m["vocab"] * with_head
            + pair_flops(m) * keys)


def flash_call(m: dict, seq: int) -> tuple[float, float]:
    """(operations, bytes) of one layer's causal attention call over a
    prompt of `seq` tokens in the expanded form: q and k (nope + rope)
    and v wide per head, 2 operations per (query, key) pair and width of
    each product; q, k, v read once and o written once, bf16."""
    _, nope, rp, v, _ = _dims(m)
    H, qk = m["n_heads"], nope + rp
    pairs = seq * (seq + 1) // 2
    return (2.0 * H * (qk + v) * pairs,
            float(2 * seq * H * (2 * qk + 2 * v)))


def mla_decode_call(m: dict, rows: int) -> tuple[float, float]:
    """(operations, bytes) of one layer's paged MLA decode kernel for one
    slot attending over `rows` cached positions: each row (latent + rope,
    bf16) read once for all heads, 2 * H * (row + latent) operations on
    it (scores and the latent output); the slot's latent query read and
    its latent output written once."""
    lat, _, _, _, row = _dims(m)
    H = m["n_heads"]
    return (2.0 * H * (row + lat) * rows,
            float(2 * (rows * row + H * row + H * lat)))

