"""The plain reference: the decoder LM of a configuration in float32
PyTorch (TF32 off), written from the architecture and imported from
nothing of the program.

It takes the benchmark's own bf16 weights (`weights.make`) and works its
quantized weights out itself, with a copy of the per-output-channel
symmetric arithmetic: scale = max|w| / qmax + 1e-12 over each column of
each (K, N) matrix, codes round(w / scale) (half to even) clipped to
[-qmax, qmax], weight = codes * scale; qmax 127 for INT8 (the
configuration's precision) and 7 for INT4 (the control).  The
embedding, norms, biases and the MoE router stay as drawn.

The model, per layer: x += Wo(attn(rope(Wq h + bq), rope(Wk h + bk),
Wv h + bv)) with h = rmsnorm(x), causal softmax attention with each kv
head shared by n_heads / n_kv_heads query heads; then x += ffn(rmsnorm(x)),
ffn a SwiGLU (silu(h Wg) * (h Wu)) Wd, or for a MoE layer the top_k
experts of softmax(h R) weighted by their probabilities renormalised to
sum 1, plus the shared SwiGLU expert (ungated, as the port's model; no
expert capacity).  logits = rmsnorm(x) W_head.  RoPE rotates the two
halves of each head (theta from the configuration).

Everything runs one layer at a time over all sequences, with that layer's
weights dequantized to float32 and freed after it, so a model larger than
the card in float32 fits.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def dequantize(w, bits: int):
    """float32 weight of the (..., K, N) leaf w after the round trip
    through `bits`-bit per-output-channel symmetric codes."""
    qmax = {8: 127.0, 4: 7.0}[bits]
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / qmax + 1e-12
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


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


def swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def moe(h, layer: dict, m: dict, bits: int):
    """Top-k routed experts (probabilities renormalised over the k) plus
    the shared expert, for the tokens h (T, d)."""
    cfg = m["moe"]
    probs = torch.softmax(h @ layer["router"].float(), dim=-1)
    vals, ids = torch.topk(probs, cfg["top_k"], dim=-1)
    vals = vals / vals.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(cfg["n_experts"]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (dequantize(layer[k][e], bits)
                      for k in ("w_gate", "w_up", "w_down"))
        out = swiglu(h[rows], wg, wu, wd) * vals[rows, slot][:, None]
        y.index_add_(0, rows, out)
    if cfg["n_shared_experts"]:
        sh = layer["shared"]
        y = y + swiglu(h, *(dequantize(sh[k], bits)
                            for k in ("w_gate", "w_up", "w_down")))
    return y


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def final_hidden(m: dict, params: dict, seqs: list, reads: list,
                 bits: int = 8) -> list:
    """The normalised final hidden state (n_i, d_model) float32 at the
    positions reads[i] of each token sequence seqs[i] (1-D int tensors on
    the weights' device)."""
    H, KV, d = m["n_heads"], m["n_kv_heads"], m["d_model"]
    dh = m.get("d_head") or d // H
    eps, theta = m["rmsnorm_eps"], m["rope_theta"]
    slot = params["slots"][0]
    with no_tf32(), torch.inference_mode():
        xs = [params["embed"][s.long()].float() for s in seqs]
        for i in range(m["n_layers"]):
            lp = _layer(slot, i)
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


def logits(h, w_head, chunk: int = 1024):
    """Yields (start, logits of rows start .. start + chunk) of h @ w_head,
    float32, TF32 off."""
    with no_tf32(), torch.inference_mode():
        for a in range(0, h.shape[0], chunk):
            yield a, h[a:a + chunk] @ w_head
