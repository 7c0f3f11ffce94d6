"""The benchmark's yardstick arithmetic, frozen here so that it stays put
when the program changes: the card's published peaks, the operations a
token needs, and each kernel call's operations and bytes.

Peaks are NVIDIA's data sheet for one H100 SXM 80GB HBM3 at its 700 W
limit (dense, no sparsity).  The bf16 rate is the peak of every share
here: the INT8 GEMM is W8A16 on bf16 tensor-core MMAs.

A model configuration is the dict of `configs/<name>.json`'s "model"
block (the program's field names).  Counts follow the architecture, not
the program's implementation: a token needs 2 operations per weight of
every projection it passes through (for a MoE layer its top-k routed
experts and the shared expert, plus the router), and attention needs
4 * heads * head_dim operations per (query, key) pair it attends to
(QK^T and PV).  The embedding is a gather and counts nothing.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # H100 SXM, bf16 dense
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


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


def gemm_call(m_rows: int, k: int, n: int, w_bytes: int = 1,
              x_bytes: int = 2, y_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one W8A16 GEMM call y = x @ (w * scale):
    2 M N K operations; the weight (int8 or e4m3), x, the f32 scale read
    once and y written once."""
    moved = k * n * w_bytes + m_rows * k * x_bytes + 4 * n \
        + m_rows * n * y_bytes
    return 2.0 * m_rows * n * k, float(moved)


def flash_call(seq: int, heads: int, kv_heads: int, d: int,
               el_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one causal flash-attention call over a
    sequence of `seq` queries and keys: 4 d operations per unmasked
    (query, key) pair, seq (seq + 1) / 2 pairs per head; q, k, v read once
    and o written once."""
    pairs = seq * (seq + 1) // 2
    moved = el_bytes * seq * d * (2 * heads + 2 * kv_heads)
    return 4.0 * d * pairs * heads, float(moved)


def bound_s(ops: float, moved: float) -> float:
    """The least time the card could take: the larger of operations at the
    bf16 peak and bytes at the HBM rate."""
    return max(ops / PEAK_BF16_FLOPS, moved / HBM_BYTES_PER_S)
