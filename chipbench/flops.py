"""The benchmark's yardstick arithmetic, frozen here so that it stays put
when the program changes: the card's published peaks and each kernel
call's operations and bytes.  The operations a token needs follow the
architecture and are its module's (`chipbench/archs/<arch>.py`).

Peaks are NVIDIA's data sheet for one H100 SXM 80GB HBM3 at its 700 W
limit (dense, no sparsity).  The bf16 rate is the peak of every share
here: the INT8 GEMM is W8A16 on bf16 tensor-core MMAs.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # H100 SXM, bf16 dense
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3


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
