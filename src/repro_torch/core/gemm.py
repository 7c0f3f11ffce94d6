"""GEMM shape abstraction (paper §III-A, Table I).

A GEMM(M, N, K) multiplies an input matrix A (M×K) with a weight matrix
W (K×N) producing output Z (M×N).  Matrix-vector multiplication is the
special case M == 1.  All paper evaluations use INT8 (1 byte/element).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class GEMM:
    """A single GEMM workload instance.

    Attributes:
      M: rows of the input/output matrix (paper: input rows, e.g. seq len
         or conv output pixels).
      N: columns of the weight/output matrix (e.g. output channels).
      K: reduction dimension.
      bits: data precision in bits (paper fixes 8; the widened What
         axis also evaluates 4).
      label: human-readable provenance ("BERT-Large QK^T", ...).
      count: how many times this exact GEMM occurs in the workload.
      fp: floating-point element format (FP8 when bits == 8); False is
         the paper's integer precision.
    """

    M: int
    N: int
    K: int
    bits: int = 8
    label: str = ""
    count: int = 1
    fp: bool = False

    def __post_init__(self) -> None:
        if min(self.M, self.N, self.K) < 1:
            raise ValueError(f"GEMM dims must be >= 1, got {self}")
        if self.fp and self.bits != 8:
            raise ValueError(f"fp GEMMs must be 8-bit (FP8), got {self}")

    @property
    def precision(self) -> str:
        """Canonical precision token: "int8" / "int4" / "fp8"."""
        return "fp8" if self.fp else f"int{self.bits}"

    # --- basic quantities -------------------------------------------------
    @property
    def macs(self) -> int:
        return self.M * self.N * self.K

    @property
    def ops(self) -> int:
        """Operations = 2·MACs (multiply + accumulate), paper Fig. 2."""
        return 2 * self.macs

    @property
    def bytes_per_elem(self) -> float:
        return self.bits / 8.0

    @property
    def input_elems(self) -> int:
        return self.M * self.K

    @property
    def weight_elems(self) -> int:
        return self.K * self.N

    @property
    def output_elems(self) -> int:
        return self.M * self.N

    @property
    def total_elems(self) -> int:
        return self.input_elems + self.weight_elems + self.output_elems

    @property
    def algorithmic_reuse(self) -> float:
        """Paper eq. (1): 2·MNK / (BP·(MN + NK + MK)), ops per byte."""
        return self.ops / (self.bytes_per_elem * self.total_elems)

    def scaled(self, **kw) -> "GEMM":
        return dataclasses.replace(self, **kw)

    def __str__(self) -> str:  # pragma: no cover - debugging nicety
        tag = f" [{self.label}]" if self.label else ""
        return f"GEMM(M={self.M}, N={self.N}, K={self.K}){tag}"


# --- Table I constructors -----------------------------------------------


def conv2d_gemm(h_o: int, w_o: int, c_o: int, h_k: int, w_k: int, c_i: int,
                label: str = "", count: int = 1) -> GEMM:
    """Convolution lowered by im2col (Table I row 1).

    M = H_o·W_o, N = C_o, K = H_k·W_k·C_i  (kernel spatial × input channels).
    """
    return GEMM(M=h_o * w_o, N=c_o, K=h_k * w_k * c_i, label=label, count=count)


def fc_gemm(out_dim: int, in_dim: int, batch: int = 1, label: str = "",
            count: int = 1) -> GEMM:
    """Fully connected layer (Table I row 2): M=out, N=batch, K=in.

    Note the paper's convention places batch on N so that the weight matrix
    (K×N) is ... historically the paper writes (M=output dim, N=batch,
    K=input dim); with batch=1 this is a GEMV in M.  We keep the convention
    used by Table VI instead (DLRM rows are M=1, N=out, K=in), i.e. weights
    stationary as K×N:
    """
    return GEMM(M=batch, N=out_dim, K=in_dim, label=label, count=count)


def attention_gemms(seq: int, d_model: int, n_q_heads: int | None = None,
                    n_kv_heads: int | None = None, d_head: int | None = None,
                    label: str = "", count: int = 1) -> list[GEMM]:
    """The attention-layer GEMMs of Table I for one layer (single batch).

    Q/K/V projections, fused scores QKᵀ, QKᵀV, and output projection.
    When GQA head counts are given, K/V projections shrink accordingly.
    """
    if d_head is None:
        d_head = d_model // (n_q_heads or 1) if n_q_heads else d_model
    q_out = (n_q_heads or 1) * d_head if n_q_heads else d_model
    kv_out = (n_kv_heads or n_q_heads or 1) * d_head if n_kv_heads else d_model
    lab = (label + " " if label else "")
    gemms = [
        GEMM(M=seq, N=q_out, K=d_model, label=lab + "Wq", count=count),
        GEMM(M=seq, N=kv_out, K=d_model, label=lab + "Wk", count=count),
        GEMM(M=seq, N=kv_out, K=d_model, label=lab + "Wv", count=count),
        # per-head scores; expressed as fused (paper: single-batch fused)
        GEMM(M=seq, N=seq, K=d_head, label=lab + "QK^T",
             count=count * (n_q_heads or 1)),
        GEMM(M=seq, N=d_head, K=seq, label=lab + "QK^T.V",
             count=count * (n_q_heads or 1)),
        GEMM(M=seq, N=d_model, K=q_out, label=lab + "Wo", count=count),
    ]
    return gemms


def total_ops(gemms: Iterable[GEMM]) -> int:
    return sum(g.ops * g.count for g in gemms)


def geomean(xs: Iterable[float]) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return 0.0
    return math.exp(sum(math.log(x) for x in xs) / len(xs))
