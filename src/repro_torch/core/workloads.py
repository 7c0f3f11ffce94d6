"""Workload GEMM datasets (paper §V-C, Table VI, Appendix B).

Real dataset: ResNet50/ImageNet, BERT-Large (seq 512), DLRM, GPT-J decode —
transcribed from Table VI.  Synthetic dataset: 1000 GEMMs with M, N, K in
[16, 8192] (paper Fig. 9).
"""
from __future__ import annotations

import random

from .gemm import GEMM

# --- Table VI (exact transcription; repeated layers keep their multiplicity)

BERT_LARGE = [
    GEMM(512, 1024, 1024, label="BERT-Large QKV/O proj"),
    GEMM(512, 512, 1024, label="BERT-Large logit/attend"),
    GEMM(512, 1024, 512, label="BERT-Large attn out"),
    GEMM(512, 4096, 1024, label="BERT-Large FFN up"),
    GEMM(512, 1024, 4096, label="BERT-Large FFN down"),
]

GPT_J = [
    GEMM(1, 4096, 4096, label="GPT-J decode proj"),
    GEMM(2048, 4096, 4096, label="GPT-J prefill proj"),
    GEMM(1, 2048, 4096, label="GPT-J decode down"),
    GEMM(1, 4096, 2048, label="GPT-J decode up"),
    GEMM(1, 16384, 4096, label="GPT-J decode FFN"),
]

DLRM = [
    GEMM(1, 256, 512, label="DLRM MLP"),
    GEMM(1, 64, 256, label="DLRM MLP"),
]

_RESNET50_ROWS = [
    (12544, 64, 147, 1), (3136, 64, 64, 1), (3136, 64, 576, 3),
    (3136, 256, 64, 3), (3136, 64, 256, 3), (3136, 128, 256, 1),
    (784, 128, 1152, 4), (784, 512, 128, 4), (784, 128, 512, 4),
    (784, 256, 512, 1), (196, 256, 2304, 6), (196, 1024, 256, 6),
    (196, 256, 1024, 6), (196, 512, 1024, 1), (49, 512, 4608, 3),
    (49, 2048, 512, 3), (49, 512, 2048, 3), (1, 1000, 2048, 1),
]

RESNET50 = [GEMM(m, n, k, label=f"ResNet50 {m}x{n}x{k}", count=c)
            for (m, n, k, c) in _RESNET50_ROWS]

REAL_WORKLOADS: dict[str, list[GEMM]] = {
    "BERT-Large": BERT_LARGE,
    "GPT-J": GPT_J,
    "DLRM": DLRM,
    "ResNet50": RESNET50,
}


def synthetic_dataset(n: int = 1000, seed: int = 0,
                      lo: int = 16, hi: int = 8192) -> list[GEMM]:
    """Paper §V-C synthetic dataset: M, N, K uniform over powers of two in
    [16, 8192] (1000 datapoints)."""
    rng = random.Random(seed)
    choices = []
    v = lo
    while v <= hi:
        choices.append(v)
        v *= 2
    return [GEMM(rng.choice(choices), rng.choice(choices),
                 rng.choice(choices), label=f"synthetic#{i}")
            for i in range(n)]


def square_sweep(lo: int = 64, hi: int = 8192) -> list[GEMM]:
    """Appendix Fig. 13: square GEMMs (X, X, X) from 64 to 8192."""
    out, v = [], lo
    while v <= hi:
        out.append(GEMM(v, v, v, label=f"square{v}"))
        v *= 2
    return out


def all_real_gemms() -> list[GEMM]:
    out: list[GEMM] = []
    for name, gs in REAL_WORKLOADS.items():
        out.extend(gs)
    return out
