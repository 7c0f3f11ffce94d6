"""Three-term roofline of one step of an (arch x shape) cell, on the
NVIDIA H100 (the port of the JAX package's `launch/roofline.py`, whose
constants are a TPU's):

  compute    = FLOPs_per_device / PEAK_FLOPS          (bf16 dense peak)
  memory     = HBM_bytes_per_device / HBM_BW          (HBM bandwidth)
  collective = collective_bytes_per_device / LINK_BW  (NVLink, one way)

The constants are the data sheet's for one H100 SXM 80GB HBM3 at its
700 W limit (a card set to a lower power limit runs below them).  On one
card nothing crosses a link: its caller passes 0 collective bytes.
MODEL_FLOPS uses 6·N·D (train) / 2·N_active·tokens + attention (serve),
divided by the device count — the "useful fraction" of the counted FLOPs
catches remat/dispatch waste.  `model_flops` and `analytic_hbm_bytes`
are the JAX package's formulas, unchanged.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12          # H100 SXM (80GB HBM3, 700 W): bf16 dense
HBM_BW = 3.35e12             # H100 SXM: HBM3, B/s
LINK_BW = 450e9              # H100 SXM: NVLink 4, 900 GB/s both ways = 450
                             # GB/s per direction (all 18 links), B/s


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per device (counted FLOPs of the step)
    hlo_bytes: float             # per device (counted bytes accessed)
    collective_bytes: float      # per device
    model_flops_total: float     # whole step, all devices
    hbm_bytes: float = 0.0       # per device, analytic (fusion-adjusted)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s_xla(self) -> float:
        """Counted bytes-accessed / HBM bw.  Every op's operands counted —
        a gross HBM upper bound; reported for the spec, not used for the
        bottleneck verdict (the name is the JAX package's row key)."""
        return self.hlo_bytes / HBM_BW

    @property
    def memory_s(self) -> float:
        """Analytic HBM traffic (params/grads/optstate/activations/cache,
        post-fusion) / HBM bw — the memory term used for the bottleneck."""
        return (self.hbm_bytes or self.hlo_bytes) / HBM_BW

    @property
    def collective_s(self) -> float:
        """Collective bytes / one-way NVLink rate (a one-card step moves
        0 collective bytes)."""
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        dev_model = self.model_flops_total / max(1, self.chips)
        return dev_model / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak the step achieves at the roofline
        bound = useful-FLOPs time / bound time (the §Perf score)."""
        dev_model = self.model_flops_total / max(1, self.chips)
        ideal = dev_model / PEAK_FLOPS
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_xla": self.memory_s_xla,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "hlo_flops_dev": self.hlo_flops,
            "hbm_bytes_dev": self.hbm_bytes,
            "useful_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for one step of this (arch, shape) cell."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * tokens
        attn = _attn_flops(cfg, shape.seq_len, shape.global_batch,
                           causal=True) * 3.0      # fwd + bwd(2x)
        return base + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens + _attn_flops(
            cfg, shape.seq_len, shape.global_batch, causal=True)
    # decode: one token against a seq_len cache
    b = shape.global_batch
    base = 2.0 * n_active * b
    attn = _decode_attn_flops(cfg, shape.seq_len, b)
    return base + attn


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _attn_flops(cfg: ModelConfig, s: int, b: int, causal: bool) -> float:
    n = _n_attn_layers(cfg)
    if n == 0:
        return 0.0
    h, dh = cfg.n_heads, cfg.head_dim()
    eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
    per_layer = 2.0 * b * h * s * eff * dh * (0.5 if causal
                                              and not cfg.sliding_window
                                              else 1.0) * 2  # QK^T + PV
    return n * per_layer


def _decode_attn_flops(cfg: ModelConfig, s_cache: int, b: int) -> float:
    n = _n_attn_layers(cfg)
    if n == 0:
        return 0.0
    h, dh = cfg.n_heads, cfg.head_dim()
    eff = min(s_cache, cfg.sliding_window) if cfg.sliding_window else s_cache
    return n * 4.0 * b * h * eff * dh


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                       optimizer: str = "adamw", microbatches: int = 1,
                       kv_cache_bytes_per_el: int = 2,
                       tp: int = 16) -> float:
    """Per-device HBM traffic per step, assuming full fusion (the JAX
    package's formula).

    Train: weights read fwd+bwd at the TP shard size (FSDP gathers land in
    HBM once per layer per pass), grads written + read, optimizer state
    read+written, remat-saved layer inputs written+read, logits in fp32.
    Decode: full local weight + cache read, cache line write.
    Prefill: local weights + activations.
    """
    P = cfg.param_count()
    P_active = cfg.active_param_count()
    d, V = cfg.d_model, cfg.vocab
    if shape.kind == "train":
        tokens_local = shape.seq_len * shape.global_batch / max(1, chips // tp)
        w = 2.0 * 2 * P / tp               # bf16 weights, fwd + bwd passes
        g = 2.0 * 2 * P / chips            # grad write + read (shard, f32->bf16ish)
        if optimizer == "adamw":
            opt = (4 + 4) * 2.0 * P / chips    # m,v f32 read+write
        else:
            opt = 0.2 * P / chips              # factored state
        upd = 2 * 2.0 * P / chips
        acts = 2.0 * tokens_local * d * 2 * cfg.n_layers / microbatches \
            * microbatches        # saved carries written + read (per mb)
        logits = tokens_local * V * 4.0 / tp
        return w + g + opt + upd + acts + logits
    if shape.kind == "prefill":
        tokens_local = shape.seq_len * shape.global_batch \
            / max(1, chips // tp)
        w = 2.0 * P_active / tp
        acts = 2.0 * tokens_local * d * 2 * cfg.n_layers
        return w + acts
    # decode
    w = 2.0 * P_active / tp
    n_attn = _n_attn_layers(cfg)
    cache = (2.0 * n_attn * shape.global_batch * shape.seq_len
             * cfg.n_kv_heads * cfg.head_dim()
             * kv_cache_bytes_per_el) / chips
    return w + cache
