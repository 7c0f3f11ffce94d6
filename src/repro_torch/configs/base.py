"""Model / shape / run configuration dataclasses.

Every assigned architecture is a `ModelConfig`; the four assigned input
shapes are `ShapeConfig`s.  `reduced()` produces the CPU smoke-test variant
of any architecture (same family & wiring, tiny sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    expert_d_ff: int = 0            # per-expert FFN width
    shared_d_ff: int = 0            # shared-expert FFN width
    every_n_layers: int = 1         # MoE FFN every N layers (1 = all)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128              # mamba2 N (per-head state)
    d_conv: int = 4
    headdim: int = 64
    expand: int = 2
    chunk: int = 256                # SSD chunk length
    n_groups: int = 1               # B/C groups

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    cross_attn_every: int = 5       # a cross-attn layer every N layers
    n_image_tokens: int = 1601      # precomputed patch-embedding stub
    image_d_model: int = 0          # 0 => same as text d_model


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    n_codebooks: int = 4            # EnCodec parallel codebooks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention pattern
    attn_every: int = 1             # hybrid: attention every N layers
    sliding_window: int = 0         # 0 = full attention; >0 = local window
    # sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    vision: VisionConfig | None = None
    audio: AudioConfig | None = None
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(1, self.n_heads))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (long_500k shape)?"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.head_dim()
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        n_attn = (self.n_layers // self.attn_every
                  if self.attn_every > 1 else self.n_layers)
        if self.family == "ssm":
            n_attn = 0
        attn = (d * self.n_heads * h + 2 * d * self.n_kv_heads * h
                + self.n_heads * h * d)
        per_layer += 0  # accumulated per kind below
        total = emb + n_attn * attn
        # FFN / experts
        if self.moe:
            moe_layers = self.n_layers // self.moe.every_n_layers
            dense_layers = self.n_layers - moe_layers
            total += moe_layers * (
                self.moe.n_experts * 3 * d * self.moe.expert_d_ff
                + (3 * d * self.moe.shared_d_ff
                   if self.moe.n_shared_experts else 0)
                + d * self.moe.n_experts)
            total += dense_layers * 3 * d * self.d_ff
        elif self.family == "ssm":
            pass
        else:
            total += self.n_layers * 3 * d * self.d_ff
        # ssm mixers
        if self.ssm:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_ssm_heads(d)
            ssm_layers = (self.n_layers if self.family == "ssm"
                          else self.n_layers - n_attn)
            per = (d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state
                        + nh)              # in_proj (z,x,B,C,dt)
                   + di * self.ssm.d_conv  # conv
                   + nh                    # A
                   + di * d)               # out_proj
            total += ssm_layers * per
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        moe_layers = self.n_layers // self.moe.every_n_layers
        inactive = moe_layers * (self.moe.n_experts - self.moe.top_k) \
            * 3 * d * self.moe.expert_d_ff
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in
                                  (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving runtime knobs."""
    optimizer: str = "adamw"          # "adamw" | "adafactor"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    microbatches: int = 1             # gradient accumulation
    remat: bool = True                # activation checkpoint each block
    fsdp: bool = True                 # shard params/optstate over data axis
    grad_compress: bool = False       # int8 error-feedback all-reduce
    kv_cache_dtype: str = "bfloat16"  # "int8" for quantized cache
    attn_impl: str = "flash_jnp"      # "flash_jnp" | "naive" | "pallas"
    attn_chunk: int = 1024            # kv chunk for flash_jnp / decode
    scan_unroll: int = 0              # layer-scan unroll factor (dry-run:
                                      # XLA counts a while-loop body once,
                                      # so the roofline pass compiles two
                                      # partial unrolls and extrapolates)
    # --- beyond-paper perf knobs (EXPERIMENTS.md §Perf) ---
    shard_heads: bool = False         # with_sharding_constraint heads->TP
    shard_attn: str = ""              # "heads" | "seq" (context parallel)
    sp_residual: bool = False         # Megatron-SP: residual stream stays
                                      # sequence-sharded between blocks
    batch_axes: str = "data"          # mesh axes carrying batch ("pod,data"
                                      # for multi-pod) used by constraints
    shard_loss: bool = False          # constrain logits + sharded-vocab
                                      # masked-sum loss (no fp32 gather)
    gqa_einsum: bool = False          # grouped-query einsums (no repeat)
    block_causal: bool = False        # triangular-chunk flash attention
    attn_q_chunk: int = 4096          # q-chunk for block-causal
    remat_policy: str = "nothing"     # "nothing" | "dots"


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    n_layers = min(cfg.n_layers, 2)
    kw: dict = dict(
        name=cfg.name + "-smoke", d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128, vocab=256, d_head=16)
    if cfg.family == "hybrid":
        kw["attn_every"] = 2
        n_layers = 4
    if cfg.family == "vlm":
        n_layers = 4
    kw["n_layers"] = n_layers
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), expert_d_ff=64,
            shared_d_ff=64 if cfg.moe.n_shared_experts else 0)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=16,
                                        chunk=32)
    if cfg.vision:
        kw["vision"] = dataclasses.replace(cfg.vision, n_image_tokens=8,
                                           cross_attn_every=2)
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    return dataclasses.replace(cfg, **kw)
