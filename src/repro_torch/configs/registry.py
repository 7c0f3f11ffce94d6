"""The 10 assigned architectures (exact configs from the assignment) plus
the paper's own evaluation workloads.

Sources in brackets per the assignment table; all configs verbatim.
"""
from __future__ import annotations

from .base import (AudioConfig, MLAConfig, ModelConfig, MoEConfig,
                   SSMConfig, VisionConfig)

# --- LM-family transformers -------------------------------------------------

QWEN2_7B = ModelConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True)
# [arXiv:2407.10671; hf]

QWEN1_5_32B = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True)
# [hf:Qwen/Qwen1.5; hf]

MISTRAL_NEMO_12B = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, d_head=128)
# [hf:mistralai/Mistral-Nemo-Base-2407; hf] — 128k ctx

MINITRON_4B = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab=256000, d_head=128)
# [arXiv:2407.14679; hf] — pruned nemotron

MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
    audio=AudioConfig(n_codebooks=4))
# [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens (frontend stub)

QWEN2_MOE_A2_7B = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                  expert_d_ff=1408, shared_d_ff=4 * 1408))
# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4

LLAMA4_SCOUT_17B_A16E = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, d_head=128,
    sliding_window=8192,    # chunked/local attention => sub-quadratic
    moe=MoEConfig(n_experts=16, top_k=1, n_shared_experts=1,
                  expert_d_ff=8192, shared_d_ff=8192))
# [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE, early fusion

MAMBA2_780M = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2))
# [arXiv:2405.21060; unverified] — SSD (state-space duality), attn-free

LLAMA3_2_VISION_90B = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, d_head=128,
    vision=VisionConfig(cross_attn_every=5, n_image_tokens=1601))
# [hf:meta-llama/Llama-3.2-Vision; unverified] — cross-attn image layers

JAMBA_1_5_LARGE_398B = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    d_head=128, attn_every=8,     # Mamba : attention = 7 : 1
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=24576,
                  every_n_layers=2),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2))
# [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave, MoE 16e top-2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (
    QWEN2_7B, QWEN1_5_32B, MISTRAL_NEMO_12B, MINITRON_4B, MUSICGEN_LARGE,
    QWEN2_MOE_A2_7B, LLAMA4_SCOUT_17B_A16E, MAMBA2_780M,
    LLAMA3_2_VISION_90B, JAMBA_1_5_LARGE_398B)}

# --- served by the port alone ------------------------------------------------
# Not in ARCHS, which stays the ten assigned architectures that the JAX
# package also has (the campaign grid, the dry run and the parity tests
# walk it); `get` finds these too.

MOONLIGHT_16B_A3B = ModelConfig(
    name="moonlight-16b-a3b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=11264, vocab=163840, rope_theta=50000.0,
    rmsnorm_eps=1e-5,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                  expert_d_ff=1408, shared_d_ff=2 * 1408,
                  capacity_factor=11.0, scoring="sigmoid",
                  routed_scale=2.446, first_dense_layers=1))
# [hf:moonshotai/Moonlight-16B-A3B config.json; model_type deepseek_v3] —
# MLA (latent 512, nope 128, rope 64, v 128), 64 routed top-6 by sigmoid
# + bias (noaux_tc, one group) + 2 shared, layer 0 dense; capacity 11 >=
# 64 / 6 so that no token is dropped

PORT_ARCHS: dict[str, ModelConfig] = {c.name: c for c in (
    MOONLIGHT_16B_A3B,)}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    raise KeyError(f"unknown arch '{name}'; have "
                   f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
