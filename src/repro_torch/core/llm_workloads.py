"""GEMM extraction from the assigned LM architectures (DESIGN.md §2).

Lowers each (arch x shape) cell into the paper's Table-I GEMM taxonomy so
the WWW planner can answer what/when/where for modern LM workloads:
train/prefill => large-M GEMMs; decode => the paper's M=1 pathology
(batched: M = batch).
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from .gemm import GEMM


def gemms_of_model(cfg: ModelConfig, shape: ShapeConfig) -> list[GEMM]:
    """Per-step GEMM list with per-layer counts.

    Decode uses M = global_batch (one token per sequence); train/prefill
    use M = seq_len with count x batch (the paper's single-batch
    convention, scaled by occurrence count).
    """
    s, b = shape.seq_len, shape.global_batch
    decode = shape.kind == "decode"
    M = b if decode else s
    per_seq = 1 if decode else b
    d, dh = cfg.d_model, cfg.head_dim()
    out: list[GEMM] = []

    n_attn = cfg.n_layers
    n_mamba = 0
    if cfg.family == "ssm":
        n_attn, n_mamba = 0, cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        n_mamba = cfg.n_layers - n_attn
    elif cfg.family == "vlm" and cfg.vision:
        # cross-attn layers run the xattn-* projections counted below,
        # not the self-attn ones — don't double-count them here
        n_attn = cfg.n_layers - cfg.n_layers // cfg.vision.cross_attn_every

    def add(m, n, k, label, count):
        if count > 0 and min(m, n, k) >= 1:
            out.append(GEMM(int(m), int(n), int(k), label=label,
                            count=int(count)))

    # --- attention projections ---
    if n_attn and cfg.mla:
        # latent attention: q and the latent row from d, the latent up to
        # k_nope and v per head, the output from v; decode attends in the
        # absorbed form over rows of kv_lora_rank + qk_rope_head_dim
        a = cfg.mla
        H = cfg.n_heads
        add(M, H * a.qk_head_dim, d, f"{cfg.name} Wq", n_attn * per_seq)
        add(M, a.row_width, d, f"{cfg.name} Wkva", n_attn * per_seq)
        add(M, H * (a.qk_nope_head_dim + a.v_head_dim), a.kv_lora_rank,
            f"{cfg.name} Wkvb", n_attn * per_seq)
        add(M, d, H * a.v_head_dim, f"{cfg.name} Wo", n_attn * per_seq)
        if decode:
            add(b, s, a.row_width, f"{cfg.name} qK^T (decode)", n_attn * H)
            add(b, a.kv_lora_rank, s, f"{cfg.name} pV (decode)", n_attn * H)
        else:
            add(s, s, a.qk_head_dim, f"{cfg.name} QK^T", n_attn * H * per_seq)
            add(s, a.v_head_dim, s, f"{cfg.name} QK^T.V",
                n_attn * H * per_seq)
    elif n_attn:
        add(M, cfg.n_heads * dh, d, f"{cfg.name} Wq", n_attn * per_seq)
        add(M, cfg.n_kv_heads * dh, d, f"{cfg.name} Wk", n_attn * per_seq)
        add(M, cfg.n_kv_heads * dh, d, f"{cfg.name} Wv", n_attn * per_seq)
        add(M, d, cfg.n_heads * dh, f"{cfg.name} Wo", n_attn * per_seq)
        # score GEMMs (per head); decode: 1 x cache x dh
        kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
        if decode:
            add(b, kv_len, dh, f"{cfg.name} qK^T (decode)",
                n_attn * cfg.n_heads)
            add(b, dh, kv_len, f"{cfg.name} pV (decode)",
                n_attn * cfg.n_heads)
        else:
            add(s, kv_len, dh, f"{cfg.name} QK^T",
                n_attn * cfg.n_heads * per_seq)
            add(s, dh, kv_len, f"{cfg.name} QK^T.V",
                n_attn * cfg.n_heads * per_seq)

    # --- FFN / experts ---
    if cfg.moe:
        lead = cfg.moe.first_dense_layers
        moe_layers = (cfg.n_layers - lead) // cfg.moe.every_n_layers
        dense_layers = (cfg.n_layers - moe_layers
                        if cfg.family == "hybrid" else lead)
        tokens = M
        per_expert_m = max(1, tokens * cfg.moe.top_k // cfg.moe.n_experts)
        for nm, wn, wk in (("gate", cfg.moe.expert_d_ff, d),
                           ("up", cfg.moe.expert_d_ff, d),
                           ("down", d, cfg.moe.expert_d_ff)):
            add(per_expert_m, wn, wk, f"{cfg.name} expert-{nm}",
                moe_layers * cfg.moe.n_experts * per_seq)
        if cfg.moe.n_shared_experts:
            for nm, wn, wk in (("gate", cfg.moe.shared_d_ff, d),
                               ("up", cfg.moe.shared_d_ff, d),
                               ("down", d, cfg.moe.shared_d_ff)):
                add(M, wn, wk, f"{cfg.name} shared-{nm}",
                    moe_layers * per_seq)
        for nm, wn, wk in (("gate", cfg.d_ff, d), ("up", cfg.d_ff, d),
                           ("down", d, cfg.d_ff)):
            if dense_layers and cfg.d_ff:
                add(M, wn, wk, f"{cfg.name} mlp-{nm}",
                    dense_layers * per_seq)
    elif cfg.d_ff and cfg.family != "ssm":
        # pure-SSM periods are (mamba, None): no FFN slot exists even if
        # the config carries a (smoke-default) d_ff
        for nm, wn, wk in (("gate", cfg.d_ff, d), ("up", cfg.d_ff, d),
                           ("down", d, cfg.d_ff)):
            add(M, wn, wk, f"{cfg.name} mlp-{nm}",
                cfg.n_layers * per_seq)

    # --- mamba mixer projections ---
    if n_mamba and cfg.ssm:
        di = cfg.ssm.d_inner(d)
        nh = cfg.ssm.n_ssm_heads(d)
        gdim = cfg.ssm.n_groups * cfg.ssm.d_state
        add(M, di, d, f"{cfg.name} ssm-z", n_mamba * per_seq)
        add(M, di, d, f"{cfg.name} ssm-x", n_mamba * per_seq)
        add(M, 2 * gdim + nh, d, f"{cfg.name} ssm-BCdt",
            n_mamba * per_seq)
        add(M, d, di, f"{cfg.name} ssm-out", n_mamba * per_seq)

    # --- vision cross-attn K/V from image tokens ---
    if cfg.family == "vlm" and cfg.vision:
        n_cross = cfg.n_layers // cfg.vision.cross_attn_every
        nimg = cfg.vision.n_image_tokens
        add(nimg, cfg.n_kv_heads * dh, d, f"{cfg.name} xattn-KV",
            2 * n_cross * per_seq)
        add(M, cfg.n_heads * dh, d, f"{cfg.name} xattn-Q",
            n_cross * per_seq)
        add(M, d, cfg.n_heads * dh, f"{cfg.name} xattn-out",
            n_cross * per_seq)
        if not decode:
            add(s, nimg, dh, f"{cfg.name} xattn-scores",
                2 * n_cross * cfg.n_heads * per_seq)

    # --- LM head ---
    add(M, cfg.vocab, d, f"{cfg.name} lm_head", per_seq)
    return out


def phase_gemms_of_model(cfg: ModelConfig, seq_len: int,
                         batch: int) -> dict[str, list[GEMM]]:
    """The serving phases of one model as separate GEMM sets.

    {"prefill": gemms at M = seq_len (kind="prefill"),
     "decode":  gemms at M = batch  (kind="decode")}

    This is the input `planner.plan_workload_by_phase` expects: the same
    architecture produces structurally different What/When verdicts per
    phase (prefill's large-M reuse vs decode's M=batch GEMV pathology),
    and the serving stack gates each phase by its own plan table."""
    from ..configs.base import ShapeConfig
    return {
        "prefill": gemms_of_model(
            cfg, ShapeConfig("phase-prefill", seq_len, batch, "prefill")),
        "decode": gemms_of_model(
            cfg, ShapeConfig("phase-decode", seq_len, batch, "decode")),
    }


# GEMMs whose labels match these markers multiply two *activations*
# (attention scores / probability-weighted values): there is no stationary
# weight to quantize, so the runtime projection gate never sees them.
ACTIVATION_GEMM_MARKERS = ("qK^T", "pV (decode)", "QK^T", "xattn-scores")


def is_projection_label(label: str) -> bool:
    """True for GEMMs with a stationary weight operand (the labels the
    model-side `linear(...)` execution layer consumes)."""
    return not any(m in label for m in ACTIVATION_GEMM_MARKERS)


def projection_labels(cfg: ModelConfig, shape: ShapeConfig) -> set[str]:
    """Short (model-prefix-stripped) labels of all weight projections of
    one (arch x shape) cell — the exact label set the model stack must
    route through `models.layers.linear` (coverage-tested)."""
    prefix = f"{cfg.name} "
    return {g.label[len(prefix):] if g.label.startswith(prefix) else g.label
            for g in gemms_of_model(cfg, shape)
            if is_projection_label(g.label)}
