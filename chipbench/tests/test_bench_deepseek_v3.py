"""The deepseek_v3 architecture module (moonlight-16b-a3b): its leaves
are the program's parameter tree, its operation and byte counts are the
hand arithmetic at the published widths, its reference runs at tiny
widths on the CPU, the MLA kernel's roofline reader does its arithmetic
on a synthetic record, and a run whose timed path is broken comes out
not correct.

The tiny runs compute in float32 with an f32 latent cache, so that a
sound run reads gap 0 at every position (the program and the reference
agree to f32 rounding, and no router sits close enough to a tie to flip
on it): the tiny limit is 1e-3 on the widest gap.  The cell's own
quantile (p70) is set for the full-size bf16 program, whose routing
flips cascade (`gap_sources.py`); a tiny f32 run has no such cascade,
and there the bias fault moves the top token at only 10-20% of
positions.  The faults read 0.01 and above: the latent attention's
scores without the rope columns, and the selection bias added into the
experts' weights."""
import json
import time

import pytest
import torch

from chipbench import harness, spec, weights
from chipbench.drivers.common import program_config
from chipbench.tests import tiny

ARCH = spec.arch("deepseek_v3")
CONFIG = "moonlight-16b-a3b"
CELL = "moonlight-16b-a3b.chat-backlog-128"
TINY = {"name": "tiny-mla", "family": "moe", "n_layers": 3, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 4, "d_ff": 96, "vocab": 256,
        "d_head": 0, "qkv_bias": False, "rope_theta": 50000.0,
        "rmsnorm_eps": 1e-05, "tie_embeddings": False,
        "mla": {"kv_lora_rank": 32,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                "v_head_dim": 16},
        "moe": {"n_experts": 8, "top_k": 3, "n_shared_experts": 2,
                "expert_d_ff": 32, "shared_d_ff": 64, "every_n_layers": 1,
                "capacity_factor": 3.0, "router_aux_loss": 0.001,
                "scoring": "sigmoid", "routed_scale": 2.446,
                "first_dense_layers": 1},
        "param_dtype": "float32", "compute_dtype": "float32"}
LIMIT = 1e-3


def _config():
    return spec.load_config(spec.load_benchmark(), CONFIG)


def _layout(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _layout(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _layout(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


def test_leaves_are_the_programs_tree():
    from repro_torch.models import init
    ours = weights.make("deepseek_v3", TINY, 5, "cpu")
    theirs = init(torch.Generator().manual_seed(0), program_config(TINY),
                  device="cpu")
    got, want = _layout(ours), _layout(theirs)
    # the program's init draws in its param dtype; the benchmark's bf16
    want = {k: (s, torch.float32 if k.endswith(("router", "score_bias"))
                else torch.bfloat16) for k, (s, _) in want.items()}
    assert got == want
    assert "/lead/attn/wkv_b" in got and "/slots/0/moe/score_bias" in got


def test_config_is_the_published_model():
    """The file's "model" block is the registry's entry; the catalog's
    config keys stand at the top level and under "published", nothing
    reduced, and its byte counts are the leaves'."""
    from repro_torch.configs.registry import MOONLIGHT_16B_A3B
    config = _config()
    m = config["model"]
    assert config["arch"] == "deepseek_v3" and config["reduced"] == []
    assert program_config(m) == MOONLIGHT_16B_A3B
    pub = config["published"]
    assert all(config[k] == v for k, v in pub.items())
    assert (pub["hidden_size"], pub["num_hidden_layers"],
            pub["n_routed_experts"], pub["num_experts_per_tok"],
            pub["kv_lora_rank"], pub["qk_rope_head_dim"],
            pub["first_k_dense_replace"], pub["routed_scaling_factor"]) == (
        m["d_model"], m["n_layers"], m["moe"]["n_experts"],
        m["moe"]["top_k"], m["mla"]["kv_lora_rank"],
        m["mla"]["qk_rope_head_dim"], m["moe"]["first_dense_layers"],
        m["moe"]["routed_scale"])
    names = ("wq", "wkv_a", "wkv_b", "wo", "w_gate", "w_up", "w_down",
             "lm_head")
    q8 = sum(torch.Size(s).numel() for p, s, *_ in ARCH.leaf_specs(m)
             if p.split("/")[-1] in names)
    assert config["bytes"]["int8_projection_weights"] == q8 == 15621029888
    assert config["bytes"]["kv_cache_per_token_bf16"] == 27 * 576 * 2


def test_counts_are_the_hand_arithmetic():
    m = _config()["model"]
    d, H, L, V = 2048, 16, 27, 163840
    shapes = ARCH.projection_shapes(m)
    assert shapes["Wq"] == (d, H * 192, L)
    assert shapes["Wkva"] == (d, 576, L)
    assert shapes["Wkvb"] == (512, H * 256, L)
    assert shapes["Wo"] == (H * 128, d, L)
    assert shapes["mlp-gate"] == (d, 11264, 1)
    assert shapes["expert-down"] == (1408, d, 26)
    assert shapes["shared-up"] == (d, 2816, 26)
    attn = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    ffn = 3 * d * 11264 + 26 * (6 * 3 * d * 1408 + 3 * d * 2816 + d * 64)
    assert ARCH.matmul_params_per_token(m, False) == L * attn + ffn
    assert ARCH.matmul_params_per_token(m) == L * attn + ffn + d * V
    # the registry's active parameters, less the embedding (a gather)
    from repro_torch.configs.registry import MOONLIGHT_16B_A3B as cfg
    assert ARCH.matmul_params_per_token(m) == (cfg.active_param_count()
                                               - V * d)
    pair = 2 * L * H * (576 + 512)
    assert ARCH.positions_flops(m, 10, 13, 12) == (
        2.0 * (L * attn + ffn) * 3 + 2.0 * d * V * 1 + pair * (11 + 12 + 13))
    assert ARCH.mla_decode_call(m, 100) == (
        2.0 * H * 1088 * 100, 2.0 * (100 * 576 + H * 576 + H * 512))
    assert ARCH.flash_call(m, 4) == (2.0 * H * (192 + 128) * 10,
                                     2.0 * 4 * H * (2 * 192 + 2 * 128))


@pytest.mark.parametrize("bits", [8, 4])
def test_reference_runs_at_tiny_widths(bits):
    params = weights.make("deepseek_v3", TINY, 9, "cpu")
    seqs = [torch.arange(7) * 3, torch.arange(12) % 5]
    reads = [torch.arange(7), torch.arange(4, 12)]
    h = ARCH.final_hidden(TINY, params, seqs, reads, bits)
    assert [tuple(x.shape) for x in h] == [(7, 64), (8, 64)]
    assert all(bool(torch.isfinite(x).all()) for x in h)
    other = ARCH.final_hidden(TINY, params, seqs, reads, 12 - bits)
    assert not torch.equal(h[0], other[0])


def test_mla_roofline_reader_on_a_synthetic_record():
    from chipbench import flops
    m = _config()["model"]
    read = spec.reader("mla_decode_roofline")
    run = {"arch": "deepseek_v3", "model": m, "steps": 4,
           "pos_start": [0, 100, 7], "pos_end": [3, 102, 7],
           "trace": {"steps": 2, "by_name": {
               "paged_mla_kernel(CUtensorMap_st, ...)": 2e-4,
               "paged_mla_combine_kernel(float const*, ...)": 1e-4,
               "int8_gemm_tma_kernel<0>": 5.0}}}
    rows = [1, 2, 3, 101, 102]
    ops = sum(2.0 * 16 * 1088 * r for r in rows)
    moved = sum(2.0 * (r * 576 + 16 * 576 + 16 * 512) for r in rows)
    want = 100 * flops.bound_s(ops, moved) * 27 / 4 * 2 / 3e-4
    assert read(run) == pytest.approx(want, rel=1e-12)
    assert read(dict(run, trace=dict(run["trace"], by_name={}))) is None
    assert read({k: v for k, v in run.items() if k != "trace"}) is None
    assert read(dict(run, arch="qwen2")) is None


def _run(seed=2 ** 31 + 7):
    """A tiny run on one torch thread: under parallel test workers the
    threads of each would contend, and a run would compare few tokens."""
    cell = tiny.engine_cell(CELL)
    cell["run_config"] = dict(cell["run_config"], kv_cache_dtype="float32")
    cell["check"] = dict(cell["check"], limit=LIMIT, quantile=100)
    ctx = harness.Ctx(bench=spec.load_benchmark(), workload=CELL, cell=cell,
                      model=TINY, arch="deepseek_v3", seed=seed,
                      seconds=3.0, trace=False, device="cpu",
                      t_start=time.perf_counter())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run(ctx)
    finally:
        torch.set_num_threads(threads)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "itl_p95_ms",
                                 "output_tokens_per_s"}
    json.dumps(r)


def _rope_dropped(monkeypatch):
    """The latent attention scores q . row over the latent columns only."""
    from repro_torch.models import model
    attend = model.latent_attend

    def no_rope(q, rows, lens, scale, v_dim):
        q = q.clone()
        q[..., v_dim:] = 0
        return attend(q, rows, lens, scale, v_dim)
    monkeypatch.setattr(model, "latent_attend", no_rope)


def _bias_in_weights(monkeypatch):
    """The experts weighted by sigmoid + bias, as they were chosen."""
    from repro_torch.models import moe
    route = moe.route

    def biased(params, xt, cfg):
        probs, _, ids = route(params, xt, cfg)
        w = (probs + params["score_bias"].float()).gather(1, ids)
        return probs, w / w.sum(-1, keepdim=True) * cfg.moe.routed_scale, ids
    monkeypatch.setattr(moe, "route", biased)


@pytest.mark.parametrize("fault", [_rope_dropped, _bias_in_weights],
                         ids=["rope-dropped", "bias-in-weights"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


def test_gap_sources_runs_every_variant():
    """`gap_sources.reading` at tiny widths in f32: every variant reads
    the reference's top token (gap 0 up to f32 rounding), the reference's
    forced expert ids are the ones the program picks, and the INT4
    control reads wide gaps."""
    from chipbench import gap_sources
    cell = tiny.engine_cell(CELL)
    cell["run_config"] = dict(cell["run_config"], kv_cache_dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = gap_sources.reading(TINY, "deepseek_v3", cell, 2 ** 31 + 9, 3,
                                5, 6, device="cpu")
    finally:
        torch.set_num_threads(threads)
    json.dumps(r)
    v = r["variants"]
    assert set(v) == {"cell", "plain", "bf16_scales", "f32_mla", "forced",
                      "f32", "rope_dropped", "bias_in_weights", "control"}
    assert r["positions"] == 3 * 6 == v["cell"]["n"]
    for key in ("cell", "plain", "f32_mla", "forced", "f32"):
        assert v[key]["p100"] <= LIMIT, (key, v[key])
    assert r["routing"]["all_layers_agree"] == 1.0
    assert v["control"]["p50"] > 10 * LIMIT
    assert v["rope_dropped"]["p100"] > 10 * LIMIT
