"""DeepSeek-V3's block in the port (latent attention, the sigmoid router
with a selection-only bias, the merged shared experts, a leading dense
layer) against the benchmark's plain reference
(`chipbench/archs/deepseek_v3.py`) on the CPU at reduced widths, on
seeded random weights.

Tolerances.  In float32 the port and the reference compute the same
function from the same INT8 round trip (the port quantizes its own
weights, the reference works them out from the same bf16 draws; the two
agree bit for bit, chipbench/tests/test_bench_reference.py): only the
order of f32 sums differs, so logits agree to 1e-4 of their largest
magnitude.  That bound is tight: the same port computing in bfloat16
(2^-8 unit roundoff) misses it, which the forward test checks.  The
absorbed decode against the expanded attention, one layer in f32: the
same products summed in another association, 1e-5 of the largest
output.  The router's selection and weights are held exactly: the port
and the reference make the same f32 operations in the same order.

The qwen2-moe path with every new field at its default is held bit for
bit: `route` against a frozen copy of the router the port had before
the new fields, and a reduced qwen2-moe `moe_apply` and decode step
against pinned digests of the parent commit's output (one CPU thread).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from chipbench import check, reference, weights
from chipbench.archs import deepseek_v3 as ref_arch
from chipbench.drivers.common import program_config
from repro_torch.configs import RunConfig, reduced
from repro_torch.configs.registry import MOONLIGHT_16B_A3B, QWEN2_MOE_A2_7B
from repro_torch.models import decode_step, forward, init, init_cache
from repro_torch.models import model as model_mod
from repro_torch.models.layers import swiglu
from repro_torch.models.model import init_paged_cache
from repro_torch.models.moe import moe_apply, route
from repro_torch.quant import quantize_model_params

ARCH = "deepseek_v3"
TOL = 1e-4
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
RC = RunConfig(attn_impl="naive", remat=False, kv_cache_dtype="float32")


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def _setup(seed=11, m=TINY):
    """(model block, the benchmark's bf16 draws, the port's config, the
    port's INT8 params from the same draws in f32)."""
    params = weights.make(ARCH, m, seed, "cpu")
    return m, params, program_config(m), quantize_model_params(_f32(params))


def _ref_logits(m, params, seq, reads=None):
    reads = torch.arange(len(seq)) if reads is None else reads
    h = ref_arch.final_hidden(m, params, [seq], [reads], 8)[0]
    with reference.no_tf32():
        return h @ ref_arch.head(params, 8)


def test_forward_matches_reference():
    m, params, cfg, q8 = _setup()
    tokens = torch.randint(0, m["vocab"], (1, 12),
                           generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got, _ = forward(q8, tokens, cfg, RC)
        low, _ = forward(q8, tokens, dataclasses.replace(
            cfg, compute_dtype="bfloat16"), RC)
    want = _ref_logits(m, params, tokens[0])
    bound = TOL * want.abs().max().item()
    assert (got[0] - want).abs().max().item() <= bound
    # the bound is tight: bf16 where f32 is stated does not meet it
    assert (low[0].float() - want).abs().max().item() > bound


def test_decode_over_latent_pool_matches_reference_forward():
    """Two prompts of other lengths streamed through the ragged paged
    decode step, one token a step, over the latent block pool: every
    position's logits against the reference's full forward."""
    m, params, cfg, q8 = _setup(seed=12)
    g = torch.Generator().manual_seed(4)
    seqs = [torch.randint(0, m["vocab"], (n,), generator=g) for n in (9, 14)]
    bs, nb = 4, 4
    cache = init_paged_cache(cfg, RC, 2, 2 * nb, bs, device="cpu")
    assert [tuple(c["kv"].shape) for c in cache] == [(3, 2 * nb, bs, 40)]
    tables = torch.tensor([[5, 2, 7, 0], [1, 3, 4, 6]])
    got = [[], []]
    with torch.inference_mode():
        for t in range(14):
            active = torch.tensor([t < 9, True])
            tok = torch.stack([s[min(t, len(s) - 1)] for s in seqs])[:, None]
            lg, cache = decode_step(q8, cache, tok, torch.full((2,), t), cfg,
                                    RC, active=active, block_tables=tables)
            for i in range(2):
                if active[i]:
                    got[i].append(lg[i, 0])
    for i, s in enumerate(seqs):
        want = _ref_logits(m, params, s)
        err = (torch.stack(got[i]) - want).abs().max().item()
        assert err <= TOL * want.abs().max().item(), (i, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepared_absorbed_operands_are_the_steps_own(dtype):
    """`with_absorbed` (what DecodeCore does once) stacks W_UK / W_UV
    beside W_kvb in the compute dtype, formed in f32 from the codes and
    scales; the decode step over the prepared params equals, bit for bit,
    the step that forms them from W_kvb itself."""
    m, params, cfg, q8 = _setup(seed=13)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    prepared = model_mod.with_absorbed(q8, cfg)
    a = cfg.mla
    for sp, layers in ((prepared["lead"], 1), (prepared["slots"][0], 2)):
        ab, w = sp["attn"]["absorbed"], sp["attn"]["wkv_b"]
        assert ab["uk"].dtype == ab["uv"].dtype == getattr(torch, dtype)
        assert tuple(ab["uk"].shape) == (layers, 4, 16, a.kv_lora_rank)
        assert tuple(ab["uv"].shape) == (layers, 4, a.kv_lora_rank, 16)
        full = (w["q"].float() * w["scale"][:, None, :]).view(
            layers, a.kv_lora_rank, 4, 32)
        assert torch.equal(ab["uk"], full[..., :16].permute(0, 2, 3, 1).to(
            ab["uk"].dtype))
        assert torch.equal(ab["uv"], full[..., 16:].permute(0, 2, 1, 3).to(
            ab["uv"].dtype))
    assert "absorbed" not in q8["lead"]["attn"]
    g = torch.Generator().manual_seed(6)
    tok = torch.randint(0, m["vocab"], (2, 5), generator=g)
    caches = [init_cache(cfg, RC, 2, 8, device="cpu") for _ in range(2)]
    with torch.inference_mode():
        for t in range(5):
            outs = [decode_step(p, c, tok[:, t:t + 1], t, cfg, RC)[0]
                    for p, c in zip((prepared, q8), caches)]
            assert torch.equal(*outs), t


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_absorbed_decode_matches_expanded_attention(quantized):
    """One MLA layer: the decode step's absorbed form (q_nope W_UK, the
    latent attention, W_UV, with W_kvb's scales folded where they
    belong) over a contiguous latent cache, position by position,
    against `forward`'s expanded form over the whole sequence."""
    cfg = dataclasses.replace(program_config(TINY), n_layers=1,
                              moe=None, family="dense")
    p = init(torch.Generator().manual_seed(1), cfg, device="cpu")
    ap = p["slots"][0]["attn"]
    ap = {k: v[0] for k, v in ap.items() if k != "kv_norm"} | {
        "kv_norm": {"scale": 1 + 0.1 * torch.randn(
            32, generator=torch.Generator().manual_seed(2))}}
    if quantized:
        ap = quantize_model_params(ap)
    L = 10
    h = torch.randn(2, L, 64, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model_mod._mla_mix(ap, h, torch.arange(L)[None], cfg)
        cache = init_cache(cfg, RC, 2, 16, device="cpu")[0]
        layer = {"kv": cache["kv"][0]}
        got = []
        for t in range(L):
            pvec = torch.full((2, 1), t)
            got.append(model_mod._mla_step(
                ap, layer, h[:, t:t + 1], t, pvec, pvec[:, 0] + 1, cfg,
                None, None, None))
    err = (torch.cat(got, 1) - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_router_selects_with_bias_and_weighs_without():
    cfg = program_config(TINY)
    g = torch.Generator().manual_seed(5)
    params = {"router": torch.randn(64, 8, generator=g) / 8,
              "score_bias": 0.3 * torch.randn(8, generator=g)}
    x = torch.randn(40, 64, generator=g)
    probs, vals, ids = route(params, x, cfg)
    scores = torch.sigmoid(x @ params["router"])
    assert torch.equal(probs, scores)
    assert torch.equal(ids, torch.topk(scores + params["score_bias"], 3,
                                       dim=-1).indices)
    picked = scores.gather(1, ids)
    assert torch.equal(vals, picked / picked.sum(-1, keepdim=True).clamp_min(
        1e-9) * 2.446)
    # the bias moves the selection of some tokens, and the reference's
    # router takes the same experts and weights
    assert not torch.equal(ids.sort(-1).values, torch.topk(
        scores, 3, dim=-1).indices.sort(-1).values)
    r_ids, r_vals = ref_arch.route(x, params, TINY)
    assert torch.equal(r_ids, ids)
    assert torch.allclose(r_vals, vals, rtol=1e-6, atol=0)


def test_shared_experts_are_one_wide_swiglu():
    """Two SwiGLU experts of width f sum to one of width 2 f whose
    gate/up columns and down rows are theirs side by side."""
    g = torch.Generator().manual_seed(6)
    d, f = 48, 24
    parts = [{"w_gate": torch.randn(d, f, generator=g),
              "w_up": torch.randn(d, f, generator=g),
              "w_down": torch.randn(f, d, generator=g)} for _ in range(2)]
    merged = {"w_gate": torch.cat([p["w_gate"] for p in parts], 1),
              "w_up": torch.cat([p["w_up"] for p in parts], 1),
              "w_down": torch.cat([p["w_down"] for p in parts], 0)}
    x = torch.randn(5, d, generator=g)
    want = sum(swiglu(p, x, label_prefix="shared") for p in parts)
    got = swiglu(merged, x, label_prefix="shared")
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_engine_serves_reduced_moonlight_against_reference():
    """Two requests of the reduced registry entry through DecodeCore
    (INT8, planned) and the continuous-batching engine over the latent
    pool: each served token is the reference's top token up to the f32
    tolerance (its gap below the reference's best logit)."""
    from repro_torch.serving import ContinuousBatchingEngine, DecodeCore
    from repro_torch.serving.scheduler import Request
    cfg = dataclasses.replace(reduced(MOONLIGHT_16B_A3B),
                              param_dtype="float32", compute_dtype="float32")
    m = dataclasses.asdict(cfg)
    assert program_config(m) == cfg
    params = weights.make(ARCH, m, 21, "cpu")
    core = DecodeCore(cfg, RC, _f32(params), quantize=True, plan_batch=2,
                      plan_max_len=32, device="cpu")
    assert all("absorbed" in sp["attn"]
               for sp in (core.params["lead"], *core.params["slots"]))
    eng = ContinuousBatchingEngine(core, n_slots=2, max_len=32, block_size=8)
    g = np.random.default_rng(7)
    prompts = [g.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9)]
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
    eng.drain()
    done = sorted(eng.completed, key=lambda r: r.rid)
    samples = [(r.prompt, [int(t) for t in r.tokens]) for r in done]
    seqs, reads, chosen = check.served(samples, "cpu")
    gaps, _ = check.top_gaps(ARCH, m, params, seqs, reads, chosen)
    flat = np.concatenate(gaps)
    assert flat.size == 12
    scale = _ref_logits(m, params, seqs[0]).abs().max().item()
    assert flat.max() <= TOL * scale, flat


# --- the qwen2-moe path, unchanged -------------------------------------------

def _parent_route(params, xt, cfg):
    """The router as the port had it before the routing fields: softmax,
    top-k, the k weights renormalised."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1,
                                       sorted=True)
    total = gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals / total, expert_ids


# sha256 of the parent commit's outputs (one CPU thread): a reduced
# qwen2-moe's moe_apply (y, aux) and two decode steps' logits, bf16
QWEN2_MOE_PINS = {
    "moe_apply":
        "635ae7b14df21d3c3668e20c230feeb9e1f28b05b48ed6add38edb0f2f5669b7",
    "decode_step":
        "d9784bfaf6af116f97e07e7537900a00763ec33b693b693ded2aaab3c872f8e9",
}


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def qwen2_moe_outputs() -> dict:
    """The reduced qwen2-moe outputs the pins hold (run by the parent and
    by this tree alike)."""
    cfg = reduced(QWEN2_MOE_A2_7B)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
        x = torch.randn(2, 3, cfg.d_model,
                        generator=torch.Generator().manual_seed(1)).to(
            torch.bfloat16)
        rc = RunConfig(attn_impl="naive", remat=False)
        with torch.inference_mode():
            y, aux = moe_apply(model_mod._layer(params["slots"][0]["moe"],
                                                0), x, cfg)
            cache = init_cache(cfg, rc, 2, 8, device="cpu")
            tok = torch.tensor([[3], [7]])
            l0, cache = decode_step(params, cache, tok, 0, cfg, rc)
            l1, cache = decode_step(params, cache, tok + 1, 1, cfg, rc)
    finally:
        torch.set_num_threads(old)
    return {"moe_apply": _digest(y, torch.as_tensor(aux)),
            "decode_step": _digest(l0, l1)}


def test_qwen2_moe_router_is_the_parents():
    cfg = reduced(QWEN2_MOE_A2_7B)
    g = torch.Generator().manual_seed(8)
    params = {"router": torch.randn(cfg.d_model, cfg.moe.n_experts,
                                    generator=g)}
    x = torch.randn(7, cfg.d_model, generator=g).to(torch.bfloat16)
    for got, want in zip(route(params, x, cfg),
                         _parent_route(params, x, cfg)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("which", sorted(QWEN2_MOE_PINS))
def test_qwen2_moe_outputs_are_the_parents(which):
    assert qwen2_moe_outputs()[which] == QWEN2_MOE_PINS[which]
