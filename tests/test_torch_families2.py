"""The audio and vlm families end to end against the JAX package, on the
CPU, at `reduced(...)` of musicgen-large (4 codebooks: stacked per-codebook
embedding and head) and llama-3.2-vision-90b (a period of one self- and
one cross-attention layer, 8 image tokens), widened to d_model 256 as
tests/test_torch_lowbit_serving.py widens qwen2-7b: at 64 the planner
gates nothing, at 256 the decode table puts Wq, Wk, Wv, the MLP and
xattn-Q on the kernel route and leaves Wo and xattn-out on the dequant
route.  The audio lm_head contracts the spec "bld,ndv->blnv", so it
stays on the dequant route even where its label gates on.

Params come from the reference's `init`, converted with
`params_from_jax`; tokens and image embeddings from numpy seeds.  Logits
are held relative to the reference's largest magnitude, as in
tests/test_torch_families.py: f32 within 1e-5, bf16 within 2**-5.  The
audio embedding's sum over the codebooks is held bit for bit in bf16.
Greedy streams of the INT8-gated `ServeSession` (f32, batch 8) token for
token (audio per codebook), route reports label for label, the
prefill's route trace (with `xattn-KV`) call for call, the engine's
audio streams against the reference's engine, and the engine's refusal
of vlm, which the reference shares.  On the CPU a gated label runs the
kernel's plain version, the reference its Pallas kernel in interpret
mode.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward, init as jax_init
from repro.models import init_cache as jax_init_cache
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models.layers import route_trace as jax_route_trace
from repro.models.model import period_slots as jax_period_slots
from repro.quant import quantize_model_params as jax_quantize
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import DecodeCore as JaxDecodeCore
from repro.serving import ServeSession as JaxServeSession
from repro.serving import synthetic_requests as jax_synthetic_requests

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import (decode_step, forward, init, init_cache,
                                init_paged_cache, linear, period_slots,
                                route_trace)
from repro_torch.models.layers import CIM_ROUTE, DEQUANT_ROUTE
from repro_torch.models.model import _embed
from repro_torch.quant import quantize_model_params
from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                 ServeSession, sample_token,
                                 synthetic_requests)

AUDIO, VLM = "musicgen-large", "llama-3.2-vision-90b"
ARCHS_2 = (AUDIO, VLM)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
D_MODEL = 256
BATCH, PROMPT, NEW, MAX_LEN = 8, 6, 6, 16
BLOCK = 4
# the decode table's verdicts at d_model 256, batch 8 (the reference's)
GATED = {AUDIO: {"Wq", "Wk", "Wv", "mlp-gate", "mlp-up", "mlp-down"},
         VLM: {"Wq", "Wk", "Wv", "mlp-gate", "mlp-up", "mlp-down",
               "xattn-Q", "lm_head"}}


def _rc(dtype="float32", jax_side=False, kv="bfloat16"):
    cls = JaxRunConfig if jax_side else RunConfig
    return cls(attn_impl="naive", remat=False,
               kv_cache_dtype=kv if kv == "int8" else dtype)


def _configs(arch, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, d_model=D_MODEL)
    return (dataclasses.replace(jax_reduced(JAX_ARCHS[arch]), **kw),
            dataclasses.replace(reduced(ARCHS[arch]), **kw))


def _params(arch, dtype="float32"):
    jcfg, cfg = _configs(arch, dtype)
    jp = jax_init(jax.random.PRNGKey(11), jcfg)
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _n_img(cfg):
    return cfg.vision.n_image_tokens if cfg.family == "vlm" else 0


def _tokens(cfg, b, l, seed=0):
    shape = (b, l) + ((cfg.audio.n_codebooks,) if cfg.family == "audio"
                      else ())
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _image(cfg, b, dtype, seed=1):
    """(jax, torch) image embeddings of `b` prompts, or (None, None)."""
    if cfg.family != "vlm":
        return None, None
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.vision.n_image_tokens, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


def _close(got, want, tol):
    """max|got - want| <= tol · max|want| at every position."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(-1)
    assert (err <= tol * scale).all(), (err.max(), scale)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS_2)
def test_init_and_caches_match_reference_layout(arch):
    """The port's own init (the stacked audio embed and head, the cross
    slots' attention weights) and both caches, with a bf16 and an int8
    KV cache (a cross slot's image K/V stay bf16), have the reference's
    tree, shapes and dtypes."""
    jcfg, cfg = _configs(arch, "bfloat16")
    ours = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = params_from_jax(jax_init(jax.random.PRNGKey(0), jcfg), "cpu")
    assert _shapes(ours) == _shapes(ref)
    n_img = _n_img(cfg)
    for kv in ("bfloat16", "int8"):
        rc, jrc = _rc("bfloat16", kv=kv), _rc("bfloat16", True, kv=kv)
        for got, want in (
                (init_cache(cfg, rc, 3, 8, device="cpu",
                            n_image_tokens=n_img),
                 jax_init_cache(jcfg, jrc, 3, 8, n_image_tokens=n_img)),
                (init_paged_cache(cfg, rc, 3, 5, BLOCK, device="cpu",
                                  n_image_tokens=n_img),
                 jax_init_paged_cache(jcfg, jrc, 3, 5, BLOCK,
                                      n_image_tokens=n_img))):
            assert _shapes(got) == _shapes(params_from_jax(want, "cpu"))
    assert [(s.mixer, s.ffn) for s in period_slots(cfg)] == [
        (s.mixer, s.ffn) for s in jax_period_slots(jcfg)]


def test_params_from_jax_carries_the_new_leaves():
    """`params_from_jax` is generic over the tree: the audio model's
    stacked (nb, vocab, d) embedding and (nb, d, vocab) head, and the
    vlm's cross slots, arrive leaf for leaf (values bit for bit, INT8
    codes and scales too)."""
    for arch in ARCHS_2:
        jcfg, cfg, jp, tp = _params(arch, "bfloat16")
        leaves = [("embed",), ("lm_head",)]
        if arch == AUDIO:
            nb = cfg.audio.n_codebooks
            assert tp["embed"].shape == (nb, cfg.vocab, cfg.d_model)
            assert tp["lm_head"].shape == (nb, cfg.d_model, cfg.vocab)
        else:
            cross = [i for i, s in enumerate(period_slots(cfg))
                     if s.mixer == "cross"]
            assert cross == [1]
            leaves += [("slots", 1, "attn", w) for w in ("wq", "wk", "wv",
                                                         "wo")]
        for path in leaves:
            got, want = tp, jp
            for k in path:
                got, want = got[k], want[k]
            assert torch.equal(got.float(), torch.tensor(
                np.asarray(want.astype(jnp.float32))))
        qt = params_from_jax(jax_quantize(jp), "cpu")
        ours = quantize_model_params(tp)
        for key in ("q", "scale"):
            assert torch.equal(qt["lm_head"][key], ours["lm_head"][key])
            assert torch.equal(qt["slots"][-1]["attn"]["wk"][key],
                               ours["slots"][-1]["attn"]["wk"][key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS_2)
def test_forward_matches_reference(arch, dtype):
    """Prefill logits ((b, l, nb, vocab) for audio), the vlm's cross
    slots attending onto K/V projected from seeded image embeddings."""
    jcfg, cfg, jp, tp = _params(arch, dtype)
    toks = _tokens(cfg, 2, 16)
    jimg, img = _image(cfg, 2, dtype)
    jl, _ = jax_forward(jp, jnp.asarray(toks), jcfg, _rc(dtype, True),
                        image_embeds=jimg)
    tl, _ = forward(tp, torch.tensor(toks), cfg, _rc(dtype),
                    image_embeds=img)
    _close(tl, jl, TOL[dtype])


def test_audio_embedding_sum_is_bitwise_in_bf16():
    """The reference sums the codebooks' bf16 rows with one `jnp.sum`,
    which XLA accumulates in f32 and rounds once; the port's f32 sum in
    codebook order, rounded once, gives the same bits (a bf16 sum
    rounded after each add differs at ~30% of the elements)."""
    jcfg, cfg, jp, tp = _params(AUDIO, "bfloat16")
    toks = _tokens(cfg, 4, 64, seed=5)
    want = jnp.sum(jax.vmap(lambda e, t: e[t], in_axes=(0, 2), out_axes=2)(
        jp["embed"], jnp.asarray(toks)), axis=2)
    got = _embed(tp, torch.tensor(toks), cfg)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    rounded = tp["embed"][0][torch.tensor(toks[..., 0])]
    for i in range(1, cfg.audio.n_codebooks):
        rounded = rounded + tp["embed"][i][torch.tensor(toks[..., i])]
    assert not torch.equal(rounded, got)


def _fill_cross(cache, params, cfg, img):
    """Write each cross slot's image K/V projections into its cache rows
    (what the serving stacks of both packages never do), as the forward
    computes them."""
    for s, slot in enumerate(period_slots(cfg)):
        if slot.mixer != "cross":
            continue
        for i in range(cache[s]["k"].shape[0]):
            for key, w in (("k", "wk"), ("v", "wv")):
                kv = linear(params["slots"][s]["attn"][w][i], img, "xattn-KV")
                cache[s][key][i] = kv.reshape(cache[s][key][i].shape)
    return cache


@pytest.mark.parametrize("arch", ARCHS_2)
def test_decode_matches_forward(arch):
    """Token-by-token decode logits against the full forward within 1e-4
    · max|forward|, and each step against the reference's step within
    1e-5; a vlm cache is first filled with the image K/V the forward
    projects, so its cross slots attend to the same keys."""
    jcfg, cfg, jp, tp = _params(arch)
    toks = _tokens(cfg, 2, 12, seed=1)
    jimg, img = _image(cfg, 2, "float32")
    rc, jrc = _rc(), _rc(jax_side=True)
    full, _ = forward(tp, torch.tensor(toks), cfg, rc, image_embeds=img)
    n_img = _n_img(cfg)
    cache = init_cache(cfg, rc, 2, 16, device="cpu", n_image_tokens=n_img)
    jcache = jax_init_cache(jcfg, jrc, 2, 16, n_image_tokens=n_img)
    if img is not None:
        cache = _fill_cross(cache, tp, cfg, img)
        jcache = [{k: (jnp.asarray(cache[s][k].float().numpy(), jnp.bfloat16)
                       if period_slots(cfg)[s].mixer == "cross" else v)
                   for k, v in e.items()} for s, e in enumerate(jcache)]
    steps = []
    for t in range(12):
        lg, cache = decode_step(tp, cache, torch.tensor(toks[:, t:t + 1]), t,
                                cfg, rc)
        jl, jcache = jax_decode_step(jp, jcache, jnp.asarray(
            toks[:, t:t + 1]), jnp.int32(t), jcfg, jrc)
        _close(lg, jl, TOL["float32"])
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    # the cross cache holds bf16 K/V, the forward f32 ones
    _close(got, full.numpy(), 1e-4 if img is None else 2.0 ** -7)


def _sessions(arch):
    jcfg, cfg, jp, tp = _params(arch)
    n_img = _n_img(cfg)
    ours = ServeSession(cfg, _rc(), tp, max_len=MAX_LEN, batch=BATCH,
                        n_image_tokens=n_img, quantize=True, device="cpu")
    ref = JaxServeSession(jcfg, _rc(jax_side=True), jp, max_len=MAX_LEN,
                          batch=BATCH, n_image_tokens=n_img, quantize=True)
    return jcfg, cfg, ours, ref


@pytest.mark.parametrize("arch", ARCHS_2)
def test_gated_serve_streams_and_routes_equal_reference(arch):
    """INT8-gated `ServeSession` at batch 8: the same plan tables, the
    same route report (the vlm's xattn-Q on the kernel, xattn-out on the
    dequant route; the decode step projects no image K/V, so no
    xattn-KV), greedy streams token for token ((b, n, nb) for audio)."""
    _, cfg, ours, ref = _sessions(arch)
    assert ours.plan_table.digest == ref.plan_table.digest
    assert ours.prefill_plan_table.digest == ref.prefill_plan_table.digest
    rr = ours.route_report()
    assert rr == ref.route_report()
    assert {lab for lab, r in rr.items() if r["route"] == CIM_ROUTE} == (
        GATED[arch])
    assert rr["Wo"]["route"] == DEQUANT_ROUTE
    if arch == AUDIO:
        assert rr["lm_head"]["route"] == DEQUANT_ROUTE
    else:
        assert rr["xattn-out"]["route"] == DEQUANT_ROUTE
        assert "xattn-KV" not in rr
    prompt = _tokens(cfg, BATCH, PROMPT, seed=2)
    got = ours.generate(torch.tensor(prompt), NEW).numpy()
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), NEW))
    assert got.shape == want.shape == (BATCH, NEW) + prompt.shape[2:]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS_2)
def test_prefill_route_trace_equals_reference(arch):
    """The gated prefill forward under the prefill table: the port's
    route trace, call for call, is the reference's traced period (its
    scan traces the period once) repeated per period, then lm_head; the
    vlm's xattn-KV projections of the image embeddings are in it."""
    jcfg, cfg, jp, tp = _params(arch)
    core = DecodeCore(cfg, _rc(), tp, quantize=True, plan_batch=BATCH,
                      plan_max_len=MAX_LEN, device="cpu")
    jcore = JaxDecodeCore(jcfg, _rc(jax_side=True), jp, quantize=True,
                          plan_batch=BATCH, plan_max_len=MAX_LEN)
    toks = _tokens(cfg, 1, MAX_LEN, seed=3)
    jimg, img = _image(cfg, 1, "float32")
    with route_trace() as records, torch.inference_mode():
        forward(core.params, torch.tensor(toks), cfg, _rc(), image_embeds=img,
                plan=core.prefill_plan_table)
    with jax_route_trace() as jrecords:
        jax_forward(jcore.params, jnp.asarray(toks), jcfg,
                    _rc(jax_side=True), image_embeds=jimg,
                    plan=jcore.prefill_plan_table)
    got = [(r["label"], r["route"]) for r in records]
    want = [(r["label"], r["route"]) for r in jrecords]
    n = cfg.n_layers // len(period_slots(cfg))
    assert got == want[:-1] * n + want[-1:]
    if arch == VLM:
        assert ("xattn-KV", CIM_ROUTE) in got


@pytest.mark.parametrize("arch", ARCHS_2)
def test_paged_masked_step_matches_reference(arch):
    """The continuous-batching step (ragged positions, an active mask, a
    block pool, the audio tokens (n, 1, nb), the vlm's per-slot image
    K/V) on the same block tables: logits and pools."""
    jcfg, cfg, jp, tp = _params(arch)
    jp, tp = jax_quantize(jp), quantize_model_params(tp)
    rc, jrc = _rc(), _rc(jax_side=True)
    n, blocks, n_img = 4, 9, _n_img(cfg)
    cache = init_paged_cache(cfg, rc, n, blocks, BLOCK, device="cpu",
                             n_image_tokens=n_img)
    jcache = jax_init_paged_cache(jcfg, jrc, n, blocks, BLOCK,
                                  n_image_tokens=n_img)
    tables = np.array([[0, 1], [2, 3], [4, 5], [0, 1]], np.int32)
    active = np.array([True, True, False, True])
    pos = np.zeros(n, np.int32)
    for step in range(6):
        toks = _tokens(cfg, n, 1, seed=10 + step)
        act = active if step else np.array([True, True, True, False])
        lg, cache = decode_step(
            tp, cache, torch.tensor(toks), torch.tensor(pos), cfg, rc,
            active=torch.tensor(act), block_tables=torch.tensor(tables))
        jl, jcache = jax_decode_step(
            jp, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos), jcfg,
            jrc, active=jnp.asarray(act), block_tables=jnp.asarray(tables))
        for i in np.flatnonzero(act):
            _close(lg[i], np.asarray(jl)[i], TOL["float32"])
        pos = pos + act
    for ours, ref in zip(cache, jcache):
        for key in ours:
            _close(ours[key], ref[key], TOL["float32"])


def test_audio_engine_streams_equal_reference_engine():
    """More audio requests ((P, nb) prompts) than slots through both
    engines: every greedy stream token for token and codebook for
    codebook, the same completion order, and no EOS check (the reference
    skips it for audio: an eos_id equal to a generated token evicts
    nothing)."""
    jcfg, cfg, jp, tp = _params(AUDIO)
    core = DecodeCore(cfg, _rc(), tp, quantize=True, plan_batch=BATCH,
                      plan_max_len=MAX_LEN, device="cpu")
    jcore = JaxDecodeCore(jcfg, _rc(jax_side=True), jp, quantize=True,
                          plan_batch=BATCH, plan_max_len=MAX_LEN)
    assert core.plan_table.digest == jcore.plan_table.digest
    kw = dict(seed=5, prompt_len=(2, 6), new_tokens=(2, 8))
    eng = ContinuousBatchingEngine(core, n_slots=3, max_len=MAX_LEN,
                                   block_size=BLOCK)
    jeng = JaxEngine(jcore, n_slots=3, max_len=MAX_LEN, block_size=BLOCK)
    reqs = synthetic_requests(cfg, 7, **kw)
    jreqs = jax_synthetic_requests(jcfg, 7, **kw)
    assert all(np.array_equal(a.prompt, b.prompt) and a.prompt.shape[1] == 4
               for a, b in zip(reqs, jreqs))
    for r in reqs + jreqs:
        r.eos_id = 0
    jeng.run(jreqs, None)
    eng.run(reqs, None)
    want = {r.rid: np.asarray(r.tokens).tolist() for r in jeng.completed}
    got = {r.rid: np.asarray(r.tokens).tolist() for r in eng.completed}
    assert got == want
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]
    assert all(r.done_reason == "max_tokens" and len(r.tokens) ==
               r.max_new_tokens and np.asarray(r.tokens).shape[1] == 4
               for r in eng.completed)
    assert eng.evictions >= 4 and eng.steps == jeng.steps


def test_engine_refuses_vlm_as_the_reference_does():
    jcfg, cfg, jp, tp = _params(VLM)
    core = DecodeCore(cfg, _rc(), tp, device="cpu")
    jcore = JaxDecodeCore(jcfg, _rc(jax_side=True), jp)
    with pytest.raises(NotImplementedError, match="image embeddings"):
        JaxEngine(jcore, n_slots=2, max_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="image embeddings"):
        ContinuousBatchingEngine(core, n_slots=2, max_len=MAX_LEN)


def test_audio_sampling_shapes():
    """`sample_token` gives one token per codebook, (b, 1, nb), greedy
    (first maximum per codebook) and with temperature (a seeded draw)."""
    _, cfg = _configs(AUDIO)
    logits = torch.randn((3, 1, cfg.audio.n_codebooks, cfg.vocab),
                         generator=torch.Generator().manual_seed(0))
    tok = sample_token(cfg, logits, 0.0)
    assert tok.shape == (3, 1, cfg.audio.n_codebooks)
    assert torch.equal(tok[:, 0], logits[:, 0].argmax(-1))
    draws = [sample_token(cfg, logits, 0.8,
                          torch.Generator().manual_seed(4)) for _ in range(2)]
    assert draws[0].shape == tok.shape and torch.equal(*draws)


@pytest.mark.parametrize("arch", ARCHS_2)
def test_serve_cli_serves_the_new_families(arch, capsys, monkeypatch):
    """`python -m repro_torch.launch.serve --arch <audio|vlm> --smoke
    --quantize` runs (it refused both families before) and reports the
    reference CLI's keys, generated shape and routes."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--quantize", "--batch", "2",
            "--prompt-len", "4", "--new-tokens", "3"]
    serve.main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jax_serve.main()
    ref = json.loads(capsys.readouterr().out)
    assert sorted(ours) == sorted(ref)
    assert ours["generated_shape"] == ref["generated_shape"]
    assert ours["gating"]["routes"] == ref["gating"]["routes"]


def test_other_families_ignore_image_embeds():
    """A model without cross slots ignores `image_embeds`, as the
    reference does (the port raised on them before)."""
    cfg = reduced(ARCHS["qwen2-7b"])
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, 1, 6))
    img = torch.ones((1, 3, cfg.d_model), dtype=torch.bfloat16)
    with_img, _ = forward(params, toks, cfg, _rc("bfloat16"), image_embeds=img)
    without, _ = forward(params, toks, cfg, _rc("bfloat16"))
    assert torch.equal(with_img, without)
    with pytest.raises(ValueError, match="image_embeds"):
        forward(*_params(VLM)[3:], toks, _configs(VLM)[1], _rc())
