"""Where a served cell's top-token gaps come from: the gaps `check.py`
reads (how far the program's top token lies below the reference's best
logit), with one factor of the program changed at a time, at the same
positions of the same token sequences.

For each seed: the cell's weights (`weights.make`), prompts of --prompt
random tokens in --slots slots, then --new tokens chosen greedily by the
program as the cell runs it (INT8, planned, bf16, a block pool in blocks
of the cell's size, each step eager).  Every variant is then fed those
sequences and its own top token is read at each generated position:

    cell         the program as the cell runs it (the sequences' source)
    plain        the latent attention on `latent_attend` over the gathered
                 strips in place of the paged MLA kernel
    bf16_scales  W_UK / W_UV formed from W_kvb's codes times its scales
                 rounded to bf16 first, as the dequant route rounds them
    f32_mla      the latent attention (its projections, latent rows,
                 pool and attention) in f32 from the bf16 normed input
    forced       the reference's expert ids at every MoE layer, each
                 weighted by the program's own router scores
    f32          the whole program in f32 (f32 compute and pool)

and two broken programs, which the check has to find: rope_dropped (the
latent scores without the rope columns) and bias_in_weights (the
experts weighted by the biased scores they were chosen by).

beside the control (the reference at INT4, `check.py`).  The expert ids
the cell's program picks are compared with the reference's at every MoE
layer, and the cell's gaps are split by whether all layers agree.

    python chipbench/gap_sources.py --workload <cell> --seeds 11,12 \\
        [--slots 128 --prompt 24 --new 40] [--out chiprun_out/gaps.jsonl]

A JSON line per seed goes to standard output and to --out.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANTILES = (50, 60, 70, 75, 80, 90, 95, 99, 100)


def _stats(g) -> dict:
    import numpy as np
    if not g.size:
        return {"n": 0}
    return {"n": int(g.size), "mean": float(g.mean()),
            "nonzero": float(np.mean(g > 0)),
            **{f"p{q}": float(np.percentile(g, q)) for q in QUANTILES}}


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _steps(params, cfg, rc, plan, seq, P: int, N: int, bs: int, device,
           greedy: bool):
    """Feed every slot seq[:, t] at position t for t < P + N - 1 through
    `decode_step` (eager, a block pool of bs-row blocks); with `greedy`
    the tokens after the prompt are the program's own argmax, written
    into seq.  Returns the argmax at positions P - 1 .. P + N - 2 (B,
    N)."""
    import torch
    from repro_torch.models import decode_step, init_paged_cache
    B = seq.shape[0]
    mb = -(-(P + N) // bs)
    pools = init_paged_cache(cfg, rc, B, B * mb, bs, device=device)
    tables = torch.arange(B * mb, dtype=torch.int32,
                          device=device).view(B, mb)
    active = torch.ones(B, dtype=torch.bool, device=device)
    chosen = []
    with torch.inference_mode():
        for t in range(P + N - 1):
            pos = torch.full((B,), t, dtype=torch.int32, device=device)
            logits, pools = decode_step(params, pools, seq[:, t:t + 1], pos,
                                        cfg, rc, plan=plan, active=active,
                                        block_tables=tables)
            top = logits[:, 0].float().argmax(-1)
            if t >= P - 1:
                chosen.append(top)
                if greedy:
                    seq[:, t + 1] = top
    del pools
    return torch.stack(chosen, 1)


@contextlib.contextmanager
def _rope_dropped(model_mod):
    """The latent attention on `latent_attend` with the scores taken over
    the latent columns only (a broken program)."""
    attend = model_mod.latent_attend

    def no_rope(q, rows, lens, scale, v_dim):
        q = q.clone()
        q[..., v_dim:] = 0
        return attend(q, rows, lens, scale, v_dim)
    with _patched(model_mod, "paged_kernel_fits", lambda *a: False), \
            _patched(model_mod, "latent_attend", no_rope):
        yield


def _bf16_scale_absorbed(params, cfg):
    """core params with each MLA slot's absorbed operands formed from the
    codes times the scales rounded to bf16 first (products rounded to
    bf16), in the compute dtype."""
    import torch
    from repro_torch.models.layers import dtype_of
    a, nh = cfg.mla, cfg.n_heads

    def redo(ap):
        w = ap["wkv_b"]
        wf = (w["q"].to(torch.bfloat16) * w["scale"].to(
            torch.bfloat16)[..., None, :]).to(dtype_of(cfg.compute_dtype))
        uk, uv = wf.unflatten(-1, (nh, -1)).split(
            [a.qk_nope_head_dim, a.v_head_dim], -1)
        return {**ap, "absorbed": {"uk": uk.movedim(-3, -1).contiguous(),
                                   "uv": uv.movedim(-2, -3).contiguous()}}
    out = dict(params)
    out["lead"] = {**params["lead"], "attn": redo(params["lead"]["attn"])}
    out["slots"] = [{**sp, "attn": redo(sp["attn"])} if "attn" in sp
                    else sp for sp in params["slots"]]
    return out


def reading(m: dict, arch: str, cell: dict, seed: int, B: int, P: int,
            N: int, device="cuda") -> dict:
    """One seed's gaps per variant (see the module docstring) for the
    model block `m` of architecture `arch` served as `cell` sets it."""
    import dataclasses

    import torch

    from chipbench import reference, spec, weights
    from chipbench.drivers.common import program_config, release, run_config
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import DecodeCore
    ref = spec.arch(arch)
    cfg, rc = program_config(m), run_config(cell)
    bs = cell["block_size"]
    t0 = time.perf_counter()
    params = weights.make(arch, m, seed, device)
    gen = torch.Generator(device="cpu").manual_seed(seed % 2 ** 63)
    seq = torch.zeros(B, P + N, dtype=torch.long)
    seq[:, :P] = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    seq = seq.to(device)
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=cell["slots"],
                      plan_max_len=cell["max_len"], device=device)
    chosen, timing = {}, {}

    # the cell's program: the sequences, and its expert ids
    prog_ids = []
    real_route = moe_mod.route

    def recording(p, xt, c):
        out = real_route(p, xt, c)
        prog_ids.append(out[2].sort(-1).values)
        return out
    t = time.perf_counter()
    with _patched(moe_mod, "route", recording):
        chosen["cell"] = _steps(core.params, cfg, rc, core.plan_table, seq,
                                P, N, bs, device, greedy=True)
    timing["cell"] = time.perf_counter() - t
    seqs = [s[:P + N - 1] for s in seq]
    reads = [torch.arange(P - 1, P + N - 1, device=device)] * B

    # the reference: its final hidden states and its expert ids
    ref_ids = []
    real_ref_route = ref.route

    def ref_recording(h, layer, mm):
        ids, vals = real_ref_route(h, layer, mm)
        ref_ids.append(ids)
        return ids, vals
    t = time.perf_counter()
    with _patched(ref, "route", ref_recording):
        h8 = torch.cat(ref.final_hidden(m, params, seqs, reads, 8))
    h4 = torch.cat(ref.final_hidden(m, params, seqs, reads, 4))
    timing["reference"] = time.perf_counter() - t
    L = P + N - 1
    ref_sorted = torch.stack([i.view(B, L, -1).sort(-1).values
                              for i in ref_ids])        # (layers, B, L, k)
    n_moe = ref_sorted.shape[0]
    prog = torch.stack(prog_ids).view(L, n_moe, B, -1)  # (L, layers, B, k)
    prog = prog.permute(1, 2, 0, 3)                      # (layers, B, L, k)
    differ = (prog != ref_sorted).any(-1)[:, :, P - 1:]  # (layers, B, N)
    agree = ~differ.any(0)                                # (B, N)

    # the other variants, fed the cell's sequences
    def forced_route(p, xt, c):
        probs, _, _ = real_route(p, xt, c)
        k = forced_route.calls
        forced_route.calls += 1
        ids = ref_sorted[k % n_moe, :, k // n_moe]
        vals = probs.gather(1, ids)
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        return probs, vals * c.moe.routed_scale, ids
    forced_route.calls = 0
    real_step = model_mod._mla_step

    def f32_step(ap, layer, h, pos, pvec, lens, c, plan, active, tables):
        ap32 = {k: v for k, v in ap.items() if k != "absorbed"}
        return real_step(ap32, layer, h.float(), pos, pvec, lens, c, None,
                         active, tables).to(h.dtype)
    def biased_route(p, xt, c):
        probs, _, ids = real_route(p, xt, c)
        w = (probs + p["score_bias"].float()).gather(1, ids)
        return probs, w / w.sum(-1, keepdim=True) * c.moe.routed_scale, ids
    rc32 = dataclasses.replace(rc, kv_cache_dtype="float32")
    runs = {
        "plain": (core.params, rc, _patched(
            model_mod, "paged_kernel_fits", lambda *a: False)),
        "bf16_scales": (_bf16_scale_absorbed(core.params, cfg), rc,
                        contextlib.nullcontext()),
        "f32_mla": (core.params, rc32, _patched(model_mod, "_mla_step",
                                                f32_step)),
        "forced": (core.params, rc, _patched(moe_mod, "route",
                                             forced_route)),
        "rope_dropped": (core.params, rc, _rope_dropped(model_mod)),
        "bias_in_weights": (core.params, rc, _patched(moe_mod, "route",
                                                      biased_route))}
    for key, (p, r, ctx) in runs.items():
        t = time.perf_counter()
        with ctx:
            chosen[key] = _steps(p, cfg, r, core.plan_table, seq, P, N, bs,
                                 device, greedy=False)
        timing[key] = time.perf_counter() - t
    del core, runs
    release()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    core = DecodeCore(cfg32, rc32, params, quantize=True,
                      plan_batch=cell["slots"], plan_max_len=cell["max_len"],
                      device=device)
    t = time.perf_counter()
    chosen["f32"] = _steps(core.params, cfg32, rc32, core.plan_table, seq,
                           P, N, bs, device, greedy=False)
    timing["f32"] = time.perf_counter() - t
    del core
    release()

    # the gaps below the reference's best logit
    w8, w4 = ref.head(params, 8), ref.head(params, 4)
    flat = {k: v.reshape(-1) for k, v in chosen.items()}
    gaps = {k: [] for k in list(flat) + ["control"]}
    for a, lg in reference.logits(h8, w8):
        best = lg.max(-1).values
        rows = slice(a, a + lg.shape[0])
        for k, c in flat.items():
            gaps[k].append(best - lg.gather(1, c[rows, None])[:, 0])
        with reference.no_tf32(), torch.inference_mode():
            cc = (h4[rows] @ w4).argmax(-1)
        gaps["control"].append(best - lg.gather(1, cc[:, None])[:, 0])
    gaps = {k: torch.cat(v).cpu().numpy() for k, v in gaps.items()}
    ok = agree.reshape(-1).cpu().numpy()
    out = {"seed": seed, "slots": B, "prompt": P,
           "new": N, "positions": int(ok.size),
           "variants": {k: _stats(g) for k, g in gaps.items()},
           "routing": {
               "all_layers_agree": float(ok.mean()),
               "layer_disagree_share": float(differ.float().mean()),
               "cell_where_agree": _stats(gaps["cell"][ok]),
               "cell_where_differ": _stats(gaps["cell"][~ok]),
               "control_where_agree": _stats(gaps["control"][ok])},
           "seconds": {**timing, "all": time.perf_counter() - t0}}
    prog_ids.clear()
    del params, h8, h4, w8, w4
    release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slots", type=int, default=128)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--new", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from chipbench import spec
    bench = spec.load_benchmark()
    config = spec.load_config(bench, spec.workload(bench,
                                                   args.workload)["config"])
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, **reading(
            config["model"], config["arch"], cell, seed, args.slots,
            args.prompt, args.new, args.device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
