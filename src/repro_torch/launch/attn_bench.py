"""Times the attention kernels at qwen2-7b's shapes against
`scaled_dot_product_attention` and another checkout's kernels.

    python -m repro_torch.launch.attn_bench [--baseline DIR]
        [--flash-seq 512,1024,2048,4096,8192] [--decode-s 4096,8192,32768]
        [--out FILE]

Needs a CUDA device.  qwen2-7b has 28 query and 4 kv heads of width 128;
every input is bf16, made on the card from a seed.  One child process per
checkout times:

* "flash"  — `flash_attention` on folded (28, s, 128) q and (4, s, 128)
  k, v, causal, at sq = sk = s for every s in --flash-seq (one layer of a
  one-prompt prefill);
* "decode" — `decode_attention` on folded (224, 1, 128) q and (32, S, 128)
  caches (batch 8), length S, for every S in --decode-s;
* "sdpa"   — `scaled_dot_product_attention` on the same tensors in the
  (b, heads, s, d) layout with `enable_gqa=True` (this checkout's children
  only: the port never calls it);
* "baseline" — the checkout at --baseline (its `src/` on PYTHONPATH), run
  in its own child processes before and after this checkout's (baseline,
  this, this, baseline), because device times of unchanged kernels spread
  between calls.

Each row gets "event_ms", CUDA events around back-to-back calls (what a
caller sees, host launch cost included), and "device_ms", the summed
device activity torch.profiler records per call.  The kernel rows of the
sizes whose plain version fits in memory (flash s <= 2048, decode all)
are also held against it with the kernel's own check.  Rows go to --out
as JSON lines; a table with each shape's bound (flash: 4·d operations
per unmasked (query, key) pair at 989 TFLOP/s; decode: the caches' bytes
at 3.35 TB/s) is printed with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

H, KV, D, BATCH = 28, 4, 128, 8           # qwen2-7b attention, decode batch
BF16_OPS_PER_S = 989e12                   # H100 SXM dense bf16
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
CHECK_MAX_FLASH = 2048                    # larger plain versions skip


def flash_bound_ms(s: int) -> float:
    """Operations bound of one causal call at sq = sk = s."""
    return 1e3 * 4 * D * (s * (s + 1) // 2) * H / BF16_OPS_PER_S


def decode_bound_ms(S: int) -> float:
    """Bytes bound of one call: both caches and q read once, out written."""
    moved = 2 * BATCH * KV * S * D * 2 + 2 * BATCH * H * D * 2
    return 1e3 * moved / HBM_BYTES_PER_S


def _event_ms(torch, fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    iters = int(min(200, max(5, 30.0 / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, calls=24):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if getattr(e.device_type, "name",
                            str(e.device_type)).endswith("CUDA")]
        if len(spans) >= calls:
            return sum(spans) / 1e3 / calls
    return float("nan")


def child(tag, flash_seqs, decode_ss, out) -> None:
    """Times this process's `repro_torch` (PYTHONPATH) and writes rows."""
    import importlib
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    dev = torch.device("cuda")
    with open(out, "a") as f:
        def emit(row):
            row["tree"] = tag
            f.write(json.dumps(row) + "\n")
            f.flush()

        def run(kind, size, variant, fn, check=None):
            row = {"kind": kind, "size": size, "variant": variant,
                   "event_ms": _event_ms(torch, fn),
                   "device_ms": _device_ms(torch, fn)}
            if check is not None:
                row["check"] = check()
            emit(row)

        for s in flash_seqs:
            gen = torch.Generator(device="cuda").manual_seed(s)
            q, k, v = (torch.randn((1, s, h, D), generator=gen, device=dev
                                   ).to(torch.bfloat16) for h in (H, KV, KV))
            qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, D).contiguous()
                          for t in (q, k, v))
            check = None
            if s <= CHECK_MAX_FLASH and hasattr(fa, "flash_attention_check"):
                def check():
                    r = fa.flash_attention_check(fa.flash_attention(qf, kf, vf),
                                                 qf, kf, vf)
                    torch.cuda.empty_cache()
                    return {"ok": r["ok"], "worst": r["worst"]}
            run("flash", s, "kernel" if tag == "this" else "baseline",
                lambda: fa.flash_attention(qf, kf, vf), check)
            if tag == "this":
                q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
                run("flash", s, "sdpa",
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True, enable_gqa=True))
            del q, k, v, qf, kf, vf
            torch.cuda.empty_cache()

        for S in decode_ss:
            gen = torch.Generator(device="cuda").manual_seed(S + 1)
            q = torch.randn((BATCH, 1, H, D), generator=gen, device=dev
                            ).to(torch.bfloat16)
            kc, vc = (torch.randn((BATCH, S, KV, D), generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            qf = q.transpose(1, 2).reshape(-1, 1, D).contiguous()
            kf, vf = (t.transpose(1, 2).reshape(-1, S, D).contiguous()
                      for t in (kc, vc))
            length = torch.tensor(S, dtype=torch.int32, device=dev)

            def check():
                r = da.decode_attention_check(
                    da.decode_attention(qf, kf, vf, length), qf, kf, vf, S)
                torch.cuda.empty_cache()
                return {"ok": r["ok"], "worst": r["worst"]}
            run("decode", S, "kernel" if tag == "this" else "baseline",
                lambda: da.decode_attention(qf, kf, vf, length), check)
            if tag == "this":
                q4, k4, v4 = (t.transpose(1, 2) for t in (q, kc, vc))
                run("decode", S, "sdpa",
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, enable_gqa=True))
            del q, kc, vc, qf, kf, vf
            torch.cuda.empty_cache()


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def report(path) -> None:
    """Per (kind, size, variant): the mean over the runs of each tree,
    the share of the bound, and the ratio to SDPA and to the baseline."""
    acc = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            acc.setdefault((r["kind"], r["size"], r["variant"]), []).append(r)

    def mean(key, t):
        rs = acc.get(key, [])
        return sum(r[t] for r in rs) / len(rs) if rs else float("nan")

    for (kind, size, variant) in sorted(acc):
        bound = (flash_bound_ms if kind == "flash" else decode_bound_ms)(size)
        ev, dv = mean((kind, size, variant), "event_ms"), mean(
            (kind, size, variant), "device_ms")
        checks = [r["check"] for r in acc[(kind, size, variant)]
                  if "check" in r]
        line = (f"{kind} {size} {variant}: event {ev!r} ms, device {dv!r} ms"
                f" ({len(acc[(kind, size, variant)])} runs); bound "
                f"{bound!r} ms, {bound / dv:.1%} of it by device time")
        for other in ("sdpa", "baseline"):
            if other != variant and (kind, size, other) in acc:
                line += (f"; x{ev / mean((kind, size, other), 'event_ms'):.3f}"
                         f" of {other} (events), x"
                         f"{dv / mean((kind, size, other), 'device_ms'):.3f}"
                         f" (device)")
        if checks:
            line += (f"; check ok {all(c['ok'] for c in checks)}, worst "
                     f"{max(c['worst'] for c in checks)!r}")
        print(line)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--baseline", default=None)
    p.add_argument("--flash-seq", default="512,1024,2048,4096,8192")
    p.add_argument("--decode-s", default="4096,8192,32768")
    p.add_argument("--out", default="runs/attn_bench.jsonl")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    flash_seqs = [int(v) for v in a.flash_seq.split(",") if v]
    decode_ss = [int(v) for v in a.decode_s.split(",") if v]
    if a.child is not None:
        child(a.child, flash_seqs, decode_ss, a.out)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("attn_bench needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    open(a.out, "w").close()
    trees = [("this", here)]
    if a.baseline:
        base = os.path.join(os.path.abspath(a.baseline), "src")
        trees = [("baseline", base), ("this", here), ("this", here),
                 ("baseline", base)]
    for tag, src in trees:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tag, "--flash-seq", a.flash_seq, "--decode-s",
                        a.decode_s, "--out", os.path.abspath(a.out)],
                       env=dict(os.environ, PYTHONPATH=src), check=True,
                       cwd=os.path.dirname(src))
        print(f"{tag} ({src}): {time.perf_counter() - t0:.1f} s")
    report(a.out)
    print(card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
