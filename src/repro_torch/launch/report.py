"""Render cell, bench and campaign JSONs as markdown tables (the port of
the JAX package's `launch/report.py`: plain host code on dicts, the same
strings for the same input).

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun

It reads dry-run cell JSONs (`<arch>.<shape>.<mesh>.json`), the serve
bench's BENCH_serve.json ($BENCH_SERVE_OUT) and a campaign report
($CAMPAIGN_REPORT); the engine telemetry tables read the sweep engine's
`cache_info()` blocks as the serve CLI and the campaign write them.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load_cells(outdir: str, tag: str = "") -> list[dict]:
    """tag='' loads only baseline cells (mesh part has no -variant
    suffix); tag='xyz' loads only '<mesh>-xyz' variants."""
    cells = []
    for path in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        base = os.path.basename(path)[:-5]
        parts = base.split(".")
        if len(parts) < 3:
            continue
        mesh_part = parts[2]
        cell_tag = mesh_part.split("-", 1)[1] if "-" in mesh_part else ""
        if cell_tag != tag:
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(cells: list[dict]) -> str:
    lines = ["| arch | shape | mesh | status | compile | HBM args/dev |",
             "|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] == "ok":
            mem = c.get("memory_analysis", {})
            args_gb = mem.get("argument_size_in_bytes", 0) / 1e9
            lines.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok | "
                f"{c.get('compile_s', '?')}s | {args_gb:.2f} GB |")
        elif c["status"] == "skipped":
            lines.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                         f"skipped (sub-quadratic rule) | — | — |")
        else:
            err = c.get("error", "?")[:60]
            lines.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                         f"ERROR: {err} | — | — |")
    return "\n".join(lines)


def roofline_table(cells: list[dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck |"
        " useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] != "ok" or c["mesh"] != mesh:
            continue
        r = c["roofline"]
        lines.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['bottleneck']} | {r['useful_fraction']:.2f} | "
            f"**{r['roofline_fraction']:.3f}** |")
    return "\n".join(lines)


def planner_cache_table(cells: list[dict]) -> str:
    """Per-decode-cell what/when/where summary + sweep-cache telemetry
    (the sweep engine's LRU hit/miss counters recorded at dry-run time —
    the cache-sizing signal for serving traffic)."""
    lines = ["| arch | shape | mesh | cim frac | cim routed | "
             "energy gain | plan hits/misses | engine cache |",
             "|---|---|---|---|---|---|---|---|"]
    found = False
    for c in cells:
        p = c.get("planner")
        if c["status"] != "ok" or not p:
            continue
        found = True
        s = p["summary"]
        eng = p["cache"]
        # executed-route fraction: how many projections the gated decode
        # step actually lowers to the CiM INT8 path (older cell JSONs
        # predate the routing block)
        routed = (f"{p['cim_routed_fraction']:.2f}"
                  if "cim_routed_fraction" in p else "-")
        # per-backend keyspace breakdown + pallas fallback marker (older
        # cell JSONs predate both fields)
        backends = " ".join(f"{b}:{v['hits']}h/{v['misses']}m"
                            for b, v in sorted(
                                (eng.get("backends") or {}).items()))
        if eng.get("pallas_fallback"):
            backends = (backends + " pallas→xla").strip()
        engine_cell = f"{eng['hits']}h/{eng['misses']}m size={eng['size']}"
        if backends:
            engine_cell += f" [{backends}]"
        # streaming-enumerator accounting (cells predating chunked
        # evaluation, or whole-batch engines, carry no tile count)
        ch = eng.get("chunks") or {}
        if ch.get("chunk_rows"):
            engine_cell += (f" chunks={ch.get('evaluated', 0)}"
                            f"@{ch['chunk_rows']}rows")
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{s['cim_fraction']:.2f} | {routed} | "
            f"{s['energy_gain_x']:.2f}x | "
            f"{p['plan_hits']}/{p['plan_misses']} | "
            f"{engine_cell} |")
    return "\n".join(lines) if found else "(no decode cells with planner telemetry)"


def shard_balance_table(cells: list[dict]) -> str:
    """Per-host telemetry of distributed sweep runs: each process's
    engine cache hit/miss (SPMD — every host keeps its own LRU with
    identical contents, so a divergent column is a bug signal) plus the
    row shard balance of the padded batches (a skewed balance means an
    uneven device set is bottlenecked on its largest host).

    Cells whose planner block ran on a single-host mesh carry
    `cache.distributed = None` and are skipped."""
    lines = ["| arch | shape | host | procs | devices | host cache | "
             "rows/process |",
             "|---|---|---|---|---|---|---|"]
    found = False
    for c in cells:
        p = c.get("planner")
        if c.get("status") != "ok" or not p:
            continue
        eng = p.get("cache") or {}
        d = eng.get("distributed")
        if not d:
            continue
        found = True
        balance = " ".join(f"p{k}:{v}" for k, v in
                           sorted(d.get("shard_balance", {}).items()))
        lines.append(
            f"| {c['arch']} | {c['shape']} | "
            f"p{d['process_index']}/{d['processes']} | "
            f"{d['processes']} | {d.get('mesh_devices', '?')} | "
            f"{eng['hits']}h/{eng['misses']}m | {balance} |")
    return ("\n".join(lines) if found
            else "(no distributed sweep telemetry in these cells)")


def serve_traffic_table(bench: dict) -> str:
    """Throughput-vs-latency rows from BENCH_serve.json's `traffic`
    block (the continuous-batching open-loop bench): one row per
    arrival rate, TTFT percentiles against engine tokens/s, plus the
    scheduler health columns (queue depth, slot occupancy, evictions).
    The fixed-batch reference row anchors the curves against the legacy
    lockstep session on the same core."""
    t = bench.get("traffic")
    if not t:
        return "(no traffic block in BENCH_serve.json — run " \
               "benchmarks.serve_traffic_bench)"
    lines = [f"arch={t['arch']} slots={t['n_slots']} "
             f"block_size={t['block_size']} "
             f"requests/rate={t['requests_per_rate']} seed={t['seed']}",
             "",
             "| arrival req/s | TTFT p50 | TTFT p95 | engine tok/s | "
             "req tok/s | occupancy | queue depth | evict |",
             "|---|---|---|---|---|---|---|---|"]
    for c in t.get("curves", []):
        lines.append(
            f"| {c['arrival_rate_req_per_s']:g} | "
            f"{fmt_s(c['ttft_p50_s'])} | {fmt_s(c['ttft_p95_s'])} | "
            f"{c['engine_tokens_per_s']:.1f} | "
            f"{c['request_tokens_per_s_mean']:.1f} | "
            f"{c['slot_occupancy_mean']:.2f} | "
            f"{c['queue_depth_mean']:.2f} | {c['evictions']} |")
    ref = t.get("fixed_batch_reference_tokens_per_s")
    if ref is not None:
        lines.append(f"\nfixed-batch reference (legacy lockstep, "
                     f"batch={t['n_slots']}): {ref:.1f} tok/s")
    return "\n".join(lines)


def serve_step_breakdown_table(bench: dict) -> str:
    """Decode hot-path health from the `traffic` block's per-rate
    `decode_step_breakdown`: where each step's host budget went
    (device dispatch vs blocking host fetch vs telemetry sampling),
    whether the loop ran pipelined (host fetch of step t overlapped
    with step t+1's compute), and whether KV-cache buffer donation took
    effect (no per-token pool copy; "off" = donation disabled, the CPU
    default)."""
    t = bench.get("traffic")
    curves = (t or {}).get("curves", [])
    if not any("decode_step_breakdown" in c for c in curves):
        return "(no decode_step_breakdown in BENCH_serve.json traffic " \
               "curves — regenerate with benchmarks.serve_traffic_bench)"
    lines = ["| arrival req/s | steps | pipelined | donation | "
             "dispatch/step | fetch/step | telemetry/step |",
             "|---|---|---|---|---|---|---|"]
    for c in curves:
        b = c.get("decode_step_breakdown")
        if not b:
            continue
        don = c.get("kv_donation_ok")
        lines.append(
            f"| {c['arrival_rate_req_per_s']:g} | {b['steps']} | "
            f"{'yes' if b['pipelined'] else 'no'} | "
            f"{'ok' if don else ('off' if don is None else 'FAIL')} | "
            f"{b['dispatch_ms_per_step']:.2f}ms | "
            f"{b['host_fetch_ms_per_step']:.2f}ms | "
            f"{b['telemetry_ms_per_step']:.2f}ms |")
    return "\n".join(lines)


def serve_adaptive_table(bench: dict) -> str:
    """Adaptive-planning rows from BENCH_serve.json's `adaptive` block
    (benchmarks.serve_adaptive_bench): adaptive vs frozen-plan engine
    throughput, the hot-swap counters of the forced-flip scenario, and
    the per-bucket hit/build/flip table of the plan service."""
    a = bench.get("adaptive")
    if not a:
        return "(no adaptive block in BENCH_serve.json — run " \
               "benchmarks.serve_adaptive_bench)"
    lines = [f"arch={a['arch']} slots={a['n_slots']} "
             f"requests={a['requests']} seed={a['seed']}",
             "",
             "| mode | engine tok/s | plan swaps | verdict flips | "
             "executables | swap mean | swap max |",
             "|---|---|---|---|---|---|---|"]
    for mode in ("no_flip", "forced_flip"):
        s = a.get(mode)
        if not s:
            continue
        lat = s.get("swap_latency_s") or {}
        mean = lat.get("mean")
        mx = lat.get("max")
        lines.append(
            f"| {mode.replace('_', '-')} | "
            f"{s['engine_tokens_per_s']:.1f} | {s['plan_swaps']} | "
            f"{s['verdict_flips']} | {s['decode_executables']} | "
            f"{fmt_s(mean) if mean else '—'} | "
            f"{fmt_s(mx) if mx else '—'} |")
    frozen = a.get("frozen_tokens_per_s")
    if frozen is not None:
        lines.append(f"\nfrozen-plan reference engine: {frozen:.1f} tok/s")
    buckets = ((a.get("forced_flip") or {}).get("service") or {}) \
        .get("buckets") or {}
    if buckets:
        lines += ["", "| bucket | hits | misses | builds | flips | "
                  "plan digest |", "|---|---|---|---|---|---|"]
        for name, b in buckets.items():
            lines.append(
                f"| {name} | {b['hits']} | {b['misses']} | "
                f"{b['builds']} | {b['flips']} | {b['table_digest']} |")
    return "\n".join(lines)


def campaign_table(report: dict) -> str:
    """Campaign summary from results/campaign/campaign_report.json
    (launch/campaign.py): grid provenance, constraint accounting,
    and the certification gate's verdict per champion design point."""
    if not report:
        return "(no campaign report — run " \
               "python -m repro_torch.launch.campaign)"
    r = report.get("report", {})
    spec = r.get("spec", {})
    stats = r.get("stats", {})
    fr = report.get("frontier_csv", {})
    lines = [
        f"grid: {spec.get('n_points', '?')} points "
        f"({len(spec.get('workloads', []))} cells x "
        f"{spec.get('n_units', '?')} units), "
        f"digest {spec.get('digest', '?')}, "
        f"backend {r.get('group_by', '?')}/{r.get('backend', '?')}",
        f"frontier: {fr.get('rows', '?')} rows, "
        f"sha256 {str(fr.get('sha256', '?'))[:16]}",
    ]
    filt = stats.get("constraint_filtered") or {}
    if filt:
        lines.append("contracts: " + ", ".join(
            f"{spec_} filtered {n}" for spec_, n in filt.items()))
    cert = report.get("certification") or {}
    pts = cert.get("points") or []
    if pts:
        lines += ["",
                  "| group | champion config | order | bitwise | "
                  "contracts | CiM deployed |",
                  "|---|---|---|---|---|---|"]
        for p in pts:
            pl = p.get("planner", {})
            lines.append(
                f"| {p['group']} | {p['config']} | {p['order_mode']} | "
                f"{'ok' if p['bitwise_ok'] else 'FAIL'} | "
                f"{'ok' if p['contracts_ok'] else 'FAIL'} | "
                f"{pl.get('n_use_cim', '?')}/{p.get('n_gemms', '?')} |")
        lines.append(f"\ncertification: "
                     f"{'OK' if cert.get('ok') else 'FAILED'} "
                     f"({len(pts)} champion points)")
    return "\n".join(lines)


def summarize(cells: list[dict]) -> dict:
    ok = [c for c in cells if c["status"] == "ok"]
    skipped = [c for c in cells if c["status"] == "skipped"]
    err = [c for c in cells if c["status"] == "error"]
    worst = sorted((c for c in ok if c["mesh"] == "single"),
                   key=lambda c: c["roofline"]["roofline_fraction"])
    coll = sorted((c for c in ok if c["mesh"] == "single"),
                  key=lambda c: -c["roofline"]["collective_s"])
    return {
        "n_ok": len(ok), "n_skipped": len(skipped), "n_error": len(err),
        "errors": [(c["arch"], c["shape"], c["mesh"]) for c in err],
        "worst_fraction": [(c["arch"], c["shape"],
                            round(c["roofline"]["roofline_fraction"], 4))
                           for c in worst[:5]],
        "most_collective_bound": [
            (c["arch"], c["shape"],
             round(c["roofline"]["collective_s"], 3)) for c in coll[:5]],
    }


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    cells = load_cells(outdir)
    print("## Dry-run status\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single pod, 256 chips)\n")
    print(roofline_table(cells, "single"))
    print("\n## Roofline (multi-pod, 512 chips)\n")
    print(roofline_table(cells, "multi"))
    print("\n## Planner (decode cells: what/when/where + sweep cache)\n")
    print(planner_cache_table(cells))
    print("\n## Distributed sweeps (per-host cache + shard balance)\n")
    print(shard_balance_table(cells))
    bench_path = os.environ.get("BENCH_SERVE_OUT", "BENCH_serve.json")
    if os.path.exists(bench_path):
        with open(bench_path) as f:
            bench = json.load(f)
        print("\n## Serving traffic (continuous batching, "
              "throughput vs latency)\n")
        print(serve_traffic_table(bench))
        print("\n## Decode step breakdown (dispatch vs host fetch vs "
              "telemetry)\n")
        print(serve_step_breakdown_table(bench))
        print("\n## Adaptive planning (bucket hit rates, verdict "
              "flips, plan swaps)\n")
        print(serve_adaptive_table(bench))
    campaign_path = os.environ.get("CAMPAIGN_REPORT",
                                   "results/campaign/campaign_report.json")
    if os.path.exists(campaign_path):
        with open(campaign_path) as f:
            campaign = json.load(f)
        print("\n## Design-space campaign (Pareto fronts + "
              "certification)\n")
        print(campaign_table(campaign))
    print("\n## Summary\n")
    print(json.dumps(summarize(cells), indent=1))
