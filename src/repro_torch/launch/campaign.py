"""Design-space campaign CLI: stream a grid, emit the frontier.

  PYTHONPATH=src python -m repro_torch.launch.campaign --backend pallas \
      --out runs/campaign

This is the port of the JAX package's `launch/campaign.py`, with the same
flags plus `--device` ("cuda" by default; "cpu" runs the plain torch
versions).  On the card, `--backend pallas` scores the CiM rows with the
hand-written sweep kernel and `--backend vectorized` with the eager
torch spec.

The default grid is the full production campaign — every arch x shape
cell of the config registry crossed with the four Table-IV prototypes,
three cache levels, five primitive-budget scales, both input-driver
serialization modes (RF only), two K:N balance thresholds, and both
DRAM order modes: 142,720 points, streamed through the chunked sweep
engine in bounded blocks (peak memory is O(block + chunk + front), not
O(grid)).  Outputs land in --out:

  frontier.csv         the Pareto fronts, canonical order, sha256-pinned
  campaign_report.json provenance (git sha, torch and CUDA versions,
                       the card's name and power limit, grid digest), run
                       stats,
                       constraint accounting, and the certification
                       gate's verdicts for each group's champion row

Constraint contracts are repeatable `--constraint metric<=bound` flags
(metrics: energy_pj, time_ns, area_bytes, gflops, tops_per_w), applied
before front reduction and re-asserted by certification.  Use
--dry-run to print the grid spec (including point count and digest)
without evaluating anything.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from datetime import datetime, timezone

import torch

from ..configs import ARCHS, SHAPES
from ..core.campaign import (CIM_LEVELS, CampaignSpec, Constraint,
                             certify_front, run_campaign)
from ..core.sweep import CIM_BACKENDS, SweepEngine

DEFAULT_SCALES = (0.5, 1.0, 2.0, 4.0, 8.0)


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.check_output(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], text=True, stderr=subprocess.DEVNULL,
            timeout=60).strip().splitlines()[0]
    except Exception:
        return None


def provenance(device) -> dict:
    try:
        # --dirty marks artifacts produced by uncommitted code: the bare
        # sha alone would claim a commit that cannot reproduce the run
        sha = subprocess.check_output(
            ["git", "describe", "--always", "--dirty"], text=True,
            stderr=subprocess.DEVNULL).strip()
    except Exception:
        sha = "unknown"
    return {"git_sha": sha,
            "host": socket.gethostname(),
            "timestamp_utc": datetime.now(timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": str(device),
            "card": (f"{torch.cuda.get_device_name(device)} "
                     f"({_card()})" if device.type == "cuda" else None)}


def default_workloads() -> tuple[tuple[str, str], ...]:
    """Every arch x shape cell in the registry, registry order."""
    return tuple((a, s) for a in ARCHS for s in SHAPES)


def parse_workloads(items: list[str]) -> tuple[tuple[str, str], ...]:
    out = []
    for item in items:
        arch, sep, shape = item.partition("/")
        if not sep:
            raise SystemExit(f"bad --workload {item!r}: expected "
                             f"'arch/shape'")
        out.append((arch, shape))
    return tuple(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Streaming design-space campaign: Pareto frontiers "
                    "over (energy, latency, area) with constraint "
                    "contracts and a certification gate.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--workload", action="append", default=None,
                   metavar="ARCH/SHAPE",
                   help="workload cell (repeatable); default: every "
                        "arch x shape cell in the registry")
    p.add_argument("--prototypes", nargs="+",
                   default=["Analog-6T", "Analog-8T", "Digital-6T",
                            "Digital-8T"])
    p.add_argument("--levels", nargs="+", default=list(CIM_LEVELS),
                   choices=list(CIM_LEVELS))
    p.add_argument("--scales", nargs="+", type=float,
                   default=list(DEFAULT_SCALES),
                   help="primitive-budget scales vs the level's "
                        "iso-area count")
    p.add_argument("--serialize", choices=["ser", "par", "both"],
                   default="both",
                   help="input-driver serialization modes (RF only; "
                        "a no-op at SMEM)")
    p.add_argument("--kn-thresholds", nargs="+", type=int,
                   default=[4, 8],
                   help="mapping K:N balance thresholds")
    p.add_argument("--order-modes", nargs="+",
                   default=["exact", "greedy"],
                   choices=["exact", "greedy", "fixed"])
    p.add_argument("--precisions", nargs="+", type=int, default=[8],
                   help="GEMM bit widths (cost model calibrated at 8)")
    p.add_argument("--constraint", action="append", default=[],
                   metavar="METRIC<=BOUND",
                   help="constraint contract, repeatable (e.g. "
                        "'time_ns<=2e9', 'area_bytes<=1e5')")
    p.add_argument("--backend", choices=list(CIM_BACKENDS),
                   default="vectorized")
    p.add_argument("--group-by", choices=["workload", "gemm"],
                   default="workload")
    p.add_argument("--block-points", type=int, default=4096,
                   help="points buffered per engine call")
    p.add_argument("--chunk-rows", type=int, default=4096,
                   help="sweep-engine device chunk size")
    p.add_argument("--certify-objectives", nargs="+",
                   default=["energy_pj"],
                   help="certify each group's champion per objective")
    p.add_argument("--max-certify-groups", type=int, default=None,
                   help="cap certified groups (default: all)")
    p.add_argument("--device", default="cuda",
                   help="where the sweep engine runs ('cpu' runs the plain "
                        "torch versions)")
    p.add_argument("--out", default="runs/campaign")
    p.add_argument("--dry-run", action="store_true",
                   help="print the grid spec and exit without "
                        "evaluating")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    workloads = (parse_workloads(args.workload) if args.workload
                 else default_workloads())
    serialize_modes = {"ser": (True,), "par": (False,),
                       "both": (True, False)}[args.serialize]
    spec = CampaignSpec(
        workloads=workloads,
        prototypes=tuple(args.prototypes),
        levels=tuple(args.levels),
        scales=tuple(args.scales),
        serialize_modes=serialize_modes,
        kn_thresholds=tuple(args.kn_thresholds),
        order_modes=tuple(args.order_modes),
        precisions=tuple(args.precisions),
    )
    contracts = tuple(Constraint.parse(c) for c in args.constraint)

    print(f"[campaign] grid: {spec.n_points} points "
          f"({len(workloads)} workload cells x {spec.n_units} units), "
          f"digest {spec.digest()}", flush=True)
    if args.dry_run:
        print(json.dumps(spec.describe(), indent=1))
        return 0

    engine = SweepEngine(chunk_rows=args.chunk_rows, device=args.device)
    t0 = time.perf_counter()
    result = run_campaign(spec, contracts, engine=engine,
                          backend=args.backend,
                          block_points=args.block_points,
                          group_by=args.group_by)
    run_s = time.perf_counter() - t0
    print(f"[campaign] evaluated in {run_s:.1f}s — "
          f"{len(result.front)} front rows across "
          f"{result.stats['n_groups']} groups, "
          f"{result.stats['engine_chunks']['evaluated']} engine chunks",
          flush=True)

    t0 = time.perf_counter()
    cert = certify_front(result, objectives=args.certify_objectives,
                         max_groups=args.max_certify_groups)
    cert_s = time.perf_counter() - t0
    status = "OK" if cert["ok"] else "FAILED"
    print(f"[campaign] certification {status}: "
          f"{len(cert['points'])} champion points re-evaluated "
          f"in {cert_s:.1f}s", flush=True)

    os.makedirs(args.out, exist_ok=True)
    csv_path = os.path.join(args.out, "frontier.csv")
    sha = result.write_csv(csv_path)
    report = {
        "provenance": provenance(engine.device),
        "frontier_csv": {"path": csv_path, "sha256": sha,
                         "rows": len(result.front)},
        "run_seconds": round(run_s, 2),
        "certify_seconds": round(cert_s, 2),
        "report": result.report(),
        "certification": cert,
    }
    report_path = os.path.join(args.out, "campaign_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    print(f"[campaign] wrote {csv_path} (sha256 {sha[:16]}) "
          f"and {report_path}", flush=True)
    return 0 if cert["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
