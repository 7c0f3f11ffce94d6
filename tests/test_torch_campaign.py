"""The port's Pareto reduction and design-space campaigns, on the CPU.

* `pareto_mask` against the JAX package's and against `pareto_mask_ref`,
  ties, duplicates, single points and empty input included;
* `ParetoAccumulator` fronts independent of chunk cuts and row order;
* tests/golden/campaign_front.csv byte for byte on both batched backends
  and on a chunk_rows=512 engine with >= 2 chunks;
* a workload-grouped campaign's CSV byte-equal to the reference's;
* `certify_point` bitwise, and tamper detection;
* `python -m repro_torch.launch.campaign --dry-run` names the reference's
  default grid (digest fe02f387b69771a6), and a small run writes a
  certified frontier.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from repro.core import campaign as jcampaign
from repro.core import pareto as jpareto
from repro.core.sweep import SweepEngine as JaxSweepEngine

from repro_torch.core import campaign, pareto
from repro_torch.core.sweep import SweepEngine
from repro_torch.launch import campaign as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "campaign_front.csv")
DEFAULT_DIGEST = "fe02f387b69771a6"

# the grid of tests/test_campaign_golden.py: 20 GEMMs x 144 units
GOLDEN_AXES = dict(
    workloads=(("mistral-nemo-12b", "train_4k"),
               ("mistral-nemo-12b", "decode_32k")),
    prototypes=("Analog-6T", "Analog-8T", "Digital-6T", "Digital-8T"),
    precisions=("int8", "int4", "fp8"),
    levels=("RF", "SMEM-A", "SMEM-B"),
    scales=(1.0, 4.0),
    serialize_modes=(True,),
    kn_thresholds=(4,),
    order_modes=("exact", "greedy"),
)
SPEC = campaign.CampaignSpec(**GOLDEN_AXES)
N_POINTS = 2880


def _point_sets():
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 4, (64, 3)).astype(np.float32)
    return {
        "empty": np.zeros((0, 3), np.float32),
        "single": np.asarray([[1.0, 2.0, 3.0]], np.float32),
        "duplicates": np.asarray([[1, 2, 3], [1, 2, 3], [0, 5, 5],
                                  [1, 2, 4]], np.float32),
        "ties": ties,
        "random": rng.random((200, 3)).astype(np.float32),
        "two_objectives": rng.integers(0, 9, (100, 2)).astype(np.float32),
        "inf_rows": np.asarray([[1, np.inf, 2], [np.inf, np.inf, np.inf],
                                [2, 1, 2]], np.float32),
    }


@pytest.mark.parametrize("name", list(_point_sets()))
def test_pareto_mask_matches_reference(name):
    pts = _point_sets()[name]
    want = jpareto.pareto_mask_np(pts)
    assert np.array_equal(pareto.pareto_mask_np(pts), want)
    if len(pts):
        assert np.array_equal(
            pareto.pareto_mask(torch.from_numpy(pts)).numpy(),
            np.asarray(jpareto.pareto_mask(pts)))
        assert np.array_equal(pareto.pareto_mask_ref(pts),
                              jpareto.pareto_mask_ref(pts))
        assert np.array_equal(pareto.pareto_mask_ref(pts), want)
    for i in range(min(len(pts), 5)):
        for j in range(min(len(pts), 5)):
            assert pareto.dominates(pts[i], pts[j]) == \
                jpareto.dominates(pts[i], pts[j])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulator_is_order_and_cut_invariant(seed):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 6, (300, 3)).astype(np.float32)
    idx = np.arange(len(pts)) * 3 + 7
    whole = pareto.ParetoAccumulator(3)
    whole.update(pts, idx)
    perm = rng.permutation(len(pts))
    cuts = np.sort(rng.choice(np.arange(1, len(pts)), 5, replace=False))
    acc = pareto.ParetoAccumulator(3)
    for part in np.split(perm, cuts):
        acc.update(pts[part], idx[part])
    a_pts, a_idx = acc.front()
    w_pts, w_idx = whole.front()
    assert np.array_equal(a_idx, w_idx) and np.array_equal(a_pts, w_pts)
    assert np.array_equal(np.sort(w_idx),
                          idx[jpareto.pareto_mask_np(pts)])
    assert acc.rows_seen == len(pts) and acc.chunks_merged == 6
    with pytest.raises(ValueError):
        acc.update(np.full((1, 3), np.inf, np.float32), [0])


@pytest.mark.parametrize("backend,chunk_rows", [("vectorized", None),
                                                ("pallas", None),
                                                ("vectorized", 512)])
def test_golden_front_byte_for_byte(backend, chunk_rows):
    engine = SweepEngine(chunk_rows=chunk_rows, device="cpu")
    result = campaign.run_campaign(SPEC, engine=engine, backend=backend,
                                   block_points=256, group_by="gemm")
    assert result.stats["n_points"] == N_POINTS
    with open(GOLDEN, newline="") as f:
        golden = f.read()
    assert result.csv_text() == golden
    assert result.device == "cpu"
    chunks = engine.cache_info()["chunks"]
    assert chunks["chunk_rows"] == chunk_rows and chunks["evaluated"] >= 2


def test_workload_grouped_csv_equals_reference():
    axes = dict(workloads=(("qwen2-7b", "decode_32k"),
                           ("mamba2-780m", "train_4k")),
                scales=(0.5, 2.0), serialize_modes=(True, False),
                kn_thresholds=(4, 8), precisions=(8, "fp8"))
    contracts = ("time_ns<=1e12",)
    ours = campaign.run_campaign(
        campaign.CampaignSpec(**axes),
        [campaign.Constraint.parse(c) for c in contracts],
        engine=SweepEngine(chunk_rows=1000, device="cpu"),
        backend="pallas", block_points=500)
    ref = jcampaign.run_campaign(
        jcampaign.CampaignSpec(**axes),
        [jcampaign.Constraint.parse(c) for c in contracts],
        engine=JaxSweepEngine(mesh=None, chunk_rows=1000),
        backend="pallas", block_points=500)
    assert ours.csv_text() == ref.csv_text()
    assert ours.stats["constraint_filtered"] == \
        ref.stats["constraint_filtered"]
    assert ours.spec.digest() == ref.spec.digest()


@pytest.fixture(scope="module")
def front():
    return campaign.run_campaign(SPEC, engine=SweepEngine(device="cpu"),
                                 block_points=256, group_by="gemm",
                                 device="cpu")


def test_certify_point_bitwise_and_tamper(front):
    row = front.front[0]
    ok = campaign.certify_point(row, device="cpu")
    assert ok["certified"] and ok["bitwise_ok"], ok
    assert ok["recomputed"]["energy_pj"] == float(row["energy_pj"])
    tampered = dict(row, energy_pj=np.nextafter(float(row["energy_pj"]),
                                                np.inf))
    bad = campaign.certify_point(tampered, device="cpu")
    assert not bad["bitwise_ok"] and not bad["certified"]
    contract = campaign.Constraint.parse(
        f"time_ns<={float(row['time_ns']) / 2}")
    bad = campaign.certify_point(row, [contract], device="cpu")
    assert bad["bitwise_ok"] and not bad["contracts_ok"]
    assert bad["planner"]["filtered_summary_error"] is not None
    cert = campaign.certify_front(front, max_groups=2)
    assert cert["ok"] and cert["groups_certified"] == 2


def test_cli_dry_run_digest(capsys):
    assert cli.main(["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert f"digest {DEFAULT_DIGEST}" in out
    spec = json.loads(out[out.index("{"):])
    assert spec["n_points"] == 142720 and spec["digest"] == DEFAULT_DIGEST
    assert spec["digest"] == jcampaign.CampaignSpec(
        workloads=tuple(map(tuple, spec["workloads"])),
        scales=tuple(spec["scales"]), serialize_modes=(True, False),
        kn_thresholds=(4, 8), order_modes=("exact", "greedy"),
        precisions=(8,)).digest()


def test_cli_small_run_on_cpu(tmp_path, capsys):
    rc = cli.main(["--workload", "qwen2-7b/decode_32k", "--prototypes",
                   "Digital-6T", "Analog-8T", "--scales", "1", "4",
                   "--backend", "pallas", "--group-by", "gemm",
                   "--device", "cpu", "--chunk-rows", "64",
                   "--max-certify-groups", "1", "--out", str(tmp_path)])
    assert rc == 0
    with open(tmp_path / "campaign_report.json") as f:
        report = json.load(f)
    assert report["provenance"]["device"] == "cpu"
    assert report["provenance"]["torch"] == torch.__version__
    assert report["certification"]["ok"]
    assert report["report"]["stats"]["engine_chunks"]["evaluated"] >= 2
    with open(tmp_path / "frontier.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == report["frontier_csv"]["rows"] > 0
    assert "certification OK" in capsys.readouterr().out


def test_constraint_and_precision_parsing_match_reference():
    for text in ("time_ns<=2e6", "area_bytes>=1e5", "gflops<=3"):
        assert campaign.Constraint.parse(text).spec() == \
            jcampaign.Constraint.parse(text).spec()
    for bad in ("speed<=1", "time_ns==3", "time_ns<=abc"):
        with pytest.raises(ValueError):
            campaign.Constraint.parse(bad)
    for tok in (4, 8, "int4", "INT8", "fp8", "8"):
        assert campaign.parse_precision(tok) == \
            jcampaign.parse_precision(tok)
    with pytest.raises(ValueError):
        campaign.parse_precision("int3")
