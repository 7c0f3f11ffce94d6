"""The port's hand-written Hopper kernels against their plain versions, on
the card.  These tests carry the `cuda` marker and skip where torch has no
CUDA device; on a machine with an H100 run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the INT8 GEMM kernel and its plain version sum the same f32
products (bf16 x times an int8 weight is exact in f32) in different
orders, so max|Δ| ≤ 1e-4 · max|ref|.  The sweep kernel repeats its plain
version operation for operation, so it is held bit for bit (NaN
positions included), and so are the planner's verdicts and the campaign
front it feeds, against the golden CSVs.
"""
import csv
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import (CampaignSpec, SweepEngine, gemms_of_model,
                              phase_gemms_of_model, plan_workload,
                              run_campaign, standard_configs)
from repro_torch.core.sweep import candidate_cols
from repro_torch.core.vectorized import FLAT_FIELDS
from repro_torch.kernels import (int8_gemm, int8_gemm_ref, sweep_eval,
                                 sweep_eval_ref)

pytestmark = pytest.mark.cuda

TOL = 1e-4
# qwen2-7b projections (K, N): Wq/Wo, Wk/Wv, mlp-gate/up, mlp-down, lm_head
FULL_WIDTH = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
              (3584, 152064)]
RAGGED = [(5, 300, 1000), (1, 17, 33), (17, 129, 65), (130, 1000, 37),
          (200, 333, 77), (8, 18944, 3584)]


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python -m pytest -m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, k, n, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=gen).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    s = torch.rand(n, generator=gen) * 0.02 + 1e-3
    return x.to(device), q.to(device), s.to(device)


def _check(x, q, s):
    got = int8_gemm(x, q, s)
    want = int8_gemm_ref(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mkn", RAGGED, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_ragged(cuda, mkn, dtype):
    _check(*_inputs(*mkn, dtype, cuda))


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("kn", FULL_WIDTH, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_full_width(cuda, kn, m):
    _check(*_inputs(m, *kn, torch.bfloat16, cuda, seed=m))


def test_kernel_strided_x(cuda):
    """x may be a row-strided view (unit column stride)."""
    x, q, s = _inputs(8, 512, 256, torch.bfloat16, cuda)
    wide = torch.zeros((8, 520), dtype=torch.bfloat16, device=cuda)
    wide[:, 3:515] = x
    _check(wide[:, 3:515], q, s)


def test_launch_counter(cuda):
    x, q, s = _inputs(8, 256, 128, torch.bfloat16, cuda)
    before = int8_gemm.launches
    int8_gemm(x, q, s)
    int8_gemm(x, q, s)
    assert int8_gemm.launches == before + 2
    int8_gemm(x.cpu(), q.cpu(), s.cpu())          # plain version: no launch
    int8_gemm_ref(x, q, s)
    assert int8_gemm.launches == before + 2


def test_wrapper_rejects_bad_inputs(cuda):
    x, q, s = _inputs(8, 256, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        int8_gemm(x, q.cpu(), s)
    with pytest.raises(TypeError):
        int8_gemm(x.half(), q, s)
    with pytest.raises(ValueError, match="unit column stride"):
        int8_gemm(x, q.t().contiguous().t(), s)


# --- the sweep kernel ------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PRECISIONS = {"int8": (8, False), "int4": (4, False), "fp8": (8, True)}


def _grid():
    """(arch, shape, precision, GEMM) of tests/test_golden_verdicts.py's
    1338-row grid."""
    for arch, mc in ARCHS.items():
        workloads = [(s, gemms_of_model(mc, SHAPES[s]))
                     for s in ("train_4k", "decode_32k")]
        workloads += [(f"phase-{ph}", gs) for ph, gs in
                      phase_gemms_of_model(mc, 2048, 8).items()]
        for sname, gemms in workloads:
            for g in gemms:
                for tok, (bits, fp) in PRECISIONS.items():
                    yield (arch, sname, tok,
                           g if (g.bits == bits and g.fp == fp)
                           else g.scaled(bits=bits, fp=fp))


def _grid_rows(order_mode):
    parts = [candidate_cols(g, c, order_mode)[1]
             for *_, g in _grid() for c in standard_configs().values()]
    rows = np.stack([np.concatenate([p[f] for p in parts])
                     for f in FLAT_FIELDS])
    # degenerate rows: k_arr = 0 (NaN terms), M = N = K = 1
    bad = rows[:, :64].copy()
    bad[FLAT_FIELDS.index("k_arr"), :32] = 0.0
    bad[:3, 32:] = 1.0
    return torch.from_numpy(np.concatenate([rows, bad], axis=1))


def _canon(x):
    x = x.clone()
    x[torch.isnan(x)] = float("nan")
    return x.view(torch.int32)


@pytest.mark.parametrize("order_mode", ["exact", "greedy"])
def test_sweep_kernel_bitwise_vs_plain(cuda, order_mode):
    rows = _grid_rows(order_mode)
    before = sweep_eval.launches
    got = sweep_eval(rows.to(cuda), order_mode)
    want = sweep_eval_ref(rows.to(cuda), order_mode)
    torch.cuda.synchronize()
    assert sweep_eval.launches == before + 1
    assert torch.equal(_canon(got), _canon(want))
    cpu = sweep_eval_ref(rows, order_mode)
    assert torch.equal(_canon(got.cpu()), _canon(cpu))
    assert torch.isnan(cpu[6]).any() and (cpu[0] == 0).any()


def test_sweep_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        sweep_eval(torch.zeros((24, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        sweep_eval(torch.zeros((8, 24), device=cuda).t())
    assert sweep_eval(torch.zeros((24, 0), device=cuda)).shape == (11, 0)


@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
def test_golden_verdicts_on_card(cuda, backend):
    with open(os.path.join(GOLDEN, "planner_verdicts.csv")) as f:
        golden = list(csv.DictReader(f))
    entries = list(_grid())
    before = sweep_eval.launches
    decisions = plan_workload([g for *_, g in entries], backend=backend,
                              engine=SweepEngine(device=cuda))
    launched = sweep_eval.launches - before
    assert launched == (1 if backend == "pallas" else 0)   # one batch
    got = [(arch, sname, prec, g.label, d.best_energy, d.best_throughput,
            str(int(d.use_cim)), d.where)
           for (arch, sname, prec, g), d in zip(entries, decisions)]
    want = [(r["arch"], r["shape"], r["precision"], r["label"],
             r["best_energy"], r["best_throughput"], r["use_cim"],
             r["where"]) for r in golden]
    assert got == want


GOLDEN_SPEC = CampaignSpec(
    workloads=(("mistral-nemo-12b", "train_4k"),
               ("mistral-nemo-12b", "decode_32k")),
    prototypes=("Analog-6T", "Analog-8T", "Digital-6T", "Digital-8T"),
    precisions=("int8", "int4", "fp8"), levels=("RF", "SMEM-A", "SMEM-B"),
    scales=(1.0, 4.0), serialize_modes=(True,), kn_thresholds=(4,),
    order_modes=("exact", "greedy"))


@pytest.mark.parametrize("backend,chunk_rows", [("vectorized", None),
                                                ("pallas", None),
                                                ("pallas", 512)])
def test_golden_campaign_front_on_card(cuda, backend, chunk_rows):
    engine = SweepEngine(chunk_rows=chunk_rows, device=cuda)
    result = run_campaign(GOLDEN_SPEC, engine=engine, backend=backend,
                          block_points=256, group_by="gemm")
    with open(os.path.join(GOLDEN, "campaign_front.csv"), newline="") as f:
        assert result.csv_text() == f.read()
    assert engine.cache_info()["chunks"]["evaluated"] >= 2
