"""The port's hand-written Hopper kernels against their plain versions, on
the card.  These tests carry the `cuda` marker and skip where torch has no
CUDA device; on a machine with an H100 run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the INT8 GEMM kernel and its plain version sum the same f32
products (bf16 x times an int8 weight is exact in f32) in different
orders, so max|Δ| ≤ 1e-4 · max|ref|.  The same holds for its float8 e4m3
weight operand, which every design decodes exactly (e4m3 -> bf16 is
exact); those weights hold all 254 finite e4m3 codes.  The sweep kernel repeats its plain
version operation for operation, so it is held bit for bit (NaN
positions included), and so are the planner's verdicts and the campaign
front it feeds, against the golden CSVs.

The attention kernels are held element by element by
`flash_attention_check` / `decode_attention_check`
(kernels/flash_attention.py:compare_to_plain): in f32 |Δ| ≤ 1e-5 ·
max|ref| (the same f32 recurrence, other summation orders).  In bf16 both
sides compute in f32 and round the output once, so an element may differ
by one bf16 ulp, 1.02 · 2**-7 · |ref|, plus 2**-12 · (P|v|) for f32 sums
in other orders (P the plain softmax weights); the flash kernel also
rounds p to bf16 (unit roundoff 2**-8) for its PV product, which moves an
element by at most 2**-8 · (P|v|).  The shapes are those of
chip_smoke.py's FLASH_CASES and DECODE_CASES and edge cases of their own.
Model level (the reduced prefill on the card against the same forward on
the CPU): 1e-5 of max|ref| in f32, 2**-6 in bf16, as
tests/test_torch_model.py.
"""
import csv
import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, RunConfig, reduced
from repro_torch.core import (CampaignSpec, SweepEngine, gemms_of_model,
                              phase_gemms_of_model, plan_workload,
                              plan_workload_by_phase, run_campaign,
                              standard_configs)
from repro_torch.core.sweep import candidate_cols
from repro_torch.core.vectorized import FLAT_FIELDS
from repro_torch.kernels import (decode_attention, decode_attention_check,
                                 flash_attention, flash_attention_check,
                                 flash_attention_ref, int8_gemm,
                                 int8_gemm_ref, ops, paged_decode_attention,
                                 paged_mla_decode, sweep_eval,
                                 sweep_eval_ref)
from repro_torch.kernels.mla_decode import mla_decode_check
from repro_torch.models import forward, init
from repro_torch.quant import KernelPlanTable, quantize_model_params

pytestmark = pytest.mark.cuda

I8 = importlib.import_module("repro_torch.kernels.int8_gemm")
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


def _fp8_inputs(m, k, n, dtype, device, seed=0):
    """x, an e4m3 weight whose first 254 elements are the 254 finite
    codes in order (the rest drawn from them), and a scale."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=gen).to(dtype)
    codes = torch.tensor([c for c in range(256) if c & 0x7F != 0x7F],
                         dtype=torch.uint8)
    idx = torch.randint(0, codes.numel(), (k * n,), generator=gen)
    idx[:min(k * n, codes.numel())] = torch.arange(min(k * n, codes.numel()))
    q = codes[idx].reshape(k, n).view(torch.float8_e4m3fn)
    s = torch.rand(n, generator=gen) * 0.02 / 448 + 1e-5
    return x.to(device), q.to(device), s.to(device)


def _check(x, q, s, dataflow="os", design=None):
    """Kernel vs plain version within TOL·max|ref|; `design` is the one
    int8_gemm.launches_by_design must show for the call."""
    before = dict(int8_gemm.launches_by_design)
    got = int8_gemm(x, q, s, dataflow=dataflow)
    want = int8_gemm_ref(x, q, s)
    torch.cuda.synchronize()
    ran = [d for d, n in int8_gemm.launches_by_design.items()
           if n != before[d]]
    assert len(ran) == 1 and (design is None or ran == [design]), ran
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err
    return got


@pytest.mark.parametrize("dataflow", ["os", "ws"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mkn", RAGGED, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_ragged(cuda, mkn, dtype, dataflow):
    """Ragged shapes; bf16 x runs design B on both dataflows, f32 x the
    FMA kernel."""
    design = "fma" if dtype == torch.float32 else "B"
    _check(*_inputs(*mkn, dtype, cuda), dataflow, design)


@pytest.mark.parametrize("dataflow", ["os", "ws"])
@pytest.mark.parametrize("m", [8, 32, 64, 128, 129, 2048])
@pytest.mark.parametrize("kn", FULL_WIDTH, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_full_width(cuda, kn, m, dataflow):
    """Each design at every qwen2-7b projection shape: "os" takes design A
    above A_MIN_ROWS (32) rows and B at or below; "ws" takes B at every
    M."""
    design = "A" if dataflow == "os" and m > I8.A_MIN_ROWS else "B"
    _check(*_inputs(m, *kn, torch.bfloat16, cuda, seed=m), dataflow, design)


# mamba2-780m's narrow gated outputs (ssm-BCdt at K = 1536: w_B / w_C
# N = 128, w_dt N = 48), below design A's 64-column wgmma tile
NARROW = [(1536, 48), (1536, 128)]


@pytest.mark.parametrize("m,dataflow,design", [(8, "os", "B"), (8, "ws", "B"),
                                               (2048, "os", "A"),
                                               (2048, "ws", "B")])
@pytest.mark.parametrize("kn", NARROW, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_narrow_outputs(cuda, kn, m, dataflow, design):
    _check(*_inputs(m, *kn, torch.bfloat16, cuda, seed=kn[1]), dataflow,
           design)
    x, q, s = _inputs(m, *kn, torch.bfloat16, cuda, seed=kn[1] + 1)
    got = int8_gemm(x, q, s, out_dtype=torch.bfloat16, dataflow=dataflow)
    assert torch.equal(got, int8_gemm(x, q, s, dataflow=dataflow).to(
        torch.bfloat16))


FP8_DESIGNS = [(300, 512, 256, torch.bfloat16, "os", "A"),
               (8, 512, 256, torch.bfloat16, "os", "B"),
               (300, 512, 256, torch.bfloat16, "ws", "B"),
               (8, 512, 256, torch.float32, "os", "fma"),
               (8, 512, 256, torch.float32, "ws", "fma")]


@pytest.mark.parametrize("case", FP8_DESIGNS,
                         ids=lambda c: "-".join(map(str, c[:3] + c[4:])))
def test_fp8_weight_all_codes_each_design(cuda, case):
    """The e4m3 operand in designs A, B and fma, on a weight holding all
    254 finite codes, in f32 and bf16 output, with its launch counted
    under "fp8"."""
    m, k, n, dtype, dataflow, design = case
    x, q, s = _fp8_inputs(m, k, n, dtype, cuda, seed=m + k)
    assert q.view(torch.uint8).unique().numel() == 254
    before = dict(int8_gemm.launches_by_format)
    y32 = _check(x, q, s, dataflow, design)
    assert int8_gemm.launches_by_format["fp8"] == before["fp8"] + 1
    assert int8_gemm.launches_by_format["int8"] == before["int8"]
    y16 = int8_gemm(x, q, s, out_dtype=torch.bfloat16, dataflow=dataflow)
    torch.cuda.synchronize()
    assert torch.equal(y16, y32.to(torch.bfloat16))


@pytest.mark.parametrize("dataflow", ["os", "ws"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mkn", RAGGED, ids=lambda t: "x".join(map(str, t)))
def test_fp8_weight_matches_plain_ragged(cuda, mkn, dtype, dataflow):
    design = "fma" if dtype == torch.float32 else "B"
    _check(*_fp8_inputs(*mkn, dtype, cuda), dataflow, design)


@pytest.mark.parametrize("m", [8, 2048])
@pytest.mark.parametrize("kn", FULL_WIDTH, ids=lambda t: "x".join(map(str, t)))
def test_fp8_weight_matches_plain_full_width(cuda, kn, m):
    """qwen2-7b's projections at the serve's M = 8 (design B) and the
    prefill's M = 2048 (design A), and design B's ws dataflow at M = 8."""
    x, q, s = _fp8_inputs(m, *kn, torch.bfloat16, cuda, seed=m)
    _check(x, q, s, "os", "A" if m > I8.A_MIN_ROWS else "B")
    if m == 8:
        _check(x, q, s, "ws", "B")


def test_fp8_weight_rejects_other_float8(cuda):
    x, q, s = _fp8_inputs(8, 256, 128, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        int8_gemm(x, q.float().to(torch.float8_e5m2), s)
    with pytest.raises(TypeError):
        int8_gemm(x, q.half(), s)


def test_kernel_strided_x(cuda):
    """x may be a row-strided view (unit column stride)."""
    x, q, s = _inputs(8, 512, 256, torch.bfloat16, cuda)
    wide = torch.zeros((8, 520), dtype=torch.bfloat16, device=cuda)
    wide[:, 3:515] = x
    _check(wide[:, 3:515], q, s)


@pytest.mark.parametrize("m", [129, 2000, 2048])
@pytest.mark.parametrize("kn", FULL_WIDTH[:4],
                         ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_prefill_rows(cuda, kn, m):
    """More than 128 rows: design A, the last 128-row tile ragged at
    M = 129 and 2000 (the prefill runs M = 2048)."""
    _check(*_inputs(m, *kn, torch.bfloat16, cuda, seed=m), design="A")


def test_kernel_matches_plain_cross_kv(cuda):
    """llama-3.2-vision's xattn-KV projection at full width: the 1601 image
    tokens of one prompt (M not a multiple of the 128-row tile, so design
    A runs a masked tail) times wk / wv (K = 8192, N = 8 x 128)."""
    _check(*_inputs(1601, 8192, 1024, torch.bfloat16, cuda, seed=1601),
           "os", "A")


def test_kernel_matches_plain_prefill_lm_head(cuda):
    _check(*_inputs(2048, *FULL_WIDTH[4], torch.bfloat16, cuda, seed=1))


@pytest.mark.parametrize("dataflow", ["os", "ws"])
@pytest.mark.parametrize("m", [8, 300])
def test_unaligned_and_strided_inputs(cuda, m, dataflow):
    """Row strides and base addresses TMA cannot take run design B: an x
    view with an odd row stride, an x view 2 bytes off alignment, a
    weight view 1 byte off and with an odd row stride; a strided but
    aligned x keeps design A."""
    x, q, s = _inputs(m, 512, 256, torch.bfloat16, cuda, seed=m)
    odd = torch.zeros((m, 515), dtype=torch.bfloat16, device=cuda)
    odd[:, 1:513] = x
    _check(odd[:, 1:513], q, s, dataflow, "B")
    wide = torch.zeros((m, 520), dtype=torch.bfloat16, device=cuda)
    wide[:, 8:520] = x
    _check(wide[:, 8:520], q, s, dataflow,
           "A" if dataflow == "os" and m > I8.A_MIN_ROWS else "B")
    qw = torch.zeros((512, 259), dtype=torch.int8, device=cuda)
    qw[:, 1:257] = q
    _check(x, qw[:, 1:257], s, dataflow, "B")


@pytest.mark.parametrize("case", [(8, 3584, 3584, "os"), (2048, 3584, 512, "os"),
                                  (130, 1000, 37, "os"), (8, 18944, 3584, "ws"),
                                  (300, 3584, 3584, "ws")],
                         ids=lambda c: "x".join(map(str, c)))
def test_bf16_out_is_the_f32_out_cast_and_repeatable(cuda, case):
    """bf16 out_dtype equals the f32 output cast, bit for bit; two calls
    give equal bits (split-K partials are added in a fixed order)."""
    m, k, n, dataflow = case
    x, q, s = _inputs(m, k, n, torch.bfloat16, cuda, seed=k + n)
    y32 = int8_gemm(x, q, s, dataflow=dataflow)
    y16 = int8_gemm(x, q, s, out_dtype=torch.bfloat16, dataflow=dataflow)
    again = int8_gemm(x, q, s, dataflow=dataflow)
    torch.cuda.synchronize()
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.to(torch.bfloat16))
    assert torch.equal(y32.view(torch.int32), again.view(torch.int32))


def test_per_design_counters(cuda):
    """One count per GEMM (design B's reduce pass is no second count), and
    one per design."""
    x, q, s = _inputs(256, 512, 256, torch.bfloat16, cuda)
    cases = [((x, q, s), {}, "A"), ((x[:8], q, s), {}, "B"),
             ((x, q, s), {"dataflow": "ws"}, "B"),
             ((x[:8].float(), q, s), {}, "fma"),
             ((x[:8].float(), q, s), {"dataflow": "ws"}, "fma")]
    for args, kw, design in cases:
        before = (int8_gemm.launches, dict(int8_gemm.launches_by_design))
        int8_gemm(*args, **kw)
        after = int8_gemm.launches_by_design
        assert int8_gemm.launches == before[0] + 1
        assert {d: after[d] - before[1][d] for d in after} == {
            d: int(d == design) for d in after}


def test_workspace_cap_takes_fewer_splits(cuda):
    """ws at M = 2048 on mlp-gate: two K-slices would need 310 MB of
    partials, above the cap, so the plan takes one and the call runs."""
    i8 = importlib.import_module("repro_torch.kernels.int8_gemm")
    m, k, n = 2048, 3584, 18944
    plan = i8.plan_gemm(m, n, k, dataflow="ws")
    assert plan.splits == 1
    assert 4 * 2 * m * n > i8.WORKSPACE_CAP
    _check(*_inputs(m, k, n, torch.bfloat16, cuda, seed=3), "ws", "B")


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


# --- the attention kernels -------------------------------------------------

def _attn_inputs(shapes, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype).to(device)
            for s in shapes]


def _attn_ok(result: dict) -> None:
    assert result["ok"], result


def _smoke_cases():
    """chip_smoke.py's attention shapes (a script beside the tests, loaded
    by path: it imports nothing at module level but the standard library)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.FLASH_CASES, smoke.DECODE_CASES


SMOKE_FLASH, SMOKE_DECODE = _smoke_cases()
# (b, sq, sk, H, KV, d, window): the smoke's cases, then edge cases (no
# GQA, a 16-row block, ragged sq and sk, a one-key window)
FLASH_CASES = SMOKE_FLASH + [(1, 512, 512, 4, 4, 64, 100),
                             (2, 16, 16, 4, 2, 16, 0),
                             (1, 200, 328, 4, 2, 32, 0),
                             (1, 64, 64, 8, 1, 128, 1),
                             # ragged sk over several kv heads at d = 128:
                             # a 2-D TMA map would read the next head
                             (2, 104, 296, 8, 2, 128, 0),
                             # qwen2-7b's heads at a 4096-token prompt
                             (1, 4096, 4096, 28, 4, 128, 0),
                             # a window with causal that skips tiles at
                             # both ends of the later query blocks
                             (1, 1024, 1024, 4, 2, 128, 300),
                             # qwen2-moe-a2.7b's prefill: 16/16 heads,
                             # group size 1, at d = 128
                             (1, 2048, 2048, 16, 16, 128, 0),
                             # musicgen-large's prefill: 32/32 heads at
                             # d = 64, the first model path at that width
                             (1, 2048, 2048, 32, 32, 64, 0),
                             # llama-3.2-vision's self-attention: 64/8
                             (1, 2048, 2048, 64, 8, 128, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, sk, h, kv, d, window = case
    q, k, v = _attn_inputs([(b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)],
                           dtype, cuda, seed=sq + h)
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, block_q=8, block_kv=8)
    assert flash_attention.launches == before + 1
    _attn_ok(flash_attention_check(ops.fold(got), ops.fold(q), ops.fold(k),
                                   ops.fold(v), True, window))


def test_flash_kernel_not_causal_and_masked_rows(cuda):
    """causal=False with a window, and sq > sk (rows whose position is
    negative see no key: the mean of v, as the reference gives)."""
    q, k, v = _attn_inputs([(4, 192, 64), (2, 192, 64), (2, 192, 64)],
                           torch.bfloat16, cuda, seed=3)
    _attn_ok(flash_attention_check(
        flash_attention(q, k, v, causal=False, window=32, block_q=64,
                        block_kv=64), q, k, v, False, 32))
    k, v = k[:, :64].contiguous(), v[:, :64].contiguous()
    _attn_ok(flash_attention_check(
        flash_attention(q, k, v, block_q=64, block_kv=64), q, k, v))


# (b, S, H, KV, d): the smoke's cases, then edge cases (rep 4, rep 32,
# no GQA at d = 16)
DECODE_CASES = SMOKE_DECODE + [(2, 300, 8, 2, 64), (2, 256, 32, 1, 32),
                               (1, 128, 4, 4, 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, S, h, kv, d = case
    q, kc, vc = _attn_inputs([(b, 1, h, d), (b, S, kv, d), (b, S, kv, d)],
                             dtype, cuda, seed=S)
    for length in (0, 7, min(300, S), S):
        before = decode_attention.launches
        got = ops.decode_attention(q, kc, vc, length)
        assert decode_attention.launches == before + 1
        _attn_ok(decode_attention_check(ops.fold(got), ops.fold(q),
                                        ops.fold(kc), ops.fold(vc), length))


def test_decode_kernel_length_at_a_split_boundary(cuda):
    """qwen2-7b's decode_32k shape with `length` on the boundary of the
    wrapper's splits, one past it and one short of it."""
    from repro_torch.kernels.paged import split_plan
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    b, S, h, kv, d = 8, 32768, 28, 4, 128
    q, kc, vc = _attn_inputs([(b, 1, h, d), (b, S, kv, d), (b, S, kv, d)],
                             torch.bfloat16, cuda, seed=5)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, split_len = split_plan(b * kv, S, n_sms, da.TILE)
    assert n_splits > 1
    for length in (split_len - 1, split_len, split_len + 1,
                   (n_splits - 1) * split_len + 1):
        got = ops.decode_attention(q, kc, vc, length)
        _attn_ok(decode_attention_check(ops.fold(got), ops.fold(q),
                                        ops.fold(kc), ops.fold(vc), length))


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_attention_kernels_repeat_bit_for_bit(cuda, kernel):
    """Two calls on the same inputs give equal bits (fixed summation
    orders: no atomics, splits combined in split order)."""
    if kernel == "flash":
        q, k, v = _attn_inputs([(1, 1024, 28, 128), (1, 1024, 4, 128),
                                (1, 1024, 4, 128)], torch.bfloat16, cuda)
        first = ops.flash_attention(q, k, v)
        assert torch.equal(first, ops.flash_attention(q, k, v))
    else:
        q, kc, vc = _attn_inputs([(8, 1, 28, 128), (8, 8192, 4, 128),
                                  (8, 8192, 4, 128)], torch.bfloat16, cuda)
        first = ops.decode_attention(q, kc, vc, 5000)
        assert torch.equal(first, ops.decode_attention(q, kc, vc, 5000))
    assert bool(torch.isfinite(first).all())


def test_attention_launches_by_design(cuda):
    """bf16 calls run the tensor-core designs, f32 calls the FMA kernels;
    each launch is counted once, under its design."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    for dtype, fdesign, ddesign in ((torch.bfloat16, "wgmma", "mma"),
                                    (torch.float32, "fma", "fma")):
        q, k, v = _attn_inputs([(4, 64, 64), (2, 64, 64), (2, 64, 64)],
                               dtype, cuda)
        before = (dict(fa.flash_attention.launches_by_design),
                  dict(da.decode_attention.launches_by_design))
        flash_attention(q, k, v)
        decode_attention(q[:, :1].contiguous(), k, v, 9)
        after = (fa.flash_attention.launches_by_design,
                 da.decode_attention.launches_by_design)
        for by, was, want in ((after[0], before[0], fdesign),
                              (after[1], before[1], ddesign)):
            assert {key: by[key] - was[key] for key in by} == {
                key: int(key == want) for key in by}


def test_decode_kernel_reads_length_on_the_card(cuda):
    q, kc, vc = _attn_inputs([(2, 1, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)],
                             torch.bfloat16, cuda, seed=4)
    for n in (300, 5):
        length = torch.tensor(n, device=cuda)
        assert torch.equal(ops.decode_attention(q, kc, vc, length),
                           ops.decode_attention(q, kc, vc, n))


def test_attention_launch_counters(cuda):
    q, k, v = _attn_inputs([(4, 64, 32), (2, 64, 32), (2, 64, 32)],
                           torch.bfloat16, cuda)
    before = (flash_attention.launches, decode_attention.launches)
    flash_attention(q, k, v)
    decode_attention(q[:, :1].contiguous(), k, v, 9)
    flash_attention(q.cpu(), k.cpu(), v.cpu())       # plain: no launch
    decode_attention(q[:, :1].cpu(), k.cpu(), v.cpu(), 9)
    flash_attention_ref(q, k, v)
    assert (flash_attention.launches,
            decode_attention.launches) == (before[0] + 1, before[1] + 1)


def test_attention_wrappers_reject_bad_inputs(cuda):
    """On a CUDA tensor the wrappers launch or raise: no plain fallback."""
    q, k, v = _attn_inputs([(4, 64, 32), (2, 64, 32), (2, 64, 32)],
                           torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                        v[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="share a device"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head widths"):
        decode_attention(q[:, :1, :24].contiguous(), k[..., :24].contiguous(),
                         v[..., :24].contiguous(), 5)
    with pytest.raises(ValueError, match="lives on"):
        decode_attention(q[:, :1].contiguous(), k, v, torch.tensor(5))
    with pytest.raises(TypeError):
        decode_attention(q[:, :1].contiguous(), k, v,
                         torch.tensor(5.0, device=cuda))


# --- the paged design: the engine's decode attention over the block pool -----

# (b, S, block_size, H, KV, d, window): both engine cells' attention (32
# slots of 512 positions in blocks of 16; qwen2-7b 28/4, qwen2-moe-a2.7b
# 16/16, d 128) with and without a window, then edge cases: S not a
# multiple of 64; few rows over a long S (several splits and the combine
# kernel, a window across split boundaries); blocks of 8 and 128 rows;
# head widths 16, 32 and 64
PAGED_CASES = [(32, 512, 16, 28, 4, 128, 0), (32, 512, 16, 28, 4, 128, 64),
               (32, 512, 16, 16, 16, 128, 0), (32, 512, 16, 16, 16, 128, 100),
               (4, 48, 16, 8, 2, 64, 0), (3, 4096, 8, 32, 8, 128, 0),
               (2, 8192, 64, 8, 1, 32, 300), (2, 512, 128, 4, 4, 16, 0),
               (4, 256, 32, 32, 32, 64, 0)]


def _paged_inputs(case, device, seed=0):
    """q, shuffled pools with spare blocks, tables (the last slot, idle,
    aliasing the first one's blocks) and ragged lengths: 0, 1, the edges
    of a block and of a tile, S and past it, then random ones."""
    b, S, bs, H, KV, d, window = case
    mb = S // bs
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * mb + 3
    q, kp, vp = (torch.randn(s, generator=gen).to(torch.bfloat16).to(device)
                 for s in ((b, 1, H, d), (n_blocks, bs, KV, d),
                           (n_blocks, bs, KV, d)))
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb].view(b, mb)
    if b > 1:
        tables[-1] = tables[0]
    edge = [0, 1, 15, 16, 17, 63, 64, 65, S - 1, S, S + 50]
    rand = torch.randint(1, S + 1, (b,), generator=gen).tolist()
    lengths = [edge[i] if i < len(edge) else rand[i] for i in range(b)]
    return (q, kp, vp, tables.to(torch.int32).to(device),
            torch.tensor(lengths, device=device), window)


def _paged_check(got, q, kp, vp, tables, lengths, window) -> dict:
    """`decode_attention_check` on the folded result: q, the gathered
    strips and one length per query row."""
    from repro_torch.models.model import _paged_view
    kf, vf = (ops.fold(_paged_view(p, tables)) for p in (kp, vp))
    return decode_attention_check(ops.fold(got), ops.fold(q), kf, vf,
                                  lengths.repeat_interleave(q.shape[2]),
                                  window)


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_paged_kernel_matches_plain(cuda, case):
    args = _paged_inputs(case, cuda, seed=case[1] + case[3])
    before = (paged_decode_attention.launches,
              dict(paged_decode_attention.launches_by_design))
    got = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before[0] + 1
    assert paged_decode_attention.launches_by_design["paged"] == (
        before[1]["paged"] + 1)
    _attn_ok(_paged_check(got, *args))


@pytest.mark.parametrize("case", PAGED_CASES[:4],
                         ids=lambda c: "-".join(map(str, c)))
def test_paged_kernel_repeats_bit_for_bit(cuda, case):
    """Two calls give equal bits, and a strided q (a view into a wider
    tensor, as the kernel reads q through its strides) the same bits."""
    q, *rest = _paged_inputs(case, cuda, seed=7)
    first = paged_decode_attention(q, *rest)
    assert torch.equal(first, paged_decode_attention(q, *rest))
    wide = torch.zeros(q.shape[:2] + (q.shape[2] + 3, q.shape[3]),
                       dtype=q.dtype, device=cuda)
    wide[:, :, 3:] = q
    assert torch.equal(first, paged_decode_attention(wide[:, :, 3:], *rest))
    assert bool(torch.isfinite(first).all())


def test_paged_wrapper_rejects_bad_inputs(cuda):
    """On CUDA tensors the paged wrapper launches or raises."""
    q, kp, vp, tables, lengths, _ = _paged_inputs(
        (2, 64, 16, 4, 2, 32, 0), cuda)
    with pytest.raises(TypeError):
        paged_decode_attention(q.float(), kp.float(), vp.float(), tables,
                               lengths)
    with pytest.raises(ValueError, match="head widths"):
        paged_decode_attention(q[..., :24], kp[..., :24], vp[..., :24],
                               tables, lengths)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_decode_attention(q, kp.view(-1, 4, 2, 32),
                               vp.view(-1, 4, 2, 32), tables, lengths)
    with pytest.raises(ValueError, match="share a device"):
        paged_decode_attention(q, kp, vp, tables.cpu(), lengths)


# --- the paged MLA decode kernel --------------------------------------------
# (b, S, bs, H, lengths): the engine cell (128 slots x 512, blocks of 16,
# 16 heads) at ragged chat lengths and at 512 throughout; then few slots
# (several splits and the combine kernel), a long strip in blocks of 64,
# fewer heads in blocks of 8

MLA_CASES = [(128, 512, 16, 16, "chat"), (128, 512, 16, 16, "full"),
             (2, 512, 16, 16, "chat"), (4, 4096, 64, 16, "chat"),
             (3, 256, 8, 8, "chat")]


def _mla_inputs(case, device, seed=0):
    """q (b, H, 576), a shuffled latent pool with a spare block, tables
    (an idle last slot aliasing the first one's blocks) and lengths:
    edges (0, 1, a tile's, a block's, S) then chat-like ones, log-normal
    around 170 positions, or S for every slot."""
    b, S, bs, H, kind = case
    mb = S // bs
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * mb + 3
    q = torch.randn(b, H, 576, generator=gen).to(torch.bfloat16).to(device)
    pool = torch.randn(n_blocks, bs, 576, generator=gen).to(
        torch.bfloat16).to(device)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb].view(b, mb)
    if b > 1:
        tables[-1] = tables[0]
    if kind == "full":
        lengths = [S] * b
    else:
        edge = [0, 1, 31, 32, 33, bs, S - 1, S]
        chat = (170 * torch.exp(torch.randn(b, generator=gen))).clamp(
            8, S).long().tolist()
        lengths = [edge[i] if i < len(edge) and i < b - 1 else chat[i]
                   for i in range(b)]
    scale = float(np.float32(192 ** -0.5))
    return (q, pool, tables.to(torch.int32).to(device),
            torch.tensor(lengths, device=device), scale)


@pytest.mark.parametrize("case", MLA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mla_kernel_matches_plain(cuda, case):
    args = _mla_inputs(case, cuda, seed=case[1] + case[3])
    before = (paged_mla_decode.launches,
              paged_mla_decode.launches_by_design["mla"])
    got = paged_mla_decode(*args)
    assert (paged_mla_decode.launches,
            paged_mla_decode.launches_by_design["mla"]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == args[0].shape[:2] + (512,)
    _attn_ok(mla_decode_check(got, *args))
    assert torch.equal(got, paged_mla_decode(*args))     # no atomics
    if case[4] == "chat":
        assert not got[0].any()                          # length 0


def test_mla_kernel_in_a_captured_graph(cuda):
    """The call captured in a CUDA graph (`serving.graphs.StepGraph`):
    each replay reads the lengths, tables and q copied in for it, equals
    the eager call bit for bit, and credits one launch."""
    from repro_torch.serving.graphs import StepGraph
    q, pool, tables, lengths, scale = _mla_inputs(MLA_CASES[0], cuda, 3)
    graph = StepGraph(lambda a, t, n: paged_mla_decode(a, pool, t, n, scale))
    for seed in range(3):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        qi = torch.randn(q.shape, generator=gen, device=cuda).to(q.dtype)
        li = torch.randint(1, 513, lengths.shape, generator=gen,
                           device=cuda)
        ti = tables.roll(seed, 0)
        before = paged_mla_decode.launches
        got = graph(qi, ti, li)
        # the first call also warms the step up, for real, before capture
        assert paged_mla_decode.launches == before + 1 + (seed == 0), seed
        assert torch.equal(got, paged_mla_decode(qi, pool, ti, li, scale))
        _attn_ok(mla_decode_check(got, qi, pool, ti, li, scale))
    assert graph.captures == 1


def test_mla_wrapper_rejects_bad_inputs(cuda):
    """On CUDA tensors the wrapper launches or raises: f32, a row not 576
    wide or V not its first 512 columns, more than 16 heads, blocks not a
    multiple of 8, mixed devices, and autograd."""
    q, pool, tables, lengths, scale = _mla_inputs((2, 64, 16, 16, "full"),
                                                  cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_mla_decode(q.float(), pool.float(), tables, lengths, scale)
    with pytest.raises(ValueError, match="rows of 576"):
        paged_mla_decode(q[..., :512].contiguous(),
                         pool[..., :512].contiguous(), tables, lengths,
                         scale)
    with pytest.raises(ValueError, match="rows of 576"):
        paged_mla_decode(q, pool, tables, lengths, scale, v_dim=256)
    with pytest.raises(ValueError, match="1 to 16 heads"):
        paged_mla_decode(torch.cat([q, q[:, :1]], 1), pool, tables, lengths,
                         scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_mla_decode(q, pool.view(-1, 4, 576), tables, lengths, scale)
    with pytest.raises(ValueError, match="share a device"):
        paged_mla_decode(q, pool, tables.cpu(), lengths, scale)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_mla_decode(q.clone().requires_grad_(), pool, tables, lengths,
                         scale)


def _mla_model(cuda, moe=True):
    """The Moonlight block at its latent attention's published widths (16
    heads, latent 512, rope 64, nope and v 128) on a narrow residual and
    few layers, bf16: one leading dense layer and two MoE layers, or
    (moe=False) three dense layers."""
    import dataclasses
    from repro_torch.configs.registry import MOONLIGHT_16B_A3B
    from repro_torch.serving import DecodeCore
    cfg = dataclasses.replace(reduced(MOONLIGHT_16B_A3B),
                              mla=MOONLIGHT_16B_A3B.mla, n_heads=16,
                              n_kv_heads=16, d_model=256)
    if not moe:
        cfg = dataclasses.replace(cfg, family="dense", moe=None)
    rc = RunConfig(attn_impl="naive", remat=False)
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    for leaf in params["slots"][0].get("moe", {}).get("score_bias", []):
        leaf.normal_(0.0, 0.1)
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=128,
                      plan_max_len=64, device="cuda")
    return cfg, rc, core


def test_captured_mla_step_credits_one_launch_per_layer(cuda, monkeypatch):
    """The engine cell's step (128 slots, blocks of 16) over the latent
    pool, captured: each replay credits one MLA launch per layer and no
    other attention kernel, gathers no strip, and equals the eager step
    bit for bit."""
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    from repro_torch.models import model as tm
    cfg, rc, core = _mla_model(cuda)
    layers = cfg.n_layers

    def no_gather(*a, **kw):
        raise AssertionError("the kernel route gathered a strip")
    monkeypatch.setattr(tm, "_paged_view", no_gather)
    slots, mb = 128, 4
    pools = init_paged_cache(cfg, rc, slots, slots * mb, 16, device="cuda")
    assert tuple(pools[0]["kv"].shape) == (layers, slots * mb, 16, 576)
    copy = clone_cache(pools)
    tables = torch.randperm(slots * mb, device="cuda").to(
        torch.int32).view(slots, mb)
    gen = torch.Generator(device="cuda").manual_seed(1)
    active = torch.arange(slots, device="cuda") % 5 != 0
    step = core.batch_step
    first = paged_mla_decode.launches
    for t in range(6):
        tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                            device="cuda")
        pos = ((torch.arange(slots, device="cuda") * 7 + t) % (mb * 16)).to(
            torch.int32)
        if t == 1:
            before = (paged_mla_decode.launches,
                      paged_decode_attention.launches,
                      decode_attention.launches)
        got, pools = step(pools, tok, pos, active, tables)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
        assert torch.equal(got, want), t
    assert step.captures == 1
    assert before[0] - first == 3 * layers
    assert (paged_mla_decode.launches - before[0],
            paged_decode_attention.launches - before[1],
            decode_attention.launches - before[2]) == (2 * 5 * layers, 0, 0)


def test_mla_kernel_route_matches_plain_route(cuda, monkeypatch):
    """Greedy steps at ragged lengths through the kernel route against
    the plain route (`latent_attend` over the gathered strips), both fed
    the kernel route's tokens: logits within 2**-6 of max|ref| (the
    model's bf16 tolerance) and the same top token wherever the plain
    route's top-two gap exceeds twice that.  Dense layers: a router on a
    near-tie would turn a bf16 rounding into another expert's output."""
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    from repro_torch.models import model as tm
    cfg, rc, core = _mla_model(cuda, moe=False)
    b, mb, bs = 4, 4, 16
    pools = init_paged_cache(cfg, rc, b, b * mb, bs, device="cuda")
    plain = clone_cache(pools)
    tables = torch.arange(b * mb, dtype=torch.int32,
                          device="cuda").view(b, mb).flip(1)
    pos0 = torch.tensor([0, 5, 17, 20], dtype=torch.int32, device="cuda")
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    tok = torch.tensor([[1], [2], [3], [4]], device="cuda")
    fits = tm.paged_kernel_fits
    agree = compared = 0
    for t in range(30):
        pos = pos0 + t
        with torch.inference_mode():
            before = paged_mla_decode.launches
            got, pools = decode_step(core.params, pools, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
            assert paged_mla_decode.launches == before + cfg.n_layers
            monkeypatch.setattr(tm, "paged_kernel_fits", lambda *a: False)
            want, plain = decode_step(core.params, plain, tok, pos, cfg, rc,
                                      plan=core.plan_table, active=active,
                                      block_tables=tables)
            monkeypatch.setattr(tm, "paged_kernel_fits", fits)
        g, w = got.float()[:, 0], want.float()[:, 0]
        tol = 2.0 ** -6 * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol, t
        top2 = w.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree += int((g.argmax(-1) == w.argmax(-1))[clear].sum())
        compared += int(clear.sum())
        tok = g.argmax(-1, keepdim=True)
    assert agree == compared and compared > 0


# --- the grouped INT8 expert kernels (kernels/moe_experts.py) ----------------

# the two MoE cells' expert shapes at full width: (E, top_k, T, d, f)
MOE_CELLS = {"qwen2-moe": (60, 4, 32, 2048, 1408),
             "moonlight": (64, 6, 128, 2048, 1408)}


def _moe_layers(cfg) -> int:
    from repro_torch.models.model import n_periods, period_slots
    return n_periods(cfg) * sum(s.ffn == "moe" for s in period_slots(cfg))


def _moe_leaves(E, d, f, device, seed=0):
    """Random INT8 expert leaves: int8 codes in [-127, 127], per-channel
    scales around 1 / (127 sqrt(K)) (a unit-variance weight's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def leaf(k, n):
        q = torch.randint(-127, 128, (E, k, n), generator=gen,
                          dtype=torch.int8)
        s = (1.0 + torch.rand((E, n), generator=gen)) / (127 * k ** 0.5)
        return {"q": q.to(device), "scale": s.to(device)}
    return leaf(d, f), leaf(d, f), leaf(f, d)


def _moe_ids(E, k, T, routing, device, seed=0):
    """(T, k) int64 distinct expert ids per token: "router" uniform at
    random; "idle" with the first E // 4 experts never chosen; "one" with
    expert 5 every token's first choice (more than 32 rows at T > 32, so
    the kernels take their rows in passes)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    score = torch.rand((T, E), generator=gen)
    if routing == "idle":
        score[:, :E // 4] = -1.0
    elif routing == "one":
        score[:, 5] = 2.0
    return score.topk(k, dim=-1).indices.to(device)


@pytest.mark.parametrize("routing", ["router", "idle", "one"])
@pytest.mark.parametrize("cell", sorted(MOE_CELLS))
def test_moe_experts_kernel_matches_plain(cuda, cell, routing):
    """At both cells' full widths and batches, against moe_experts_ref
    within MOE_TOL_DOC: per element one bf16 ulp of the output and one of
    each h term (both sides sum in f32, in other orders, so an h may round
    the other way), and over the whole tensor an RMS error of at most
    2^-10 of the reference's RMS, which a result rounded twice exceeds
    (6.3e-3 on the CPU).  Two launches, one per kernel, none counted by
    the INT8 GEMM; two calls give the same bits (no atomics)."""
    from repro_torch.kernels import moe_experts
    from repro_torch.kernels.moe_experts import (MOE_TOL_DOC,
                                                 moe_experts_check)
    E, k, T, d, f = MOE_CELLS[cell]
    leaves = _moe_leaves(E, d, f, cuda, seed=E)
    ids = _moe_ids(E, k, T, routing, cuda, seed=T)
    x = torch.randn((T, d), generator=torch.Generator(device="cpu")
                    .manual_seed(k)).to(torch.bfloat16).to(cuda)
    before = (moe_experts.launches, dict(moe_experts.launches_by_design),
              int8_gemm.launches)
    got = moe_experts(x, ids, *leaves)
    assert (moe_experts.launches - before[0], int8_gemm.launches) == (
        2, before[2])
    assert all(moe_experts.launches_by_design[n] == before[1][n] + 1
               for n in ("gate_up", "down"))
    assert got.shape == (T, k, d) and got.dtype == torch.bfloat16
    out = moe_experts_check(got, x, ids, *leaves)
    assert out["ok"], (out, MOE_TOL_DOC)
    assert torch.equal(got, moe_experts(x, ids, *leaves))


def test_moe_experts_kernel_edge_rows(cuda):
    """One token; then a T whose assignments span several scan steps of
    the in-block routing (T k > 1,024), with 33 rows on one expert."""
    from repro_torch.kernels import moe_experts
    from repro_torch.kernels.moe_experts import moe_experts_check
    E, d, f = 16, 256, 192
    leaves = _moe_leaves(E, d, f, cuda, seed=1)
    for T, k in ((1, 4), (600, 2)):
        ids = _moe_ids(E, k, T, "router", cuda, seed=T)
        if T > 1:
            ids[:33, 0] = 7
            ids[:33, 1] = 3
            ids[-1] = torch.tensor([7, 2], device=cuda)
        x = torch.randn((T, d), device=cuda).to(torch.bfloat16)
        out = moe_experts_check(moe_experts(x, ids, *leaves), x, ids,
                                *leaves)
        assert out["ok"], (T, out)


def test_moe_experts_in_a_captured_graph(cuda):
    """The call captured in a CUDA graph (`serving.graphs.StepGraph`):
    each replay reads the x and ids copied in for it, equals the eager
    call bit for bit and credits two launches."""
    from repro_torch.kernels import moe_experts
    from repro_torch.serving.graphs import StepGraph
    E, k, T, d, f = MOE_CELLS["qwen2-moe"]
    leaves = _moe_leaves(E, d, f, cuda)
    graph = StepGraph(lambda x, ids: moe_experts(x, ids, *leaves))
    for seed in range(3):
        x = torch.randn((T, d), generator=torch.Generator(device="cpu")
                        .manual_seed(seed)).to(torch.bfloat16).to(cuda)
        ids = _moe_ids(E, k, T, ("router", "idle", "one")[seed], cuda, seed)
        before = moe_experts.launches
        got = graph(x, ids)
        # the first call also warms the step up, for real, before capture
        assert moe_experts.launches == before + 2 * (1 + (seed == 0)), seed
        assert torch.equal(got, moe_experts(x, ids, *leaves))
    assert graph.captures == 1


def test_moe_experts_wrapper_rejects_bad_inputs(cuda):
    """On CUDA tensors the wrapper launches or raises: f32 x, widths not a
    multiple of 64, a float leaf, mixed devices, and autograd."""
    from repro_torch.kernels import moe_experts
    leaves = _moe_leaves(4, 128, 64, cuda)
    x = torch.randn((3, 128), device=cuda).to(torch.bfloat16)
    ids = _moe_ids(4, 2, 3, "router", cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        moe_experts(x.float(), ids, *leaves)
    narrow = _moe_leaves(4, 128, 96, cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_experts(x, ids, *narrow)
    with pytest.raises(TypeError, match="INT8 leaves"):
        moe_experts(x, ids, leaves[0]["q"].float(), *leaves[1:])
    with pytest.raises(ValueError, match="share"):
        moe_experts(x, ids.cpu(), *leaves)
    with pytest.raises(RuntimeError, match="no backward"):
        moe_experts(x.float().requires_grad_(), ids, *leaves)


def test_captured_moe_step_credits_two_expert_launches_per_layer(
        cuda, monkeypatch):
    """The MoE cell's step at reduced widths (d 256, experts of 64 and
    their capacity as the cell's, so every step is T <= C), captured:
    each replay credits two expert launches per MoE layer, the INT8 GEMM
    exactly the launches of the einsum route's step (the experts add none
    to it), and equals the eager step bit for bit."""
    import dataclasses
    from repro_torch.kernels import moe_experts
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    from repro_torch.models import moe as tmoe
    from repro_torch.serving import DecodeCore
    base = reduced(ARCHS["qwen2-moe-a2.7b"])
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    rc = RunConfig()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=32,
                      plan_max_len=64, device="cuda")
    slots, mb = 32, 4
    pools = init_paged_cache(cfg, rc, slots, slots * mb, 16, device="cuda")
    copy = clone_cache(pools)
    tables = torch.randperm(slots * mb, device="cuda").to(
        torch.int32).view(slots, mb)
    gen = torch.Generator(device="cuda").manual_seed(1)
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    step = core.batch_step
    tok = pos = None
    for t in range(6):
        tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                            device="cuda")
        pos = ((torch.arange(slots, device="cuda") * 7 + t) % (mb * 16)).to(
            torch.int32)
        if t == 1:      # the first call warmed up, captured and replayed
            before = (moe_experts.launches, int8_gemm.launches)
        got, pools = step(pools, tok, pos, active, tables)
        if t == 1:
            per_replay = (moe_experts.launches - before[0],
                          int8_gemm.launches - before[1])
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
        assert torch.equal(got, want), t
    assert step.captures == 1
    assert per_replay[0] == 2 * _moe_layers(cfg) == 2 * cfg.n_layers
    # the einsum route's eager step launches the same INT8 GEMM calls
    monkeypatch.setattr(tmoe, "_grouped_kernel_takes", lambda *a: False)
    with torch.inference_mode():
        start = (moe_experts.launches, int8_gemm.launches)
        decode_step(core.params, copy, tok, pos, cfg, rc,
                    plan=core.plan_table, active=active, block_tables=tables)
    assert (moe_experts.launches - start[0],
            int8_gemm.launches - start[1]) == (0, per_replay[1])


def _attention_layers(cfg) -> int:
    from repro_torch.models.model import n_periods, period_slots
    return n_periods(cfg) * sum(s.mixer == "attn" for s in period_slots(cfg))


@pytest.mark.parametrize("arch,layers", [("qwen2-7b", 28),
                                         ("qwen2-moe-a2.7b", 24)])
def test_captured_step_credits_one_paged_launch_per_layer(cuda, arch, layers,
                                                          monkeypatch):
    """The engine cells' step, captured (reduced widths at the cells'
    depths, 32 slots, blocks of 16): each replay credits exactly one paged
    launch per attention layer and no other attention kernel, no strip
    is gathered, and the replay equals the eager step bit for bit."""
    import dataclasses
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    from repro_torch.models import model as tm
    from repro_torch.serving import DecodeCore
    cfg = dataclasses.replace(reduced(ARCHS[arch]), n_layers=layers)
    assert _attention_layers(cfg) == layers
    rc = RunConfig()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=32,
                      plan_max_len=64, device="cuda")

    def no_gather(*a, **kw):
        raise AssertionError("the kernel route gathered a strip")
    monkeypatch.setattr(tm, "_paged_view", no_gather)
    slots, mb = 32, 4
    pools = init_paged_cache(cfg, rc, slots, slots * mb, 16, device="cuda")
    copy = clone_cache(pools)
    tables = torch.randperm(slots * mb, device="cuda").to(
        torch.int32).view(slots, mb)
    gen = torch.Generator(device="cuda").manual_seed(1)
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    step = core.batch_step
    first = paged_decode_attention.launches
    for t in range(6):
        tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                            device="cuda")
        pos = (torch.arange(slots, device="cuda") * 7 + t) % (mb * 16)
        pos = pos.to(torch.int32)
        if t == 1:      # the first call warmed up, captured and replayed
            before = (paged_decode_attention.launches,
                      decode_attention.launches, flash_attention.launches)
        got, pools = step(pools, tok, pos, active, tables)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
        assert torch.equal(got, want), t
    assert step.captures == 1
    # the first call's warm-up and replay (the capture credits nothing),
    # then the eager step
    assert before[0] - first == 3 * layers
    assert (paged_decode_attention.launches - before[0],
            decode_attention.launches - before[1],
            flash_attention.launches - before[2]) == (
        2 * 5 * layers, 0, 0)     # 5 replays + 5 eager steps


def test_kernel_route_streams_match_plain_route(cuda, monkeypatch):
    """Reduced qwen2-7b's paged step over 40 greedy steps at ragged
    lengths: the kernel route against the eager plain route
    (`decode_attend` over the gathered strips), both fed the kernel
    route's greedy tokens: logits within 2**-6 of max|ref| (the model's
    bf16 tolerance; the two differ in the order of f32 sums and where bf16
    rounds), and the same greedy token wherever the plain route's top-two
    gap exceeds twice that."""
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    from repro_torch.models import model as tm
    cfg, rc, core = _graph_core(cuda)
    b, mb, bs = 4, 4, 16
    pools = init_paged_cache(cfg, rc, b, b * mb, bs, device="cuda")
    plain = clone_cache(pools)
    tables = torch.arange(b * mb, dtype=torch.int32,
                          device="cuda").view(b, mb).flip(1)
    pos0 = torch.tensor([0, 5, 17, 20], dtype=torch.int32, device="cuda")
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    tok = torch.tensor([[1], [2], [3], [4]], device="cuda")
    fits = tm.paged_kernel_fits
    agree = compared = 0
    for t in range(40):
        pos = pos0 + t
        with torch.inference_mode():
            before = paged_decode_attention.launches
            got, pools = decode_step(core.params, pools, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
            assert paged_decode_attention.launches == before + cfg.n_layers
            monkeypatch.setattr(tm, "paged_kernel_fits",
                                lambda *a: False)
            want, plain = decode_step(core.params, plain, tok, pos, cfg, rc,
                                      plan=core.plan_table, active=active,
                                      block_tables=tables)
            monkeypatch.setattr(tm, "paged_kernel_fits", fits)
        g, w = got.float()[:, 0], want.float()[:, 0]
        tol = 2.0 ** -6 * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol, t
        top2 = w.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree += int((g.argmax(-1) == w.argmax(-1))[clear].sum())
        compared += int(clear.sum())
        tok = g.argmax(-1, keepdim=True)
    assert agree == compared and compared > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_forward_on_card_matches_cpu(cuda, dtype):
    """The reduced qwen2-7b prefill (INT8 params, prefill table forced
    all-CiM, attn_impl="pallas" reaching the flash kernel) on the card
    against the same forward on the CPU (the plain versions)."""
    import dataclasses
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-7b"]), param_dtype=dtype,
                              compute_dtype=dtype)
    rc = RunConfig(attn_impl="pallas", attn_chunk=8)
    params = quantize_model_params(
        init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    table = KernelPlanTable.from_decisions(plan_workload_by_phase(
        phase_gemms_of_model(cfg, 16, 2), backend="scalar")["prefill"],
        model_name=cfg.name)
    for lab in table.labels:
        if not table.use_cim(lab):
            table = table.with_flip(lab)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want, _ = forward(params, tokens, cfg, rc, plan=table)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(cuda)
    before = (flash_attention.launches, int8_gemm.launches)
    got, _ = forward(to_card(params), tokens.to(cuda), cfg, rc, plan=table)
    torch.cuda.synchronize()
    assert flash_attention.launches - before[0] == cfg.n_layers
    assert int8_gemm.launches - before[1] == 7 * cfg.n_layers + 1
    err = (got.float().cpu() - want.float()).abs().max().item()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert err <= tol * want.float().abs().max().item(), err


# --- the serving steps as CUDA graphs ----------------------------------------
# Bitwise: a replayed graph launches the eager step's kernels in the same
# order on the same inputs, so logits and caches equal bit for bit.

def _graph_core(cuda, kv="bfloat16", gate_all=True):
    """A CUDA DecodeCore over reduced qwen2-7b (bf16, INT8 weights); with
    gate_all the decode and prefill tables send every label to the GEMM
    kernel (at d_model 64 the planner gates none)."""
    from repro_torch.serving import DecodeCore
    cfg = reduced(ARCHS["qwen2-7b"])
    rc = RunConfig(kv_cache_dtype=kv)
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=4,
                      plan_max_len=24, device="cuda")
    if gate_all:
        table = core.plan_table
        for lab in table.labels:
            if not table.use_cim(lab):
                table = table.with_flip(lab)
        core.plan_table = core.prefill_plan_table = table
    return cfg, rc, core


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_graphed_fixed_step_equals_eager(cuda, kv):
    from repro_torch.models import clone_cache, init_cache
    from repro_torch.serving import make_serve_step
    cfg, rc, core = _graph_core(cuda, kv)
    cache = init_cache(cfg, rc, 4, 12, device="cuda")
    copy = clone_cache(cache)
    eager = make_serve_step(cfg, rc, core.plan_table)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for pos in range(6):
        tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen,
                            device="cuda")
        got, cache = core.step(cache, tok, pos)
        with torch.inference_mode():
            want, copy = eager(core.params, copy, tok, pos)
        assert torch.equal(got, want), pos
    for key in cache[0]:
        assert torch.equal(cache[0][key], copy[0][key])
    assert core.decode_executables == core.prefill_executables == 1


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_graphed_batch_step_equals_eager(cuda, kv):
    """Ragged positions, an inactive slot whose table aliases a live
    block, tables changing between replays: logits and pools bit for bit
    against the eager decode_step on a clone of the pools.  Active slots
    own distinct blocks, as the engine's allocator guarantees (two active
    slots writing one row would race in both versions)."""
    from repro_torch.models import clone_cache, decode_step, init_paged_cache
    cfg, rc, core = _graph_core(cuda, kv)
    pools = init_paged_cache(cfg, rc, 3, 12, 8, device="cuda")
    copy = clone_cache(pools)
    step = core.batch_step
    gen = torch.Generator(device="cuda").manual_seed(2)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5], [0, 6, 7]],
                          dtype=torch.int32, device="cuda")
    for t in range(7):
        tok = torch.randint(0, cfg.vocab, (3, 1), generator=gen,
                            device="cuda")
        pos = torch.tensor([t, t + 3, t], dtype=torch.int32, device="cuda")
        # slot 2 idles on slot 0's blocks, then owns blocks of its own
        active = torch.tensor([True, True, t >= 4 and t % 2 == 0],
                              device="cuda")
        if t == 4:
            tables[2] = torch.tensor([8, 9, 10], device="cuda")
        got, pools = step(pools, tok, pos, active, tables)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
        assert torch.equal(got, want), t
    for key in pools[0]:
        assert torch.equal(pools[0][key], copy[0][key])
    assert core.batch_decode_executables == 1 and step.captures == 1


def test_replays_credit_the_launch_counters(cuda):
    """A replay launches nothing from Python, yet the counters move by
    what the captured step launched: 7 projections per layer + lm_head,
    all on design B, exactly as the eager step counts."""
    from repro_torch.models import init_cache
    cfg, rc, core = _graph_core(cuda)
    per_step = 7 * cfg.n_layers + 1
    cache = init_cache(cfg, rc, 4, 12, device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    before = (int8_gemm.launches, dict(int8_gemm.launches_by_design),
              dict(int8_gemm.launches_by_format))
    core.step(cache, tok, 0)                 # warm-up + capture + replay
    assert int8_gemm.launches - before[0] == 2 * per_step
    start = (int8_gemm.launches, dict(int8_gemm.launches_by_design),
             dict(int8_gemm.launches_by_format))
    for pos in range(1, 6):
        core.step(cache, tok, pos)
    assert int8_gemm.launches - start[0] == 5 * per_step
    assert int8_gemm.launches_by_design["B"] - start[1]["B"] == 5 * per_step
    assert int8_gemm.launches_by_format["int8"] - start[2]["int8"] == (
        5 * per_step)
    assert core.decode_executables == 1


def test_engine_captures_once_through_slot_churn(cuda):
    """Back-to-back runs of different ragged traffic (joins at full
    occupancy, evictions) replay the one captured batch step."""
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.serving import synthetic_requests
    cfg, _, core = _graph_core(cuda)
    eng = ContinuousBatchingEngine(core, n_slots=2, max_len=24, block_size=8)
    streams = []
    for n_req, seed in ((3, 11), (4, 12), (3, 11)):
        eng.run(synthetic_requests(cfg, n_req, seed=seed, prompt_len=(3, 6),
                                   new_tokens=(3, 9)), None)
        streams.append([[int(t) for t in r.tokens]
                        for r in eng.completed[-n_req:]])
        assert eng.decode_executables == 1
    assert streams[0] == streams[2]           # replays are deterministic
    tel = eng.telemetry()["aggregate"]
    assert tel["completed"] == 10 and tel["kv_donation_ok"] is True
    assert tel["decode_executables"] == 1


def test_reset_keeps_the_graph_valid(cuda):
    from repro_torch.serving import ServeSession
    cfg = reduced(ARCHS["qwen2-7b"])
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    sess = ServeSession(cfg, RunConfig(), params, max_len=12, batch=2,
                        quantize=True, device="cuda")
    prompt = torch.tensor([[5, 6, 7], [8, 9, 10]], device="cuda")
    ptrs = [t.data_ptr() for t in sess.cache[0].values()]
    first = sess.generate(prompt, 5)
    sess.reset()
    assert [t.data_ptr() for t in sess.cache[0].values()] == ptrs
    assert not any(bool(t.any()) for t in sess.cache[0].values())
    assert torch.equal(sess.generate(prompt, 5), first)
    assert sess.decode_executables == 1


def test_failed_capture_raises_and_never_runs_eagerly(cuda, monkeypatch):
    """A step that reads a tensor on the host cannot be captured: the
    call raises, and so does the next one (no eager fallback)."""
    core_mod = importlib.import_module("repro_torch.serving.core")
    from repro_torch.models import init_cache
    cfg, rc, core = _graph_core(cuda, gate_all=False)
    real = core_mod.decode_step
    calls = []

    def syncing_step(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        calls.append(float(logits.float().sum().item()))   # a host read
        return logits, cache

    monkeypatch.setattr(core_mod, "decode_step", syncing_step)
    cache = init_cache(cfg, rc, 2, 8, device="cuda")
    tok = torch.zeros((2, 1), dtype=torch.long, device="cuda")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            core.step(cache, tok, 0)
    assert len(calls) == 2                   # the two warm-ups only
    assert core.decode_executables == 0
    torch.cuda.synchronize()                 # the card is still usable


def test_capture_holds_off_the_garbage_collector(cuda):
    """A dead graph in a reference cycle that the cyclic collector would
    free in the middle of another graph's capture: destroying a CUDA
    graph while a stream captures invalidates the capture, so StepGraph
    collects before it captures and holds the collector off during it.
    Here the step itself makes the old graph cyclic garbage during its
    capture and then allocates with the collector due at every
    allocation."""
    import gc

    from repro_torch.serving.graphs import StepGraph
    x = torch.ones(4, device="cuda")
    box = [StepGraph(lambda t: t * 2)]
    box[0](x)                                 # captured and replayed
    thresholds = gc.get_threshold()

    def step(t):
        if torch.cuda.is_current_stream_capturing() and box:
            cycle = [box.pop()]
            cycle.append(cycle)               # only the collector frees it
            del cycle
            gc.set_threshold(1)
            junk = [[] for _ in range(1000)]  # allocations that would collect
            del junk
        return t * 3

    try:
        out = StepGraph(step)(x)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert torch.equal(out, x * 3) and not box
    gc.collect()                              # the old graph goes now


# --- spans inside the captured step ------------------------------------------
# repro_torch.spans: with a recorder armed, each StepGraph captures a marked
# twin beside the plain graph; the marks' self times sum to the marked
# step's in-graph device time.

def test_span_mark_resolution(cuda):
    """1,000 marks back to back, each charging a slot of its own: the
    intervals sum to the CUDA-event time of the run within 5% (the events
    also hold the first mark itself), and the device's global timer
    ticks at 1 us or finer."""
    from math import gcd
    from repro_torch import spans
    n = 1000
    acc = torch.zeros(n, dtype=torch.int64, device="cuda")
    last = torch.zeros(1, dtype=torch.int64, device="cuda")
    spans.mark(acc, last, -1)
    torch.cuda.synchronize()
    acc.zero_()
    last.zero_()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        spans.mark(acc, last, i)
    end.record()
    torch.cuda.synchronize()
    steps = acc.tolist()
    assert steps[0] == 0                  # the first mark only sets the time
    assert min(steps[1:]) >= 0
    ms = start.elapsed_time(end)
    assert abs(sum(steps) / 1e6 - ms) <= 0.05 * ms, (sum(steps), ms)
    tick = 0
    for d in steps[1:]:
        tick = gcd(tick, d)
    assert 0 < tick <= 1000, tick


def _span_step(cuda, slots=32, blocks=8, bs=16):
    """Reduced qwen2-7b's paged batch step at `slots` slots of `blocks`
    blocks each, every slot active: (step, inputs) after its first call
    (which captures)."""
    from repro_torch.models import init_paged_cache
    cfg, rc, core = _graph_core(cuda)
    pools = init_paged_cache(cfg, rc, slots, slots * blocks, bs,
                             device="cuda")
    tables = torch.arange(slots * blocks, dtype=torch.int32,
                          device="cuda").reshape(slots, blocks)
    tok = torch.randint(0, cfg.vocab, (slots, 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(4))
    pos = torch.arange(slots, dtype=torch.int32, device="cuda") * 3 + 5
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    inputs = (pools, tok, pos, active, tables)
    step = core.batch_step
    step(*inputs)
    return step, inputs, cfg


def _kernels_of(graph) -> list:
    """The kernel names one replay of `graph` launches, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sorted(e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def test_span_sections_sum_to_the_marked_replay(cuda):
    """The marked twin's sections, the root's self time included, sum to
    within 5% of its replays' CUDA-event time; the sections are the dense
    step's five."""
    from repro_torch import spans
    rec = spans.arm("cuda")
    try:
        step, _, cfg = _span_step(cuda)
        graph = next(iter(step.graphs.values()))
        assert graph.marked is not None
        # root + lm_head + 7 projections and 3 attention sections a layer
        assert graph.marks == 2 * (2 + 10 * cfg.n_layers)
        for _ in range(3):
            graph.marked.replay()
        n = 50
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        rec.open()
        start.record()
        for _ in range(n):
            graph.marked.replay()
        end.record()
        torch.cuda.synchronize()
        rec.close()
        sec = rec.seconds()
        ms = start.elapsed_time(end)
        total = sum(sec.values()) * 1e3
        assert abs(total - ms) <= 0.05 * ms, (sec, ms)
        assert {k for k, v in sec.items() if v > 0} == {
            "decode.step", "attn.kv_write", "attn.gather", "attn.core",
            "proj"}
    finally:
        spans.disarm()


def test_span_twins_launch_the_parents_kernels(cuda):
    """The plain twin launches per replay exactly the kernels of a step
    captured with no recorder armed; the marked twin those and one mark
    kernel per mark.  Both twins credit the same launch counts, and a
    replay of either moves the counters by them."""
    from repro_torch import spans
    plain_step, _, _ = _span_step(cuda, slots=4, blocks=2)
    unarmed = next(iter(plain_step.graphs.values()))
    assert unarmed.marked is None
    want = _kernels_of(unarmed.graph)
    rec = spans.arm("cuda")
    try:
        step, inputs, cfg = _span_step(cuda, slots=4, blocks=2)
        graph = next(iter(step.graphs.values()))
        assert _kernels_of(graph.graph) == want
        marked = _kernels_of(graph.marked)
        marks = [k for k in marked if "span_mark" in k]
        assert len(marks) == graph.marks
        assert sorted(k for k in marked if "span_mark" not in k) == want
        assert graph.credit == unarmed.credit
        per_step = 7 * cfg.n_layers + 1
        for on in (False, True):
            if on:
                rec.open()
            before = int8_gemm.launches
            step(*inputs)
            assert int8_gemm.launches - before == per_step, on
        rec.close()
        assert step.captures == 1
    finally:
        spans.disarm()


def test_prefill_forward_range_is_host_only(cuda):
    """`make_prefill`'s "prefill.forward" range is among a profiler's host
    records, once per forward, and not among its device records, whose
    busy union it would otherwise fill over the forward's idle gaps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import make_prefill
    cfg = reduced(ARCHS["qwen2-7b"])
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    prefill = make_prefill(cfg, RunConfig())
    ids = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    prefill(params, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            prefill(params, ids)
        torch.cuda.synchronize()
    host, dev = [], []
    for r in prof.profiler.kineto_results.events():
        kind = getattr(r.device_type(), "name", str(r.device_type()))
        (dev if kind.endswith("CUDA") else host).append(r.name())
    assert host.count("prefill.forward") == 2
    assert "prefill.forward" not in dev and dev


# --- the moe, ssm and hybrid families as CUDA graphs -------------------------

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "mamba2-780m", "jamba-1.5-large-398b")


def _family_core(arch):
    """A CUDA DecodeCore over reduced `arch` (bf16, INT8 weights) with every
    label gated on: the 2-D projections run the GEMM kernel, the experts
    their dequant einsums."""
    from repro_torch.serving import DecodeCore
    cfg = reduced(ARCHS[arch])
    rc = RunConfig()
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, rc, params, quantize=True, plan_batch=4,
                      plan_max_len=24, device="cuda")
    table = core.plan_table
    for lab in table.labels:
        if not table.use_cim(lab):
            table = table.with_flip(lab)
    core.plan_table = core.prefill_plan_table = table
    return cfg, rc, core


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_graphed_family_steps_equal_eager(cuda, arch):
    """The fixed-batch step and the paged, masked batch step of each new
    family, replayed from one CUDA graph each, against the eager
    decode_step on a clone of the cache: logits, KV pools, mamba state
    and conv carry bit for bit (the mamba entries are updated in place,
    an inactive slot's left as they were)."""
    from repro_torch.models import (clone_cache, decode_step, init_cache,
                                    init_paged_cache)
    cfg, rc, core = _family_core(arch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cache = init_cache(cfg, rc, 4, 12, device="cuda")
    copy = clone_cache(cache)
    for pos in range(5):
        tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen,
                            device="cuda")
        got, cache = core.step(cache, tok, pos)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table)
        assert torch.equal(got, want), pos
    for ours, ref in zip(cache, copy):
        for key in ours:
            assert torch.equal(ours[key], ref[key]), key
    pools = init_paged_cache(cfg, rc, 3, 12, 8, device="cuda")
    copy = clone_cache(pools)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8]],
                          dtype=torch.int32, device="cuda")
    for t in range(5):
        tok = torch.randint(0, cfg.vocab, (3, 1), generator=gen,
                            device="cuda")
        pos = torch.tensor([t, t + 2, t], dtype=torch.int32, device="cuda")
        active = torch.tensor([True, True, t % 2 == 0], device="cuda")
        got, pools = core.batch_step(pools, tok, pos, active, tables)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table, active=active,
                                     block_tables=tables)
        assert torch.equal(got, want), t
    for ours, ref in zip(pools, copy):
        for key in ours:
            assert torch.equal(ours[key], ref[key]), key
    assert core.decode_executables == 1
    assert core.batch_decode_executables == 1


@pytest.mark.parametrize("arch", ("mamba2-780m", "jamba-1.5-large-398b"))
def test_engine_resets_mamba_state_under_the_graph(cuda, arch):
    """The engine on the card: the same requests run twice through one
    engine give the same streams, so every joining slot starts from a
    zeroed state although the slots still hold the first run's (the
    reset writes in place: the cache keeps its addresses, and the
    captured steps replay)."""
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeCore,
                                     synthetic_requests)
    cfg = reduced(ARCHS[arch])
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    core = DecodeCore(cfg, RunConfig(), params, quantize=True, plan_batch=8,
                      plan_max_len=24, device="cuda")
    eng = ContinuousBatchingEngine(core, n_slots=2, max_len=24, block_size=8)
    ptrs = [t.data_ptr() for e in eng.cache for t in e.values()]
    streams = []
    for _ in range(2):
        eng.run(synthetic_requests(cfg, 5, seed=4, prompt_len=(2, 5),
                                   new_tokens=(2, 6)), None)
        streams.append([[int(t) for t in r.tokens]
                        for r in eng.completed[-5:]])
        assert any(bool(e["state"].any()) for e in eng.cache
                   if "state" in e)
    assert streams[0] == streams[1]
    assert [t.data_ptr() for e in eng.cache for t in e.values()] == ptrs
    assert core.batch_decode_executables == len(
        {core.plan_table, core.prefill_plan_table})


# --- the audio and vlm families as CUDA graphs, and the paper's sweeps --------

@pytest.mark.parametrize("arch", ("musicgen-large", "llama-3.2-vision-90b"))
def test_graphed_audio_and_vlm_steps_equal_eager(cuda, arch):
    """The fixed-batch step of reduced musicgen-large ((b, 1, nb) tokens,
    the spec-form head) and llama-3.2-vision-90b (its cross slots reading
    the image K/V), replayed from one CUDA graph, against the eager
    decode_step on a clone of the cache: logits and cache bit for bit."""
    from repro_torch.models import clone_cache, decode_step, init_cache
    from repro_torch.serving.core import token_shape
    cfg, rc, core = _family_core(arch)
    n_img = cfg.vision.n_image_tokens if cfg.family == "vlm" else 0
    gen = torch.Generator(device="cuda").manual_seed(3)
    cache = init_cache(cfg, rc, 4, 12, device="cuda", n_image_tokens=n_img)
    for e in cache:
        if n_img and e["k"].shape[2] == n_img:      # image K/V, not zeros
            e["k"].normal_(generator=gen)
            e["v"].normal_(generator=gen)
    copy = clone_cache(cache)
    for pos in range(5):
        tok = torch.randint(0, cfg.vocab, token_shape(cfg, 4), generator=gen,
                            device="cuda")
        got, cache = core.step(cache, tok, pos)
        with torch.inference_mode():
            want, copy = decode_step(core.params, copy, tok, pos, cfg, rc,
                                     plan=core.plan_table)
        assert torch.equal(got, want), pos
    for ours, ref in zip(cache, copy):
        for key in ours:
            assert torch.equal(ours[key], ref[key]), key
    assert core.decode_executables == 1


def test_paper_fig13_backends_equal_on_card(cuda):
    """`launch/paper.py`'s Fig. 13 on the card: the sweep kernel
    (backend "pallas", launched) and the torch spec give the same rows
    and derived metrics (the kernel is bit-equal to its plain version)."""
    from repro_torch.kernels.sweep_eval import sweep_eval as kernel
    from repro_torch.launch import paper
    vec = paper.fig13_square_gemms(backend="vectorized", device="cuda",
                                   engine=SweepEngine(device="cuda"))
    before = kernel.launches
    pal = paper.fig13_square_gemms(backend="pallas", device="cuda",
                                   engine=SweepEngine(device="cuda"))
    assert kernel.launches > before
    assert pal == vec


# --- training on the card ---------------------------------------------------

# reduced qwen2-7b widened (tests/test_torch_lowbit_serving.py's width)
TRAIN_WIDE = dict(d_model=256, d_ff=512, d_head=64, vocab=512)


def _train_cfg(dtype="float32", **kw):
    import dataclasses
    return dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **TRAIN_WIDE,
                               param_dtype=dtype, compute_dtype=dtype, **kw)


def _train_batch(cfg, batch=4, seq=64, step=0):
    from repro_torch.data import DataConfig, batch_at_step
    return batch_at_step(DataConfig(seed=0, vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch), step, device="cpu")


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 AdamW step on the card against the same step on the CPU:
    loss within 1e-5 and gnorm within 1e-4 relative; the updated params
    within 2·lr (Adam's first step is ~lr·sign(g): an element whose
    gradient is ~0 may move the other way on the other device), at most
    1e-3 of the elements beyond 1e-6·max|p|."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_tree
    cfg = _train_cfg()
    rc = RunConfig(learning_rate=1e-3, warmup_steps=0, remat=True,
                   attn_chunk=16)
    cpu = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = map_tree(lambda t: t.to(cuda, copy=True), cpu)
    b = _train_batch(cfg)
    step = make_train_step(cfg, rc)
    _, _, mc = step(cpu, adamw_init(cpu), b, 0)
    _, _, mg = step(card, adamw_init(card),
                    {k: v.to(cuda) for k, v in b.items()}, 0)
    assert abs(mg["loss"].item() / mc["loss"].item() - 1) <= 1e-5
    assert abs(mg["gnorm"].item() / mc["gnorm"].item() - 1) <= 1e-4
    flips = n = 0
    for pc, pg in zip(leaves(cpu), leaves(card)):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        assert diff.max().item() <= 2 * rc.learning_rate * (1 + 1e-3)
        flips += int((diff > 1e-6 * pc.detach().abs().max()).sum())
        n += diff.numel()
    assert flips <= 1e-3 * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_update_on_card_matches_cpu(cuda, which, dtype,
                                              monkeypatch):
    """Three updates with the same params, grads and lr on both devices,
    leaves cut into slices (SLICE_ELEMS shrunk): f32 within 1e-6 of each
    leaf's largest magnitude, bf16 within one bf16 ulp."""
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves, map_tree
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", 100)
    gen = torch.Generator().manual_seed(0)
    shapes = [(16, 8), (8,), (3, 8, 12), (2, 3, 4, 6), (3, 1, 6)]
    params = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    grads = [(torch.randn(s, generator=gen) * 0.3).to(dtype)
             for s in shapes]
    opt_init, update = make_optimizer(which)
    out = {}
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.to(dev, copy=True), params)
        g = map_tree(lambda t: t.to(dev), grads)
        st = opt_init(p)
        for lr in (3e-3, 1e-2, 5e-3):
            update(p, g, st, lr)
        out[str(dev)] = [t.cpu() for t in leaves((p, st))]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        if a.dtype == torch.bfloat16:
            d = (a.view(torch.int16).int() - b.view(torch.int16).int())
            assert d.abs().max().item() <= 1
        elif a.is_floating_point():
            scale = max(a.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= 1e-6 * scale
        else:
            assert torch.equal(a, b)


def test_train_step_launches_no_kernel(cuda):
    """A bf16 train step (flash_jnp attention, float weights) launches
    none of the four kernels, as the JAX package's runs none of its
    Pallas kernels; the attention kernels refuse autograd on the card
    and run under no_grad."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adafactor_init
    from repro_torch.train import make_train_step
    cfg = _train_cfg("bfloat16")
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    counted = (int8_gemm, sweep_eval, flash_attention, decode_attention)
    before = [w.launches for w in counted]
    step = make_train_step(cfg, RunConfig(optimizer="adafactor",
                                          attn_chunk=32))
    _, _, m = step(params, adafactor_init(params),
                   {k: v.to(cuda) for k, v in _train_batch(cfg).items()}, 3)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["gnorm"])
    assert [w.launches for w in counted] == before
    q, k, v = _attn_inputs([(1, 128, 4, 64)] * 3, torch.bfloat16, cuda)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q[:, :1], k, v, 7)
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert flash_attention.launches == before[2] + 1


def test_remat_lowers_peak_memory(cuda):
    """The peak memory of a forward and backward at 4 layers, 4 x 1024
    tokens: remat below no remat, "dots" between the two."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves
    cfg = _train_cfg("bfloat16", n_layers=4)
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg,
                  device="cuda")
    for p in leaves(params):
        p.requires_grad_(True)
    b = {k: v.to(cuda) for k, v in _train_batch(cfg, seq=1024).items()}
    peak = {}
    for name, kw in (("off", dict(remat=False)),
                     ("dots", dict(remat=True, remat_policy="dots")),
                     ("nothing", dict(remat=True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = loss_fn(params, b, cfg, RunConfig(attn_chunk=256, **kw))
        torch.autograd.grad(loss, list(leaves(params)))
        del loss
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    assert peak["nothing"] < peak["dots"] < peak["off"], peak


# --- the distributed layer (chip_smoke.py phase 31) ------------------------

@pytest.fixture
def nccl1(cuda):
    """A world of 1 under NCCL, through `distributed.initialize` on a free
    localhost port; destroyed after the test."""
    import socket

    import torch.distributed as tdist
    from repro_torch.launch import distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert dist.initialize(f"127.0.0.1:{port}", 1, 0) is False
    try:
        assert tdist.get_backend() == "nccl"
        assert dist.rank_device() == torch.device("cuda", 0)
        yield dist
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
def test_row_sharded_golden_plan_nccl_world1(nccl1, backend):
    """The golden grid through distributed_engine(chunk_rows=512) over a
    one-rank NCCL row mesh: every verdict equal to the golden CSV, >= 2
    chunks, the sweep kernel launched on the pallas backend."""
    with open(os.path.join(GOLDEN, "planner_verdicts.csv")) as f:
        golden = list(csv.DictReader(f))
    entries = list(_grid())
    engine = nccl1.distributed_engine(chunk_rows=512)
    assert engine.n_shards == 1 and engine.mesh.device_type == "cuda"
    assert engine.device.type == "cuda"
    before = sweep_eval.launches
    decisions = plan_workload([g for *_, g in entries], backend=backend,
                              engine=engine)
    launched = sweep_eval.launches - before
    assert (launched > 0) == (backend == "pallas")
    got = [(arch, sname, prec, g.label, d.best_energy, d.best_throughput,
            str(int(d.use_cim)), d.where)
           for (arch, sname, prec, g), d in zip(entries, decisions)]
    want = [(r["arch"], r["shape"], r["precision"], r["label"],
             r["best_energy"], r["best_throughput"], r["use_cim"],
             r["where"]) for r in golden]
    assert got == want
    info = engine.cache_info()
    assert info["chunks"]["evaluated"] >= 2
    assert info["distributed"] is None            # the mesh is this rank


def test_compressed_psum_nccl_matches_gloo_cpu(nccl1):
    """compressed_psum on the card under NCCL (world 1) against the same
    call under a gloo group on the CPU: every leaf's reduced mean and new
    residual bit for bit, over two steps (the second with a residual)."""
    import torch.distributed as tdist
    from repro_torch.optim.grad_compress import (compressed_psum,
                                                 init_error_state)
    from repro_torch.tree import flatten_with_paths
    cfg = reduced(ARCHS["qwen2-7b"])
    gloo = tdist.new_group(backend="gloo")
    errors = cpu_errors = None
    for step in range(2):
        grads = init(torch.Generator(device="cuda").manual_seed(step), cfg,
                     device="cuda")
        cpu_grads = {k: v.to("cpu", copy=True)
                     for k, v in flatten_with_paths(grads).items()}
        if errors is None:
            errors = init_error_state(grads)
            cpu_errors = {k: torch.zeros(v.shape) for k, v in
                          cpu_grads.items()}
        red, errors = compressed_psum(grads, errors)
        cpu_red, cpu_errors = compressed_psum(cpu_grads, cpu_errors,
                                              group=gloo)
        got_r, got_e = flatten_with_paths(red), flatten_with_paths(errors)
        for k in cpu_grads:
            assert torch.equal(got_r[k].cpu(), cpu_red[k]), (step, k)
            assert torch.equal(got_e[k].cpu(), cpu_errors[k]), (step, k)
