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
                                 int8_gemm_ref, ops, sweep_eval,
                                 sweep_eval_ref)
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
                             (1, 1024, 1024, 4, 2, 128, 300)]


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
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    b, S, h, kv, d = 8, 32768, 28, 4, 128
    q, kc, vc = _attn_inputs([(b, 1, h, d), (b, S, kv, d), (b, S, kv, d)],
                             torch.bfloat16, cuda, seed=5)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, split_len = da.split_plan(b * kv, S, n_sms)
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
    pools = init_paged_cache(cfg, rc, 3, 12, 4, device="cuda")
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
    eng = ContinuousBatchingEngine(core, n_slots=2, max_len=24, block_size=4)
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
