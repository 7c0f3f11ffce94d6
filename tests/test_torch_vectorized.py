"""The port's batched cost model against the JAX package's, on the CPU.

* `evaluate_flat`: bit for bit (NaN positions equal, NaN payloads
  canonicalized) against the reference's jitted `evaluate_flat`, over
  every candidate row of qwen2-7b, mamba2-780m and mistral-nemo-12b x
  {train_4k, prefill_32k} x {int8, int4, fp8} x the standard configs, in
  both order modes, and over hand-made invalid and degenerate rows;
* the sweep kernel's plain version (`sweep_eval_ref`, and the
  `sweep_eval` wrapper on CPU tensors) against the same, bit for bit;
* `evaluate_baseline_flat`: `valid` exactly and every other output
  within a relative 1e-6 — the reference's XLA contracts some a*b+c of
  the baseline into fused multiply-adds, which eager torch never does —
  with the number of rows that are not bit-equal in the message.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.core import vectorized as jv
from repro.core.gemm import GEMM as JaxGEMM
from repro.core.llm_workloads import gemms_of_model as jax_gemms_of_model
from repro.core.mapping import candidate_mappings as jax_candidates
from repro.core.planner import standard_configs as jax_standard_configs

from repro_torch.core import vectorized as tv
from repro_torch.core.gemm import GEMM
from repro_torch.core.planner import standard_configs
from repro_torch.kernels import (SWEEP_OUT_FIELDS, sweep_eval,
                                 sweep_eval_ref)

ARCHS = ("qwen2-7b", "mamba2-780m", "mistral-nemo-12b")
SHAPES = ("train_4k", "prefill_32k")
PRECISIONS = ((8, False), (4, False), (8, True))
BASE_RTOL = 1e-6


def _canon(x) -> np.ndarray:
    """f32 bits with every NaN rewritten to one NaN, so equal bit
    patterns mean equal values and equal NaN positions."""
    x = np.array(x, np.float32)
    x[np.isnan(x)] = np.nan
    return x.view(np.int32)


@functools.lru_cache(maxsize=None)
def _candidate_rows(order_mode: str) -> dict:
    """FLAT_FIELDS columns of every candidate row of the grid above."""
    cols = {f: [] for f in jv.FLAT_FIELDS}
    cfgs = list(jax_standard_configs().values())
    for arch in ARCHS:
        for shape in SHAPES:
            for g0 in jax_gemms_of_model(JAX_ARCHS[arch], JAX_SHAPES[shape]):
                for bits, fp in PRECISIONS:
                    g = (g0 if (g0.bits, g0.fp) == (bits, fp)
                         else g0.scaled(bits=bits, fp=fp))
                    for c in cfgs:
                        row = {"M": g.M, "N": g.N, "K": g.K,
                               **jv.precision_row(g), **jv.config_row(c)}
                        for mp in jax_candidates(g, c, order_mode):
                            for f, v in row.items():
                                cols[f].append(float(v))
                            for f in jv.MAP_FIELDS:
                                cols[f].append(float(getattr(mp, f)))
    return {f: np.asarray(v, np.float32) for f, v in cols.items()}


def _degenerate_rows() -> dict:
    """Invalid and degenerate rows: k_arr = 0 (NaN and inf terms),
    M = N = K = 1, zero and oversized mapping factors, int4 and fp8 on
    both compute types, RF and SMEM levels."""
    cfgs = list(jax_standard_configs().values())
    base = []
    for c in cfgs:
        for bits, fp in PRECISIONS:
            for mnk in ((1, 1, 1), (1, 4096, 4096), (7, 3, 5),
                        (4096, 1, 1)):
                base.append({"M": mnk[0], "N": mnk[1], "K": mnk[2],
                             "bits": bits, "is_fp": int(fp),
                             **jv.config_row(c),
                             "k_arr": 16, "n_arr": 8, "pk": 1, "pn": 1,
                             "m1": 4, "fk": 2, "fn": 2})
    edits = [{}, {"k_arr": 0}, {"n_arr": 0}, {"m1": 0}, {"fk": 0},
             {"fn": 0}, {"pk": 64, "pn": 64}, {"k_arr": 0, "n_arr": 0},
             {"M": 0}, {"k_arr": 1e6}, {"m1": 1e6, "fk": 4096},
             {"serialize": 0}, {"at_rf": 1}, {"at_rf": 0}]
    rows = [{**r, **e} for r in base for e in edits]
    return {f: np.asarray([r[f] for r in rows], np.float32)
            for f in jv.FLAT_FIELDS}


ROW_SETS = {"candidates": _candidate_rows, "degenerate":
            lambda order_mode: _degenerate_rows()}


@functools.lru_cache(maxsize=None)
def _reference(rows_name: str, order_mode: str) -> dict:
    batch = ROW_SETS[rows_name](order_mode)
    out = jax.jit(functools.partial(jv.evaluate_flat,
                                    order_mode=order_mode))(batch)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_bitwise(got: dict, want: dict, what: str) -> None:
    bad = {k: int((_canon(got[k]) != _canon(want[k])).sum()) for k in want}
    bad = {k: n for k, n in bad.items() if n}
    assert not bad, f"{what}: rows not bit-equal per output {bad}"


@pytest.mark.parametrize("order_mode", ["exact", "greedy"])
@pytest.mark.parametrize("rows_name", list(ROW_SETS))
def test_evaluate_flat_bitwise_vs_reference(rows_name, order_mode):
    batch = ROW_SETS[rows_name](order_mode)
    assert len(batch["M"]) > 100
    got = tv.evaluate_flat({k: torch.from_numpy(v) for k, v in batch.items()},
                           order_mode=order_mode)
    want = _reference(rows_name, order_mode)
    assert set(got) == set(want) == set(SWEEP_OUT_FIELDS)
    assert got["valid"].dtype == torch.bool
    if rows_name == "degenerate":
        assert not want["valid"].all() and want["valid"].any()
        assert np.isnan(want["compute_ns"]).any()
    _assert_bitwise({k: v.numpy() for k, v in got.items()}, want,
                    f"{rows_name}/{order_mode}")


@pytest.mark.parametrize("order_mode", ["exact", "greedy"])
@pytest.mark.parametrize("rows_name", list(ROW_SETS))
def test_sweep_kernel_plain_version_bitwise_vs_reference(rows_name,
                                                         order_mode):
    batch = ROW_SETS[rows_name](order_mode)
    rows = torch.from_numpy(np.stack([batch[f] for f in jv.FLAT_FIELDS]))
    want = _reference(rows_name, order_mode)
    before = sweep_eval.launches
    for fn in (sweep_eval_ref, sweep_eval):
        out = fn(rows, order_mode=order_mode)
        assert out.shape == (len(SWEEP_OUT_FIELDS), rows.shape[1])
        assert out.dtype == torch.float32
        got = {f: out[j].numpy() for j, f in enumerate(SWEEP_OUT_FIELDS)}
        got["valid"] = got["valid"] > 0.5
        _assert_bitwise(got, want, f"{fn.__name__} {rows_name}/{order_mode}")
    assert sweep_eval.launches == before      # CPU tensors: plain version


def test_sweep_eval_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match="field"):
        sweep_eval(torch.zeros((23, 4)))
    with pytest.raises(ValueError):
        sweep_eval(torch.zeros((24, 4)), order_mode="bogus")
    assert sweep_eval(torch.zeros((24, 0))).shape == (11, 0)


@pytest.mark.parametrize("e", [-8.0, -4.0, 0.0, 3.0, -4.5, 200.0, -300.0])
def test_pow2_exact(e):
    got = tv.pow2_exact(torch.tensor([e], dtype=torch.float32)).item()
    k = int(np.clip(np.trunc(e), -126, 127))
    assert got == 2.0 ** k
    assert torch.isnan(tv.pow2_exact(torch.tensor([float("nan")]))).all()


def _baseline_rows() -> dict:
    parts = []
    for arch in ARCHS:
        for shape in SHAPES + ("decode_32k",):
            for g in jax_gemms_of_model(JAX_ARCHS[arch], JAX_SHAPES[shape]):
                parts.append(jv.enumerate_baseline_space(g))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_evaluate_baseline_flat_vs_reference():
    batch = _baseline_rows()
    want = {k: np.asarray(v) for k, v in
            jax.jit(jv.evaluate_baseline_flat)(batch).items()}
    got = {k: v.numpy() for k, v in tv.evaluate_baseline_flat(
        {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
    assert set(got) == set(want)
    assert np.array_equal(got["valid"], want["valid"])
    not_bitwise = {k: int((_canon(got[k]) != _canon(want[k])).sum())
                   for k in want}
    for k in want:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        assert np.array_equal(np.isfinite(g), np.isfinite(w)), k
        fin = np.isfinite(w)
        rel = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]), 1e-30)
        assert rel.max(initial=0.0) <= BASE_RTOL, (
            f"{k}: max rel err {rel.max()} > {BASE_RTOL}; rows not "
            f"bit-equal per output: {not_bitwise} of {len(w)}")


def test_enumerate_baseline_space_matches_reference():
    for mnk in ((4096, 4096, 4096), (1, 3584, 512), (7, 3, 5)):
        ours = tv.enumerate_baseline_space(GEMM(*mnk))
        ref = jv.enumerate_baseline_space(JaxGEMM(*mnk))
        assert set(ours) == set(ref)
        for k in ref:
            assert np.array_equal(ours[k], np.asarray(ref[k])), (mnk, k)


def test_evaluate_batch_and_exhaustive_best_match_reference():
    g, jg = GEMM(64, 128, 256, bits=4), JaxGEMM(64, 128, 256, bits=4)
    cfg = standard_configs()["Digital-6T@RF"]
    jcfg = jax_standard_configs()["Digital-6T@RF"]
    best, best_map, n = tv.exhaustive_best(g, cfg, device="cpu")
    rbest, rmap, rn = jv.exhaustive_best(jg, jcfg)
    assert n == rn and best_map == rmap
    assert best == rbest
    space = tv.enumerate_space(g, cfg, max_points=512, device="cpu")
    ours = tv.evaluate_batch(g, cfg, space, device="cpu")
    ref = jax.jit(lambda s: jv.evaluate_batch(jg, jcfg, s))(
        {k: v.numpy() for k, v in space.items()})
    _assert_bitwise({k: v.numpy() for k, v in ours.items()},
                    {k: np.asarray(v) for k, v in ref.items()},
                    "evaluate_batch")
