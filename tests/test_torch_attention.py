"""The port's attention against the JAX package's, on the same inputs made
from a numpy seed.

* `models.attention`: `naive_causal`, `flash_jnp`, `flash_block_causal`
  and the `attend` switch, f32 and bf16, with and without a window;
* `kernels.ops.flash_attention` / `decode_attention` and the folded kernel
  functions, against the JAX wrappers and kernels run in Pallas interpret
  mode (here the port runs each kernel's plain version: the tensors are
  on the CPU), at `tests/test_kernels.py`'s shapes;
* the shape contract, the plain version only for CPU tensors, and the
  launch counters;
* the host-side plans of the CUDA kernels (the decode split plan, heads
  per block, the design per dtype) against hand-worked values, and the
  build hash over included headers;
* the per-element check that holds the card's attention kernels to their
  plain versions (`flash_attention_check`, `decode_attention_check`): it
  passes an implementation that rounds p to bf16 as the flash kernel does,
  and rejects outputs with one key tile dropped in late rows or a
  mis-scaled score.

Tolerances are relative to the reference's largest magnitude: 1e-5 in
f32 (the same f32 terms summed in another order); 2**-7 in bf16 (both
sides compute in f32 and round the output to bf16 once, so an element may
differ by one bf16 ulp, at most 2**-7 of the largest magnitude).
"""
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_folded
from repro.kernels import flash_attention as jax_flash_folded
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attention

from repro_torch.kernels import (decode_attention, decode_attention_check,
                                 decode_attention_ref, flash_attention,
                                 flash_attention_check, flash_attention_ref,
                                 ops)
from repro_torch.kernels.flash_attention import _mask, _probs, _repeat
from repro_torch.models import attention

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(shapes, dtype, seed=0):
    """numpy f32 arrays -> (jax arrays, torch tensors) of `dtype`; the bf16
    rounding is the same on both sides (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, JNP[dtype]) for a in host],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in host])


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


QKV = [(2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)]


# --- models.attention ------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_causal(dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _arrays(QKV, dtype)
    _close(attention.naive_causal(tq, tk, tv, window=window),
           jax_attention.naive_causal(jq, jk, jv, window=window), TOL[dtype])


def test_naive_causal_explicit_positions():
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(2, 8, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)], "float32", seed=3)
    pq = np.array([[3, 9, 10, 17, 20, 25, 30, 31]] * 2)
    pk = np.tile(np.arange(32), (2, 1))
    _close(attention.naive_causal(tq, tk, tv, torch.from_numpy(pq),
                                  torch.from_numpy(pk), window=8),
           jax_attention.naive_causal(jq, jk, jv, jnp.asarray(pq),
                                      jnp.asarray(pk), window=8), 1e-5)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_jnp(dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _arrays(QKV, dtype, seed=1)
    _close(attention.flash_jnp(tq, tk, tv, chunk=16, window=window),
           jax_attention.flash_jnp(jq, jk, jv, chunk=16, window=window),
           TOL[dtype])


@pytest.mark.parametrize("q_chunk", [16, 64])      # 4 query chunks; one
@pytest.mark.parametrize("window", [0, 24])
def test_flash_block_causal(window, q_chunk):
    (jq, jk, jv), (tq, tk, tv) = _arrays(QKV, "float32", seed=2)
    _close(attention.flash_block_causal(tq, tk, tv, q_chunk=q_chunk,
                                        kv_chunk=16, window=window),
           jax_attention.flash_block_causal(jq, jk, jv, q_chunk=q_chunk,
                                            kv_chunk=16, window=window),
           1e-5)


@pytest.mark.parametrize("impl,chunk,block_causal", [
    ("naive", 16, False), ("flash_jnp", 16, False), ("flash_jnp", 16, True),
    ("pallas", 16, False), ("pallas", 64, False), ("flash_jnp", 48, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend(dtype, impl, chunk, block_causal):
    """`attend` routes as the JAX package's does: chunk 64 (= sk) and 48
    (does not divide sk) go naive; impl="pallas" reaches the kernel (the
    Pallas kernel in interpret mode on the JAX side)."""
    (jq, jk, jv), (tq, tk, tv) = _arrays(QKV, dtype, seed=4)
    kw = dict(impl=impl, chunk=chunk, window=0, block_causal=block_causal,
              q_chunk=16)
    before = flash_attention.launches
    _close(attention.attend(tq, tk, tv, **kw),
           jax_attention.attend(jq, jk, jv, **kw), TOL[dtype])
    assert flash_attention.launches == before       # CPU: the plain version


# --- kernels.ops -------------------------------------------------------------

@pytest.mark.parametrize("s,h,kv,d", [(128, 4, 4, 64), (256, 4, 2, 32),
                                      (256, 8, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention(s, h, kv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(2, s, h, d), (2, s, kv, d), (2, s, kv, d)], dtype, seed=s + h)
    _close(ops.flash_attention(tq, tk, tv, block_q=64, block_kv=64),
           jax_ops.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                   interpret=True), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_window(causal):
    """A window masks keys at distance >= window, with or without the
    causal mask, as the TPU kernel does."""
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(1, 256, 4, 64), (1, 256, 4, 64), (1, 256, 4, 64)], "float32")
    _close(ops.flash_attention(tq, tk, tv, causal=causal, window=64,
                               block_q=64, block_kv=64),
           jax_ops.flash_attention(jq, jk, jv, causal=causal, window=64,
                                   block_q=64, block_kv=64, interpret=True),
           1e-5)


def test_ops_flash_attention_queries_at_the_tail():
    """sq < sk: the queries are the last sq positions (seq_offset)."""
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(2, 64, 4, 32), (2, 192, 2, 32), (2, 192, 2, 32)], "bfloat16",
        seed=5)
    _close(ops.flash_attention(tq, tk, tv, block_q=64, block_kv=64),
           jax_ops.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                   interpret=True), TOL["bfloat16"])


@pytest.mark.parametrize("length", [0, 7, 300, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_decode_attention(length, dtype):
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(2, 1, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)], dtype,
        seed=length)
    got = ops.decode_attention(tq, tk, tv, length, block_kv=128)
    _close(got, jax_ops.decode_attention(jq, jk, jv, jnp.int32(length),
                                         block_kv=128, interpret=True),
           TOL[dtype])
    if length == 0:     # every position masked: the mean of v over S
        _close(got[:, 0],
               torch.repeat_interleave(tv.float().mean(1), 4, 1).numpy(),
               TOL[dtype])


def test_ops_decode_attention_tensor_length():
    (_, jk, jv), (tq, tk, tv) = _arrays(
        [(2, 1, 4, 32), (2, 256, 4, 32), (2, 256, 4, 32)], "float32", seed=9)
    want = ops.decode_attention(tq, tk, tv, 100, block_kv=64)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(100), block_kv=64)
    assert torch.equal(got, want)
    _close(got, jax_attention.decode_attend(
        jnp.asarray(tq.numpy()), jk, jv, jnp.full((2,), 100, jnp.int32)),
        1e-5)


def test_int8_matmul():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    w = rng.integers(-127, 128, (128, 64)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, 64).astype(np.float32)
    want = jax_ops.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                               dataflow="os", block_m=8, block_n=64,
                               block_k=64, interpret=True)
    got = ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(s))
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    want_ws = jax_ops.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(s), dataflow="ws", block_m=8,
                                  block_n=64, block_k=64, interpret=True)
    got_ws = ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(s), dataflow="ws")
    assert got_ws.dtype == torch.float32
    _close(got_ws, want_ws, 1e-5)
    with pytest.raises(ValueError, match="dataflow"):
        ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(s), dataflow="is")


# --- the folded kernel functions -----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_flash_kernel(dtype):
    """The folded function against the Pallas kernel (bh_kv == bh), and
    with bh_kv < bh against the same kernel on repeated k and v."""
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(8, 128, 32), (4, 128, 32), (4, 128, 32)], dtype, seed=11)
    want = jax_flash_folded(
        jq, jnp.repeat(jk, 2, 0), jnp.repeat(jv, 2, 0), block_q=64,
        block_kv=32, interpret=True)
    _close(flash_attention(tq, tk, tv, block_q=64, block_kv=32), want,
           TOL[dtype])
    _close(flash_attention(tq, tk.repeat_interleave(2, 0),
                           tv.repeat_interleave(2, 0)), want, TOL[dtype])


@pytest.mark.parametrize("length", [0, 1, 200, 256])
def test_folded_decode_kernel(length):
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        [(6, 1, 32), (2, 256, 32), (2, 256, 32)], "float32", seed=12)
    want = jax_decode_folded(
        jq, jnp.repeat(jk, 3, 0), jnp.repeat(jv, 3, 0), jnp.int32(length),
        block_kv=64, interpret=True)
    _close(decode_attention(tq, tk, tv, length, block_kv=64), want, 1e-5)


# --- contract, devices, counters --------------------------------------------

def test_shape_contract_raises():
    q = torch.zeros((4, 100, 32))
    kv = torch.zeros((2, 100, 32))
    with pytest.raises(ValueError, match="multiples of the blocks"):
        flash_attention(q, kv, kv, block_q=64, block_kv=64)
    with pytest.raises(ValueError, match="multiple of bh_kv"):
        flash_attention(torch.zeros((3, 64, 32)), kv[:, :64], kv[:, :64])
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(torch.zeros((4, 64, 16)), kv[:, :64], kv[:, :64])
    with pytest.raises(ValueError, match="multiple of the block"):
        decode_attention(torch.zeros((4, 1, 32)), torch.zeros((2, 300, 32)),
                         torch.zeros((2, 300, 32)), 5, block_kv=128)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[:, :64], kv[:, :64], kv[:, :64], window=-1)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 2, 16)),
                            torch.zeros((1, 8, 2, 16)))


def test_cpu_plain_meta_empty_and_no_launches():
    """CPU tensors take the plain versions (no launch is counted); meta
    tensors give empty outputs of the right shape."""
    before = (flash_attention.launches, decode_attention.launches)
    (_, _, _), (tq, tk, tv) = _arrays(
        [(4, 64, 32), (2, 64, 32), (2, 64, 32)], "float32")
    assert torch.equal(flash_attention(tq, tk, tv),
                       flash_attention_ref(tq, tk, tv))
    assert torch.equal(decode_attention(tq[:, :1], tk, tv, 9),
                       decode_attention_ref(tq[:, :1], tk, tv, 9))
    assert (flash_attention.launches, decode_attention.launches) == before
    meta = flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))
    assert meta.device.type == "meta" and meta.shape == tq.shape
    meta = decode_attention(tq[:, :1].to("meta"), tk.to("meta"),
                            tv.to("meta"), 9)
    assert meta.device.type == "meta" and meta.shape == (4, 1, 32)


# --- host-side plans of the CUDA kernels -------------------------------------

@pytest.mark.parametrize("tile,n_blocks,S,n_sms,plan", [
    (64, 32, 32768, 132, (4, 8192)),   # qwen2-7b decode_32k: 128 blocks
    (64, 12, 4096, 132, (11, 384)),    # 3 x 4 kv heads: 132 // 12 = 11
    (64, 2, 300, 132, (5, 64)),        # one 64-position tile per piece
    (64, 300, 1000, 132, (1, 1024)),   # more blocks than a wave: no split
    (64, 1, 64, 132, (1, 64)),
    (64, 4, 32768, 8, (2, 16384)),     # a small card: 8 // 4 pieces
    (32, 2, 300, 132, (10, 32)),       # MLA's tile: one 32-row tile a piece
    (32, 128, 4096, 132, (1, 4096)),   # MLA, 128 slots: one wave, no split
    (32, 8, 2048, 132, (16, 128)),     # MLA, 8 slots: 132 // 8 = 16 pieces
    (32, 3, 100, 132, (4, 32))])       # a ragged last piece
def test_decode_split_plan(tile, n_blocks, S, n_sms, plan):
    """`paged.split_plan`, which both decode kernels and the paged MLA
    kernel take with their own tile, against hand-worked values: as many
    tile-aligned pieces as fit one wave of one block per SM, at most one
    per tile."""
    from repro_torch.kernels.paged import split_plan
    assert split_plan(n_blocks, S, n_sms, tile) == plan
    n_splits, split_len = plan
    assert split_len % tile == 0 and (n_splits - 1) * split_len < S
    assert n_blocks * n_splits <= max(n_blocks, n_sms)


@pytest.mark.parametrize("module,heads,py_heads", [
    ("decode_attention", "HB_MAX", "HEADS_PER_BLOCK"),
    ("mla_decode", "HMAX", "MAX_HEADS")])
def test_split_plan_tiles_are_the_kernels(module, heads, py_heads):
    """The tile a wrapper plans its splits by, and its most heads a block,
    are its CUDA source's constants (decode_attention.cu: TK and dk::T,
    HB_MAX; mla_decode.cu: T, HMAX)."""
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    with open(os.path.join(os.path.dirname(mod.__file__), "csrc",
                           f"{module}.cu")) as f:
        src = f.read()
    consts = re.findall(r"constexpr int (TK|T|HB_MAX|HMAX) = (\d+);", src)
    tiles = {int(v) for k, v in consts if k in ("TK", "T")}
    assert tiles == {mod.TILE}
    assert int(dict(consts)[heads]) == getattr(mod, py_heads)


@pytest.mark.parametrize("rep,hb", [(7, 7), (32, 16), (4, 4), (1, 1),
                                    (20, 10), (17, 1)])
def test_decode_heads_per_block(rep, hb):
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    assert da.heads_per_block(rep) == hb


def test_attention_designs_by_dtype():
    """bf16 takes the tensor-core designs, f32 the FMA kernels; both
    wrappers count launches per design, and the CPU path counts none."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    assert (fa.design(torch.bfloat16), fa.design(torch.float32)) == (
        "wgmma", "fma")
    assert (da.design(torch.bfloat16), da.design(torch.float32)) == (
        "mma", "fma")
    assert set(fa.flash_attention.launches_by_design) == set(fa.DESIGNS)
    assert set(da.decode_attention.launches_by_design) == set(da.DESIGNS)
    before = (dict(fa.flash_attention.launches_by_design),
              dict(da.decode_attention.launches_by_design))
    _, (tq, tk, tv) = _arrays([(4, 64, 32), (2, 64, 32), (2, 64, 32)],
                              "bfloat16")
    flash_attention(tq, tk, tv)
    decode_attention(tq[:, :1], tk, tv, 9)
    assert (fa.flash_attention.launches_by_design,
            da.decode_attention.launches_by_design) == before


def test_build_tag_follows_included_headers(tmp_path):
    """The library's hash covers every header a source includes,
    recursively: editing a header two includes deep renames the library,
    and so does a flag."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    src = tmp_path / "k.cu"
    assert [p.name for p in build.included_files(src)] == [
        "k.cu", "a.cuh", "b.cuh"]
    tag = build.source_tag(src, ("-O3",))
    assert build.source_tag(src, ("-O3",)) == tag
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = build.source_tag(src, ("-O3",))
    assert edited != tag
    assert build.source_tag(src, ("-O2",)) != edited
    csrc = [p.name for p in build.included_files(build.CSRC /
                                                 "flash_attention.cu")]
    assert csrc == ["flash_attention.cu", "hopper.cuh"]


# --- the kernel-vs-plain check ----------------------------------------------

def _check_inputs():
    """qwen2-7b's prefill layer with 7 of its 28 query heads (one kv head):
    (1, 2048, 7/1, 128) bf16, unfolded and folded."""
    _, qkv = _arrays([(1, 2048, 7, 128), (1, 2048, 1, 128),
                      (1, 2048, 1, 128)], "bfloat16", seed=13)
    return qkv, [ops.fold(t) for t in qkv]


def _renormalised(p, v):
    """p @ v with each row of p renormalised, rounded to bf16."""
    return torch.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdim=True),
                        v.float()).bfloat16()


def test_attention_check_passes_rounded_p_and_the_plain_versions():
    """`flash_jnp` with 64-key chunks runs the bf16 flash kernel's
    recurrence (running max, p rounded to bf16 for PV, l summed in f32):
    it must pass the flash check.  The plain versions pass their own
    checks in both dtypes."""
    (q4, k4, v4), (q, k, v) = _check_inputs()
    got = ops.fold(attention.flash_jnp(q4, k4, v4, chunk=64))
    r = flash_attention_check(got, q, k, v)
    assert r["ok"] and 0.0 < r["max_abs_err"], r
    for dt in (torch.bfloat16, torch.float32):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        assert flash_attention_check(flash_attention_ref(qd, kd, vd, True, 64),
                                     qd, kd, vd, window=64)["ok"]
        for length in (0, 7, 2048):
            assert decode_attention_check(
                decode_attention_ref(qd[:, :1], kd, vd, length), qd[:, :1],
                kd, vd, length)["ok"]


@pytest.mark.parametrize("fault", ["tile_in_last_block", "scale"])
def test_attention_check_rejects_a_faulty_kernel(fault):
    """Outputs a faulty kernel would give: one 64-key tile dropped in the
    last 128-row query block of one head, or every score scaled 1% too
    large.  Both errors are a few hundredths, the size of a whole-tensor
    bound set by the first rows' large outputs; the per-element check
    must reject them."""
    _, (q, k, v) = _check_inputs()
    vr = _repeat(v, q.shape[0])
    if fault == "tile_in_last_block":
        p = _probs(q, _repeat(k, q.shape[0]), True, 0)
        p[0, -128:, 192:256] = 0
        bad = _renormalised(p, vr)
    else:
        s = torch.einsum("bqd,bkd->bqk", q.float(),
                         _repeat(k, q.shape[0]).float()) * (1.01 / 128 ** 0.5)
        s = torch.where(_mask(2048, 2048, True, 0, "cpu"), s, -1e30)
        bad = _renormalised(torch.softmax(s, -1), vr)
    r = flash_attention_check(bad, q, k, v)
    assert r["max_abs_err"] < 0.1 and not r["ok"], r


# --- the paged entry: the engine's decode attention over a block pool --------

PAGED_LENGTHS = [0, 1, 15, 16, 17, 511, 512, 600]    # S = 512; 600 > S


def _paged(rep, dtype, tables_kind, seed=0, KV=2, d=16, bs=16, mb=32):
    """q, pools and tables for len(PAGED_LENGTHS) slots at S = mb * bs:
    the tables a shuffle of the pool's blocks; "aliased": the last slot
    (inactive in an engine) names the first slot's blocks."""
    gen = torch.Generator().manual_seed(seed)
    b = len(PAGED_LENGTHS)
    n_blocks = b * mb + 5
    q, kp, vp = (torch.randn(s, generator=gen).to(TORCH[dtype]) for s in (
        (b, 1, KV * rep, d), (n_blocks, bs, KV, d), (n_blocks, bs, KV, d)))
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb].view(b, mb)
    if tables_kind == "aliased":
        tables[-1] = tables[0]
    return q, kp, vp, tables.to(torch.int32), torch.tensor(PAGED_LENGTHS)


@pytest.mark.parametrize("tables_kind", ["shuffled", "aliased"])
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_plain_equals_decode_attend(dtype, window, rep, tables_kind):
    """The paged entry's plain version (what it runs on CPU tensors) is
    `decode_attend` over `_paged_view`'s strips bit for bit, at ragged
    lengths (0, the edges of a block, S and past S), windowed or not."""
    from repro_torch.models.model import _paged_view
    q, kp, vp, tables, lengths = _paged(rep, dtype, tables_kind,
                                        seed=rep + window)
    got = ops.paged_decode_attention(q, kp, vp, tables, lengths,
                                     window=window)
    want = attention.decode_attend(q, _paged_view(kp, tables),
                                   _paged_view(vp, tables), lengths,
                                   window=window)
    assert got.dtype == q.dtype and torch.equal(got, want)


def _refusal(case):
    """(arguments, keyword arguments, the exception, its message) of one
    refused call of the paged wrapper."""
    q, kp, vp, tables, lengths = _paged(4, "bfloat16", "shuffled")
    cases = {
        "q-3d": ((q[:, 0], kp, vp, tables, lengths), ValueError,
                 "q \\(b, 1, H, d\\)"),
        "head-width": ((q[..., :8], kp, vp, tables, lengths), ValueError,
                       "head widths"),
        "heads": ((q[:, :, :3], kp, vp, tables, lengths), ValueError,
                  "multiple of KV"),
        "tables-rows": ((q, kp, vp, tables[:3], lengths), ValueError,
                        "block_tables"),
        "lengths-shape": ((q, kp, vp, tables, lengths[:, None]), ValueError,
                          "lengths"),
        "float-tables": ((q, kp, vp, tables.float(), lengths), TypeError,
                         "integers"),
        "int8-pool": ((q, kp.to(torch.int8), vp.to(torch.int8), tables,
                       lengths), TypeError, "bfloat16"),
        "mixed-dtype": ((q.float(), kp, vp, tables, lengths), TypeError,
                        "bfloat16"),
        "window": ((q, kp, vp, tables, lengths), ValueError, "window"),
        "devices": ((q, kp.to("meta"), vp, tables, lengths), ValueError,
                    "share a device"),
        "autograd": ((q.float().requires_grad_(), kp.float(), vp.float(),
                      tables, lengths), RuntimeError, "no backward"),
    }
    args, exc, match = cases[case]
    return args, {"window": -1} if case == "window" else {}, exc, match


@pytest.mark.parametrize("case", ["q-3d", "head-width", "heads",
                                  "tables-rows", "lengths-shape",
                                  "float-tables", "int8-pool", "mixed-dtype",
                                  "window", "devices", "autograd"])
def test_paged_wrapper_refuses(case):
    args, kw, exc, match = _refusal(case)
    before = ops.paged_decode_attention.launches
    with pytest.raises(exc, match=match):
        ops.paged_decode_attention(*args, **kw)
    assert ops.paged_decode_attention.launches == before


def test_paged_wrapper_meta_is_empty_and_cpu_counts_nothing():
    q, kp, vp, tables, lengths = _paged(7, "bfloat16", "aliased")
    before = (ops.paged_decode_attention.launches,
              dict(ops.paged_decode_attention.launches_by_design))
    meta = ops.paged_decode_attention(*(t.to("meta") for t in (
        q, kp, vp, tables, lengths)))
    assert meta.device.type == "meta" and meta.shape == q.shape
    ops.paged_decode_attention(q, kp, vp, tables, lengths)
    assert (ops.paged_decode_attention.launches,
            ops.paged_decode_attention.launches_by_design) == before
    assert set(before[1]) == {"paged"}


class _Card:
    """A stand-in for a tensor on the card: what the route reads of it."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype
        self.device = torch.device("cuda")


# case -> (pool, dtype, where, tables given, which path, the error the
# kernel's wrapper then raises, if any)
_ROUTES = {
    "paged-bf16": ((64, 16, 4, 128), torch.bfloat16, "card", True, True,
                   None),
    "int8-kv": ((64, 16, 4, 128), torch.int8, "card", True, False, None),
    "contiguous": ((32, 512, 4, 128), torch.bfloat16, "card", False, False,
                   None),
    "cpu": ((64, 16, 4, 128), torch.bfloat16, "cpu", True, False, None),
    "meta": ((64, 16, 4, 128), torch.bfloat16, "meta", True, False, None),
    "head-width-96": ((64, 16, 4, 96), torch.bfloat16, "card", True, True,
                      "head widths"),
    "block-of-4": ((64, 4, 4, 128), torch.bfloat16, "card", True, True,
                   "multiple of 8"),
}


@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_paged_route_predicate(case):
    """Which path `_attn_step` takes, decided from the kind of cache alone:
    the paged kernel for a bf16 pool on the card; `decode_attend` for the
    int8 KV pool, the contiguous cache, CPU and meta tensors.  A bf16 pool
    on the card that the kernel cannot read (a head width it is not built
    for, blocks of other than a multiple of 8 rows) takes the kernel route
    all the same, and the wrapper's card contract refuses it."""
    from repro_torch.kernels.decode_attention import check_paged_card
    from repro_torch.models.model import paged_kernel_fits
    shape, dtype, where, paged, want, error = _ROUTES[case]
    pool = (_Card(shape, dtype) if where == "card"
            else torch.zeros(shape, dtype=dtype, device=where))
    tables = torch.zeros((2, 4), dtype=torch.int32) if paged else None
    assert paged_kernel_fits(pool, tables) is want
    if where != "card" or dtype != torch.bfloat16:
        return
    q, kp = (torch.zeros(s, dtype=dtype) for s in ((2, 1, 28, shape[-1]),
                                                   shape))
    if error is None:
        check_paged_card(q, kp, kp.clone())
    else:
        with pytest.raises(ValueError, match=error):
            check_paged_card(q, kp, kp.clone())


def test_serve_cli_refuses_blocks_the_kernel_cannot_read():
    """Traffic mode on the card with a bf16 KV cache in blocks of other
    than a multiple of 8 rows is refused before anything is built; the
    int8 cache (read by `decode_attend`) and the CPU keep any block
    size."""
    from repro_torch.kernels.paged import PAGED_ROWS
    from repro_torch.launch import serve
    argv = ["--requests", "2", "--block-size", "4"]
    with pytest.raises(SystemExit):
        serve.main(argv + ["--device", "cuda"])
    assert serve.block_size_error(4, "cuda", "bfloat16")
    assert serve.block_size_error(4, "cuda:1", "bfloat16")
    assert not serve.block_size_error(4, "cuda", "int8")
    assert not serve.block_size_error(4, "cpu", "bfloat16")
    assert not serve.block_size_error(2 * PAGED_ROWS, "cuda", "bfloat16")


# arch, KV cache, paged -> attention slots that take the kernel route
_STEPS = {
    "paged-bf16": ("qwen2-7b", "bfloat16", True),
    "int8-kv": ("qwen2-7b", "int8", True),
    "contiguous": ("qwen2-7b", "bfloat16", False),
    "cross": ("llama-3.2-vision-90b", "bfloat16", True),
}


@pytest.mark.parametrize("case", sorted(_STEPS))
def test_attn_step_route(case, monkeypatch):
    """`decode_step` on the CPU with the route predicate told that the CPU
    is the card (the wrapper then runs its plain version): the bf16 pool
    goes through `paged_decode_attention` in every attention slot and
    gathers no strip, with logits bit for bit those of the plain route;
    the int8 pool and the contiguous cache never reach it, and a vlm's
    cross slots never do (only its self-attention slots)."""
    from repro_torch.configs import ARCHS, RunConfig, reduced
    from repro_torch.models import (decode_step, init, init_cache,
                                    init_paged_cache)
    from repro_torch.models import model as tm
    arch, kv, paged = _STEPS[case]
    cfg, rc = reduced(ARCHS[arch]), RunConfig(kv_cache_dtype=kv)
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b, mb, bs = 3, 2, 16
    n_img = 4 if cfg.family == "vlm" else 0

    def run(kernel_route):
        calls = {"kernel": 0, "gather": 0}
        kernel, gather = ops.paged_decode_attention, tm._paged_view
        inside = []

        def spy_kernel(*a, **kw):      # its plain version gathers: not
            calls["kernel"] += 1       # the step's own gather
            inside.append(True)
            try:
                return kernel(*a, **kw)
            finally:
                inside.pop()

        def spy_gather(*a, **kw):
            calls["gather"] += not inside
            return gather(*a, **kw)
        with monkeypatch.context() as m:
            m.setattr(ops, "paged_decode_attention", spy_kernel)
            m.setattr(tm, "_paged_view", spy_gather)
            if kernel_route:
                m.setattr(tm, "paged_kernel_fits", lambda pool, bt: (
                    bt is not None and pool.dtype == torch.bfloat16))
            tok = torch.tensor([[3], [5], [7]])
            if paged:
                cache = init_paged_cache(cfg, rc, b, b * mb, bs,
                                         device="cpu", n_image_tokens=n_img)
                tables = torch.arange(b * mb, dtype=torch.int32).view(b, mb)
                pos = torch.tensor([0, 9, 20], dtype=torch.int32)
                logits, _ = decode_step(params, cache, tok, pos, cfg, rc,
                                        active=torch.ones(b, dtype=torch.bool),
                                        block_tables=tables)
            else:
                cache = init_cache(cfg, rc, b, mb * bs, device="cpu")
                logits, _ = decode_step(params, cache, tok, 9, cfg, rc)
        return logits, calls

    want, _ = run(False)
    got, calls = run(True)
    slots = tm.period_slots(cfg)
    attn = tm.n_periods(cfg) * sum(s.mixer == "attn" for s in slots)
    kv_tensors = 4 if kv == "int8" else 2
    if case in ("paged-bf16", "cross"):
        assert calls == {"kernel": attn, "gather": 0}
        assert attn < cfg.n_layers or case == "paged-bf16"
    elif case == "int8-kv":
        assert calls == {"kernel": 0, "gather": kv_tensors * attn}
    else:
        assert calls == {"kernel": 0, "gather": 0}
    assert torch.equal(got, want)
