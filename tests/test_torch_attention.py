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

@pytest.mark.parametrize("n_blocks,S,n_sms,plan", [
    (32, 32768, 132, (4, 8192)),   # qwen2-7b decode_32k: 128 blocks
    (12, 4096, 132, (11, 384)),    # 3 x 4 kv heads: 132 // 12 = 11 pieces
    (2, 300, 132, (5, 64)),        # one 64-position tile per piece
    (300, 1000, 132, (1, 1024)),   # more blocks than a wave: no split
    (1, 64, 132, (1, 64)),
    (4, 32768, 8, (2, 16384))])    # a small card: 8 // 4 pieces
def test_decode_split_plan(n_blocks, S, n_sms, plan):
    """`split_plan` against hand-worked values: as many tile-aligned
    pieces as fit one wave of one block per SM, at most one per tile."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    assert da.split_plan(n_blocks, S, n_sms) == plan
    n_splits, split_len = plan
    assert split_len % da.TILE == 0 and (n_splits - 1) * split_len < S
    assert n_blocks * n_splits <= max(n_blocks,
                                      da.BLOCKS_PER_SM * n_sms)


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
