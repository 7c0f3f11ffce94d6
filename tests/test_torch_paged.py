"""The port's paged, slot-masked decode path against the JAX package's, on
the CPU, on reduced qwen2-7b (2 layers, d_model 64) with f32 params.

* `_paged_write` / `_paged_view` bit for bit, for f32 and bf16 pools and
  for int8 codes with their bf16 scales (the codes from rows whose
  largest quotient rounds to 128, which XLA saturates and the port
  clamps);
* inactive slots leave every block bit for bit untouched, also when
  their block table aliases a live block;
* the ragged `decode_step` (per-slot `pos`, `active`, `block_tables`),
  bf16-sized and int8 KV, within 1e-5 · max|ref| of the reference's
  logits (f32 params and compute: only summation orders differ);
* the fixed-batch step takes `pos` as a 0-d tensor without reading it on
  the host; `_scale` is the f32 value the tensor expression gave;
  `ServeSession.reset` zeroes the cache in place.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.models import init as jax_init
from repro.models import model as jax_model

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import (clone_cache, decode_step, init_cache,
                                init_paged_cache)
from repro_torch.models import attention as t_attention
from repro_torch.models import model as t_model
from repro_torch.serving import ServeSession

TOL = 1e-5                   # f32 logits: ≤ TOL · max|ref|
N_BLOCKS, BS = 10, 4


def _cfgs():
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw),
            dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jp, "cpu")


def _bits(t):
    """A tensor's bits as a numpy array (bf16 through int16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_pool(content):
    """A pool with init_paged_cache's spare block, holding `content`."""
    pool = t_model._pool((1,) + tuple(content.shape), content.dtype,
                         "cpu")[0]
    pool.copy_(content)
    return pool


def _write_inputs(seed=0, b=3, max_blocks=3):
    rng = np.random.default_rng(seed)
    tables = np.stack([rng.permutation(N_BLOCKS)[:max_blocks]
                       for _ in range(b)]).astype(np.int32)
    pos = rng.integers(0, max_blocks * BS, b).astype(np.int32)
    return tables, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_write_and_view_bitwise(dtype):
    rng = np.random.default_rng(1)
    tables, pos = _write_inputs()
    tables[1] = [4, 5, 6]          # distinct blocks per slot
    tables[0], tables[2] = [0, 1, 2], [7, 8, 9]
    pool = jnp.asarray(rng.standard_normal((N_BLOCKS, BS, 2, 16)), dtype)
    new = jnp.asarray(rng.standard_normal((3, 2, 16)), dtype)
    active = np.array([True, True, True])
    want = jax_model._paged_write(pool, new, jnp.asarray(pos),
                                  jnp.asarray(tables), jnp.asarray(active))
    tp = _port_pool(params_from_jax(pool, "cpu"))
    got = t_model._paged_write(tp, params_from_jax(new, "cpu"),
                               torch.tensor(pos), torch.tensor(tables),
                               torch.tensor(active))
    assert got is tp
    assert np.array_equal(_bits(got), _bits(want))
    view_want = jax_model._paged_view(want, jnp.asarray(tables))
    view_got = t_model._paged_view(got, torch.tensor(tables))
    assert tuple(view_got.shape) == view_want.shape == (3, 3 * BS, 2, 16)
    assert np.array_equal(_bits(view_got), _bits(view_want))


def test_paged_write_int8_codes_and_scales_bitwise():
    """The int8 KV path on the pool: codes and bf16 scales of bf16 rows
    (some rows' largest quotient rounds to 128) written bit for bit."""
    rng = np.random.default_rng(2)
    k = jnp.asarray(rng.standard_normal((8, 4, 128)), jnp.bfloat16)
    scale = jnp.max(jnp.abs(k), axis=-1, keepdims=True) / 127.0 + 1e-8
    assert int((jnp.round(k / scale) == 128).sum()) > 0
    jq, js = jax_model._quantize_kv(k)
    tq, ts = t_model._quantize_kv(params_from_jax(k, "cpu"))
    tables = np.arange(8 * 2, dtype=np.int32).reshape(8, 2) % N_BLOCKS
    tables[5:] = [[0, 1], [2, 3], [4, 5]]      # lanes 5-7 are inactive
    pos = np.array([0, 3, 5, 7, 1, 2, 6, 4], np.int32)
    active = np.array([True] * 5 + [False] * 3)
    tables[:5] = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    for new_j, new_t, tail in ((jq, tq, (4, 128)), (js, ts, (4,))):
        dt = new_j.dtype
        pool_j = jnp.asarray(rng.integers(-100, 100, (N_BLOCKS, BS) + tail),
                             dt)
        want = jax_model._paged_write(pool_j, new_j, jnp.asarray(pos),
                                      jnp.asarray(tables),
                                      jnp.asarray(active))
        got = t_model._paged_write(_port_pool(params_from_jax(pool_j, "cpu")),
                                   new_t, torch.tensor(pos),
                                   torch.tensor(tables), torch.tensor(active))
        assert got.dtype == new_t.dtype
        assert np.array_equal(_bits(got), _bits(want))


def test_inactive_slots_leave_live_blocks_untouched():
    """Slot 1 is inactive and its table still names slot 0's live blocks,
    at slot 0's own write position: slot 0's row lands, nothing else in
    the pool moves (the reference drops the row; the port sends it to the
    spare block)."""
    rng = np.random.default_rng(3)
    content = torch.from_numpy(rng.standard_normal((N_BLOCKS, BS, 2, 16))
                               .astype(np.float32))
    pool = _port_pool(content)
    tables = torch.tensor([[2, 3, 4], [2, 3, 4], [5, 6, 7]], dtype=torch.int32)
    pos = torch.tensor([6, 6, 1], dtype=torch.int32)
    active = torch.tensor([True, False, False])
    new = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32))
    for _ in range(3):                       # any order, every time
        t_model._paged_write(pool, new, pos, tables, active)
    want = content.clone()
    want[3, 2] = new[0]                      # block 3 = pos 6 // 4, row 2
    assert torch.equal(pool, want)
    ref = jax_model._paged_write(jnp.asarray(content.numpy()),
                                 jnp.asarray(new.numpy()),
                                 jnp.asarray(pos.numpy()),
                                 jnp.asarray(tables.numpy()),
                                 jnp.asarray(active.numpy()))
    assert np.array_equal(pool.numpy(), np.asarray(ref))


def test_paged_write_needs_the_spare_block():
    """A pool without the spare block raises rather than spill into the
    next pool's rows."""
    pools = torch.zeros((2, N_BLOCKS, BS, 2, 16))
    with pytest.raises(ValueError, match="spare block"):
        t_model._paged_write(pools[0], torch.zeros(1, 2, 16),
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros((1, 3), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.bool))


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_cache_layout_as_reference(models, kv):
    jcfg, tcfg, _, _ = models
    jc = jax_model.init_paged_cache(jcfg, JaxRunConfig(kv_cache_dtype=kv),
                                    3, N_BLOCKS, BS)
    tc = init_paged_cache(tcfg, RunConfig(kv_cache_dtype=kv), 3, N_BLOCKS,
                          BS, device="cpu")
    for a, b in zip(tc, jc):
        assert sorted(a) == sorted(b)
        for key in a:
            assert tuple(a[key].shape) == b[key].shape
            assert str(a[key].dtype).split(".")[-1] == str(b[key].dtype)
            assert not bool(a[key].any())


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_ragged_decode_step_matches_reference(models, kv):
    """Eight steps of three slots at ragged positions, slot 2 inactive
    with a table that aliases slot 0's blocks: logits of the active slots
    within TOL · max|ref|, and the pools after equal the reference's
    (int8 codes and scales bit for bit; f32 rows to the same tolerance)."""
    jcfg, tcfg, jp, tp = models
    jrc, trc = (JaxRunConfig(kv_cache_dtype=kv), RunConfig(kv_cache_dtype=kv))
    jc = jax_model.init_paged_cache(jcfg, jrc, 3, N_BLOCKS, BS)
    tc = init_paged_cache(tcfg, trc, 3, N_BLOCKS, BS, device="cpu")
    tables = np.array([[0, 1, 2], [3, 4, 5], [1, 6, 7]], np.int32)
    active = np.array([True, True, False])
    rng = np.random.default_rng(4)
    for step in range(8):
        pos = np.array([step, step + 2, step], np.int32)
        tok = rng.integers(0, tcfg.vocab, (3, 1))
        jl, jc = jax_model.decode_step(
            jp, jc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos), jcfg, jrc,
            active=jnp.asarray(active), block_tables=jnp.asarray(tables))
        with torch.inference_mode():
            tl, tc = decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos),
                                 tcfg, trc, active=torch.tensor(active),
                                 block_tables=torch.tensor(tables))
        want = np.asarray(jl)[:2]
        assert tl.shape == (3, 1, tcfg.vocab)
        assert np.abs(tl.numpy()[:2] - want).max() <= TOL * np.abs(want).max()
    for key in tc[0]:
        got, want = tc[0][key], np.asarray(jc[0][key])
        if kv == "int8" and key in ("k", "v"):
            # codes of f32 rows that differ in their last bits (summation
            # order) may round to the neighbouring code
            assert np.abs(got.numpy().astype(int) - want).max() <= 1
        elif kv == "int8":
            ref = want.astype(np.float32)
            assert np.abs(got.float().numpy() - ref).max() <= (
                2 ** -7 * np.abs(ref).max())          # one bf16 ulp
        else:
            assert np.abs(got.numpy() - want).max() <= TOL * np.abs(
                want).max()


def test_ragged_pos_needs_block_tables(models):
    _, tcfg, _, tp = models
    cache = init_cache(tcfg, RunConfig(kv_cache_dtype="float32"), 2, 8,
                       device="cpu")
    with pytest.raises(ValueError, match="block_tables"):
        decode_step(tp, cache, torch.zeros((2, 1), dtype=torch.long),
                    torch.tensor([1, 2]), tcfg,
                    RunConfig(kv_cache_dtype="float32"))


@contextlib.contextmanager
def _no_host_reads():
    """Inside the block every way of reading a tensor on the host
    raises."""
    names = ("item", "tolist", "__int__", "__index__", "__bool__",
             "__float__", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*args, **kwargs):
        raise AssertionError("the step read a tensor on the host")
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_tensor_pos_equals_int_pos_without_host_reads(models, kv):
    """A 0-d tensor `pos` gives the int `pos`'s logits and cache bit for
    bit, and the step never reads a tensor on the host (contiguous and
    paged caches)."""
    _, tcfg, _, tp = models
    rc = RunConfig(kv_cache_dtype=kv)
    a = init_cache(tcfg, rc, 2, 8, device="cpu")
    b = clone_cache(a)
    tok = torch.tensor([[3], [7]])
    with torch.inference_mode():
        for pos in range(3):
            la, a = decode_step(tp, a, tok + pos, pos, tcfg, rc)
            tpos = torch.tensor(pos)
            with _no_host_reads():
                lb, b = decode_step(tp, b, tok + pos, tpos, tcfg, rc)
            assert torch.equal(la, lb)
        for key in a[0]:
            assert torch.equal(a[0][key], b[0][key])
        paged = init_paged_cache(tcfg, rc, 2, N_BLOCKS, BS, device="cpu")
        args = (torch.tensor([0, 5]), tcfg, rc)
        kw = dict(active=torch.tensor([True, False]),
                  block_tables=torch.tensor([[0, 1], [2, 3]]))
        with _no_host_reads():
            decode_step(tp, paged, tok, *args, **kw)


@pytest.mark.parametrize("d", [16, 64, 128, 100])
def test_scale_is_the_f32_tensor_value(d):
    """`_scale` is a Python float holding exactly the f32 value that
    1 / sqrt(tensor(d)) gave, and multiplying by it gives the same bits."""
    old = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    new = t_attention._scale(d)
    assert isinstance(new, float)
    assert torch.equal(torch.tensor(new, dtype=torch.float32), old)
    x = torch.randn(1000, generator=torch.Generator().manual_seed(d))
    assert torch.equal(x * new, x * old)


def test_serve_session_reset_zeroes_in_place(models):
    _, tcfg, _, tp = models
    sess = ServeSession(tcfg, RunConfig(kv_cache_dtype="float32"), tp,
                        max_len=8, batch=2, device="cpu")
    ptrs = [t.data_ptr() for t in sess.cache[0].values()]
    first = sess.generate(np.array([[1, 2], [3, 4]]), 3)
    assert bool(sess.cache[0]["k"].any())
    sess.reset()
    assert sess.pos == 0
    assert [t.data_ptr() for t in sess.cache[0].values()] == ptrs
    assert not any(bool(t.any()) for t in sess.cache[0].values())
    assert torch.equal(sess.generate(np.array([[1, 2], [3, 4]]), 3), first)
