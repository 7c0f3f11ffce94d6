"""The port's training substrate against the JAX package, on the CPU: the
optimizers and the schedule, the data pipeline, checkpoints (across the
two packages' on-disk format) and the fault-tolerance runtime.

Optimizers are fed the same params, grads and state (numpy, seeded) in
both packages, over three updates with the same grads each: f32 params
and state agree within 1e-6 of each leaf's largest magnitude (the same
f32 operations; XLA and torch differ only in fused roundings and in
pow/rsqrt), bf16 params within one bf16 ulp (their f32 values round to
neighbouring bf16 values at most).  The slicing of large leaves
(`adamw.SLICE_ELEMS`) is exercised by shrinking it to a few elements.
The schedule agrees within one f32 ulp over steps 0-300.

The data stream is not bit-equal to the JAX package's (torch draws, not
threefry); its tests are the JAX package's (tests/test_substrate.py) on
the port's pipeline, plus the law x[t+1] = 5 x[t] + 17 mod vocab.
"""
import json
import os
import tempfile
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adafactor_init as jax_adafactor_init
from repro.optim import adafactor_update as jax_adafactor_update
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import linear_warmup_cosine as jax_schedule
from repro.train import checkpoint as jax_ckpt

from repro_torch.data import (DataConfig, DataIterator, batch_at_step,
                              data_config_for)
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, linear_warmup_cosine,
                               make_optimizer)
from repro_torch.optim import adamw as adamw_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               StragglerWatchdog,
                                               plan_elastic_mesh)
from repro_torch.tree import flatten_with_paths

# leaf shapes: a stacked (periods, d, f) leaf, a 4-D stacked expert leaf,
# 2-D and 1-D leaves, and shapes adafactor does not factor
SHAPES_TREE = {"embed": (16, 8), "final_norm": {"scale": (8,)},
               "slots": [{"w": (3, 8, 12), "experts": (2, 3, 4, 6),
                          "b": (3, 12), "col": (3, 1, 6), "row": (1, 7)}]}
BF16 = np.dtype(ml_dtypes.bfloat16)


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, fn) for v in shapes]
    return fn(shapes)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(SHAPES_TREE, lambda s: (rng.standard_normal(s) * scale
                                         ).astype(np.float32))


def _jax(tree, dtype):
    return _tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return _tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(
        dtype), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _np(x):
    """A leaf of either package as numpy (bf16 as ml_dtypes.bfloat16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16)
        return x.numpy()
    return np.asarray(x)


def _assert_leaf(got, want, key):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, key
    if want.dtype == BF16:
        # one bf16 ulp: the bit patterns of same-signed values differ by
        # at most 1
        gi = got.view(np.int16).astype(np.int32)
        wi = want.view(np.int16).astype(np.int32)
        assert np.abs(gi - wi).max() <= 1, key
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    scale = max(np.abs(w).max(), 1e-30)
    assert np.abs(g - w).max() <= 1e-6 * scale, (key,
                                                 np.abs(g - w).max() / scale)


def _assert_trees(got, want):
    fg = flatten_with_paths(got)
    fw = {k: v for k, v in _flatten_jax(want).items()}
    assert sorted(fg) == sorted(fw)
    for k in fg:
        _assert_leaf(fg[k], fw[k], k)


def _flatten_jax(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_jax(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# --- optimizers -------------------------------------------------------------

OPTS = {"adamw": (adamw_init, adamw_update, jax_adamw_init,
                  jax_adamw_update),
        "adafactor": (adafactor_init, adafactor_update, jax_adafactor_init,
                      jax_adafactor_update)}


@pytest.mark.parametrize("slice_elems", [adamw_mod.SLICE_ELEMS, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_matches_reference(which, dtype, slice_elems, monkeypatch):
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", slice_elems)
    init, update, jinit, jupdate = OPTS[which]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    p_np, g_np = _np_tree(0), _np_tree(1, scale=0.3)
    jp, jg = _jax(p_np, dtype), _jax(g_np, dtype)
    tp, tg = _torch(p_np, tdt), _torch(g_np, tdt)
    jst, tst = jinit(jp), init(tp)
    kw = {"weight_decay": 0.1} if which == "adamw" else {}
    for lr in (3e-3, 1e-2, 5e-3):
        jp, jst = jupdate(jp, jg, jst, lr, **kw)
        tp, tst = update(tp, tg, tst, lr, **kw)
    _assert_trees(tp, jp)
    _assert_trees(tst, jst)
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert tst["step"].dtype == torch.int32 and tst["step"].dim() == 0


def test_adafactor_state_is_factored_like_reference():
    p_np = _np_tree(0)
    tst = adafactor_init(_torch(p_np, torch.float32))
    jst = jax_adafactor_init(_jax(p_np, "float32"))
    ft, fj = flatten_with_paths(tst), _flatten_jax(jst)
    assert sorted(ft) == sorted(fj)
    for k in ft:
        assert tuple(ft[k].shape) == tuple(fj[k].shape), k
    adam = sum(t.numel() for t in flatten_with_paths(
        adamw_init({"w": torch.zeros(128, 256)})).values())
    fact = sum(t.numel() for t in flatten_with_paths(
        adafactor_init({"w": torch.zeros(128, 256)})).values())
    assert fact < adam / 50


def test_grad_scale_is_the_clipped_gradient():
    """`grad_scale` multiplies the f32 gradient: the same update as
    feeding the scaled gradient (the JAX package's clip)."""
    p_np, g_np = _np_tree(2), _np_tree(3)
    scale = torch.tensor(0.37)
    for which in ("adamw", "adafactor"):
        init, update, _, _ = OPTS[which]
        a = _torch(p_np, torch.float32)
        b = _torch(p_np, torch.float32)
        sa, sb = init(a), init(b)
        update(a, _torch(g_np, torch.float32), sa, 1e-2, grad_scale=scale)
        update(b, _tree_map(lambda t: t * scale, _torch(g_np, torch.float32)),
               sb, 1e-2)
        for (ka, ta), (_, tb) in zip(flatten_with_paths(a).items(),
                                     flatten_with_paths(b).items()):
            assert torch.equal(ta, tb), (which, ka)


def test_make_optimizer_pairs():
    init, update = make_optimizer("adafactor", weight_decay=0.1)
    p = {"w": torch.ones(4, 6)}
    st = init(p)
    update(p, {"w": torch.zeros(4, 6)}, st, 0.1)
    assert torch.equal(p["w"], torch.ones(4, 6))   # no weight decay
    init, update = make_optimizer("adamw", weight_decay=0.1)
    st = init(p)
    update(p, {"w": torch.zeros(4, 6)}, st, 0.1)
    assert bool((p["w"] < 1).all())                 # decoupled decay
    with pytest.raises(ValueError):
        make_optimizer("sgd")


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizers_converge(which):
    """The JAX package's convergence check (tests/test_substrate.py,
    run there under the slow marker) on a quadratic."""
    init, update, _, _ = OPTS[which]
    params = {"w": torch.zeros((4, 8)), "b": torch.ones((8,))}

    def loss(p):
        return torch.sum((p["w"] - 3.0) ** 2) + torch.sum(p["b"] ** 2)
    state = init(params)
    loss0 = float(loss(params))
    kw = {"weight_decay": 0.0} if which == "adamw" else {}
    for _ in range(200):
        for t in params.values():
            t.requires_grad_(True)
        grads = dict(zip(params, torch.autograd.grad(loss(params),
                                                     list(params.values()))))
        update(params, grads, state, 0.05, **kw)
    with torch.no_grad():
        assert float(loss(params)) < 0.05 * loss0


def test_schedule_matches_reference_within_one_ulp():
    args = (1e-3, 10, 300)
    got = np.array([float(linear_warmup_cosine(s, *args))
                    for s in range(301)], np.float32)
    want = np.array([np.float32(jax_schedule(s, *args))
                     for s in range(301)], np.float32)
    assert np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64)).max() <= 1
    lrs = [float(linear_warmup_cosine(s, 1e-3, 10, 100))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] > lrs[3] > lrs[4] >= 1e-4 * 0.99
    t = linear_warmup_cosine(torch.tensor(7, dtype=torch.int32), *args)
    assert t.dtype == torch.float32 and t.dim() == 0


# --- data pipeline ----------------------------------------------------------

def test_data_deterministic_and_skippable():
    dc = DataConfig(seed=7, vocab=101, seq_len=16, global_batch=4)
    b1 = batch_at_step(dc, 5, device="cpu")
    b2 = batch_at_step(dc, 5, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    it = DataIterator(dc, start_step=5, device="cpu")
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert it.state() == {"step": 6, "seed": 7}
    again = DataIterator.restore(dc, it.state(), device="cpu")
    assert torch.equal(next(again)["tokens"],
                       batch_at_step(dc, 6, device="cpu")["tokens"])
    assert not torch.equal(batch_at_step(dc, 6, device="cpu")["tokens"],
                           b1["tokens"])
    with pytest.raises(ValueError, match="seed"):
        DataIterator.restore(DataConfig(seed=8), it.state())


def test_data_host_sharding_disjoint():
    dc0 = DataConfig(seed=1, vocab=50, seq_len=8, global_batch=8,
                     n_hosts=2, host_id=0)
    dc1 = DataConfig(seed=1, vocab=50, seq_len=8, global_batch=8,
                     n_hosts=2, host_id=1)
    b0 = batch_at_step(dc0, 3, device="cpu")
    b1 = batch_at_step(dc1, 3, device="cpu")
    assert b0["tokens"].shape == (4, 8)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    with pytest.raises(ValueError):
        DataConfig(global_batch=9, n_hosts=2).host_batch


def test_data_targets_shifted_and_law_holds():
    dc = DataConfig(seed=0, vocab=64, seq_len=256, global_batch=8)
    b = batch_at_step(dc, 0, device="cpu")
    tok, tgt = b["tokens"], b["targets"]
    assert tok.shape == tgt.shape == (8, 256) and tok.dtype == torch.int64
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    assert bool(((tok >= 0) & (tok < 64)).all())
    law = (tgt == (tok * 5 + 17) % 64).float().mean().item()
    assert 0.9 <= law < 1.0


def test_data_audio_shape():
    dc = DataConfig(seed=0, vocab=32, seq_len=12, global_batch=2)
    b = batch_at_step(dc, 1, n_codebooks=4, device="cpu")
    assert b["tokens"].shape == b["targets"].shape == (2, 12, 4)
    law = (b["targets"] == (b["tokens"] * 5 + 17) % 32).float().mean()
    assert float(law) >= 0.85
    # codebooks are independent streams
    assert not torch.equal(b["tokens"][..., 0], b["tokens"][..., 1])


def test_data_config_for():
    dc = data_config_for(ARCHS["qwen2-7b"], SHAPES["train_4k"], n_hosts=4,
                         host_id=2)
    assert (dc.vocab, dc.seq_len, dc.global_batch, dc.host_batch,
            dc.host_id) == (152064, 4096, 256, 64, 2)


# --- checkpointing ----------------------------------------------------------

def test_checkpoint_roundtrip_and_latest():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.randn(4).to(torch.bfloat16)},
            "l": [torch.tensor(3, dtype=torch.int32)]}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, tree, extra={"k": 1})
        ckpt.save(d, 7, tree)
        assert ckpt.latest_step(d) == 7
        got, extra = ckpt.restore(d, 3, tree)
        assert extra == {"k": 1}
        for (k, a), (_, b) in zip(flatten_with_paths(got).items(),
                                  flatten_with_paths(tree).items()):
            assert a.dtype == b.dtype and torch.equal(a, b), k
            assert a.data_ptr() != b.data_ptr()
        moved, _ = ckpt.restore_resharded(
            d, 7, tree, put_fn=lambda t: {"a": t["a"] * 2})
        assert torch.equal(moved["a"], tree["a"] * 2)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(d, 7, {"a": torch.zeros(3, 2), "b": tree["b"],
                                "l": tree["l"]})


def test_checkpoint_incomplete_ignored_and_gc():
    tree = {"a": torch.ones(2)}
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(os.path.join(d, "none")) is None
        ckpt.save(d, 2, tree)
        # a crash between the shard's write and the manifest's
        os.makedirs(os.path.join(d, "step_00000009"))
        assert ckpt.latest_step(d) == 2
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, tree)
        ckpt.gc_old(d, keep=2)
        assert ckpt.latest_step(d) == 5
        assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def _bits_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _opt_tree_np():
    """(params, adamw state) as numpy, bf16 params included."""
    p = _np_tree(4)
    m = _np_tree(5)
    return p, m


def test_checkpoint_reference_to_port_and_back():
    """A (params, opt_state) tuple saved by the JAX package restores in
    the port element for element (bf16 included), and the other way
    round: the same keys, shapes and dtypes on disk."""
    p_np, m_np = _opt_tree_np()
    jtree = (_jax(p_np, "bfloat16"),
             {"m": _jax(m_np, "float32"), "v": _jax(p_np, "float32"),
              "step": jnp.asarray(5, jnp.int32)})
    ttree = (_torch(p_np, torch.bfloat16),
             {"m": _torch(m_np, torch.float32),
              "v": _torch(p_np, torch.float32),
              "step": torch.tensor(5, dtype=torch.int32)})
    like_t = _tree_map(torch.zeros_like, ttree)
    like_j = _tree_map(jnp.zeros_like, jtree)
    with tempfile.TemporaryDirectory() as d:
        jax_ckpt.save(os.path.join(d, "jax"), 11, jtree,
                      extra={"data": {"step": 11, "seed": 0}})
        got, extra = ckpt.restore(os.path.join(d, "jax"), 11, like_t)
        assert extra == {"data": {"step": 11, "seed": 0}}
        ft, fj = flatten_with_paths(got), _flatten_jax(jtree)
        assert sorted(ft) == sorted(fj)
        for k in ft:
            assert _bits_equal(_np(ft[k]), np.asarray(fj[k])), k
            assert _np(ft[k]).dtype == np.asarray(fj[k]).dtype, k

        ckpt.save(os.path.join(d, "torch"), 12, ttree)
        manifests = []
        for sub, step in (("torch", 12), ("jax", 11)):
            with open(os.path.join(d, sub, f"step_{step:08d}",
                                   "manifest.json")) as f:
                manifests.append(json.load(f))
        for field in ("keys", "shapes", "dtypes", "status"):
            assert manifests[0][field] == manifests[1][field], field
        assert jax_ckpt.latest_step(os.path.join(d, "torch")) == 12
        back, _ = jax_ckpt.restore(os.path.join(d, "torch"), 12, like_j)
        fb = _flatten_jax(back)
        for k, t in flatten_with_paths(ttree).items():
            assert _bits_equal(np.asarray(fb[k]), _np(t)), k


# --- fault tolerance --------------------------------------------------------

def test_straggler_watchdog_flags_slow_step():
    w = StragglerWatchdog(threshold=2.0)
    for _ in range(10):
        w.step_start()
        time.sleep(0.002)
        assert not w.step_end()
    w.step_start()
    time.sleep(0.03)
    assert w.step_end()
    assert w.median > 0


def test_plan_elastic_mesh_and_failure_injector():
    assert plan_elastic_mesh(512, 16) == (32, 16)
    assert plan_elastic_mesh(504, 16) == (31, 16)
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, 16)
    inj = FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(RuntimeError, match="step 3"):
        inj.check(3)
