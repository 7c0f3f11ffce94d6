"""The port's training path against the JAX package, on the CPU: `loss_fn`
and its gradients for every arch, the train step (clip, schedule,
optimizer; microbatches), remat, `train` with crash and resume, and the
train CLI.

Models are `reduced(...)` in f32 (param and compute dtype float32, MoE
included, as the families' tests run it), with the reference's params
converted by `params_from_jax` and the reference's batches
(`repro.data.batch_at_step`, plus image embeddings from numpy for the
vlm) fed to both packages.  Sequences of 32 tokens with attn_chunk 16
run the chunked `flash_jnp` attention and its backward.  Tolerances:
loss within 1e-5 relative, gnorm within 1e-4 relative, each gradient
leaf within 1e-4 of its largest magnitude (the same f32 sums in other
orders, through a backward that XLA and torch each fuse their own way).
A 10-step `train` on reduced qwen2-7b follows the reference's loss curve
within 1e-4 relative at every step (f32; the updates of the two
packages differ by f32 roundings, and Adam's normalised steps carry them
on).
"""
import dataclasses
import io
import json
import os
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JaxDataConfig
from repro.data import batch_at_step as jax_batch_at_step
from repro.models import init as jax_init, loss_fn as jax_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro.train import train as jax_train

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.launch import train as train_cli
from repro_torch.models import init, loss_fn
from repro_torch.models.attention import attend
from repro_torch.optim import adamw_init
from repro_torch.train import loop as loop_mod
from repro_torch.train import make_train_step, train
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.tree import flatten_with_paths, leaves, rebuild

SEQ, BATCH, CHUNK = 32, 4, 16
RC = dict(remat=False, attn_chunk=CHUNK, learning_rate=1e-3,
          warmup_steps=5)
LOSS_TOL, GNORM_TOL, GRAD_TOL, CURVE_TOL = 1e-5, 1e-4, 1e-4, 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32")
CLI_KEYS = {"arch", "steps", "resumed_from", "loss_first", "loss_last",
            "stragglers", "devices"}


def _cfgs(arch):
    return (dataclasses.replace(reduced(ARCHS[arch]), **F32),
            dataclasses.replace(jax_reduced(JAX_ARCHS[arch]), **F32))


def _batch(jcfg, seed=0, step=0, batch=BATCH):
    """The reference's batch (numpy), image embeddings for a vlm."""
    nb = jcfg.audio.n_codebooks if jcfg.family == "audio" else 0
    dc = JaxDataConfig(seed=seed, vocab=jcfg.vocab, seq_len=SEQ,
                       global_batch=batch)
    b = {k: np.asarray(v) for k, v in
         jax_batch_at_step(dc, step, n_codebooks=nb).items()}
    if jcfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        b["image_embeds"] = (rng.standard_normal(
            (batch, jcfg.vision.n_image_tokens, jcfg.d_model)) * 0.5
            ).astype(np.float32)
    return b


def _to_torch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _flat_jax(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_jax(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_grads(params, batch, cfg, rc):
    plist = list(leaves(params))
    for p in plist:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, batch, cfg, rc)
    grads = torch.autograd.grad(loss, plist)
    return loss.detach(), flatten_with_paths(rebuild(params, grads))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _assert_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, (
            k, float(np.abs(g - w).max()) / scale)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_grads_and_step_match_reference(arch):
    cfg, jcfg = _cfgs(arch)
    rc, jrc = RunConfig(**RC), JaxRunConfig(**RC)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jax_loss_fn(p, bb, jcfg, jrc), has_aux=True))(jparams,
                                                                    jb)
    jflat = _flat_jax(jgrads)
    jgnorm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                         for g in jflat.values()))

    params = params_from_jax(jparams, device="cpu")
    loss, grads = _port_grads(params, _to_torch(b), cfg, rc)
    assert _rel(loss, jloss) <= LOSS_TOL, (float(loss), float(jloss))
    _assert_grads(grads, jflat)

    # the train step (at step 3: the warmup's rate is 0 at step 0): its
    # loss, its gnorm and one AdamW update of every leaf
    params = params_from_jax(jparams, device="cpu")
    opt = adamw_init(params)
    _, _, metrics = make_train_step(cfg, rc)(params, opt, _to_torch(b), 3)
    assert _rel(metrics["loss"], jloss) <= LOSS_TOL
    assert _rel(metrics["gnorm"], jgnorm) <= GNORM_TOL
    assert int(opt["step"]) == 1
    changed = [k for k, (p, q) in enumerate(zip(
        leaves(params), leaves(params_from_jax(jparams, device="cpu"))))
        if not torch.equal(p.detach(), q)]
    assert len(changed) == len(list(leaves(params)))


def _stacked_leaves(params):
    return {id(t) for t in leaves(params["slots"])}


def _select_into_stacked(loss, stacked: set) -> list:
    """SelectBackward0 nodes of loss's graph that feed the AccumulateGrad
    of a stacked parameter."""
    bad, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if (type(node).__name__ == "SelectBackward0"
                    and type(nxt).__name__ == "AccumulateGrad"
                    and id(nxt.variable) in stacked):
                bad.append(node)
            todo.append(nxt)
    return bad


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-1.5-large-398b",
                                  "musicgen-large"])
@pytest.mark.parametrize("remat", [False, True])
def test_no_select_backward_into_stacked_params(arch, remat):
    """Each stacked leaf is unbound once per forward: its gradient comes
    through one UnbindBackward0, never a SelectBackward0 per period."""
    cfg, jcfg = _cfgs(arch)
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = loss_fn(params, _to_torch(_batch(jcfg)), cfg,
                      RunConfig(**{**RC, "remat": remat}))
    assert not _select_into_stacked(loss, _stacked_leaves(params))
    # the walk does find one where a period is taken by indexing
    w = params["slots"][0]["norm1"]["scale"]
    assert _select_into_stacked((w[0] * 2).sum(), {id(w)})


class _CountDots(TorchDispatchMode):
    """Counts the matmuls (mm / bmm / addmm) dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads_counting_backward_dots(params, batch, cfg, rc):
    plist = list(leaves(params))
    for p in plist:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, batch, cfg, rc)
    with _CountDots() as count:
        grads = torch.autograd.grad(loss, plist)
    return loss.detach(), flatten_with_paths(rebuild(params, grads)), count.n


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-780m", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b"])
def test_remat_is_bitwise_on_the_cpu(arch):
    """remat on (policies "nothing" and "dots") and off: the same loss
    and gradients, bit for bit (the backward recomputes the same ops).
    The backward's matmul count shows each policy at work: "nothing"
    recomputes the periods' forward matmuls, "dots" keeps their outputs
    and recomputes none."""
    cfg, jcfg = _cfgs(arch)
    params = init(torch.Generator().manual_seed(1), cfg, device="cpu")
    b = _to_torch(_batch(jcfg, seed=1))
    base_loss, base, n_off = _grads_counting_backward_dots(
        params, b, cfg, RunConfig(**RC))
    with torch.no_grad(), _CountDots() as fwd:
        loss_fn(params, b, cfg, RunConfig(**RC))
    n_dots = {}
    for policy in ("nothing", "dots"):
        rc = RunConfig(**{**RC, "remat": True, "remat_policy": policy})
        loss, grads, n_dots[policy] = _grads_counting_backward_dots(
            params, b, cfg, rc)
        assert torch.equal(loss, base_loss), policy
        for k in base:
            assert torch.equal(grads[k], base[k]), (policy, k)
    assert n_dots["dots"] == n_off
    # the periods' matmuls again (less those whose outputs no backward
    # reads: the recompute stops early, after the last saved tensor)
    assert n_off + fwd.n // 2 <= n_dots["nothing"] < n_off + fwd.n


def _capture_grads(monkeypatch):
    """Record the (scaled) gradients the train step hands its optimizer."""
    seen = []
    real = loop_mod.make_optimizer

    def fake(name, weight_decay=0.1):
        opt_init, update = real(name, weight_decay)

        def capture(p, g, s, lr, grad_scale=None):
            seen.append({k: (v.to(torch.float32) * grad_scale).clone()
                         for k, v in flatten_with_paths(g).items()})
            return update(p, g, s, lr, grad_scale=grad_scale)
        return opt_init, capture
    monkeypatch.setattr(loop_mod, "make_optimizer", fake)
    return seen


def test_microbatches_match_full_batch_and_reference(monkeypatch):
    seen = _capture_grads(monkeypatch)
    cfg, jcfg = _cfgs("minitron-4b")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    b = _batch(jcfg, seed=3, batch=8)
    out = {}
    for mb in (1, 4):
        params = params_from_jax(jparams, device="cpu")
        step = make_train_step(cfg, RunConfig(**{**RC, "microbatches": mb}))
        _, _, out[mb] = step(params, adamw_init(params), _to_torch(b), 0)
    g1, g4 = seen
    for k in g1:
        scale = float(g1[k].abs().max())
        assert float((g4[k] - g1[k]).abs().max()) <= 1e-5 * scale, k
    assert _rel(out[4]["loss"], out[1]["loss"]) <= LOSS_TOL
    from repro.optim import make_optimizer as jax_make_optimizer
    jopt = jax_make_optimizer("adamw")[0](jparams)
    jrc = JaxRunConfig(**{**RC, "microbatches": 4})
    _, _, jm = jax.jit(jax_make_train_step(jcfg, jrc))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.int32(0))
    assert _rel(out[4]["loss"], jm["loss"]) <= LOSS_TOL
    assert _rel(out[4]["gnorm"], jm["gnorm"]) <= GNORM_TOL
    assert _rel(out[4]["lr"], jm["lr"]) == 0.0


class _ReferenceBatches:
    """DataIterator stand-in that yields the reference's batches."""

    def __init__(self, cfg, start_step=0, n_codebooks=0, device="cpu"):
        self.jcfg = JaxDataConfig(seed=cfg.seed, vocab=cfg.vocab,
                                  seq_len=cfg.seq_len,
                                  global_batch=cfg.global_batch)
        self.step = start_step

    def __next__(self):
        b = jax_batch_at_step(self.jcfg, self.step)
        self.step += 1
        return {k: torch.from_numpy(np.asarray(v).copy())
                for k, v in b.items()}

    def state(self):
        return {"step": self.step, "seed": self.jcfg.seed}


def test_train_follows_the_reference_curve(monkeypatch):
    monkeypatch.setattr(loop_mod, "DataIterator", _ReferenceBatches)
    cfg, jcfg = _cfgs("qwen2-7b")
    rc = dict(RC, attn_impl="naive")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    dc = dict(seed=0, vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    want = jax_train(jcfg, JaxRunConfig(**rc), JaxDataConfig(**dc), 10,
                     params=jparams).losses
    got = train(cfg, RunConfig(**rc), DataConfig(**dc), 10,
                params=params_from_jax(jparams, device="cpu"),
                device="cpu").losses
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert _rel(g, w) <= CURVE_TOL, (got, want)


def test_tiny_lm_learns():
    """The JAX package's tests/test_integration.py:test_tiny_lm_learns
    (there under the slow marker) on the port."""
    cfg = reduced(ARCHS["qwen2-7b"])
    rc = RunConfig(remat=False, attn_impl="naive", learning_rate=1e-3,
                   warmup_steps=5)
    dc = DataConfig(seed=0, vocab=cfg.vocab, seq_len=64, global_batch=8)
    res = train(cfg, rc, dc, n_steps=30, seed=0, device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.3
    assert res.resumed_from is None


def test_crash_resume_is_bit_for_bit():
    cfg = reduced(ARCHS["qwen2-7b"])
    rc = RunConfig(remat=True, attn_impl="flash_jnp", attn_chunk=16,
                   learning_rate=1e-3, warmup_steps=5, microbatches=2)
    dc = DataConfig(seed=0, vocab=cfg.vocab, seq_len=SEQ, global_batch=4)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="step 12"):
            train(cfg, rc, dc, n_steps=20, seed=0, ckpt_dir=d,
                  ckpt_every=5, injector=FailureInjector((12,)),
                  device="cpu")
        resumed = train(cfg, rc, dc, n_steps=20, seed=0, ckpt_dir=d,
                        ckpt_every=5, device="cpu")
        assert resumed.resumed_from == 10
        assert sorted(os.listdir(d)) == ["step_00000010", "step_00000015",
                                         "step_00000020"]
    full = train(cfg, rc, dc, n_steps=20, seed=0, device="cpu")
    assert resumed.losses == full.losses[10:]
    for a, b in zip(leaves((resumed.params, resumed.opt_state)),
                    leaves((full.params, full.opt_state))):
        assert torch.equal(a, b)


def _cli(argv) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_cli.main(argv)
    return json.loads(buf.getvalue())


def test_cli_keys_failure_and_resume():
    out = _cli(["--smoke", "--steps", "6", "--batch", "4", "--seq", "32",
                "--device", "cpu"])
    assert set(out) == CLI_KEYS
    assert out["arch"] == "qwen2-7b-smoke" and out["devices"] == 1
    assert out["resumed_from"] is None
    with tempfile.TemporaryDirectory() as d:
        argv = ["--smoke", "--steps", "8", "--batch", "4", "--seq", "32",
                "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]
        with pytest.raises(RuntimeError, match="injected"):
            _cli(argv + ["--fail-at", "5"])
        out = _cli(argv)
        assert out["resumed_from"] == 4 and set(out) == CLI_KEYS


def test_no_silent_cpu_fallback():
    """Without device= training means the card: on a CPU-only torch
    `train` and the CLI raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this torch has a CUDA device")
    cfg = reduced(ARCHS["qwen2-7b"])
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, RunConfig(), dc, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--smoke", "--steps", "1"])
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="params live on cpu"):
        train(cfg, RunConfig(), dc, 1, params=params, device="meta")


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 32, 4, 16), generator=g) for _ in range(3))
    for t in (q, k, v):
        t.requires_grad_(requires_grad)
    return q, k, v


def test_forward_only_kernels_refuse_autograd():
    """attend(impl="pallas") and the attention kernels' wrappers raise
    while autograd records through them (the check comes before the
    device dispatch, so the CPU's plain path refuses too); under no_grad
    they run; make_train_step refuses attn_impl="pallas" up front."""
    q, k, v = _qkv(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attend(q, k, v, impl="pallas", chunk=8)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q[:, :1], k, v, 5)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q[0].transpose(0, 1).contiguous(),
                        k[0].transpose(0, 1).contiguous(),
                        v[0].transpose(0, 1).contiguous())
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q[0, :1].transpose(0, 1).contiguous(),
                         k[0].transpose(0, 1).contiguous(),
                         v[0].transpose(0, 1).contiguous(), 3)
    with torch.no_grad():
        a = attend(q, k, v, impl="pallas", chunk=8)
    with torch.inference_mode():
        b = attend(*_qkv(False), impl="pallas", chunk=8)
    assert torch.equal(a, b)
    # no input requires grad: nothing to lose, the kernel runs
    assert torch.equal(attend(*_qkv(False), impl="pallas", chunk=8), b)
    # the naive fallback (sk <= chunk) is differentiable, as in the JAX
    # package
    attend(q, k, v, impl="pallas", chunk=32).sum().backward()
    assert q.grad is not None
    cfg = reduced(ARCHS["qwen2-7b"])
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(cfg, RunConfig(attn_impl="pallas"))
