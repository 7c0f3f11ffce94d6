"""The port's `ServeSession` against the JAX package's on reduced qwen2-7b.

* greedy streams are token-exact at f32 params and compute, with
  quantization on and off and gating on and off;
* the prefill's last logits match within tolerance in f32 and bf16
  (relative to the reference's largest logit: 1e-5 in f32, 2**-6 in
  bf16, where the frameworks round bf16 at different places);
* route reports, plan digests and per-label gates are equal;
* the port imports neither jax nor `repro`, and an entry point with no
  `device=` does not silently run on a CPU-only torch.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, RunConfig as JaxRunConfig
from repro.configs import reduced as jax_reduced
from repro.models import init as jax_init
from repro.serving import ServeSession as JaxServeSession

from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import init
from repro_torch.serving import DecodeCore, ServeSession, cim_fraction

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
BATCH, PROMPT, NEW = 4, 5, 8
MAX_LEN = PROMPT + NEW + 1


def _pair(dtype, quantize, gated, seed=0):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["qwen2-7b"]), **kw)
    tcfg = dataclasses.replace(reduced(ARCHS["qwen2-7b"]), **kw)
    jp = jax_init(jax.random.PRNGKey(seed), jcfg)
    js = JaxServeSession(jcfg, JaxRunConfig(kv_cache_dtype=dtype), jp,
                         max_len=MAX_LEN, batch=BATCH, quantize=quantize,
                         gated=gated)
    ts = ServeSession(tcfg, RunConfig(kv_cache_dtype=dtype),
                      params_from_jax(jp, "cpu"), max_len=MAX_LEN,
                      batch=BATCH, quantize=quantize, gated=gated,
                      device="cpu")
    return js, ts


def _prompt(vocab):
    return np.random.default_rng(1).integers(0, vocab, (BATCH, PROMPT))


@pytest.mark.parametrize("quantize,gated", [(False, True), (False, False),
                                            (True, True), (True, False)])
def test_greedy_streams_token_exact_f32(quantize, gated):
    js, ts = _pair("float32", quantize, gated)
    prompt = _prompt(ts.cfg.vocab)
    want = np.asarray(js.generate(jnp.asarray(prompt, jnp.int32), NEW))
    got = ts.generate(prompt, NEW)
    assert got.shape == (BATCH, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the streams are not degenerate: the check compares real choices
    assert len(np.unique(want)) > BATCH
    if quantize:
        assert ts.plan_table.digest == js.plan_table.digest
        assert (ts.prefill_plan_table.digest
                == js.prefill_plan_table.digest)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_first_step_logits_match(dtype, quantize):
    js, ts = _pair(dtype, quantize, gated=True, seed=2)
    prompt = _prompt(ts.cfg.vocab)
    want = np.asarray(js.prefill(jnp.asarray(prompt, jnp.int32)),
                      np.float32)
    got = ts.prefill(prompt).float().numpy()
    assert got.shape == want.shape == (BATCH, 1, ts.cfg.vocab)
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


def test_route_report_and_gates_equal():
    js, ts = _pair("float32", quantize=True, gated=True)
    ours, ref = ts.route_report(), js.route_report()
    assert ours == ref and len(ours) == 8
    assert cim_fraction(ours) == cim_fraction(ref)
    for lab in ours:
        assert ts.use_cim_for(lab) == js.use_cim_for(lab)
        assert ts.use_cim_for(f"{ts.cfg.name} {lab}") == js.use_cim_for(lab)
    assert ts.verdict_table.digest == js.verdict_table.digest
    assert set(ts.kernel_plan) == set(js.kernel_plan)
    with pytest.raises(KeyError):
        ts.use_cim_for("no-such-label")


def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_repro():
    files = list(_port_files())
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not bad, bad


def _layers_imported(node, layer: str) -> list[str]:
    """The packages of repro_torch that an import statement in a module
    of package `layer` names ("kernels", "models", ...)."""
    if isinstance(node, ast.Import):
        return [a.name.split(".")[1] for a in node.names
                if a.name.startswith("repro_torch.")]
    if node.level == 0:
        mod = node.module or ""
        return [mod.split(".")[1]] if mod.startswith("repro_torch.") else []
    if node.level == 1:
        return [layer]
    return ([node.module.split(".")[0]] if node.module
            else [a.name for a in node.names])


def test_kernel_and_model_layers_import_one_way():
    """No module under kernels/ imports models or serving (the plain
    versions the kernels' CPU paths run live beside them), and no module
    under models/ imports kernels inside a function (the models import
    the kernels at module top, no cycle to dodge)."""
    bad = []
    for layer in ("kernels", "models"):
        pkg = os.path.join(ROOT, "src", "repro_torch", layer)
        for f in sorted(os.listdir(pkg)):
            if not f.endswith(".py"):
                continue
            with open(os.path.join(pkg, f)) as fh:
                tree = ast.parse(fh.read(), f)
            for node in ast.walk(tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    used = set(_layers_imported(node, layer))
                    if layer == "kernels" and used & {"models", "serving"}:
                        bad.append(f"kernels/{f}:{node.lineno}")
                if layer == "models" and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    bad += [f"models/{f}:{n.lineno}" for n in ast.walk(node)
                            if isinstance(n, (ast.Import, ast.ImportFrom))
                            and "kernels" in _layers_imported(n, layer)]
    assert not bad, bad


def test_no_silent_cpu_fallback():
    """Without `device=` the entry points mean the card: on a CPU-only
    torch they raise instead of running on the CPU."""
    cfg = reduced(ARCHS["qwen2-7b"])
    cpu_params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params live on cpu"):
            ServeSession(cfg, RunConfig(), cpu_params, max_len=8, batch=2)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(cfg, RunConfig(), cpu_params, max_len=8, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeCore(cfg, RunConfig(), cpu_params, quantize=True)
    with pytest.raises((RuntimeError, AssertionError)):
        init(torch.Generator(), cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        params_from_jax({"w": np.zeros(3, np.float32)})


def _port_modules():
    import pkgutil
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


@pytest.mark.parametrize("name", _port_modules())
def test_port_module_has_docstring(name):
    """The docstring gate of tests/test_docs.py, for the port."""
    import importlib
    doc = importlib.import_module(name).__doc__
    assert doc and len(doc.strip()) >= 40, name


def test_temperature_sampling_is_seeded():
    """temperature > 0 draws from a torch.Generator seeded by `seed`
    (not held to the reference: jax.random draws other numbers)."""
    _, ts = _pair("float32", quantize=False, gated=True)
    prompt = _prompt(ts.cfg.vocab)
    a = ts.generate(prompt, NEW, temperature=1.0, seed=3)
    ts.reset()
    b = ts.generate(prompt, NEW, temperature=1.0, seed=3)
    assert torch.equal(a, b) and a.shape == (BATCH, NEW)
    assert bool(((a >= 0) & (a < ts.cfg.vocab)).all())
