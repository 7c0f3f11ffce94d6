"""The plain reference against the port at tiny widths on the CPU, both
in float32: the port's forward over INT8 weights it quantized itself,
the reference over INT8 weights it works out from the same bf16 draws.
Also the benchmark's weights against the layout of the port's `init`."""
import pytest
import torch

from chipbench import reference, spec, weights
from chipbench.drivers.common import program_config
from chipbench.tests import tiny

ARCH = spec.arch(tiny.ARCH)


def _f32(model):
    return dict(model, param_dtype="float32", compute_dtype="float32")


def _layout(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_layout(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE],
                         ids=["dense", "moe"])
def test_weights_have_the_programs_layout(model):
    from repro_torch.models import init
    cfg = program_config(model)
    ours = weights.make(tiny.ARCH, model, 5, "cpu")
    theirs = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _layout(ours) == _layout(theirs)
    again = weights.make(tiny.ARCH, model, 5, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(ours), _leaves(again)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE],
                         ids=["dense", "moe"])
def test_reference_matches_the_port_in_f32(model):
    from repro_torch.configs import RunConfig
    from repro_torch.models import forward
    from repro_torch.quant import quantize_model_params
    m = _f32(model)
    params = weights.make(tiny.ARCH, m, 11, "cpu")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t.float()
    f32 = walk(params)
    cfg = program_config(m)
    tokens = torch.randint(0, m["vocab"], (1, 8),
                           generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want, _ = forward(quantize_model_params(f32), tokens, cfg,
                          RunConfig(attn_impl="naive", remat=False))
    h = ARCH.final_hidden(m, params, [tokens[0]], [torch.arange(8)], 8)[0]
    got = h @ ARCH.head(params, 8)
    err = (got - want[0]).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


def test_int4_round_trip_is_coarser():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    e8 = (reference.dequantize(w, 8) - w).norm() / w.norm()
    e4 = (reference.dequantize(w, 4) - w).norm() / w.norm()
    assert e8 < 0.02 < e4


def test_dequantize_is_the_programs_arithmetic():
    from repro_torch.quant import dequantize_weight, quantize_weight
    w = torch.randn(48, 40, generator=torch.Generator().manual_seed(2))
    q, s = quantize_weight(w)
    assert torch.equal(reference.dequantize(w, 8), dequantize_weight(q, s))
