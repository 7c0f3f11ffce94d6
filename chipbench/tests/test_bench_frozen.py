"""The yardstick's frozen copies, pinned to the port's numbers today: the
decode and prefill operations (launch/roofline.py), the GEMM and flash
per-call operations and bytes (chip_smoke.py, launch/attn_bench.py), and
the device-trace arithmetic of chip_smoke.py's `profile_window`."""
import contextlib
import importlib
import sys
import types

import pytest

from chipbench import flops, spec, trace
from chipbench.drivers.common import program_config

CONFIGS = ["qwen2-7b", "qwen2-moe-a2.7b"]
QWEN2 = spec.arch("qwen2")


def _model(name):
    return spec.load_config(spec.load_benchmark(), name)["model"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_is_the_registry_entry(name):
    """The registry's entry but for what the file sets to the published
    model: rmsnorm_eps 1e-6, and for the MoE a capacity that drops no
    token (n_experts / top_k)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    want = dataclasses.replace(ARCHS[name], rmsnorm_eps=1e-6)
    if want.moe is not None:
        want = dataclasses.replace(want, moe=dataclasses.replace(
            want.moe, capacity_factor=want.moe.n_experts / want.moe.top_k))
    assert program_config(_model(name)) == want


@pytest.mark.parametrize("name", ["musicgen-large", "mamba2-780m",
                                  "llama-3.2-vision-90b",
                                  "jamba-1.5-large-398b"])
def test_every_sub_config_is_built(name):
    """A "model" block with the registry entry's sub-configs as dicts
    (audio, ssm, vision, moe) gives the entry back."""
    import dataclasses
    from repro_torch.configs import ARCHS
    assert program_config(dataclasses.asdict(ARCHS[name])) == ARCHS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_matmul_params_are_the_active_params(name):
    from repro_torch.configs import ARCHS
    cfg = ARCHS[name]
    # roofline's active count holds the embedding, a gather
    assert QWEN2.matmul_params_per_token(_model(name)) == (
        cfg.active_param_count() - cfg.vocab * cfg.d_model)


@pytest.mark.parametrize("name", CONFIGS)
def test_attention_operations_are_the_roofline_ones(name):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import roofline
    cfg, m = ARCHS[name], _model(name)
    # decode: one query against a cache of S keys
    assert QWEN2.attention_flops(m, 4096) == roofline._decode_attn_flops(
        cfg, 4096, 1)
    # prefill: roofline counts s^2 / 2 pairs, the causal count is
    # s (s + 1) / 2: they differ by the diagonal
    s = 2048
    ours = QWEN2.positions_flops(m, 0, s, 0) - 2.0 * s * (
        QWEN2.matmul_params_per_token(m))
    diag = 4.0 * m["n_layers"] * m["n_heads"] * QWEN2.head_dim(m) * s / 2
    assert ours == pytest.approx(roofline._attn_flops(cfg, s, 1, True)
                                 + diag)


def test_positions_sum_one_by_one():
    m = _model("qwen2-7b")
    total = sum(2.0 * QWEN2.matmul_params_per_token(m, p >= 63)
                + QWEN2.attention_flops(m, p + 1) for p in range(40, 200))
    assert QWEN2.positions_flops(m, 40, 200, 63) == pytest.approx(total)


def _smoke():
    sys.path.insert(0, str(spec.ROOT))
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("mkn", [(32, 3584, 18944), (2048, 18944, 3584),
                                 (8, 3584, 152064)])
def test_gemm_bound_is_chip_smokes(mkn):
    m, k, n = mkn
    bytes_ms, ops_ms = _smoke().bound_parts_ms(m, k, n, 2, 989e12, 2)
    ops, moved = flops.gemm_call(m, k, n)
    assert ops / flops.PEAK_BF16_FLOPS * 1e3 == pytest.approx(ops_ms)
    assert moved / flops.HBM_BYTES_PER_S * 1e3 == pytest.approx(bytes_ms)


@pytest.mark.parametrize("s", [512, 2048, 4096])
def test_flash_bound_is_attn_benchs(s):
    from repro_torch.launch import attn_bench
    ops, _ = flops.flash_call(s, 28, 4, 128)
    assert ops / flops.PEAK_BF16_FLOPS * 1e3 == pytest.approx(
        attn_bench.flash_bound_ms(s))


class _Evt:
    """A `prof.events()` entry, as chip_smoke.py's `profile_window` reads
    it."""

    def __init__(self, name, kind, a, b):
        self.name = name
        self.device_type = types.SimpleNamespace(name=kind)
        self.time_range = types.SimpleNamespace(start=a, end=b)


class _Record:
    """A raw activity record (`kineto_results.events()`), as the harness
    reads it: the same activity, its times in nanoseconds."""

    def __init__(self, name, kind, a, b):
        self._name, self._kind = name, kind
        self._a, self._b = a, b

    def name(self):
        return self._name

    def device_type(self):
        return types.SimpleNamespace(name=self._kind)

    def start_ns(self):
        return int(self._a * 1e3)

    def duration_ns(self):
        return int((self._b - self._a) * 1e3)


ACTIVITIES = [("k1", "CUDA", 0.0, 10.0), ("k2", "CUDA", 5.0, 12.0),
              ("k1", "CUDA", 20.0, 25.0), ("aten::mm", "CPU", 0.0, 30.0),
              ("k3", "CUDA", 24.0, 24.5)]


def test_trace_arithmetic_is_profile_windows(monkeypatch):
    import torch
    import torch.profiler

    @contextlib.contextmanager
    def fake_profile(activities=None):
        yield types.SimpleNamespace(
            events=lambda: [_Evt(*a) for a in ACTIVITIES])
    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    fake_torch = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    got = _smoke().profile_window(fake_torch, lambda: None)
    dev, host = trace.spans([_Record(*a) for a in ACTIVITIES])
    assert got["busy_ms"] * 1e3 == pytest.approx(trace.busy(dev))
    assert dict(got["kernels"]) == pytest.approx(trace.by_name(dev))
    assert trace.busy(dev) == 17.0
    assert trace.idle_gaps(dev, 0.0, 30.0) == [(12.0, 20.0), (25.0, 30.0)]
    b = trace.breakdown(dev, host, 0.0, 30.0)
    assert b["device_ops"][0] == ["k1", 15.0 / 1e6]
    assert b["idle_gaps"] == [["aten::mm", 13.0 / 1e6]]


def test_spans_read_a_real_profilers_records():
    """The records the harness reads exist on this torch and carry the
    ops that ran, as the profiler's own event list has them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    dev, host = trace.spans(prof.profiler.kineto_results.events())
    assert dev == []
    names = {n for n, _, _ in host}
    assert "aten::matmul" in names
    assert names == {e.name for e in prof.events()}
    for _, a, b in host:
        assert b >= a
