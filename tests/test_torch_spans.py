"""Spans (`repro_torch.spans`): the sections of the decode step, timed by
marks at each span's entry and exit.  On the CPU the marks run the
kernel's arithmetic on the host clock; here a clock that ticks once per
read makes every interval between two marks one nanosecond, so self
times are counts of intervals and are known exactly."""
import itertools

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import ARCHS, RunConfig, reduced
from repro_torch.models import (clone_cache, decode_step, init,
                                init_paged_cache)
from repro_torch.models.layers import EXPERT_LABELS, route_trace
from repro_torch.quant import quantize_model_params

DENSE = {"decode.step", "attn.kv_write", "attn.gather", "attn.core", "proj"}
MOE = DENSE | {"moe.router", "moe.experts"}
SLOTS, BLOCKS, BS = 3, 12, 4


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with no recorder armed."""
    assert spans.recorder() is None
    yield
    if spans.recorder() is not None:
        spans.disarm()


def _ticks():
    """A clock that reads 1, 2, 3, ... nanoseconds."""
    return itertools.count(1).__next__


def _step_inputs(arch, kv="bfloat16"):
    cfg = reduced(ARCHS[arch])
    rc = RunConfig(kv_cache_dtype=kv)
    params = quantize_model_params(
        init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    cache = init_paged_cache(cfg, rc, SLOTS, BLOCKS, BS, device="cpu")
    tok = torch.tensor([[3], [7], [11]])
    pos = torch.tensor([2, 5, 0], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    tables = torch.arange(SLOTS * 3, dtype=torch.int32).reshape(SLOTS, 3)
    return cfg, rc, params, cache, (tok, pos, active, tables)


def _step(cfg, rc, params, cache, inputs):
    tok, pos, active, tables = inputs
    with torch.inference_mode():
        return decode_step(params, cache, tok, pos, cfg, rc, active=active,
                           block_tables=tables)[0]


def test_unarmed_span_is_the_shared_noop(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "mark", lambda *a, **k: calls.append(a))
    assert spans.span("proj") is spans.NO_SPAN
    assert spans.span("decode.step") is spans.NO_SPAN
    assert not spans.active()
    cfg, rc, params, cache, inputs = _step_inputs("qwen2-7b")
    _step(cfg, rc, params, cache, inputs)
    assert calls == []


def test_armed_but_closed_marks_nothing():
    rec = spans.arm("cpu", clock=_ticks())
    marks = rec.marks
    assert spans.span("proj") is spans.NO_SPAN
    _step(*_step_inputs("qwen2-7b"))
    assert rec.marks == marks and not spans.active()
    assert all(v == 0 for v in spans.disarm().values())


@pytest.mark.parametrize("arch,names", [("qwen2-7b", DENSE),
                                        ("qwen2-moe-a2.7b", MOE)])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_armed_step_records_its_sections(arch, names, kv):
    """Exactly the step's section names; one mark at each span's entry
    and exit (one proj per `linear` but the expert contractions); self
    times that sum to the root span's length, all intervals but the
    first mark's, which only sets the time."""
    cfg, rc, params, cache, inputs = _step_inputs(arch, kv)
    with route_trace() as records:
        _step(cfg, rc, params, clone_cache(cache), inputs)
    projs = sum(r["label"] not in EXPERT_LABELS for r in records)
    per_layer = 3 + (2 if cfg.moe else 0)     # kv_write, gather, core
    want_marks = 2 * (1 + projs + per_layer * cfg.n_layers)

    rec = spans.arm("cpu", clock=_ticks())
    rec.open()
    marks = rec.marks
    _step(cfg, rc, params, cache, inputs)
    assert rec.marks - marks == want_marks
    assert rec.stack == []
    ns = {k: round(v * 1e9) for k, v in spans.disarm().items()}
    assert {k for k, v in ns.items() if v > 0} == names
    assert all(v >= 0 for v in ns.values())
    assert sum(ns.values()) == want_marks - 1


def test_self_time_is_charged_to_the_innermost_span():
    """Marks at t = 10 (root in), 30 (proj in), 60 (proj out), 100 (root
    out): the root holds 20 + 40, proj 30; a later mark with no span open
    charges nothing."""
    times = iter([5, 10, 30, 60, 100, 1000])
    rec = spans.arm("cpu", clock=times.__next__)
    rec.open()
    with spans.span("decode.step"):
        with spans.span("proj"):
            pass
    rec.mark()                          # no span open: sets the time only
    ns = {k: round(v * 1e9) for k, v in spans.disarm().items()}
    assert ns["decode.step"] == 60 and ns["proj"] == 30
    assert sum(ns.values()) == 90


def test_logits_and_cache_bit_equal_with_spans_armed():
    cfg, rc, params, cache, inputs = _step_inputs("qwen2-moe-a2.7b", "int8")
    copy = clone_cache(cache)
    want = _step(cfg, rc, params, copy, inputs)
    spans.arm("cpu").open()
    got = _step(cfg, rc, params, cache, inputs)
    spans.disarm()
    assert torch.equal(got, want)
    for a, b in zip(cache, copy):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_open_zeroes_and_forced_overrides():
    rec = spans.arm("cpu", clock=_ticks())
    with spans.forced(True):
        with spans.span("proj"):
            pass
    assert rec.acc.sum().item() > 0 and not spans.active()
    rec.open()
    assert rec.acc.sum().item() == 0 and spans.active()
    with spans.forced(False):
        assert spans.span("proj") is spans.NO_SPAN
    assert spans.span("proj") is not spans.NO_SPAN
    rec.close()
    assert not spans.active()
    with pytest.raises(RuntimeError, match="already armed"):
        spans.arm("cpu")
    spans.disarm()
    with pytest.raises(RuntimeError, match="no span recorder"):
        spans.disarm()
    with spans.forced(True):           # nothing armed: nothing to force
        assert spans.span("proj") is spans.NO_SPAN


def test_prefill_forward_is_a_profiler_range():
    """`make_prefill` runs each forward inside a host range named
    "prefill.forward", which a profiler records around the forward's
    ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import make_prefill
    cfg = reduced(ARCHS["qwen2-7b"])
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prefill = make_prefill(cfg, RunConfig())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(params, torch.zeros((1, 8), dtype=torch.long))
        prefill(params, torch.zeros((1, 8), dtype=torch.long))
    names = [e.name for e in prof.events()]
    assert names.count("prefill.forward") == 2
    assert any(n.startswith("aten::") for n in names)
