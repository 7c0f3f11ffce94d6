"""The readers of the program's spans (`chipbench/span_readers.py`) on
synthetic records: each gives the known value, and None on a record of a
program without spans."""
import pytest

from chipbench import spec

DECODE = ("decode_attention_ms", "decode_proj_ms", "moe_experts_ms")


def _decode_record(seconds, steps=10):
    return {"trace": {"steps": steps, "busy_s": 1.0, "window_s": 1.0,
                      "spans": {"steps": steps, "seconds": seconds}}}


@pytest.mark.parametrize("name,want", [("decode_attention_ms", 6.0),
                                       ("decode_proj_ms", 2.5),
                                       ("moe_experts_ms", 0.7)])
def test_decode_section_per_step(name, want):
    run = _decode_record({"decode.step": 0.05, "attn.kv_write": 0.01,
                          "attn.gather": 0.02, "attn.core": 0.03,
                          "proj": 0.025, "moe.router": 0.002,
                          "moe.experts": 0.005})
    assert spec.reader(name)(run) == pytest.approx(want)


def test_moe_experts_reads_nothing_on_a_dense_step():
    run = _decode_record({"decode.step": 0.05, "attn.core": 0.03,
                          "proj": 0.025, "moe.router": 0.0,
                          "moe.experts": 0.0})
    assert spec.reader("moe_experts_ms")(run) is None
    assert spec.reader("decode_proj_ms")(run) == pytest.approx(2.5)


@pytest.mark.parametrize("name", DECODE + ("prefill_forward_idle_ms",))
def test_none_without_spans(name):
    """A run of a program without spans: a traced record with neither a
    span window nor forward ranges, and an untraced one."""
    traced = {"trace": {"steps": 10, "busy_s": 1.0, "window_s": 1.2,
                        "by_name": {}, "breakdown": {}}}
    assert spec.reader(name)(traced) is None
    assert spec.reader(name)({"steps": 10}) is None
    empty = _decode_record({}, steps=0)
    assert spec.reader(name)(empty) is None


def test_prefill_forward_idle_splits_gaps_at_the_forwards():
    """Two forwards, issued over 0-62 and 100-182 us.  The first runs
    kernels 0-20, 30-50 and 45-60: 10 us idle between them and 2 after
    the last, while the forward is still issuing.  Then the caller
    waits and sends the next prompt (62-100, a copy at 90-95): outside.
    The second runs 105-150 and 170-180: 5 us before its first kernel,
    20 between and 2 after lie inside.  (12 + 27) / 2 us per forward."""
    run = {"trace": {
        "forward_spans": [[100.0, 182.0], [0.0, 62.0]],
        "device": [[0.0, 20.0], [30.0, 50.0], [45.0, 60.0], [90.0, 95.0],
                   [105.0, 150.0], [170.0, 180.0]]}}
    got = spec.reader("prefill_forward_idle_ms")(run)
    assert got == pytest.approx((12 + 27) / 2 / 1e3)


def test_prefill_forward_idle_counts_a_forward_with_no_gap():
    """A kernel queued before the range and one running past its end
    count only for the part inside it."""
    run = {"trace": {"forward_spans": [[10.0, 50.0]],
                     "device": [[0.0, 30.0], [30.0, 70.0]]}}
    assert spec.reader("prefill_forward_idle_ms")(run) == 0.0


class _Recorder:
    def __init__(self):
        self.calls = []

    def open(self):
        self.calls.append("open")

    def close(self):
        self.calls.append("close")


def test_span_window_opens_and_closes_between_steps():
    from chipbench.drivers.engine import SpanWindow
    rec = _Recorder()
    sw = SpanWindow(rec, 1.0, 2.0)
    for now, steps in ((0.5, 1), (1.0, 3), (1.5, 6), (2.0, 10), (2.5, 12)):
        sw.poll(now, steps)
    assert rec.calls == ["open", "close"] and sw.steps == 7
    # a step that spans the whole span window: it never opens
    late = SpanWindow(_Recorder(), 1.0, 2.0)
    late.poll(0.5, 1)
    late.poll(2.2, 2)
    assert late.rec.calls == [] and late.steps is None


def test_traced_engine_run_reads_the_spans():
    """A traced run of the MoE cell on the CPU (the program marks on the
    host clock there): the span window's sections reach the readers, and
    the recorder is disarmed after the run; an untraced run arms none."""
    from repro_torch import spans
    from chipbench.tests import tiny
    cell = tiny.engine_cell("qwen2-moe-a2.7b.chat-backlog")
    r = tiny.run(cell, tiny.MOE, seconds=1.5, trace=True,
                 workload="qwen2-moe-a2.7b.chat-backlog")
    assert spans.recorder() is None
    for name in ("decode_attention_ms", "decode_proj_ms", "moe_experts_ms"):
        assert r["metrics"][name]["value"] > 0, name
        assert r["metrics"][name]["unit"] == "ms/step"
    r = tiny.run(cell, tiny.MOE, seconds=1.0,
                 workload="qwen2-moe-a2.7b.chat-backlog")
    assert spans.recorder() is None
    assert "decode_attention_ms" not in r["metrics"]


def test_traced_prefill_run_carries_the_forward_ranges():
    """A traced prefill run hands the span readers each forward's host
    range and the device's activities (none on the CPU)."""
    import time
    from chipbench import harness
    from chipbench.drivers import prefill
    from chipbench.tests import tiny
    ctx = harness.Ctx(bench=spec.load_benchmark(),
                      workload="qwen2-7b.score-prefill",
                      cell=tiny.prefill_cell(), model=tiny.DENSE,
                      arch=tiny.ARCH, seed=9, seconds=1.5, trace=True,
                      device="cpu", t_start=time.perf_counter())
    tr = prefill.run(ctx)["record"]["trace"]
    harness.read_trace(tr)
    assert tr["forwards"] > 0
    assert len(tr["forward_spans"]) >= tr["forwards"]
    assert all(b > a for a, b in tr["forward_spans"])
    assert tr["device"] == []
