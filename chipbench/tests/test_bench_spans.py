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
