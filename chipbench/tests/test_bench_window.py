"""Window arithmetic: a rate is over the whole window, a tail over every
sample, and a request still waiting at the close stays in the sample."""
import pytest

from chipbench import window


def test_rate_is_over_the_whole_window():
    assert window.rate(300, 10.0, 40.0) == 10.0


def test_percentile_is_over_all_samples():
    vals = list(range(1, 101))
    assert window.percentile(vals, 90) == pytest.approx(90.1)
    assert window.percentile([], 90) is None


def test_waiting_request_is_kept():
    due = [0.0, 1.0, 2.0, 9.0, 11.0]
    first = [0.5, None, 3.0, None, 11.5]
    w = window.waits(due, first, 0.0, 10.0)
    # the one due at 1.0 never got a token: it enters with 10 - 1; the
    # one due at 9.0 with 10 - 9; the one due after the close is out
    assert w == [0.5, 9.0, 1.0, 1.0]
    assert window.percentile(w, 90) > 1.0


def test_event_after_close_counts_as_waiting():
    assert window.waits([1.0], [12.0], 0.0, 10.0) == [9.0]


def test_watch_past_the_close_takes_the_wait_whole():
    due = [1.0, 9.0, 10.5]
    first = [12.0, None, 11.0]
    # watched until 15: the first is taken whole, the second is still
    # waiting (15 - 9), the third was due after the close and is out
    assert window.waits(due, first, 0.0, 10.0, 15.0) == [11.0, 6.0]


def test_gaps_inside_the_window():
    stamps = [[1.0, 1.5, 2.5], [0.5, 9.0, 11.0]]
    assert window.gaps(stamps, 1.0, 10.0) == [0.5, 1.0]


def test_spread():
    assert window.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert window.spread([9, 10, 10, 11]) == pytest.approx(
        (10.75 - 9.25) / 10)


def test_window_opens_on_a_running_batch():
    """The engine cells' warm-up: at the open some requests are already
    running, at different positions, and the window counts only the
    tokens and positions that came after the open."""
    from chipbench import harness, spec
    from chipbench.drivers import engine
    from chipbench.tests import tiny
    cell = tiny.engine_cell("qwen2-moe-a2.7b.chat-backlog")
    cell["warm_s"] = 1.0
    ctx = harness.Ctx(bench=spec.load_benchmark(),
                      workload="qwen2-moe-a2.7b.chat-backlog", cell=cell,
                      model=tiny.DENSE, arch=tiny.ARCH, seed=5, seconds=1.0, trace=False,
                      device="cpu", t_start=0.0)
    rec = engine.run(ctx)["record"]
    t0 = rec["t0"]
    running = [p for p in rec["pos_start"] if p > 0]
    assert len(running) >= 2 and len(set(running)) >= 2
    assert any(s and s[0] < t0 for s in rec["stamps"])
    assert all(a <= b for a, b in zip(rec["pos_start"], rec["pos_end"]))
    reader = spec.reader("output_tokens_per_s")
    n = sum(1 for s in rec["stamps"] for t in s if t0 <= t <= rec["t1"])
    assert reader(rec) == pytest.approx(n / (rec["t1"] - t0))


def test_check_takes_the_widest_or_the_cells_quantile():
    import numpy as np
    from chipbench import check
    gaps = [np.linspace(0.0, 0.99, 100), np.array([3.0])]
    widest = check.verdict(gaps, {"limit": 0.5, "min_tokens": 10})
    assert not widest["correct"]
    assert widest["checks"]["top_token_gap"]["value"] == 3.0
    p99 = check.verdict(gaps, {"limit": 1.0, "min_tokens": 10,
                               "quantile": 99})
    assert p99["correct"]
    assert p99["checks"]["top_token_gap_p99"]["value"] == pytest.approx(
        float(np.percentile(np.concatenate(gaps), 99)))
    assert p99["checks"]["tokens_compared"] == {"value": 101,
                                                "limit": 10}
