"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes and gaps in another order, drawn from the stated
distributions."""
import math
from statistics import NormalDist

import numpy as np
import pytest

from chipbench import spec
from chipbench.traffic import Traffic, exponential_gaps, quantile_grid

CELLS = ["qwen2-7b.chat-poisson", "qwen2-moe-a2.7b.chat-backlog",
         "qwen2-7b.score-prefill"]


def _take(traffic, n):
    return [traffic.next() for _ in range(n)]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    t = spec.load_cell(cell)["traffic"]
    seed = 2 ** 31 + 12345
    a, b = _take(Traffic(t, 152064, seed), 300), _take(
        Traffic(t, 152064, seed), 300)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.out_len, x.due) == (y.out_len, y.due)
    c = _take(Traffic(t, 152064, seed + 1), 300)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_same_sizes_other_order(cell):
    t = spec.load_cell(cell)["traffic"]
    n = t["requests"]
    a, b = _take(Traffic(t, 1000, 1), n), _take(Traffic(t, 1000, 2), n)
    sizes = lambda items: sorted((len(i.prompt), i.out_len) for i in items)
    assert sorted(len(i.prompt) for i in a) == sorted(len(i.prompt)
                                                      for i in b)
    assert sorted(i.out_len for i in a) == sorted(i.out_len for i in b)
    assert [len(i.prompt) for i in a] != [len(i.prompt) for i in b]
    if t["arrival"] == "poisson":
        assert a[-1].due == pytest.approx(b[-1].due)     # same gaps summed
    assert sizes(a) != [] and all(0 <= x.prompt.min() and x.prompt.max()
                                  < 1000 for x in a)


def test_lognormal_grid():
    spec_ = {"dist": "lognormal", "median": 64, "sigma": 0.7, "min": 16,
             "max": 256}
    g = quantile_grid(spec_, 512)
    assert g.min() >= 16 and g.max() <= 256
    assert np.median(g) == pytest.approx(64, abs=1)
    # the share below 64 * e^0.7 is the normal CDF at 1, up to rounding
    share = np.mean(g <= 64 * math.exp(0.7))
    assert share == pytest.approx(NormalDist().cdf(1.0), abs=0.01)


def test_uniform_and_loguniform_grids():
    u = quantile_grid({"dist": "uniform", "min": 512, "max": 1792}, 512)
    assert u.min() >= 512 and u.max() <= 1792
    assert u.mean() == pytest.approx((512 + 1792) / 2, abs=2)
    lu = quantile_grid({"dist": "loguniform", "min": 512, "max": 4096,
                        "multiple": 128}, 32)
    assert lu.min() == 512 and lu.max() <= 4096 and np.all(lu % 128 == 0)
    # log-uniform: as many below the geometric middle as above it
    assert np.sum(lu < math.sqrt(512 * 4096)) == 16


def test_poisson_gaps():
    g = exponential_gaps(5.0, 512)
    assert g.mean() == pytest.approx(1 / 5.0, rel=0.02)
    assert np.median(g) == pytest.approx(math.log(2) / 5.0, rel=0.01)
    t = dict(spec.load_cell("qwen2-7b.chat-poisson")["traffic"], rate=5.0,
             requests=512)
    items = _take(Traffic(t, 100, 3), 1024)
    dues = np.array([i.due for i in items])
    assert np.all(np.diff(dues) > 0)
    # each cycle of the grid spends the same gaps
    assert dues[511] == pytest.approx(g.sum())
    assert dues[-1] == pytest.approx(2 * g.sum())


def test_gaps_come_in_bursts():
    """The gaps are a plain permutation of the grid: a stretch of short
    gaps comes as often as among independent exponential gaps."""
    t = dict(spec.load_cell("qwen2-7b.chat-poisson")["traffic"], rate=1.0,
             requests=128)
    grid = exponential_gaps(1.0, 128)
    short = np.sort(grid)[31]               # the shortest quarter
    runs, ours = [], []
    rng = np.random.default_rng(0)
    for seed in range(200):
        dues = np.array([i.due for i in _take(Traffic(t, 100, seed), 128)])
        gaps = np.diff(np.concatenate([[0.0], dues]))
        assert sorted(gaps) == pytest.approx(sorted(grid))
        ours.append(max(np.convolve(gaps <= short, np.ones(4), "valid")))
        iid = rng.exponential(1.0, 128)
        runs.append(max(np.convolve(iid <= np.quantile(iid, 0.25),
                                    np.ones(4), "valid")))
    # a block of 4 short gaps in a row (4 arrivals in a burst) turns up
    # about as often as in an i.i.d. draw
    assert np.mean(np.array(ours) == 4) == pytest.approx(
        np.mean(np.array(runs) == 4), abs=0.12)
    assert np.mean(np.array(ours) == 4) > 0.1


def test_chat_window_holds_one_whole_grid():
    """The chat cell's window (51 s) takes one whole permutation of the
    gap grid: every seed's window is due the same requests, in another
    order."""
    t = spec.load_cell("qwen2-7b.chat-poisson")["traffic"]
    for seed in (1, 2 ** 31 + 7):
        items = _take(Traffic(t, 1000, seed), t["requests"])
        assert items[-1].due == pytest.approx(
            exponential_gaps(t["rate"], t["requests"]).sum())
        assert items[-1].due < 51.0
