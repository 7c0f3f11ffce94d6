"""The one traffic generator: it reads a cell's "traffic" block and makes
the requests and their arrival times from a seed.

Every seed gets the same set of sizes and arrival gaps, in another
order: a length distribution is held as a fixed grid of `requests`
quantiles (inverse CDF at (i + 0.5) / requests), and so is a Poisson
process's exponential gap.  The seed draws the token ids and, for each
cycle of `requests`, a plain random permutation of each grid (prompt
lengths, output lengths and gaps each their own), so two seeds do the
same amount of work and two runs of one seed get the same inputs.  The
gaps come in a uniformly random order, so runs of short gaps (bursts)
come as often as in a Poisson process; only the sum over a cycle is
fixed, as a Poisson process's count over a stretch is once it is given.

A "traffic" block:

  {"arrival": "poisson", "rate": 5.2, ...}   open loop: request i is due
                                             at the sum of the first i gaps
  {"arrival": "backlog", "depth": 32, ...}   the queue holds `depth`
                                             requests all window
  {"arrival": "closed", ...}                 one request at a time, the
                                             next sent when one finishes
  "requests": n                              size of the quantile grid
  "source": "..."                            where the lengths come from
  "prompt": {"dist": ..., "min": a, "max": b[, "multiple": m]}
  "output": {...}                            (absent for prefill traffic)

with "dist" one of "lognormal" (+ "median", "sigma"), "uniform" and
"loguniform"; lengths are rounded to the nearest whole number (to a
multiple of "multiple") and clipped to [min, max].
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def quantile_grid(spec: dict, n: int) -> np.ndarray:
    """The n lengths of a length distribution: its quantiles at
    (i + 0.5) / n, rounded and clipped (ascending)."""
    lo, hi = spec["min"], spec["max"]
    mult = spec.get("multiple", 1)
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "uniform":
        vals = lo + u * (hi - lo)
    elif dist == "loguniform":
        vals = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    vals = np.round(vals / mult) * mult
    return np.clip(vals, lo, hi).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """The n gaps of a Poisson process at `rate` per second: quantiles of
    the exponential at (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


@dataclasses.dataclass
class Item:
    """One request: its index, prompt token ids, output length (0 for
    prefill traffic) and due time (seconds after the window opens; 0 for
    backlog and closed traffic)."""
    index: int
    prompt: np.ndarray
    out_len: int
    due: float


class Traffic:
    """The cell's requests in order, made on demand (`next()`), with their
    due times for Poisson traffic.  `stream` draws another sequence from
    the same seed (the engine cells' warm-up takes stream 2)."""

    def __init__(self, spec: dict, vocab: int, seed: int,
                 stream: int | None = None):
        self.spec = spec
        self.vocab = vocab
        self.rng = np.random.default_rng(
            seed if stream is None else [seed, stream])
        self.n = spec["requests"]
        self.prompts = quantile_grid(spec["prompt"], self.n)
        self.outputs = (quantile_grid(spec["output"], self.n)
                        if "output" in spec else np.zeros(self.n, np.int64))
        self.gaps = None
        if spec["arrival"] == "poisson":
            self.gaps = exponential_gaps(spec["rate"], self.n)
        self._count = 0
        self._cycle: list[tuple[int, int, float]] = []
        self._t = 0.0

    def _next_cycle(self) -> None:
        p = self.rng.permutation(self.prompts)
        o = self.rng.permutation(self.outputs)
        g = (self.rng.permutation(self.gaps) if self.gaps is not None
             else np.zeros(self.n))
        self._cycle = list(zip(p.tolist(), o.tolist(), g.tolist()))[::-1]

    def next(self) -> Item:
        if not self._cycle:
            self._next_cycle()
        plen, olen, gap = self._cycle.pop()
        if self.gaps is not None:
            self._t += gap
        prompt = self.rng.integers(0, self.vocab, size=plen, dtype=np.int64)
        self._count += 1
        return Item(self._count - 1, prompt.astype(np.int32), int(olen),
                    self._t)

    def distinct_prompt_lengths(self) -> list[int]:
        return sorted(set(self.prompts.tolist()))
