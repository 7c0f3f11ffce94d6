"""Heuristic (random-search) mapper baseline (paper §IV-B, Fig. 7/Table II).

Timeloop-style random sampling over the raw mapping space: factor tuples
are drawn uniformly from power-of-two grids *including invalid points*;
the search terminates after `max_consecutive_invalid` invalid samples in a
row (the paper uses 100 000) or after `max_valid` scored samples.

The paper's point (which this reproduces) is that the priority mapper gets
equal-or-better mappings with no search, because the search is agnostic to
the CiM primitive's inherent reuse structure.
"""
from __future__ import annotations

import dataclasses
import random

from .cost_model import Metrics, evaluate_cim
from .gemm import GEMM
from .loopnest import ceil_div
from .mapping import PSUM_BYTES, CiMMapping
from .memory import SMEM, CiMSystemConfig


def _pow2_choices(limit: int) -> list[int]:
    out, v = [], 1
    while v <= limit:
        out.append(v)
        v *= 2
    return out


@dataclasses.dataclass
class SearchResult:
    best: Metrics | None
    sampled: int
    valid: int
    consecutive_invalid_stop: bool


def random_search(gemm: GEMM, cfg: CiMSystemConfig, *,
                  seed: int = 0,
                  max_consecutive_invalid: int = 100_000,
                  max_valid: int = 2_000,
                  objective: str = "edp") -> SearchResult:
    rng = random.Random(seed)
    p = cfg.prim
    n_prims = cfg.resolved_n_prims()
    k_choices = _pow2_choices(min(gemm.K, p.k_rows))
    n_choices = _pow2_choices(min(gemm.N, p.n_cols))
    pk_choices = list(range(1, n_prims + 1))
    m_choices = _pow2_choices(gemm.M)
    f_choices = _pow2_choices(4096)
    dims = ["M", "N", "K"]

    best: Metrics | None = None
    invalid_run = 0
    sampled = valid = 0
    stop_invalid = False
    while True:
        sampled += 1
        k_arr = rng.choice(k_choices)
        n_arr = rng.choice(n_choices)
        pk = rng.choice(pk_choices)
        pn = rng.choice(pk_choices)
        m1 = rng.choice(m_choices)
        fk = rng.choice(f_choices)
        fn = rng.choice(f_choices)
        order = dims[:]
        rng.shuffle(order)
        k_tiles = ceil_div(gemm.K, max(1, k_arr * pk))
        n_tiles = ceil_div(gemm.N, max(1, n_arr * pn))
        loops = tuple({"M": ("M", ceil_div(gemm.M, m1)),
                       "K": ("K", ceil_div(k_tiles, fk)),
                       "N": ("N", ceil_div(n_tiles, fn))}[d] for d in order)
        mp = CiMMapping(gemm=gemm, cfg=cfg, k_arr=k_arr, n_arr=n_arr,
                        pk=pk, pn=pn, m1=m1, fk=fk, fn=fn, dram_loops=loops)
        try:
            mp.validate()
        except AssertionError:
            invalid_run += 1
            if invalid_run >= max_consecutive_invalid:
                stop_invalid = True
                break
            continue
        invalid_run = 0
        valid += 1
        m = evaluate_cim(mp, order_mode="greedy")
        if best is None or _score(m, objective) < _score(best, objective):
            best = m
        if valid >= max_valid:
            break
    return SearchResult(best=best, sampled=sampled, valid=valid,
                        consecutive_invalid_stop=stop_invalid)


def _score(m: Metrics, objective: str) -> float:
    if objective == "energy":
        return m.energy_pj
    if objective == "time":
        return m.time_ns
    return m.edp
