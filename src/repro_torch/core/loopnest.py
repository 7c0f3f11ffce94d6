"""Timeloop-lite loop-nest access counting (paper §III-B, Fig. 4).

A mapping is a nest of tiling loops.  For a tensor resident at some level,
the number of *fills* (fetches from the parent level) equals the resident
footprint times a *revisit factor* over the loops above that level:

  - loops over dimensions irrelevant to the tensor, encountered before any
    relevant loop (walking inner -> outer), reuse the resident tile: skipped;
  - from the first relevant loop outward, every loop iteration changes (or
    revisits) the tile, so every factor multiplies.

This is exactly the effect Fig. 4 illustrates: the dimension placed in the
outermost loop multiplies the access factors of the other tensors.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Sequence

Loop = tuple[str, int]          # (dim name in {"M","N","K"}, trip count)

RELEVANT = {
    "A": frozenset({"M", "K"}),
    "W": frozenset({"K", "N"}),
    "Z": frozenset({"M", "N"}),
}

# Canonical dim order the greedy rule breaks trip-count ties with (it is
# the order candidate_mappings emits DRAM loops in, and Python's stable
# sort preserves it).  vectorized.evaluate_flat's in-kernel greedy
# selection mirrors exactly this (dim, index) tie-break, so the batched
# and scalar greedy paths pick the same permutation bit-for-bit.
CANONICAL_DIMS = ("M", "K", "N")

# The DRAM-order selection modes every layer supports.  Single source of
# truth: vectorized.evaluate_flat, sweep.SweepEngine and planner.decide
# all validate against this tuple, so no layer can drift into accepting
# (or silently rerouting) a mode another layer rejects.
ORDER_MODES = ("exact", "greedy")


def check_order_mode(order_mode: str) -> None:
    if order_mode not in ORDER_MODES:
        raise ValueError(f"unknown order_mode {order_mode!r}; "
                         f"expected one of {ORDER_MODES}")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def revisit_factor(loops_above: Sequence[Loop], tensor: str) -> int:
    """Revisit multiplier for `tensor` given loops above its residency,
    ordered innermost first."""
    rel = RELEVANT[tensor]
    r = 1
    seen_relevant = False
    for dim, f in loops_above:
        if f <= 1:
            continue
        if dim in rel:
            seen_relevant = True
        if seen_relevant:
            r *= f
    return r


def fills(footprint: int, loops_above: Sequence[Loop], tensor: str) -> int:
    """Number of elements fetched from the parent level into a residency of
    `footprint` elements, given the loops above it (innermost first)."""
    return footprint * revisit_factor(loops_above, tensor)


def coverage_factor(loops_above: Sequence[Loop], tensor: str) -> int:
    """Number of *distinct* tiles the loops above iterate for `tensor`
    (product of relevant loop trips only).  revisit_factor / coverage_factor
    = how many times each distinct tile is re-visited (for the output
    tensor: partial-sum spill round-trips)."""
    rel = RELEVANT[tensor]
    c = 1
    for dim, f in loops_above:
        if dim in rel:
            c *= f
    return c


def best_order(loops: Sequence[Loop],
               score_fn,
               ) -> tuple[tuple[Loop, ...], float]:
    """Exact minimizer over all permutations of a (small) loop level.

    `score_fn(order)` -> cost.  Paper §IV-B uses a greedy rule (smallest
    loop factor outermost); `greedy_order` implements that; this exact
    search is the beyond-paper default (≤ 3! = 6 permutations).
    """
    best, best_cost = None, math.inf
    for perm in itertools.permutations(loops):
        c = score_fn(perm)
        if c < best_cost:
            best, best_cost = perm, c
    return tuple(best), best_cost


def greedy_order(loops: Sequence[Loop]) -> tuple[Loop, ...]:
    """Paper-faithful greedy rule: the dimension with the *smallest* loop
    factor goes outermost (minimizes the common multiplier of the other
    tensors' access factors — the Fig. 4 argument), descending inward.

    Returned order is innermost-first (consistent with `revisit_factor`):
    largest factor innermost ... smallest factor outermost.  Ties keep
    the input order (stable sort) — see CANONICAL_DIMS.
    """
    return tuple(sorted(loops, key=lambda lf: -lf[1]))


def greedy_perm(trips: dict) -> tuple[str, ...]:
    """The innermost-first dim permutation the greedy rule picks for the
    given {dim: trip-count} DRAM loops (dims considered in CANONICAL_DIMS
    order, as candidate_mappings emits them).

    This is the scalar reference for the per-row permutation
    vectorized.evaluate_flat selects in-kernel under order_mode="greedy".
    """
    loops = [(d, trips[d]) for d in CANONICAL_DIMS]
    return tuple(d for d, _ in greedy_order(loops))


@dataclasses.dataclass(frozen=True)
class TensorTraffic:
    """Per-tensor element counts crossing one level boundary."""
    reads: float = 0.0       # elements read from the parent (far) level
    writes: float = 0.0      # elements written back to the parent level

    def __add__(self, o: "TensorTraffic") -> "TensorTraffic":
        return TensorTraffic(self.reads + o.reads, self.writes + o.writes)


def output_rmw_traffic(tile_elems: int, loops_above: Sequence[Loop],
                       ) -> tuple[float, float]:
    """Partial-sum read/write element counts for the output tensor Z.

    Z is revisited `r` times; each residency ends with a write-back, and all
    but the first begin with a read of the previous partial sums.  Returns
    (psum_reads, psum_writes) in elements; the final write is included in
    psum_writes (caller may cost the last MN elements at output precision).
    """
    r = revisit_factor(loops_above, "Z")
    writes = tile_elems * r
    reads = tile_elems * max(0, r - 1)
    return float(reads), float(writes)
