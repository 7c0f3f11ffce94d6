"""Priority-based CiM mapping algorithm (paper §IV-B, Algorithm 1).

Priorities, in order:
  1. Weight stationarity: K -> CiM rows, N -> CiM columns; partial sums are
     reduced in-array along K.
  2. Utilization via parallelism: weights are spread across multiple
     primitives before filling the serial (Rh/Ch) extents of one unit;
     the K-vs-N expansion across primitives keeps the mapped-dimension
     ratio below a threshold (paper: 4).
  3. Input/weight reuse: the largest possible input block (M1 x K-tile) is
     held in the adjacent memory level (SMEM); then the N and K factors of
     that level are grown while capacity allows (Algorithm 1).
  4. Loop order: compute keeps M < K < N (M innermost); outer memory levels
     use the greedy smallest-factor-outermost rule or the exact
     6-permutation minimizer (see loopnest.best_order).
"""
from __future__ import annotations

import dataclasses

from .gemm import GEMM
from .loopnest import Loop, ceil_div, greedy_order
from .memory import LEVELS, SMEM, CiMSystemConfig

PSUM_BYTES = 4  # partial-sum precision (INT8 inputs -> 32-bit accumulators)


@dataclasses.dataclass(frozen=True)
class CiMMapping:
    """A complete mapping of one GEMM onto a CiM-integrated hierarchy.

    Spatial (within/across arrays):
      k_arr, n_arr : active rows / cols of the weight tile per array
      pk, pn       : primitives along K and N (pk*pn <= n_prims)
    Buffer residency (SMEM when CiM sits at RF; disabled for CiM@SMEM):
      m1           : M elements streamed per residency block
      fk, fn       : growth factors — the buffered input tile is
                     (m1 x k0*fk), the buffered output tile is (m1 x n0*fn)
    DRAM level:
      dram_loops   : remaining (dim, trips) loops, innermost first
    """

    gemm: GEMM
    cfg: CiMSystemConfig
    k_arr: int
    n_arr: int
    pk: int
    pn: int
    m1: int
    fk: int
    fn: int
    dram_loops: tuple[Loop, ...]

    # ---- derived geometry -------------------------------------------------
    @property
    def k0(self) -> int:
        """Spatial K extent across all arrays."""
        return self.k_arr * self.pk

    @property
    def n0(self) -> int:
        """Spatial N extent across all arrays."""
        return self.n_arr * self.pn

    @property
    def n_arrays(self) -> int:
        return self.pk * self.pn

    @property
    def k_tiles(self) -> int:
        return ceil_div(self.gemm.K, self.k0)

    @property
    def n_tiles(self) -> int:
        return ceil_div(self.gemm.N, self.n0)

    @property
    def m2(self) -> int:
        return ceil_div(self.gemm.M, self.m1)

    @property
    def k2(self) -> int:
        """DRAM-level K trips (above the buffered fk tiles)."""
        return ceil_div(self.k_tiles, self.fk)

    @property
    def n2(self) -> int:
        return ceil_div(self.n_tiles, self.fn)

    @property
    def waves(self) -> int:
        """Total array-activation groups: one per (m, K-tile, N-tile)."""
        return self.gemm.M * self.k_tiles * self.n_tiles

    @property
    def utilization(self) -> float:
        """Mapped weight positions / total MAC units (paper §V-D)."""
        p = self.cfg.prim
        mapped_k = min(self.gemm.K, self.k0)
        mapped_n = min(self.gemm.N, self.n0)
        total = self.cfg.resolved_n_prims() * p.mac_units
        return (mapped_k * mapped_n) / total

    def validate(self) -> None:
        p, g = self.cfg.prim, self.gemm
        assert 1 <= self.k_arr <= p.k_rows, self
        assert 1 <= self.n_arr <= p.n_cols, self
        assert self.pk * self.pn <= self.cfg.resolved_n_prims(), self
        assert self.k_arr * self.n_arr <= p.capacity_bytes, self
        assert self.m1 >= 1 and self.fk >= 1 and self.fn >= 1, self
        # the buffered tiles must fit the buffer level (Algorithm 1 check)
        if self.cfg.cim_level == "RF":
            a = self.m1 * min(g.K, self.k0 * self.fk)
            z = self.m1 * min(g.N, self.n0 * self.fn) * PSUM_BYTES
            assert a + z <= SMEM.capacity_bytes, (a, z, self)
        # full coverage
        assert self.k0 * self.fk * self.k2 >= g.K, self
        assert self.n0 * self.fn * self.n2 >= g.N, self
        assert self.m1 * self.m2 >= g.M, self


def _minfactor(rem: int) -> int | None:
    """Smallest prime factor of `rem` (> 1), None when fully mapped.

    Algorithm 1's Minfactor: the next loop-factor increment available for a
    dimension with `rem` un-mapped trips.
    """
    if rem <= 1:
        return None
    for p in (2, 3, 5, 7):
        if rem % p == 0:
            return p
    # fall back: rem itself (prime or awkward); Algorithm 1 would take it
    for p in range(11, int(rem ** 0.5) + 1, 2):
        if rem % p == 0:
            return p
    return rem


def dimension_optimize(capacity: int, m_used: int, k_elems: int,
                       n_elems: int, n_rem_tiles: int,
                       psum_bytes: int = PSUM_BYTES) -> int:
    """Algorithm 1 (Dimension Optimization for N).

    Grows the N loop factor at the buffer level while the input block
    (m_used x k_elems) plus output block (m_used x n_elems*factor) fit.
    `n_rem_tiles` is the number of N tiles still unmapped above this level.
    Returns the achieved factor.
    """
    a_size = m_used * k_elems
    factor = 1
    while a_size + m_used * n_elems * factor * psum_bytes <= capacity:
        nf = _minfactor(ceil_div(n_rem_tiles, factor))
        if nf is None:
            break  # N fully mapped
        if a_size + m_used * n_elems * factor * nf * psum_bytes > capacity:
            break
        factor *= nf
    return factor


def allocate_primitives(gemm: GEMM, cfg: CiMSystemConfig
                        ) -> tuple[int, int, int, int]:
    """Priority 2: spread weights across primitives, K->rows / N->cols,
    keeping the mapped K:N extent ratio within the balance threshold.

    Returns (k_arr, n_arr, pk, pn).
    """
    p = cfg.prim
    n_prims = cfg.resolved_n_prims()
    thr = cfg.kn_balance_threshold
    k_arr = min(gemm.K, p.k_rows)
    n_arr = min(gemm.N, p.n_cols)
    need_k = ceil_div(gemm.K, k_arr)      # arrays to fully cover K
    need_n = ceil_div(gemm.N, n_arr)
    best = (k_arr, n_arr, 1, 1)
    best_score = None
    for pk in range(1, n_prims + 1):
        if pk > need_k:
            break
        pn_max = n_prims // pk
        for pn in range(1, pn_max + 1):
            if pn > need_n:
                break
            k0, n0 = k_arr * pk, n_arr * pn
            # paper §IV-B: expansion across primitives must stay balanced —
            # the larger-to-smaller expansion ratio must be < threshold
            # (Fig. 6b skewed vs 6c balanced).
            ratio = max(pk, pn) / min(pk, pn)
            if ratio >= thr and pk * pn > 1:
                continue
            # priority: parallelism (arrays used), then coverage balance
            covered = min(gemm.K, k0) * min(gemm.N, n0)
            score = (pk * pn, covered, -ratio)
            if best_score is None or score > best_score:
                best_score = score
                best = (k_arr, n_arr, pk, pn)
    return best


def _buffer_candidates(gemm: GEMM, k0: int, n0: int, k_tiles: int,
                       n_tiles: int) -> list[tuple[int, int, int]]:
    """Candidate (m1, fk, fn) buffer residencies, per the paper's priorities.

    The paper's greedy goal is "reducing the number of data accesses"; which
    tensor to hold deep depends on the GEMM shape, so we emit the candidate
    residencies its priority rules produce and let the cost model pick:
      (a) input-stationary: the A block spans full K (the weight matrix
          streams once per M block — maximum input reuse, paper Fig. 6a),
      (b) k0-deep streaming: A streams per spatial K tile; the psum block
          grows along N via Algorithm 1 (A refetched once per N super-tile),
      (c) output-stationary: the psum block spans full N (best for tiny M,
          e.g. GEMV decode rows).
    """
    cap = int(SMEM.capacity_bytes)
    cands: list[tuple[int, int, int]] = []

    # (a) full-K input block
    a_depth = min(gemm.K, k0 * k_tiles)
    m1 = cap // (a_depth + n0 * PSUM_BYTES)
    if m1 >= 1:
        m1 = min(gemm.M, m1)
        fn = dimension_optimize(cap, m1, a_depth, n0, n_tiles)
        cands.append((m1, k_tiles, fn))

    # (b) k0-deep streaming + Algorithm 1 N growth
    m1 = min(gemm.M, max(1, cap // (k0 + n0 * PSUM_BYTES)))
    fn = dimension_optimize(cap, m1, k0, n0, n_tiles)
    cands.append((m1, 1, fn))

    # (c) full-N psum block
    z_width = min(gemm.N, n0 * n_tiles)
    m1 = cap // (k0 + z_width * PSUM_BYTES)
    if m1 >= 1:
        m1 = min(gemm.M, m1)
        # deepen the input block with what is left (Algorithm 1 on K)
        fk = 1
        while True:
            nf = _minfactor(ceil_div(k_tiles, fk))
            if nf is None:
                break
            if m1 * min(gemm.K, k0 * fk * nf) \
                    + m1 * z_width * PSUM_BYTES > cap:
                break
            fk *= nf
        cands.append((m1, fk, n_tiles))

    return sorted(set(cands))


def candidate_mappings(gemm: GEMM, cfg: CiMSystemConfig,
                       order_mode: str = "exact") -> list[CiMMapping]:
    """All residencies the priority algorithm considers; the cost model
    (cost_model.evaluate) picks the access-minimal one — the paper's stated
    greedy objective."""
    k_arr, n_arr, pk, pn = allocate_primitives(gemm, cfg)
    k0, n0 = k_arr * pk, n_arr * pn
    k_tiles = ceil_div(gemm.K, k0)
    n_tiles = ceil_div(gemm.N, n0)

    if cfg.cim_level == "RF":
        triples = _buffer_candidates(gemm, k0, n0, k_tiles, n_tiles)
    else:
        # CiM at SMEM: all capacity is CiM arrays; no buffer level.
        triples = [(gemm.M, 1, 1)]

    out = []
    for m1, fk, fn in triples:
        m2 = ceil_div(gemm.M, m1)
        k2 = ceil_div(k_tiles, fk)
        n2 = ceil_div(n_tiles, fn)
        loops: tuple[Loop, ...] = (("M", m2), ("K", k2), ("N", n2))
        if order_mode == "greedy":
            loops = greedy_order(loops)
        m = CiMMapping(gemm=gemm, cfg=cfg, k_arr=k_arr, n_arr=n_arr, pk=pk,
                       pn=pn, m1=m1, fk=fk, fn=fn, dram_loops=loops)
        m.validate()
        out.append(m)
    return out


def priority_map(gemm: GEMM, cfg: CiMSystemConfig,
                 order_mode: str = "exact") -> CiMMapping:
    """The paper's priority-based mapping algorithm, end to end (first
    candidate; prefer cost_model.evaluate which scores all candidates).

    order_mode: "exact" evaluates all DRAM-level loop permutations inside
    the cost model; "greedy" fixes the paper's smallest-factor-outermost
    order up front (the batched path re-derives the same order per row
    in-kernel from the m2/k2/n2 trips — see vectorized.evaluate_flat).
    """
    return candidate_mappings(gemm, cfg, order_mode)[0]
