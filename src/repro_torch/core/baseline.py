"""Tensor-core-like baseline architecture model (paper §V-A).

One SM: 4 sub-cores x 16x16 PEs (1024 INT8 MACs/cycle @ 1 GHz, peak
2048 GOPS), RF 4x4 KB, SMEM 256 KB, DRAM.  Unlike CiM, the baseline is
*not* forced weight-stationary: tile sizes and per-level loop orders are
searched (cuBLAS-style), which is exactly the flexibility the paper credits
for its better behaviour on small-M GEMMs (§VI-C).

Dataflow modelled: output-stationary at the PE level (psums in PE
registers while K streams), A/W/Z tiles staged in RF, super-tiles in SMEM.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from .cost_model import Metrics
from .gemm import GEMM
from .loopnest import Loop, ceil_div, coverage_factor, revisit_factor
from .mapping import PSUM_BYTES
from .memory import DRAM, RF, SMEM, TEMPORAL_REDUCTION_PJ
from .primitives import TENSOR_CORE, TensorCoreSpec

# spatial extent of the PE grid: 4 subcores arranged 2x2 -> 32x32 outputs
SPATIAL_M = 32
SPATIAL_N = 32


@dataclasses.dataclass(frozen=True)
class BaselineMapping:
    gemm: GEMM
    mt: int                      # RF tile (outputs mt x nt, depth kt)
    nt: int
    kt: int
    ms: int                      # SMEM super-tile factors (in RF tiles)
    ns: int
    ks: int
    rf_loops: tuple[Loop, ...]   # innermost first
    smem_loops: tuple[Loop, ...]
    dram_loops: tuple[Loop, ...]

    def validate(self) -> None:
        g = self.gemm
        rf_bytes = (self.mt * self.kt + self.kt * self.nt
                    + self.mt * self.nt * PSUM_BYTES)
        assert rf_bytes <= RF.capacity_bytes, self
        sm_m, sm_n, sm_k = (self.mt * self.ms, self.nt * self.ns,
                            self.kt * self.ks)
        smem_bytes = (min(g.M, sm_m) * min(g.K, sm_k)
                      + min(g.K, sm_k) * min(g.N, sm_n)
                      + min(g.M, sm_m) * min(g.N, sm_n) * PSUM_BYTES)
        assert smem_bytes <= SMEM.capacity_bytes, self


def _evaluate_order(mp: BaselineMapping, spec: TensorCoreSpec = TENSOR_CORE
                    ) -> Metrics:
    g = mp.gemm
    mt, nt, kt = min(g.M, mp.mt), min(g.N, mp.nt), min(g.K, mp.kt)
    sm_m = min(g.M, mp.mt * mp.ms)
    sm_n = min(g.N, mp.nt * mp.ns)
    sm_k = min(g.K, mp.kt * mp.ks)

    above_rf = list(mp.smem_loops) + list(mp.dram_loops)
    above_smem = list(mp.dram_loops)

    e = {}
    # ---- DRAM -> SMEM ------------------------------------------------------
    a_fills = max(sm_m * sm_k * revisit_factor(above_smem, "A"),
                  g.input_elems)
    w_fills = max(sm_k * sm_n * revisit_factor(above_smem, "W"),
                  g.weight_elems)
    rz = revisit_factor(above_smem, "Z")
    cz = coverage_factor(above_smem, "Z")
    z_spill = sm_m * sm_n * max(0, rz - cz)
    z_dram = sm_m * sm_n * cz + 2 * z_spill * PSUM_BYTES
    dram_bytes = a_fills + w_fills + max(z_dram, g.output_elems)
    e["dram"] = DRAM.energy_pj(dram_bytes)

    # ---- SMEM -> RF ----------------------------------------------------------
    a_rf = max(mt * kt * revisit_factor(above_rf, "A"), g.input_elems)
    w_rf = max(kt * nt * revisit_factor(above_rf, "W"), g.weight_elems)
    rzr = revisit_factor(above_rf, "Z")
    czr = coverage_factor(above_rf, "Z")
    z_rf = (mt * nt * czr
            + 2 * mt * nt * max(0, rzr - czr) * PSUM_BYTES)
    smem_bytes = a_rf + w_rf + z_rf
    e["smem"] = SMEM.energy_pj(smem_bytes)

    # ---- RF -> PE operand collectors -----------------------------------------
    # Every MAC reads both operands from the register file through the
    # operand collectors (no cross-PE amortization — GPU-style register
    # operand reads).  These are exactly the accesses CiM's stationarity
    # eliminates (paper §VI-C "saving the data accesses in the lower memory
    # levels").  Psums stay in PE accumulators across kt.
    macs = g.macs
    rf_reads = 2.0 * macs
    z_rf_rmw = 2.0 * g.output_elems * ceil_div(g.K, kt) * PSUM_BYTES
    e["rf"] = RF.energy_pj(rf_reads + z_rf_rmw)

    # per-MAC operand feeds from the PE operand buffers
    e["pe_buffer"] = 2.0 * macs * spec.pe_buffer_energy_pj
    e["mac"] = macs * spec.mac_energy_pj
    adds = g.output_elems * max(0, ceil_div(g.K, kt) - 1)
    e["reduction"] = adds * TEMPORAL_REDUCTION_PJ
    energy = sum(e.values())

    # ---- time ----------------------------------------------------------------
    # spatial utilization of the 32x32 grid given the RF tile
    eff_m = mt / (ceil_div(mt, SPATIAL_M) * SPATIAL_M)
    eff_n = nt / (ceil_div(nt, SPATIAL_N) * SPATIAL_N)
    util = eff_m * eff_n
    compute_ns = macs / (spec.macs_per_cycle * max(util, 1e-9)) \
        / spec.freq_ghz
    dram_ns = dram_bytes / DRAM.bandwidth_bytes_per_cycle
    smem_ns = smem_bytes / SMEM.bandwidth_bytes_per_cycle
    time_ns = max(compute_ns, dram_ns, smem_ns)

    return Metrics(ops=g.ops, energy_pj=energy, time_ns=time_ns,
                   compute_ns=compute_ns, dram_ns=dram_ns, smem_ns=smem_ns,
                   utilization=util, dram_bytes=dram_bytes,
                   smem_bytes=smem_bytes, energy_breakdown_pj=e, mapping=mp)


def _pow2s(limit: int, lo: int = 1):
    v = lo
    while v <= limit:
        yield v
        v *= 2


def tile_candidates(gemm: GEMM):
    """Yield every (mt, nt, kt, ms, ns, ks) tile combo the baseline search
    considers: the power-of-two RF tile grid, the largest K depth fitting
    RF, and greedily-grown SMEM super-tile factors (M first, then N, then
    K).  Shared by the scalar search below and the batched scorer in
    vectorized.evaluate_baseline_flat (same order, so tie-breaks agree).
    """
    g = gemm
    for mt in _pow2s(min(2 * SPATIAL_M * 4, max(SPATIAL_M, g.M)), 8):
        for nt in _pow2s(min(2 * SPATIAL_N * 4, max(SPATIAL_N, g.N)), 8):
            # largest power-of-two K depth that fits RF with these tiles
            rem = RF.capacity_bytes - mt * nt * PSUM_BYTES
            if rem <= 0:
                continue
            kt = 1
            while (mt + nt) * kt * 2 <= rem and kt < g.K:
                kt *= 2
            kt = min(kt, max(1, g.K))
            # SMEM super-tile: grow factors greedily, M first then N
            ms = ns = ks = 1

            def smem_ok(ms, ns, ks):
                return (min(g.M, mt * ms) * min(g.K, kt * ks)
                        + min(g.K, kt * ks) * min(g.N, nt * ns)
                        + min(g.M, mt * ms) * min(g.N, nt * ns) * PSUM_BYTES
                        ) <= SMEM.capacity_bytes
            while mt * ms < g.M and smem_ok(ms * 2, ns, ks):
                ms *= 2
            while nt * ns < g.N and smem_ok(ms, ns * 2, ks):
                ns *= 2
            while kt * ks < g.K and smem_ok(ms, ns, ks * 2):
                ks *= 2
            yield (mt, nt, kt, ms, ns, ks)


def evaluate_baseline(gemm: GEMM, spec: TensorCoreSpec = TENSOR_CORE
                      ) -> Metrics:
    """Search tile sizes + loop orders for the tensor-core baseline and
    return the best (min cycles, then min energy) metrics.

    This is the scalar reference; repro.core.sweep scores the identical
    grid through vectorized.evaluate_baseline_flat in one fused kernel.
    """
    g = gemm
    best: Metrics | None = None
    for mt, nt, kt, ms, ns, ks in tile_candidates(g):
        rf_loops = (("M", ms), ("K", ks), ("N", ns))
        dram = (("M", ceil_div(g.M, mt * ms)),
                ("K", ceil_div(g.K, kt * ks)),
                ("N", ceil_div(g.N, nt * ns)))
        for rf_perm in itertools.permutations(rf_loops):
            for dram_perm in itertools.permutations(dram):
                mp = BaselineMapping(g, mt, nt, kt, ms, ns, ks,
                                     rf_loops=tuple(rf_perm),
                                     smem_loops=tuple(rf_perm),
                                     dram_loops=tuple(dram_perm))
                try:
                    mp.validate()
                except AssertionError:
                    continue
                m = _evaluate_order(mp, spec)
                key = (m.time_ns, m.energy_pj)
                if best is None or key < (best.time_ns, best.energy_pj):
                    best = m
    assert best is not None, f"no valid baseline mapping for {gemm}"
    return best
