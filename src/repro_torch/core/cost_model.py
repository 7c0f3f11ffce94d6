"""Analytical energy / latency / throughput evaluation (paper §V-D).

Energy = Σ_level (accesses · access cost) + MACs · E_mac + adds · 0.05 pJ.
Cycles = max(compute cycles, SMEM-BW cycles, DRAM-BW cycles)   [pipelined]
TOPS/W = ops / energy[pJ];   GFLOPS = ops / time[ns]   (ops = 2 · MACs).

Calibration choices (DESIGN.md §7, validated in tests/test_calibration.py):
  * Table IV latency is per serial MAC step of a CiM unit: a full-array
    activation takes (active Rh steps)·(active Ch steps)·latency_ns.
    => A-1 saturates at 2·(64·4)/9 ns = 56.9 GFLOPS, D-1 at 2·(256·16)/18 ns
    = 455 GFLOPS — exactly the appendix Fig. 13 saturation values.
  * Primitives at RF share one input driver: array activations serialize
    (matching the 455 GFLOPS ceiling with 3 arrays).  SMEM banks have
    independent ports: arrays run in parallel (configB ≈ 10× RF, Fig. 11b).
  * DRAM weight streaming for CiM tiles is strided: 50 % effective
    bandwidth (reproduces the ~31 GFLOPS M=1 decode/DLRM cells).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from .gemm import GEMM
from .loopnest import Loop, ceil_div, coverage_factor, revisit_factor
from .mapping import PSUM_BYTES, CiMMapping, candidate_mappings
from .memory import (DRAM, RF, SMEM, TEMPORAL_REDUCTION_PJ, CiMSystemConfig,
                     MemoryLevel)
from .primitives import precision_factors

DRAM_STREAM_EFFICIENCY = 0.5   # strided CiM weight/input tiles (DESIGN.md §7)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """System-level evaluation result for one GEMM + mapping."""

    ops: float
    energy_pj: float
    time_ns: float
    compute_ns: float
    dram_ns: float
    smem_ns: float
    utilization: float
    dram_bytes: float
    smem_bytes: float
    energy_breakdown_pj: dict
    mapping: object = None

    @property
    def tops_per_w(self) -> float:
        return self.ops / self.energy_pj if self.energy_pj else 0.0

    @property
    def gflops(self) -> float:
        return self.ops / self.time_ns if self.time_ns else 0.0

    @property
    def fj_per_op(self) -> float:
        return 1e3 * self.energy_pj / self.ops

    @property
    def edp(self) -> float:
        return self.energy_pj * self.time_ns

    def row(self) -> dict:
        return {
            "tops_per_w": self.tops_per_w, "gflops": self.gflops,
            "utilization": self.utilization, "energy_pj": self.energy_pj,
            "time_ns": self.time_ns, "dram_bytes": self.dram_bytes,
        }


def metrics_from_row(ops: float, row: dict, mapping=None) -> Metrics:
    """Build a Metrics from one row of a batched evaluation result
    (vectorized.evaluate_flat / evaluate_baseline_flat outputs).

    The batched path computes aggregate energy only, so the per-level
    breakdown dict is empty; everything the planner consumes (energy,
    time, throughput, utilization, traffic) is populated.
    """
    return Metrics(
        ops=float(ops),
        energy_pj=float(row["energy_pj"]),
        time_ns=float(row["time_ns"]),
        compute_ns=float(row.get("compute_ns", 0.0)),
        dram_ns=float(row.get("dram_ns", 0.0)),
        smem_ns=float(row.get("smem_ns", 0.0)),
        utilization=float(row.get("utilization", 0.0)),
        dram_bytes=float(row.get("dram_bytes", 0.0)),
        smem_bytes=float(row.get("smem_bytes", 0.0)),
        energy_breakdown_pj={},
        mapping=mapping,
    )


def _dram_order_candidates(mapping: CiMMapping, order_mode: str):
    loops = mapping.dram_loops
    if order_mode == "greedy":
        return [loops]
    return [tuple(p) for p in itertools.permutations(loops)]


def evaluate_cim(mapping: CiMMapping, order_mode: str = "exact",
                 dram_eff: float = DRAM_STREAM_EFFICIENCY) -> Metrics:
    """Evaluate one CiM mapping; chooses the best DRAM loop order."""
    best: Metrics | None = None
    for order in _dram_order_candidates(mapping, order_mode):
        m = _evaluate_cim_order(mapping, order, dram_eff)
        if best is None or m.energy_pj < best.energy_pj:
            best = m
    return best


def _evaluate_cim_order(mp: CiMMapping, dram_loops: tuple[Loop, ...],
                        dram_eff: float) -> Metrics:
    g, cfg, p = mp.gemm, mp.cfg, mp.cfg.prim
    at_rf = cfg.cim_level == "RF"

    k0, n0 = min(g.K, mp.k0), min(g.N, mp.n0)
    k_tiles, n_tiles = mp.k_tiles, mp.n_tiles
    waves = g.M * k_tiles * n_tiles            # array-activation groups

    # ---- compute time ------------------------------------------------------
    # per-precision macro scaling vs the Table-IV INT8 calibration point
    # (identity at INT8): energy_x on the MAC energy, latency_x on the
    # activation latency, colpar_x on the usable column parallelism
    energy_x, latency_x, colpar_x = precision_factors(
        p.compute_type, g.bits, g.fp)
    row_steps = ceil_div(mp.k_arr, p.Rp)       # serial row groups (<= Rh)
    col_steps = math.ceil(mp.n_arr / (p.Cp * colpar_x))  # serial col groups
    steps_per_activation = row_steps * col_steps
    serial_arrays = mp.n_arrays if (cfg.serialize_primitives and at_rf) else 1
    compute_ns = (waves * steps_per_activation * serial_arrays
                  * p.latency_ns * latency_x)

    # ---- traffic -----------------------------------------------------------
    # Loops above the buffer residency (innermost-first): DRAM-level loops.
    # Loops above the CiM weight residency: buffer-level growth loops
    # (K inner of N — paper's M<K<N compute order), then DRAM loops.
    above_buffer = list(dram_loops)
    above_weights = [("K", mp.fk), ("N", mp.fn)] + above_buffer

    e = {}
    dram_bytes = 0.0
    smem_bytes = 0.0

    # Weights: DRAM -> CiM arrays (footprint = one buffer residency's worth
    # of stationary tiles: (k0*fk) x (n0*fn)).
    w_fills = (min(g.K, mp.k0 * mp.fk) * min(g.N, mp.n0 * mp.fn)
               ) * revisit_factor(above_buffer, "W")
    # cap: never less than one full pass of the weight matrix
    w_fills = max(w_fills, g.weight_elems)
    e["dram_W"] = DRAM.energy_pj(w_fills)
    dram_bytes += w_fills
    # writing weights into the arrays (charged at the hosting level's port)
    host = RF if at_rf else SMEM
    e["cim_write_W"] = host.energy_pj(w_fills)

    if at_rf:
        # Input tile (m1 x k0*fk) and psum tile (m1 x n0*fn) live in SMEM.
        a_tile = mp.m1 * min(g.K, mp.k0 * mp.fk)
        a_fills = a_tile * revisit_factor(above_buffer, "A")
        a_fills = max(a_fills, g.input_elems)
        e["dram_A"] = DRAM.energy_pj(a_fills)
        dram_bytes += a_fills

        z_tile = mp.m1 * min(g.N, mp.n0 * mp.fn)
        r = revisit_factor(above_buffer, "Z")
        cov = coverage_factor(above_buffer, "Z")
        spills = z_tile * max(0, r - cov)          # psum spill round-trips
        z_dram = z_tile * cov + 2 * spills * PSUM_BYTES  # final INT8 + RMW
        e["dram_Z"] = DRAM.energy_pj(max(z_dram, g.output_elems))
        dram_bytes += max(z_dram, g.output_elems)

        # SMEM port: input-driver reads (k0 per activation group, broadcast
        # across columns) and psum read-modify-write (n0 per group, 4 B).
        a_reads = waves * k0
        z_rmw = 2.0 * waves * n0 * PSUM_BYTES
        e["smem_A"] = SMEM.energy_pj(a_reads)
        e["smem_Z"] = SMEM.energy_pj(z_rmw)
        smem_bytes += a_reads + z_rmw
    else:
        # CiM at SMEM: inputs stream straight from DRAM; partial sums spill
        # to DRAM whenever K does not fully reduce in-array.
        a_fills = waves * k0
        e["dram_A"] = DRAM.energy_pj(a_fills)
        dram_bytes += a_fills
        spills = g.output_elems * max(0, k_tiles - 1)
        z_dram = g.output_elems + 2 * spills * PSUM_BYTES
        e["dram_Z"] = DRAM.energy_pj(z_dram)
        dram_bytes += z_dram

    # ---- compute energy ----------------------------------------------------
    macs = g.macs
    e["mac"] = macs * p.mac_energy_pj * energy_x
    # temporal reductions: one add per output element per K-tile beyond the
    # in-array reduction (plus serial row groups within an activation).
    adds = g.output_elems * max(0, k_tiles * row_steps - 1)
    e["reduction"] = adds * TEMPORAL_REDUCTION_PJ

    energy = sum(e.values())

    # ---- bandwidth-limited time (fully pipelined: take the max) ------------
    dram_ns = dram_bytes / (DRAM.bandwidth_bytes_per_cycle * dram_eff)
    smem_ns = (smem_bytes / SMEM.bandwidth_bytes_per_cycle
               if math.isfinite(SMEM.bandwidth_bytes_per_cycle) else 0.0)
    time_ns = max(compute_ns, dram_ns, smem_ns)

    return Metrics(ops=g.ops, energy_pj=energy, time_ns=time_ns,
                   compute_ns=compute_ns, dram_ns=dram_ns, smem_ns=smem_ns,
                   utilization=mp.utilization, dram_bytes=dram_bytes,
                   smem_bytes=smem_bytes, energy_breakdown_pj=e, mapping=mp)


def evaluate(gemm: GEMM, cfg: CiMSystemConfig,
             order_mode: str = "exact") -> Metrics:
    """Map (paper algorithm) + evaluate one GEMM on a CiM system.

    Scores every candidate buffer residency the priority mapper emits and
    returns the access-minimal one (the paper's greedy objective)."""
    best: Metrics | None = None
    for mp in candidate_mappings(gemm, cfg, order_mode):
        m = evaluate_cim(mp, order_mode)
        if best is None or m.energy_pj < best.energy_pj:
            best = m
    return best
