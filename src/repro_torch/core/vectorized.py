"""Batched CiM + baseline cost model on torch tensors (f32).

The scalar cost model (cost_model.py / baseline.py) evaluates one (GEMM,
mapping) at a time in Python.  This module is the same closed-form
traffic / energy / latency model as elementwise torch ops over (B,)
columns, so one call scores a whole workload's candidate rows on the
engine's device.  It is the port of the JAX package's
`core/vectorized.py`, held bit for bit against that module's jitted
`evaluate_flat` by tests/test_torch_vectorized.py.

Entry points:
  * `evaluate_flat(batch)` — every row is a complete (GEMM dims,
    precision, mapping, system config) tuple; the DRAM loop order is
    scored for all 6 permutations and chosen per row ("exact": min
    energy, "greedy": the smallest-factor-outermost order).
  * `evaluate_batch(gemm, cfg, mappings)` — B mappings of one GEMM on one
    config.
  * `evaluate_baseline_flat(batch)` — the tensor-core baseline over all
    36 RF x DRAM loop-order pairs, lexicographic (time, energy) min.

The CiM spec (`cim_cast` ... `cim_outputs`) is also the plain version of
the hand-written sweep kernel (kernels/sweep_eval.py), which repeats it
operation for operation in CUDA C++.  Rules that keep the bits equal to
the reference's on every device:

  * each expression keeps the reference's operation order (no
    reassociation, no fused multiply-add);
  * a division by a non-power-of-two constant is written as the
    multiplication by its f32 reciprocal: that is what the reference's
    XLA computes for `smem_bytes / 42.0`, and torch itself divides by a
    CPU scalar that way on CUDA but not on the CPU;
  * a division by a power-of-two constant is exact either way, and a
    division of two tensors is an IEEE division on both devices;
  * max/min propagate NaN (torch.maximum / torch.minimum), as
    jnp.maximum does; a cast to bool means "non-zero".
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .baseline import SPATIAL_M, SPATIAL_N, tile_candidates
from .cost_model import DRAM_STREAM_EFFICIENCY
from .gemm import GEMM
from .loopnest import CANONICAL_DIMS, RELEVANT, check_order_mode
from .mapping import PSUM_BYTES
from .memory import DRAM, RF, SMEM, TEMPORAL_REDUCTION_PJ, CiMSystemConfig
from .primitives import TENSOR_CORE, TensorCoreSpec

_ORDERS = list(itertools.permutations(["M", "K", "N"]))

# Row layout of an evaluate_flat batch: GEMM dims + precision + mapping +
# system config.
GEMM_FIELDS = ("M", "N", "K")
PREC_FIELDS = ("bits", "is_fp")
MAP_FIELDS = ("k_arr", "n_arr", "pk", "pn", "m1", "fk", "fn")
CFG_FIELDS = ("n_prims", "at_rf", "serialize", "k_rows", "n_cols",
              "Rp", "Cp", "mac_units", "latency_ns", "mac_energy_pj",
              "prim_capacity", "is_analog")
FLAT_FIELDS = GEMM_FIELDS + PREC_FIELDS + MAP_FIELDS + CFG_FIELDS

# The outputs of evaluate_flat / evaluate_baseline_flat, in the row order
# of the sweep kernel's output matrix.
SWEEP_OUT_FIELDS = ("valid", "energy_pj", "time_ns", "tops_per_w",
                    "gflops", "utilization", "compute_ns", "dram_ns",
                    "smem_ns", "dram_bytes", "smem_bytes")

# Baseline batch layout: GEMM dims + RF tile + SMEM super-tile factors.
BASE_TILE_FIELDS = ("mt", "nt", "kt", "ms", "ns", "ks")
BASE_FLAT_FIELDS = GEMM_FIELDS + BASE_TILE_FIELDS


def f32_reciprocal(x: float) -> float:
    """1/x rounded once to f32 (as XLA folds the constant of `a / x`)."""
    return float(np.float32(1.0) / np.float32(x))


def config_row(cfg: CiMSystemConfig) -> dict:
    """The CFG_FIELDS scalars describing one CiM system config."""
    p = cfg.prim
    return {
        "n_prims": cfg.resolved_n_prims(),
        "at_rf": int(cfg.cim_level == "RF"),
        "serialize": int(cfg.serialize_primitives),
        "k_rows": p.k_rows, "n_cols": p.n_cols,
        "Rp": p.Rp, "Cp": p.Cp, "mac_units": p.mac_units,
        "latency_ns": p.latency_ns, "mac_energy_pj": p.mac_energy_pj,
        "prim_capacity": p.capacity_bytes,
        "is_analog": int(p.compute_type == "analog"),
    }


def precision_row(gemm: GEMM) -> dict:
    """The PREC_FIELDS scalars describing one GEMM's element format."""
    return {"bits": gemm.bits, "is_fp": int(gemm.fp)}


def _zero(like):
    return torch.zeros((), dtype=torch.float32, device=like.device)


def _max0(x):
    """jnp.maximum(0.0, x): NaN propagates."""
    return torch.maximum(_zero(x), x)


def _accesses(n_bytes, level):
    """Whole accesses for a byte stream at a memory level (the batched
    MemoryLevel.energy_pj ceil); granularities are powers of two."""
    return torch.ceil(n_bytes / level.access_granularity_bytes)


def _revisit_seq(pairs, tensor: str):
    """loopnest.revisit_factor over an innermost-first sequence of (dim,
    trips) pairs: loops with trip count <= 1 are skipped, irrelevant
    loops inside the first relevant one multiply."""
    rel = RELEVANT[tensor]
    r = torch.ones_like(pairs[0][1])
    seen = torch.zeros_like(r, dtype=torch.bool)
    for dim, t in pairs:
        active = t > 1
        keep = active if dim in rel else seen & active
        r = r * torch.where(keep, t, 1.0)
        if dim in rel:
            seen = seen | active
    return r


def _revisit_vec(trips: dict, order: tuple, tensor: str):
    """Reuse rule for one static loop order (trips: dim -> (B,) tensor)."""
    return _revisit_seq([(dim, trips[dim]) for dim in order], tensor)


def _coverage_vec(trips: dict, tensor: str):
    """loopnest.coverage_factor (permutation-independent)."""
    c = torch.ones_like(trips["M"])
    for dim in ("M", "K", "N"):
        if dim in RELEVANT[tensor]:
            c = c * trips[dim]
    return c


# Tie-break index of each dim in the greedy rule (loopnest.CANONICAL_DIMS).
_GREEDY_IDX = {d: i for i, d in enumerate(CANONICAL_DIMS)}


def _greedy_mask(trips: dict, order: tuple):
    """(B,) bool: rows whose greedy DRAM order is exactly `order`.

    loopnest.greedy_order is a stable descending sort on trip counts, so
    an innermost-first permutation (d0, d1, d2) is the greedy one iff
    key(d0) < key(d1) < key(d2) with key(d) = (-trips[d], canonical
    index); exactly one of the 6 permutations matches per row."""
    def precedes(a, b):
        ta, tb = trips[a], trips[b]
        if _GREEDY_IDX[a] < _GREEDY_IDX[b]:   # static: tie keeps a first
            return ta >= tb
        return ta > tb

    d0, d1, d2 = order
    return precedes(d0, d1) & precedes(d1, d2)


# --- the CiM cost spec (also the sweep kernel's plain version) -------------


def cim_cast(batch: dict) -> dict:
    """FLAT_FIELDS columns as f32 tensors, bool (non-zero) for the four
    flags.  Columns may be tensors (kept on their device) or arrays."""
    cols = {f: torch.as_tensor(batch[f]).to(torch.float32)
            for f in FLAT_FIELDS}
    for f in ("at_rf", "serialize", "is_fp", "is_analog"):
        cols[f] = cols[f] != 0
    return cols


def pow2_exact(e):
    """2**trunc(e) exactly, as C's ldexpf(1, (int)e) for e within f32's
    normal exponent range (clamped to it); NaN stays NaN.  Built from the
    exponent bits, so no device's exp2/pow rounding enters."""
    clamped = torch.clamp(e, -126.0, 127.0)
    k = torch.nan_to_num(clamped, nan=0.0).to(torch.int32)
    out = ((k + 127) << 23).view(torch.float32)
    return torch.where(torch.isnan(e), e, out)


def cim_precision_factors(cols: dict):
    """Batched primitives.precision_factors: (energy_x, latency_x,
    colpar_x) per row; exactly (1, 1, 1) at INT8."""
    bits = cols["bits"]
    is_fp, is_analog = cols["is_fp"], cols["is_analog"]
    r = bits / 8.0
    pow2 = pow2_exact(bits - 8.0)
    energy_int = torch.where(is_analog, 0.4 * r + 0.6 * pow2, r * r)
    latency_int = torch.where(is_analog, 0.5 + 0.5 * r, r)
    colpar_int = torch.where(is_analog, torch.full_like(bits, 8.0) / bits,
                             1.0)
    energy_x = torch.where(is_fp, torch.where(is_analog, 1.3, 1.2),
                           energy_int)
    latency_x = torch.where(is_fp, torch.where(is_analog, 1.5, 1.25),
                            latency_int)
    colpar_x = torch.where(is_fp, torch.where(is_analog, 0.5, 1.0),
                           colpar_int)
    return energy_x, latency_x, colpar_x


def cim_row_terms(cols: dict) -> dict:
    """Order-independent terms of the CiM cost model: validity, compute
    time, level-local traffic/energy and the DRAM trip counts."""
    M, N, K = cols["M"], cols["N"], cols["K"]
    k_arr, n_arr = cols["k_arr"], cols["n_arr"]
    pk, pn, m1 = cols["pk"], cols["pn"], cols["m1"]
    fk, fn = cols["fk"], cols["fn"]
    n_prims, at_rf = cols["n_prims"], cols["at_rf"]
    serialize = cols["serialize"]
    k_rows, n_cols = cols["k_rows"], cols["n_cols"]
    Rp, Cp = cols["Rp"], cols["Cp"]
    mac_units = cols["mac_units"]
    latency_ns = cols["latency_ns"]
    mac_energy_pj = cols["mac_energy_pj"]
    prim_capacity = cols["prim_capacity"]

    k0 = torch.minimum(k_arr * pk, K)
    n0 = torch.minimum(n_arr * pn, N)
    k_tiles = torch.ceil(K / k0)
    n_tiles = torch.ceil(N / n0)
    m2 = torch.ceil(M / m1)
    k2 = torch.ceil(k_tiles / fk)
    n2 = torch.ceil(n_tiles / fn)
    waves = M * k_tiles * n_tiles
    macs = M * N * K
    ops = 2.0 * macs
    input_elems = M * K
    weight_elems = K * N
    output_elems = M * N

    # --- validity (same checks as CiMMapping.validate) ---
    a_block = m1 * torch.minimum(K, k0 * fk)
    z_block = m1 * torch.minimum(N, n0 * fn) * PSUM_BYTES
    fits_buffer = a_block + z_block <= SMEM.capacity_bytes
    valid = ((k_arr >= 1) & (k_arr <= k_rows)
             & (n_arr >= 1) & (n_arr <= n_cols)
             & (pk * pn <= n_prims)
             & (k_arr * n_arr <= prim_capacity)
             & (m1 >= 1) & (fk >= 1) & (fn >= 1)
             & (~at_rf | fits_buffer))   # buffer check only applies at RF

    # --- compute time (primitives share the input driver only at RF) ---
    energy_x, latency_x, colpar_x = cim_precision_factors(cols)
    row_steps = torch.ceil(k_arr / Rp)
    col_steps = torch.ceil(n_arr / (Cp * colpar_x))
    serial = torch.where(serialize & at_rf, pk * pn, 1.0)
    compute_ns = (waves * row_steps * col_steps * serial
                  * latency_ns * latency_x)

    # --- level-local traffic + compute energy (whole accesses) ---
    a_smem_reads = torch.where(at_rf, waves * k0, 0.0)
    z_smem_rmw = torch.where(at_rf, 2.0 * waves * n0 * PSUM_BYTES, 0.0)
    smem_bytes = a_smem_reads + z_smem_rmw
    e_smem = (_accesses(a_smem_reads, SMEM) + _accesses(z_smem_rmw, SMEM)
              ) * SMEM.access_energy_pj
    e_mac = macs * mac_energy_pj * energy_x
    adds = output_elems * _max0(k_tiles * row_steps - 1)
    e_red = adds * TEMPORAL_REDUCTION_PJ

    # CiM@SMEM: inputs stream straight from DRAM, psums spill per K-tile
    a_smem_lvl = waves * k0
    z_smem_lvl = (output_elems
                  + 2.0 * output_elems * _max0(k_tiles - 1) * PSUM_BYTES)
    # weights are written into the arrays through the hosting level's port
    host_gran = torch.where(at_rf, float(RF.access_granularity_bytes),
                            float(SMEM.access_granularity_bytes))
    host_energy = torch.where(at_rf, RF.access_energy_pj,
                              SMEM.access_energy_pj)

    trips = {"M": m2, "K": k2, "N": n2}
    util = (torch.minimum(K, k0) * torch.minimum(N, n0)
            / (n_prims * mac_units))
    return {
        "valid": valid, "compute_ns": compute_ns,
        "smem_bytes": smem_bytes, "e_smem": e_smem, "e_mac": e_mac,
        "e_red": e_red, "trips": trips, "at_rf": at_rf,
        "w_foot": torch.minimum(K, k0 * fk) * torch.minimum(N, n0 * fn),
        "z_tile": m1 * torch.minimum(N, n0 * fn),
        "cz": _coverage_vec(trips, "Z"),
        "a_block": a_block, "a_smem_lvl": a_smem_lvl,
        "z_smem_lvl": z_smem_lvl, "host_gran": host_gran,
        "host_energy": host_energy,
        "input_elems": input_elems, "weight_elems": weight_elems,
        "output_elems": output_elems, "ops": ops, "utilization": util,
    }


def cim_order_cost(pre: dict, order: tuple):
    """(energy_pj, dram_bytes) of one static DRAM loop order."""
    trips = pre["trips"]
    w_fills = torch.maximum(pre["w_foot"] * _revisit_vec(trips, order, "W"),
                            pre["weight_elems"])
    a_rf_fills = torch.maximum(
        pre["a_block"] * _revisit_vec(trips, order, "A"),
        pre["input_elems"])
    rz = _revisit_vec(trips, order, "Z")
    spills = pre["z_tile"] * _max0(rz - pre["cz"])
    z_rf_bytes = torch.maximum(
        pre["z_tile"] * pre["cz"] + 2.0 * spills * PSUM_BYTES,
        pre["output_elems"])
    a_fills = torch.where(pre["at_rf"], a_rf_fills, pre["a_smem_lvl"])
    z_bytes = torch.where(pre["at_rf"], z_rf_bytes, pre["z_smem_lvl"])
    dram_bytes = w_fills + a_fills + z_bytes
    e_dram = (_accesses(w_fills, DRAM) + _accesses(a_fills, DRAM)
              + _accesses(z_bytes, DRAM)) * DRAM.access_energy_pj
    e_w_write = (torch.ceil(w_fills / pre["host_gran"])
                 * pre["host_energy"])
    energy = (e_dram + e_w_write + pre["e_smem"] + pre["e_mac"]
              + pre["e_red"])
    return energy, dram_bytes


def cim_best_order(pre: dict, order_mode: str):
    """DRAM-order selection over the 6 unrolled permutations: "exact"
    keeps the first minimum-energy order (strict <), "greedy" each row's
    `_greedy_mask` order."""
    some = pre["trips"]["M"]
    best_energy = torch.full_like(some, float("inf"))
    best_dram = torch.zeros_like(some)
    for order in _ORDERS:
        energy, dram_bytes = cim_order_cost(pre, order)
        if order_mode == "greedy":
            keep = _greedy_mask(pre["trips"], order)
        else:
            keep = energy < best_energy
        best_energy = torch.where(keep, energy, best_energy)
        best_dram = torch.where(keep, dram_bytes, best_dram)
    return best_energy, best_dram


def cim_outputs(pre: dict, best_energy, best_dram,
                dram_eff: float = DRAM_STREAM_EFFICIENCY) -> dict:
    """Assemble the public output dict from the selected order's cost."""
    valid = pre["valid"]
    ops = pre["ops"]
    dram_ns = best_dram * f32_reciprocal(DRAM.bandwidth_bytes_per_cycle
                                         * dram_eff)
    # the reference writes smem_bytes / 42.0; its XLA computes it as this
    # product with the f32 reciprocal, and so does the port on every device
    smem_ns = pre["smem_bytes"] * f32_reciprocal(
        SMEM.bandwidth_bytes_per_cycle)
    time_ns = torch.maximum(pre["compute_ns"],
                            torch.maximum(dram_ns, smem_ns))
    inf = float("inf")
    return {
        "valid": valid,
        "energy_pj": torch.where(valid, best_energy, inf),
        "time_ns": torch.where(valid, time_ns, inf),
        "tops_per_w": torch.where(valid, ops / best_energy, 0.0),
        "gflops": torch.where(valid, ops / time_ns, 0.0),
        "utilization": torch.where(valid, pre["utilization"], 0.0),
        "compute_ns": pre["compute_ns"],
        "dram_ns": dram_ns,
        "smem_ns": smem_ns,
        "dram_bytes": best_dram,
        "smem_bytes": pre["smem_bytes"],
    }


def evaluate_flat(batch: dict, dram_eff: float = DRAM_STREAM_EFFICIENCY,
                  order_mode: str = "exact") -> dict:
    """Evaluate B flattened (GEMM, config, mapping) rows at once.

    batch: dict of (B,) tensors for every name in FLAT_FIELDS, on one
    device (rows may mix GEMMs, primitives and CiM levels).  Returns a
    dict of (B,) tensors on that device: valid (bool), energy_pj,
    time_ns, tops_per_w, gflops, utilization, compute_ns, dram_ns,
    smem_ns, dram_bytes, smem_bytes.  Invalid rows get inf energy/time
    and zero rate metrics."""
    check_order_mode(order_mode)
    pre = cim_row_terms(cim_cast(batch))
    best_energy, best_dram = cim_best_order(pre, order_mode)
    return cim_outputs(pre, best_energy, best_dram, dram_eff)


def evaluate_batch(gemm: GEMM, cfg: CiMSystemConfig, mappings: dict,
                   dram_eff: float = DRAM_STREAM_EFFICIENCY,
                   device="cuda") -> dict:
    """Evaluate B candidate mappings of one GEMM on one config at once.

    mappings: dict of (B,) arrays or tensors for MAP_FIELDS; they and the
    broadcast GEMM/config columns go to `device`."""
    batch = {f: torch.as_tensor(mappings[f]).to(device, torch.float32)
             for f in MAP_FIELDS}
    b = batch["k_arr"].shape[0]
    consts = {"M": gemm.M, "N": gemm.N, "K": gemm.K,
              **precision_row(gemm), **config_row(cfg)}
    for name, v in consts.items():
        batch[name] = torch.full((b,), float(v), dtype=torch.float32,
                                 device=device)
    return evaluate_flat(batch, dram_eff)


# --- tensor-core baseline ---------------------------------------------------


def evaluate_baseline_flat(batch: dict,
                           spec: TensorCoreSpec = TENSOR_CORE) -> dict:
    """Score B flattened (GEMM, tile, super-tile) baseline rows at once.

    batch: dict of (B,) tensors for BASE_FLAT_FIELDS.  All 36 (RF x DRAM)
    loop-order pairs are scored and the lexicographic (time_ns,
    energy_pj) min is kept, as baseline.evaluate_baseline does.  Rows
    violating the RF/SMEM capacity checks get inf time/energy.

    The reference's XLA contracts some a*b+c here into fused
    multiply-adds, which eager torch never does, so the raw numbers agree
    with it to f32 rounding and the verdicts exactly
    (tests/test_torch_vectorized.py)."""
    f32 = torch.float32
    M, N, K, mt, nt, kt, ms, ns, ks = (
        torch.as_tensor(batch[f]).to(f32) for f in
        ("M", "N", "K", "mt", "nt", "kt", "ms", "ns", "ks"))

    mtc = torch.minimum(M, mt)
    ntc = torch.minimum(N, nt)
    ktc = torch.minimum(K, kt)
    sm_m = torch.minimum(M, mt * ms)
    sm_n = torch.minimum(N, nt * ns)
    sm_k = torch.minimum(K, kt * ks)
    macs = M * N * K
    ops = 2.0 * macs
    out_elems = M * N

    # --- validity (BaselineMapping.validate) ---
    rf_bytes = mt * kt + kt * nt + mt * nt * PSUM_BYTES
    smem_foot = sm_m * sm_k + sm_k * sm_n + sm_m * sm_n * PSUM_BYTES
    valid = ((rf_bytes <= RF.capacity_bytes)
             & (smem_foot <= SMEM.capacity_bytes))

    # --- order-independent energy terms ---
    k_rf_trips = torch.ceil(K / ktc)
    rf_reads = 2.0 * macs
    z_rf_rmw = 2.0 * out_elems * k_rf_trips * PSUM_BYTES
    e_rf = _accesses(rf_reads + z_rf_rmw, RF) * RF.access_energy_pj
    e_pe = 2.0 * macs * spec.pe_buffer_energy_pj
    e_mac = macs * spec.mac_energy_pj
    adds = out_elems * _max0(k_rf_trips - 1.0)
    e_red = adds * TEMPORAL_REDUCTION_PJ

    eff_m = mtc / (torch.ceil(mtc / SPATIAL_M) * SPATIAL_M)
    eff_n = ntc / (torch.ceil(ntc / SPATIAL_N) * SPATIAL_N)
    util = eff_m * eff_n
    floor = torch.full((), 1e-9, dtype=f32, device=util.device)
    compute_ns = (macs / (spec.macs_per_cycle * torch.maximum(util, floor))
                  * f32_reciprocal(spec.freq_ghz))

    rf_trips = {"M": ms, "K": ks, "N": ns}
    dram_trips = {"M": torch.ceil(M / (mt * ms)),
                  "K": torch.ceil(K / (kt * ks)),
                  "N": torch.ceil(N / (nt * ns))}
    cz_smem = _coverage_vec(dram_trips, "Z")
    czr_rf = cz_smem * _coverage_vec(rf_trips, "Z")
    inv_dram = f32_reciprocal(DRAM.bandwidth_bytes_per_cycle)
    inv_smem = f32_reciprocal(SMEM.bandwidth_bytes_per_cycle)

    best = None
    for rf_perm in _ORDERS:
        rf_pairs = [(d, rf_trips[d]) for d in rf_perm]
        for dram_perm in _ORDERS:
            dram_pairs = [(d, dram_trips[d]) for d in dram_perm]
            above_rf = rf_pairs + dram_pairs

            a_fills = torch.maximum(
                sm_m * sm_k * _revisit_seq(dram_pairs, "A"), M * K)
            w_fills = torch.maximum(
                sm_k * sm_n * _revisit_seq(dram_pairs, "W"), K * N)
            rz = _revisit_seq(dram_pairs, "Z")
            z_spill = sm_m * sm_n * _max0(rz - cz_smem)
            z_dram = sm_m * sm_n * cz_smem + 2.0 * z_spill * PSUM_BYTES
            dram_bytes = a_fills + w_fills + torch.maximum(z_dram, out_elems)
            e_dram = _accesses(dram_bytes, DRAM) * DRAM.access_energy_pj

            a_rf = torch.maximum(mtc * ktc * _revisit_seq(above_rf, "A"),
                                 M * K)
            w_rf = torch.maximum(ktc * ntc * _revisit_seq(above_rf, "W"),
                                 K * N)
            rzr = _revisit_seq(above_rf, "Z")
            z_rf = (mtc * ntc * czr_rf
                    + 2.0 * mtc * ntc * _max0(rzr - czr_rf) * PSUM_BYTES)
            smem_bytes = a_rf + w_rf + z_rf
            e_smem = _accesses(smem_bytes, SMEM) * SMEM.access_energy_pj

            energy = e_dram + e_smem + e_rf + e_pe + e_mac + e_red
            dram_ns = dram_bytes * inv_dram
            smem_ns = smem_bytes * inv_smem
            time_ns = torch.maximum(compute_ns,
                                    torch.maximum(dram_ns, smem_ns))
            cand = {"time_ns": time_ns, "energy_pj": energy,
                    "dram_bytes": dram_bytes, "smem_bytes": smem_bytes,
                    "dram_ns": dram_ns, "smem_ns": smem_ns}
            if best is None:
                best = cand
            else:
                better = ((time_ns < best["time_ns"])
                          | ((time_ns == best["time_ns"])
                             & (energy < best["energy_pj"])))
                best = {k: torch.where(better, cand[k], best[k])
                        for k in cand}

    inf = float("inf")
    return {
        "valid": valid,
        "energy_pj": torch.where(valid, best["energy_pj"], inf),
        "time_ns": torch.where(valid, best["time_ns"], inf),
        "tops_per_w": torch.where(valid, ops / best["energy_pj"], 0.0),
        "gflops": torch.where(valid, ops / best["time_ns"], 0.0),
        "utilization": torch.where(valid, util, 0.0),
        "compute_ns": compute_ns,
        "dram_ns": best["dram_ns"],
        "smem_ns": best["smem_ns"],
        "dram_bytes": best["dram_bytes"],
        "smem_bytes": best["smem_bytes"],
    }


def enumerate_baseline_space(gemm: GEMM) -> dict:
    """The tile grid baseline.evaluate_baseline searches, as host (numpy)
    columns in the same enumeration order, so tie-breaks resolve
    identically."""
    grid = list(tile_candidates(gemm))
    arr = np.asarray(grid, np.float32)
    out = {n: arr[:, i] for i, n in enumerate(BASE_TILE_FIELDS)}
    b = arr.shape[0]
    for name, v in (("M", gemm.M), ("N", gemm.N), ("K", gemm.K)):
        out[name] = np.full((b,), float(v), np.float32)
    return out


# --- exhaustive mapping-space search ---------------------------------------


def enumerate_space(gemm: GEMM, cfg: CiMSystemConfig,
                    max_points: int = 200_000, device="cuda") -> dict:
    """Full power-of-two mapping space as (B,) int32 tensors on `device`
    (a seeded sample of `max_points` when larger, as the reference
    draws it)."""
    p = cfg.prim
    n_prims = cfg.resolved_n_prims()

    def pow2s(limit):
        out, v = [], 1
        while v <= limit:
            out.append(v)
            v *= 2
        return out

    ks = pow2s(min(gemm.K, p.k_rows))
    ns = pow2s(min(gemm.N, p.n_cols))
    ps = list(range(1, n_prims + 1))
    ms = pow2s(gemm.M)
    fs = pow2s(4096)
    grid = list(itertools.product(ks, ns, ps, ps, ms, fs, fs))
    if len(grid) > max_points:
        rng = np.random.default_rng(0)
        idx = rng.choice(len(grid), max_points, replace=False)
        grid = [grid[i] for i in idx]
    arr = np.asarray(grid, np.int32)
    return {n: torch.as_tensor(arr[:, i]).to(device)
            for i, n in enumerate(MAP_FIELDS)}


def exhaustive_best(gemm: GEMM, cfg: CiMSystemConfig,
                    objective: str = "energy_pj", device="cuda"):
    """Enumerate + evaluate the whole space on `device`; returns the best
    metrics dict (scalars), the winning mapping and the space size."""
    space = enumerate_space(gemm, cfg, device=device)
    out = evaluate_batch(gemm, cfg, space, device=device)
    i = int(torch.argmin(out[objective]))
    best = {k: float(v[i]) for k, v in out.items()}
    best_map = {k: int(v[i]) for k, v in space.items()}
    return best, best_map, int(space["m1"].shape[0])
