// Planner sweep row evaluator for Hopper (sm_90a): the CiM cost spec of
// src/repro_torch/core/vectorized.py, one thread per row.
//
// Replaces the TPU kernel src/repro/kernels/sweep_eval.py:_sweep_kernel
// (the planner's backend="pallas" row evaluator).  Input is the (24, B) f32
// field-major matrix of FLAT_FIELDS, output the (11, B) f32 matrix of
// SWEEP_OUT_FIELDS (valid as 0/1).  Per row: the order-independent terms,
// all 6 DRAM loop orders unrolled, the exact (first minimum energy, strict
// <) or greedy (smallest factor outermost) order, and the 11 outputs.
//
// Bound on an H100 SXM: a row reads 24 f32 and writes 11 f32, 140 bytes,
// for a few hundred f32 operations, so 4M rows move 587 MB (175 us at
// 3.35 TB/s) against ~30 us of f32 issue: the kernel is bound by bytes.
// The design therefore only makes the bytes cheap to move: fields are
// rows of the matrix, so a warp's 32 loads of one field are one coalesced
// 128-byte transaction; every intermediate stays in registers; the tail is
// masked, so nothing is padded.  The TPU kernel kept a (24, block) tile in
// VMEM per grid step; here a block of 256 threads takes 256 rows and the
// blocks run in any order, since rows are independent.
//
// Bits: the result must equal the plain torch version (and the JAX
// reference) bit for bit, so
//   * the build passes --fmad=false (no a*b+c contraction) and never
//     -use_fast_math (IEEE division, no flush to zero);
//   * every expression keeps the spec's left-to-right operation order;
//   * max/min propagate NaN like torch.maximum/minimum (fmaxf/fminf drop it);
//   * dram_ns and smem_ns multiply by the f32 reciprocals the wrapper passes
//     (the spec's rule for constant divisors);
//   * 2^(bits-8) is built exactly with ldexpf, not exp2f;
//   * flags are "!= 0", as a cast to bool is;
//   * a literal the spec takes from a Python float is written (float)x, the
//     double rounded to f32 as torch rounds the Python scalar.
#include <cuda_runtime.h>
#include <math.h>

// The cost model's memory constants, filled by the wrapper from
// core/memory.py and core/mapping.py so there is one source of them.  It
// is the by-value argument of the C entry point, so it has external
// linkage (outside the unnamed namespace).
struct SweepConsts {
  float psum_bytes;       // mapping.PSUM_BYTES
  float smem_capacity;    // SMEM.capacity_bytes
  float rf_gran, smem_gran, dram_gran;            // access granularities
  float rf_energy, smem_energy, dram_energy;      // pJ per access
  float reduction_pj;     // memory.TEMPORAL_REDUCTION_PJ
  float inv_dram_bw;      // f32(1 / (DRAM bandwidth * dram_eff))
  float inv_smem_bw;      // f32(1 / SMEM bandwidth)
};

namespace {

constexpr int THREADS = 256;

// torch.maximum / torch.minimum: a NaN operand is returned as it is.
__device__ __forceinline__ float vmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// 2^trunc(e), exponent clamped to f32's normal range; NaN stays NaN
// (vectorized.pow2_exact).
__device__ __forceinline__ float pow2_exact(float e) {
  if (e != e) return e;
  const float c = fminf(fmaxf(e, -126.0f), 127.0f);
  return ldexpf(1.0f, (int)c);
}

// Dims are indexed M = 0, K = 1, N = 2 (loopnest.CANONICAL_DIMS); a
// tensor's relevance is a bit mask over them.
constexpr int REL_A = (1 << 0) | (1 << 1);   // M, K
constexpr int REL_W = (1 << 1) | (1 << 2);   // K, N
constexpr int REL_Z = (1 << 0) | (1 << 2);   // M, N

// loopnest.revisit_factor over one innermost-first order: loops with trip
// count <= 1 are skipped, irrelevant loops inside the first relevant one
// multiply.
template <int D0, int D1, int D2>
__device__ __forceinline__ float revisit(const float* trips, int rel) {
  const int order[3] = {D0, D1, D2};
  float r = 1.0f;
  bool seen = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = trips[order[i]];
    const bool active = t > 1.0f;
    const bool is_rel = (rel >> order[i]) & 1;
    const bool keep = is_rel ? active : (seen && active);
    r = r * (keep ? t : 1.0f);
    if (is_rel) seen = seen || active;
  }
  return r;
}

// loopnest.greedy_order's stable descending sort: does dim a precede b?
__device__ __forceinline__ bool precedes(const float* trips, int a, int b) {
  return a < b ? trips[a] >= trips[b] : trips[a] > trips[b];
}

struct RowTerms {
  float trips[3];
  float w_foot, a_block, z_tile, cz;
  float weight_elems, input_elems, output_elems;
  float a_smem_lvl, z_smem_lvl, host_gran, host_energy;
  float e_smem, e_mac, e_red;
  bool at_rf;
};

// vectorized.cim_order_cost + one step of cim_best_order for one order.
template <bool GREEDY, int D0, int D1, int D2>
__device__ __forceinline__ void order_step(const RowTerms& t,
                                           const SweepConsts& c,
                                           float& best_energy,
                                           float& best_dram) {
  const float w_fills =
      vmax(t.w_foot * revisit<D0, D1, D2>(t.trips, REL_W), t.weight_elems);
  const float a_rf_fills =
      vmax(t.a_block * revisit<D0, D1, D2>(t.trips, REL_A), t.input_elems);
  const float rz = revisit<D0, D1, D2>(t.trips, REL_Z);
  const float spills = t.z_tile * vmax(0.0f, rz - t.cz);
  const float z_rf_bytes =
      vmax(t.z_tile * t.cz + 2.0f * spills * c.psum_bytes, t.output_elems);
  const float a_fills = t.at_rf ? a_rf_fills : t.a_smem_lvl;
  const float z_bytes = t.at_rf ? z_rf_bytes : t.z_smem_lvl;
  const float dram_bytes = w_fills + a_fills + z_bytes;
  const float e_dram = (ceilf(w_fills / c.dram_gran)
                        + ceilf(a_fills / c.dram_gran)
                        + ceilf(z_bytes / c.dram_gran)) * c.dram_energy;
  const float e_w_write = ceilf(w_fills / t.host_gran) * t.host_energy;
  const float energy = e_dram + e_w_write + t.e_smem + t.e_mac + t.e_red;
  const bool keep = GREEDY ? (precedes(t.trips, D0, D1)
                              && precedes(t.trips, D1, D2))
                           : (energy < best_energy);
  if (keep) {
    best_energy = energy;
    best_dram = dram_bytes;
  }
}

template <bool GREEDY>
__global__ void __launch_bounds__(THREADS)
sweep_eval_kernel(const float* __restrict__ in, float* __restrict__ out,
                  long long B, SweepConsts c) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const float* p = in + i;
  // FLAT_FIELDS order
  const float M = p[0 * B], N = p[1 * B], K = p[2 * B], bits = p[3 * B];
  const bool is_fp = p[4 * B] != 0.0f;
  const float k_arr = p[5 * B], n_arr = p[6 * B], pk = p[7 * B],
              pn = p[8 * B], m1 = p[9 * B], fk = p[10 * B], fn = p[11 * B];
  const float n_prims = p[12 * B];
  const bool at_rf = p[13 * B] != 0.0f, serialize = p[14 * B] != 0.0f;
  const float k_rows = p[15 * B], n_cols = p[16 * B], Rp = p[17 * B],
              Cp = p[18 * B], mac_units = p[19 * B], latency_ns = p[20 * B],
              mac_energy_pj = p[21 * B], prim_capacity = p[22 * B];
  const bool is_analog = p[23 * B] != 0.0f;

  // --- cim_row_terms ---
  const float k0 = vmin(k_arr * pk, K);
  const float n0 = vmin(n_arr * pn, N);
  const float k_tiles = ceilf(K / k0);
  const float n_tiles = ceilf(N / n0);
  const float m2 = ceilf(M / m1);
  const float k2 = ceilf(k_tiles / fk);
  const float n2 = ceilf(n_tiles / fn);
  const float waves = M * k_tiles * n_tiles;
  const float macs = M * N * K;
  const float ops = 2.0f * macs;

  RowTerms t;
  t.input_elems = M * K;
  t.weight_elems = K * N;
  t.output_elems = M * N;
  t.a_block = m1 * vmin(K, k0 * fk);
  const float z_block = m1 * vmin(N, n0 * fn) * c.psum_bytes;
  const bool fits_buffer = t.a_block + z_block <= c.smem_capacity;
  const bool valid = (k_arr >= 1.0f) & (k_arr <= k_rows) & (n_arr >= 1.0f)
                     & (n_arr <= n_cols) & (pk * pn <= n_prims)
                     & (k_arr * n_arr <= prim_capacity) & (m1 >= 1.0f)
                     & (fk >= 1.0f) & (fn >= 1.0f) & (!at_rf | fits_buffer);

  // cim_precision_factors
  const float r = bits / 8.0f;
  const float pow2 = pow2_exact(bits - 8.0f);
  const float energy_int =
      is_analog ? (float)0.4 * r + (float)0.6 * pow2 : r * r;
  const float latency_int = is_analog ? 0.5f + 0.5f * r : r;
  const float colpar_int = is_analog ? 8.0f / bits : 1.0f;
  const float energy_x =
      is_fp ? (is_analog ? (float)1.3 : (float)1.2) : energy_int;
  const float latency_x = is_fp ? (is_analog ? 1.5f : 1.25f) : latency_int;
  const float colpar_x = is_fp ? (is_analog ? 0.5f : 1.0f) : colpar_int;

  const float row_steps = ceilf(k_arr / Rp);
  const float col_steps = ceilf(n_arr / (Cp * colpar_x));
  const float serial = (serialize && at_rf) ? pk * pn : 1.0f;
  const float compute_ns =
      waves * row_steps * col_steps * serial * latency_ns * latency_x;

  const float a_smem_reads = at_rf ? waves * k0 : 0.0f;
  const float z_smem_rmw = at_rf ? 2.0f * waves * n0 * c.psum_bytes : 0.0f;
  const float smem_bytes = a_smem_reads + z_smem_rmw;
  t.e_smem = (ceilf(a_smem_reads / c.smem_gran)
              + ceilf(z_smem_rmw / c.smem_gran)) * c.smem_energy;
  t.e_mac = macs * mac_energy_pj * energy_x;
  const float adds = t.output_elems * vmax(0.0f, k_tiles * row_steps - 1.0f);
  t.e_red = adds * c.reduction_pj;
  t.a_smem_lvl = waves * k0;
  t.z_smem_lvl = t.output_elems + 2.0f * t.output_elems
                 * vmax(0.0f, k_tiles - 1.0f) * c.psum_bytes;
  t.host_gran = at_rf ? c.rf_gran : c.smem_gran;
  t.host_energy = at_rf ? c.rf_energy : c.smem_energy;
  t.at_rf = at_rf;
  t.trips[0] = m2;
  t.trips[1] = k2;
  t.trips[2] = n2;
  const float util = vmin(K, k0) * vmin(N, n0) / (n_prims * mac_units);
  t.w_foot = vmin(K, k0 * fk) * vmin(N, n0 * fn);
  t.z_tile = m1 * vmin(N, n0 * fn);
  t.cz = 1.0f * m2 * n2;   // coverage of Z: its relevant trips M, N

  // --- cim_best_order: itertools.permutations("MKN"), innermost first ---
  float best_energy = INFINITY, best_dram = 0.0f;
  order_step<GREEDY, 0, 1, 2>(t, c, best_energy, best_dram);   // M K N
  order_step<GREEDY, 0, 2, 1>(t, c, best_energy, best_dram);   // M N K
  order_step<GREEDY, 1, 0, 2>(t, c, best_energy, best_dram);   // K M N
  order_step<GREEDY, 1, 2, 0>(t, c, best_energy, best_dram);   // K N M
  order_step<GREEDY, 2, 0, 1>(t, c, best_energy, best_dram);   // N M K
  order_step<GREEDY, 2, 1, 0>(t, c, best_energy, best_dram);   // N K M

  // --- cim_outputs, SWEEP_OUT_FIELDS order ---
  const float dram_ns = best_dram * c.inv_dram_bw;
  const float smem_ns = smem_bytes * c.inv_smem_bw;
  const float time_ns = vmax(compute_ns, vmax(dram_ns, smem_ns));
  float* q = out + i;
  q[0 * B] = valid ? 1.0f : 0.0f;
  q[1 * B] = valid ? best_energy : INFINITY;
  q[2 * B] = valid ? time_ns : INFINITY;
  q[3 * B] = valid ? ops / best_energy : 0.0f;
  q[4 * B] = valid ? ops / time_ns : 0.0f;
  q[5 * B] = valid ? util : 0.0f;
  q[6 * B] = compute_ns;
  q[7 * B] = dram_ns;
  q[8 * B] = smem_ns;
  q[9 * B] = best_dram;
  q[10 * B] = smem_bytes;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  in: (24, B) f32, contiguous;
// out: (11, B) f32, contiguous; greedy selects the order rule.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sweep_eval_launch(const float* in, float* out, long long B,
                                 int greedy, SweepConsts consts,
                                 void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (B + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (greedy)
    sweep_eval_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(in, out, B,
                                                                 consts);
  else
    sweep_eval_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(in, out, B,
                                                                  consts);
  return (int)cudaGetLastError();
}
