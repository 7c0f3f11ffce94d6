// Blocked online-softmax attention for Hopper (sm_90a), causal with
// seq_offset = sk - sq and an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel (:21,
// the Pallas kernel behind `attend(impl="pallas")` in the prefill forward).
// It keeps that kernel's folded contract: q is (bh, sq, d), k and v are
// (bh_kv, sk, d) with bh = rep * bh_kv, and query row i reads kv row
// i / rep -- the GQA heads of one kv head are consecutive rows, so the
// wrapper never materialises the repeat.  Scores are scaled by 1/sqrt(d),
// masked with NEG = -1e30 (never -inf: a row whose first tiles are all
// masked gets p = exp(0) there, and the later correction exp(-1e30 - m)
// wipes it out), and accumulated in f32; the output has q's dtype.
//
// Bound on an H100 SXM: at qwen2-7b's prefill (1 x 2048 tokens, 28 query
// and 4 kv heads, d = 128, bf16) one call does ~30 GFLOP of causal work
// (QK^T and PV, 4 * d operations per unmasked (query, key) pair) on 34 MB of
// inputs and output: ~295x more operations per byte than the card's ridge,
// so the bf16 tensor cores (989 TFLOP/s) bound it at ~30 us.  Only wgmma
// reaches that rate, and only if the tensor cores never wait for a tile.
//
// bf16 design -- TMA + wgmma, warp-specialised:
//  * one block of 384 threads owns 128 query rows of one (batch, head): two
//    consumer warpgroups of 64 rows each and a producer warpgroup, which
//    hands its registers to the consumers (setmaxnreg: 24 and 240 a thread,
//    so S, O and P fit without spills).  Blocks are issued heaviest first:
//    the last query tile of every head, then the one before, so a wave
//    holds like-sized blocks and the tail is short;
//  * the producer's one thread loads the Q tile once and streams 128-key
//    tiles of K and V through a 2-stage ring by TMA (64-column boxes,
//    128-byte swizzle), each stage with its own `full` and `empty` mbarrier
//    for K and for V, so QK^T starts before V has landed.  The tensor maps
//    are 3-D (d, rows, heads): rows past sq or sk and columns past d read as
//    zeros, never another head's rows, and d = 16 / 32 / 64 share d = 64's
//    tile (zero columns add nothing);
//  * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//    memory.  The online softmax runs on the S accumulators in registers:
//    one multiply by scale * log2(e), then the masks (so masked scores are
//    exactly NEG and keys past sk exactly -inf, as before), the row max
//    across the four lanes that share a row, and ex2;
//  * p is rounded to bf16 in registers (as the JAX package's `flash_jnp`
//    does; l sums the f32 p) and is wgmma's register A operand for
//    O += P V: the C fragment of m64nNk16 is the A fragment of the next
//    product.  V is the B operand straight from its TMA tile, MN-major
//    (read with the transpose bit: SBO = 1024 between 8-key groups, LBO
//    between 64-column chunks), so nothing is transposed by hand;
//  * the tensor cores are kept busy two ways: a warpgroup issues QK^T of
//    tile j + 1 and PV of tile j together and runs the softmax of j + 1
//    while PV still runs, and the two warpgroups take turns to issue
//    (named barriers), so one's products overlap the other's softmax;
//  * only tiles on the diagonal, at the window's edge or past sk are
//    masked element by element.  Tiles wholly above the diagonal, or
//    wholly before the window, are skipped when every row of the block has
//    a visible key: the TPU kernel visits them, and there they contribute
//    exactly 0.
// f32 inputs take a plain FMA kernel with the same recurrence (no TF32);
// it is off the prefill path, which computes in bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;
constexpr int WARP = 32;

// The key tiles [j_lo, j_hi) a block of query rows [q0, q_end) must visit.
// Skipping is exact only when every row has a visible key (its own
// position, pos_q >= 0); otherwise the block visits every tile, as the TPU
// kernel does, so a row masked everywhere averages v over all sk keys.
__device__ __forceinline__ void tile_range(int q0, int q_end, int sq, int sk,
                                           int causal, int window, int bkv,
                                           int* j_lo, int* j_hi) {
  const int off = sk - sq;
  int lo = 0, hi = sk;
  if (q0 + off >= 0) {
    if (causal) hi = min(sk, q_end + off);     // past the last row's key
    if (window > 0) lo = max(0, q0 + off - window + 1);
  }
  *j_lo = lo / bkv;
  *j_hi = (hi + bkv - 1) / bkv;
}

// Score of (query position pq, key) after masking: -inf past sk, NEG where
// the causal or window mask hides the key, else the scaled dot product.
__device__ __forceinline__ float masked(float s, int pq, int key, int sk,
                                        int causal, int window) {
  if (key >= sk) return -INFINITY;
  if ((causal && pq < key) || (window > 0 && pq - key >= window)) return NEG;
  return s;
}

// --- bf16: TMA + wgmma -------------------------------------------------------

constexpr int BQ = 128;                  // query rows per block
constexpr int BKV = 128;                 // keys per tile
constexpr int STAGES = 2;                // K and V tiles in flight
constexpr int THREADS = 384;             // 2 consumer warpgroups + a producer
constexpr int PRODUCER_REGS = 24;        // registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 240;       // 128 x 24 + 256 x 240 <= 65536
constexpr int ROW = 128;                 // bytes of a 64-column chunk row

// Shared memory of a block, for head widths padded to DP (64 or 128)
// columns: each tile is DP / 64 chunks of rows x 128 bytes, in 1024-byte
// swizzle atoms of 8 rows.
template <int DP>
struct Layout {
  static constexpr int NCH = DP / 64;
  static constexpr int Q_BYTES = NCH * BQ * ROW;
  static constexpr int KV_BYTES = NCH * BKV * ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  // mbarriers: Q full; per stage K full, V full, K empty, V empty
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 4 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;               // for alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) = D * (accumulate != 0) + A (64 x 16, K-major, shared)
// * B (16 x 128, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// MN-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// S (64 x BKV, f32, in sc) = Q K^T for one consumer warpgroup: qa is its
// 64 Q rows, ka the K tile (both 128-byte-swizzled chunks of 64 columns);
// issued and committed, not waited for.
template <int KSTEPS>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], uint32_t qa,
                                         uint32_t ka) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint32_t at = (ks / 4) * BQ * ROW + (ks % 4) * 32;
    const uint32_t bt = (ks / 4) * BKV * ROW + (ks % 4) * 32;
    wgmma_ss_n128(sc, gmma_desc(qa + at, 16, 1024),
                  gmma_desc(ka + bt, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// What a thread's two rows need for masking: their positions, its lane in
// the quad, the block's first row position and the call's mask arguments.
struct Rows {
  int pq0, pq1, tq, first, sk, causal, window;
  float sl2;                             // scale * log2(e)
};

// The online softmax of the key tile at kv0 on its scores in sc: element
// 4 * jn + 2 * h + e is (row pq0 + 8 * h, key kv0 + 8 * jn + 2 * tq + e).
// Leaves p (f32) in sc and the row corrections in c0, c1; updates m and l.
__device__ __forceinline__ void online_softmax(float (&sc)[BKV / 2], int kv0,
                                               const Rows& r, float& m0,
                                               float& m1, float& l0,
                                               float& l1, float& c0,
                                               float& c1) {
  const bool edge = kv0 + BKV > r.sk
      || (r.causal && kv0 + BKV - 1 > r.first)
      || (r.window > 0 && r.first + BQ - 1 - kv0 >= r.window);
  if (edge) {
#pragma unroll
    for (int jn = 0; jn < BKV / 8; ++jn) {
      const int key = kv0 + jn * 8 + 2 * r.tq;
      sc[4 * jn + 0] = masked(sc[4 * jn + 0] * r.sl2, r.pq0, key, r.sk,
                              r.causal, r.window);
      sc[4 * jn + 1] = masked(sc[4 * jn + 1] * r.sl2, r.pq0, key + 1, r.sk,
                              r.causal, r.window);
      sc[4 * jn + 2] = masked(sc[4 * jn + 2] * r.sl2, r.pq1, key, r.sk,
                              r.causal, r.window);
      sc[4 * jn + 3] = masked(sc[4 * jn + 3] * r.sl2, r.pq1, key + 1, r.sk,
                              r.causal, r.window);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] *= r.sl2;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int jn = 0; jn < BKV / 8; ++jn) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * jn + 0], sc[4 * jn + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
  }
  // the four lanes of a quad hold one row's scores between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  c0 = ex2(m0 - mx0);
  c1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int jn = 0; jn < BKV / 8; ++jn) {
    sc[4 * jn + 0] = ex2(sc[4 * jn + 0] - m0);
    sc[4 * jn + 1] = ex2(sc[4 * jn + 1] - m0);
    sc[4 * jn + 2] = ex2(sc[4 * jn + 2] - m1);
    sc[4 * jn + 3] = ex2(sc[4 * jn + 3] - m1);
    s0 += sc[4 * jn + 0] + sc[4 * jn + 1];
    s1 += sc[4 * jn + 2] + sc[4 * jn + 3];
  }
  l0 = l0 * c0 + s0;
  l1 = l1 * c1 + s1;
}

// O *= the row corrections of the tile whose p is in sc, and p as bf16
// A fragments: the C layout of two 8-key column groups is the A layout of
// one 16-key step.
template <int DP>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[DP / 2],
                                                 const float (&sc)[BKV / 2],
                                                 float c0, float c1,
                                                 uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    acc[4 * i + 0] *= c0;
    acc[4 * i + 1] *= c0;
    acc[4 * i + 2] *= c1;
    acc[4 * i + 3] *= c1;
  }
#pragma unroll
  for (int jn = 0; jn < BKV / 8; ++jn) {
    pa[jn / 2][(jn % 2) * 2 + 0] = pack_bf16(sc[4 * jn + 0], sc[4 * jn + 1]);
    pa[jn / 2][(jn % 2) * 2 + 1] = pack_bf16(sc[4 * jn + 2], sc[4 * jn + 3]);
  }
}

// O += P V for one consumer warpgroup, V the tile at va (MN-major, read
// with the transpose bit); issued and committed, not waited for.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_pv<DP>(acc, pa[kk], gmma_desc(va + kk * 16 * ROW, BKV * ROW, 1024));
  wgmma_commit();
}

// The consumer warpgroups' turns on the tensor cores: warpgroup cw waits
// on named barrier 1 + cw for the other's arrival, and arrives on the
// other's when it has issued its products.
__device__ __forceinline__ void take_turn(int cw) {
  if (cw == 0) named_sync<1, 256>();
  else named_sync<2, 256>();
}

__device__ __forceinline__ void pass_turn(int cw) {
  if (cw == 0) named_arrive<2, 256>();
  else named_arrive<1, 256>();
}

// Block b serves head b % bh and query tile n_qt - 1 - b / bh.  Threads
// 0-255 are the consumer warpgroups (warpgroup cw owns rows 64 * cw .. +63
// of the tile); thread 256 is the producer.
template <int D, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int bh, int sq, int sk,
                   int rep, int causal, int window, float scale) {
  using L = Layout<DP>;
  constexpr int KSTEPS = D / 16;         // k-steps of QK^T (padding skipped)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;          // swizzle atoms
  const uint32_t qfull = base + L::BAR_OFF;
  const uint32_t kfull0 = qfull + 8, vfull0 = kfull0 + 8 * STAGES;
  const uint32_t kempty0 = vfull0 + 8 * STAGES;
  const uint32_t vempty0 = kempty0 + 8 * STAGES;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int head = (int)(blockIdx.x % (unsigned)bh);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (unsigned)bh)) * BQ;
  const int off = sk - sq;
  int j_lo, j_hi;
  tile_range(q0, min(q0 + BQ, sq), sq, sk, causal, window, BKV, &j_lo, &j_hi);

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(kempty0 + 8 * s, 2);         // one arrive per consumer WG
      mbar_init(vempty0 + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int kvh = head / rep;
      mbar_expect_tx(qfull, L::Q_BYTES);
      for (int c = 0; c < L::NCH; ++c)
        tma_load_3d(base + L::Q_OFF + c * BQ * ROW, &qmap, qfull, 64 * c, q0,
                    head);
      for (int j = j_lo; j < j_hi; ++j) {
        const int it = j - j_lo, s = it % STAGES;
        const uint32_t prev = ((it / STAGES) - 1) & 1;
        const uint32_t k_at = base + L::K_OFF + s * L::KV_BYTES;
        const uint32_t v_at = base + L::V_OFF + s * L::KV_BYTES;
        if (it >= STAGES) mbar_wait(kempty0 + 8 * s, prev);
        mbar_expect_tx(kfull0 + 8 * s, L::KV_BYTES);
        for (int c = 0; c < L::NCH; ++c)
          tma_load_3d(k_at + c * BKV * ROW, &kmap, kfull0 + 8 * s, 64 * c,
                      j * BKV, kvh);
        if (it >= STAGES) mbar_wait(vempty0 + 8 * s, prev);
        mbar_expect_tx(vfull0 + 8 * s, L::KV_BYTES);
        for (int c = 0; c < L::NCH; ++c)
          tma_load_3d(v_at + c * BKV * ROW, &vmap, vfull0 + 8 * s, 64 * c,
                      j * BKV, kvh);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / WARP, lane = t % WARP;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;  // this
  const int pq0 = r0 + off, pq1 = r1 + off;                   // thread's rows
  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  const uint32_t qa = base + L::Q_OFF + cw * 64 * ROW;
  float acc[DP / 2], sc[BKV / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f, c0 = 1.0f, c1 = 1.0f;

  // Pipeline: while a warpgroup runs the softmax of tile j + 1, the
  // tensor cores run its O += P V of tile j (both issued together, QK^T
  // of j + 1 first, so waiting for one wgmma group leaves PV running).
  // The two warpgroups take turns to issue (named barriers 1 and 2), so
  // one's products run while the other's softmax does.
  const Rows rows{pq0, pq1, tq, q0 + off, sk, causal, window, sl2};
  const int n = j_hi - j_lo;
  uint32_t pa[BKV / 16][4];
  mbar_wait(qfull, 0);
  if (cw == 1) named_arrive<1, 256>();    // warpgroup 0 goes first
  mbar_wait(kfull0, 0);
  take_turn(cw);
  wgmma_fence();
  issue_qk<KSTEPS>(sc, qa, base + L::K_OFF);
  pass_turn(cw);
  wgmma_wait<0>();
  fence_regs(sc);
  if (t == 0) mbar_arrive(kempty0);
  online_softmax(sc, j_lo * BKV, rows, m0, m1, l0, l1, c0, c1);
  for (int it = 0; it + 1 < n; ++it) {
    const int s = it % STAGES, s1 = (it + 1) % STAGES;
    rescale_and_pack<DP>(acc, sc, c0, c1, pa);
    fence_regs(acc);
    fence_regs(pa);
    mbar_wait(kfull0 + 8 * s1, ((it + 1) / STAGES) & 1);
    mbar_wait(vfull0 + 8 * s, (it / STAGES) & 1);
    take_turn(cw);
    wgmma_fence();
    issue_qk<KSTEPS>(sc, qa, base + L::K_OFF + s1 * L::KV_BYTES);
    issue_pv<DP>(acc, pa, base + L::V_OFF + s * L::KV_BYTES);
    pass_turn(cw);
    wgmma_wait<1>();                     // QK^T of tile it + 1 is done
    fence_regs(sc);
    if (t == 0) mbar_arrive(kempty0 + 8 * s1);
    online_softmax(sc, (j_lo + it + 1) * BKV, rows, m0, m1, l0, l1, c0, c1);
    wgmma_wait<0>();                     // PV of tile it is done
    fence_regs(acc);
    fence_regs(pa);
    if (t == 0) mbar_arrive(vempty0 + 8 * s);
  }
  {                                      // PV of the last tile
    const int s = (n - 1) % STAGES;
    rescale_and_pack<DP>(acc, sc, c0, c1, pa);
    fence_regs(acc);
    fence_regs(pa);
    mbar_wait(vfull0 + 8 * s, ((n - 1) / STAGES) & 1);
    take_turn(cw);
    wgmma_fence();
    issue_pv<DP>(acc, pa, base + L::V_OFF + s * L::KV_BYTES);
    if (cw == 0) pass_turn(cw);          // warpgroup 1 passes no last turn
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (long long)head * sq * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = i * 8 + 2 * tq;
    if (c >= D) continue;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + c) =
          pack_bf16(acc[4 * i + 0] / d0, acc[4 * i + 1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + c) =
          pack_bf16(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int sk, int rep, int causal, int window, float scale,
                cudaStream_t s) {
  constexpr int DP = D < 64 ? 64 : D;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult r = encode_heads_bf16(&qm, fn, q, bh, sq, D, BQ);
  if (r == CUDA_SUCCESS)
    r = encode_heads_bf16(&km, fn, k, bh / rep, sk, D, BKV);
  if (r == CUDA_SUCCESS)
    r = encode_heads_bf16(&vm, fn, v, bh / rep, sk, D, BKV);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  constexpr int smem = Layout<DP>::ALLOC;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)flash_wgmma_kernel<D, DP>, smem,
                           &attr_set);
  if (e != 0) return e;
  const long long blocks = (long long)((sq + BQ - 1) / BQ) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<D, DP><<<(unsigned)blocks, THREADS, smem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), bh, sq, sk, rep, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// --- f32: FMA ----------------------------------------------------------------

constexpr int F_BQ = 32;                 // query rows per block
constexpr int F_BKV = 16;                // keys per tile
constexpr int F_LANES = 8;               // threads per query row
constexpr int F_THREADS = F_BQ * F_LANES;  // 256

// Thread (r, x) owns query row r: it scores keys x and x + 8 of each tile,
// runs the row's softmax with the row's other 7 lanes (one aligned group of
// 8 in a warp), and accumulates output columns x, x + 8, ...
template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int rep, int causal, int window, float scale) {
  constexpr int DP = D + 1;              // conflict-free row pitch
  constexpr int PP = F_BKV + 1;
  __shared__ float Qs[F_BQ * DP];
  __shared__ float Ks[F_BKV * DP];
  __shared__ float Vs[F_BKV * D];
  __shared__ float Ps[F_BQ * PP];

  const int n_qt = (sq + F_BQ - 1) / F_BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * F_BQ;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / F_LANES, x = threadIdx.x % F_LANES;
  const int pq = q0 + r + sk - sq;
  const float* qb = q + (long long)bh * sq * D;
  const float* kb = k + (long long)(bh / rep) * sk * D;
  const float* vb = v + (long long)(bh / rep) * sk * D;
  for (int i = threadIdx.x; i < F_BQ * D; i += F_THREADS) {
    const int row = i / D, c = i % D;
    Qs[row * DP + c] = q0 + row < sq ? qb[(long long)(q0 + row) * D + c] : 0.0f;
  }
  float acc[D / F_LANES];
#pragma unroll
  for (int jj = 0; jj < D / F_LANES; ++jj) acc[jj] = 0.0f;
  float m = NEG, l = 0.0f;

  int j_lo, j_hi;
  tile_range(q0, min(q0 + F_BQ, sq), sq, sk, causal, window, F_BKV, &j_lo,
             &j_hi);
  for (int j = j_lo; j < j_hi; ++j) {
    const int kv0 = j * F_BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < F_BKV * D; i += F_THREADS) {
      const int row = i / D, c = i % D;
      const bool in = kv0 + row < sk;
      const long long at = (long long)(kv0 + row) * D + c;
      Ks[row * DP + c] = in ? kb[at] : 0.0f;
      Vs[row * D + c] = in ? vb[at] : 0.0f;
    }
    __syncthreads();
    float s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kl = x + F_LANES * u;
      float dot = 0.0f;
#pragma unroll 8
      for (int e = 0; e < D; ++e)
        dot = fmaf(Qs[r * DP + e], Ks[kl * DP + e], dot);
      s[u] = masked(dot * scale, pq, kv0 + kl, sk, causal, window);
    }
    float mx = fmaxf(m, fmaxf(s[0], s[1]));
#pragma unroll
    for (int w = 1; w < F_LANES; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float corr = expf(m - mx);
    m = mx;
    const float p0 = expf(s[0] - m), p1 = expf(s[1] - m);
    float ps = p0 + p1;
#pragma unroll
    for (int w = 1; w < F_LANES; w <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, w);
    l = l * corr + ps;
    Ps[r * PP + x] = p0;
    Ps[r * PP + x + F_LANES] = p1;
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < D / F_LANES; ++jj) {
      const int c = x + F_LANES * jj;
      float a = acc[jj] * corr;
#pragma unroll
      for (int kk = 0; kk < F_BKV; ++kk)
        a = fmaf(Ps[r * PP + kk], Vs[kk * D + c], a);
      acc[jj] = a;
    }
  }
  if (q0 + r < sq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = o + (long long)bh * sq * D + (long long)(q0 + r) * D;
#pragma unroll
    for (int jj = 0; jj < D / F_LANES; ++jj)
      orow[x + F_LANES * jj] = acc[jj] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
           int bh, int sq, int sk, int rep, int causal, int window,
           float scale, cudaStream_t s) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, o, bh, sq, sk, rep, causal, window, scale,
                          s);
  const dim3 grid((sq + F_BQ - 1) / F_BQ, bh);
  flash_f32_kernel<D><<<grid, F_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, rep,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q, o: (bh, sq, d) contiguous;
// k, v: (bh / rep, sk, d) contiguous; all bf16 when is_bf16 else f32;
// d in {16, 32, 64, 128}; bf16 bases 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or 10000 + the
// CUresult when a TMA descriptor cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int bh, int sq, int sk, int d, int rep,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || rep < 1 || bh % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal,
                               window, scale, s);
    case 32: return launch<32>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal,
                               window, scale, s);
    case 64: return launch<64>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal,
                               window, scale, s);
    case 128: return launch<128>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal,
                                 window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
