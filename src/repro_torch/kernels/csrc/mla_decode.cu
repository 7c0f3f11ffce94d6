// Paged MLA decode for Hopper (sm_90a): the engine's latent attention step.
// Each slot's query heads attend over its cached latent rows, read in place
// from the layer's block pool through the slot's block table.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  The
// model (models/model.py: _mla_step) runs DeepSeek-V3's absorbed form, in
// which every query head attends over ONE row per position, W = 576
// columns: the 512-wide latent c and the 64-wide roped key.  The latent
// query q = [q_nope W_UK, q_pe] is 576 wide too.  The scores are q . row
// times `scale`, the softmax runs in f32, and the output is the weighted
// sum of each row's first 512 columns (the latent serves as V), 512 wide,
// which the model takes back through W_UV.  The plain version is
// kernels/mla_decode.py: paged_mla_decode_ref (models/attention.py:
// latent_attend over each slot's gathered strip).
//
// Bound on an H100 SXM: a position is one 1,152-byte row read once for
// all 16 heads, and 2 * 16 * (576 + 512) = 34,816 operations on it, ~30
// operations a byte: under the card's ~295, so HBM at 3.35 TB/s bounds it.
// At the engine cell (128 slots, ~200 positions each) a layer's call reads
// ~30 MB, ~9 us.  (The GQA paged kernel reads K and V per kv head at ~1
// operation a byte.)  What the design does about it:
//  * one block serves one slot (and one split of its positions): its 16
//    query heads are the 16 rows of the A operand of mma.sync m16n8k16, so
//    each row is read from HBM once, not once per head;
//  * a producer warp's lanes stream the split's 32-position tiles through
//    a 4-stage ring by TMA: each tile is 9 chunks of 64 columns x 32 rows
//    (128-byte swizzle, 36 KB a stage, 144 KB in flight on an SM), a chunk
//    arriving as boxes of one pool block's rows (box = gcd(bs, 32) >= 8),
//    each from the physical block the slot's table names
//    (hopper.cuh: encode_pool_bf16 with one 576-wide "head");
//  * four consumer warps: warp w scores positions 8w .. 8w + 7 of each
//    tile against all 16 heads (36 k-steps, q's fragments by ldmatrix from
//    a padded copy in shared memory, the rows' by ldmatrix from the
//    swizzled tile, conflict-free), the scores meet in shared memory, and
//    every warp takes the whole tile's softmax for all 16 heads (the same
//    f32 arithmetic in each, so the warps agree bit for bit) and then owns
//    128 of the 512 output columns in its PV product (the V fragments by
//    ldmatrix.trans from the same tile).  So no warp holds more than 64
//    accumulators a thread, and no merge of warps is needed at the end;
//  * p enters the PV product as a hi/lo pair of bf16 values (two MMAs),
//    as in the GQA decode kernel: ~16 bits of p, so the check holds p as
//    f32; the product is not the bound;
//  * a slot's positions [0, length) are valid; a split visits only its
//    part of them, so no tile past a slot's length is read.  With one
//    split per slot (the plan when the slots fill the SMs) the block
//    writes its output itself; with more, each split writes its partial
//    (acc, m, l) and a second kernel combines them in split order (no
//    atomics: two calls give equal bits).  A slot with no valid position
//    gets zeros.
// Nothing is read on the host and nothing synced: lengths and tables are
// read from device memory, so the call captures into a CUDA graph.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;
constexpr int LAT = 512;                 // latent columns, V
constexpr int W = 576;                   // a row: the latent and the rope key
constexpr int HMAX = 16;                 // query heads: the A operand's rows
constexpr int T = 32;                    // positions per tile
constexpr int STAGES = 4;                // tiles in flight per block
constexpr int WARPS = 4;                 // consumer warps
constexpr int THREADS = (WARPS + 1) * 32;  // + a producer warp
constexpr int ROWB = 128;                // bytes of a 64-column chunk row
constexpr int NCH = W / 64;              // chunks of a row
constexpr int TILE_BYTES = NCH * T * ROWB;
constexpr int QROW = W + 8;              // a q row in shared memory, padded
constexpr int NT = LAT / WARPS / 8;      // 8-column tiles of a warp's output
// shared memory, from the 1024-byte aligned base: the ring, q, the scores
// of two tiles, the stages' barriers (full, then empty)
constexpr int Q_OFF = STAGES * TILE_BYTES;
constexpr int S_OFF = Q_OFF + HMAX * QROW * 2;
constexpr int BAR_OFF = S_OFF + 2 * HMAX * T * 4;
constexpr int ALLOC = BAR_OFF + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// (a, b) as a bf16 pair `hi` and the bf16 pair `lo` of what hi leaves
// over: hi + lo holds ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte address of the 16-byte piece `piece` (8 columns) of row `row` in a
// tile: 64-column chunks of T rows x 128 bytes, 128-byte swizzle.
__device__ __forceinline__ uint32_t tile_at(uint32_t tile, int row,
                                            int piece) {
  return tile + (piece / 8) * T * ROWB + row * ROWB
         + (((piece % 8) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
}

// Grid (n_splits, b), THREADS threads: block (split, slot) takes the
// slot's valid positions [split * split_len, ...) of [0, min(length, S)),
// S = max_blocks * bs.  q: (b, H, W) contiguous, H <= 16 (rows past H are
// zero).  With part null (one split) it writes out (b, H, LAT); else the
// partial (acc[0..LAT), m, l) of each of the 16 rows to part[(slot *
// n_splits + split) * 16 + row], m in log2 units.
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_kernel(const __grid_constant__ CUtensorMap map,
                 const __nv_bfloat16* __restrict__ q,
                 const int* __restrict__ tables, long long t_sb,
                 const long long* __restrict__ lengths,
                 float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                 int S, int bs, int box, int H, int split_len, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t full0 = base + BAR_OFF, empty0 = full0 + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int split = blockIdx.x, slot = blockIdx.y;
  const long long len = lengths[slot];
  const int hi = (int)max(0LL, min(len, (long long)S));
  const int k_lo = split * split_len;
  const int k_hi = min(hi, k_lo + split_len);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + T - 1) / T : 0;

  if (threadIdx.x >= WARPS * 32) {
    // producer warp: lane j < T / box loads box j of each tile's chunks
    const int lane = threadIdx.x % 32, n_box = T / box;
    const int* tab = tables + (long long)slot * t_sb;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t kt = base + s * TILE_BYTES;
      int pblk = 0, off = 0;             // read before the wait, to hide it
      if (lane < n_box) {
        const int p = min(k_lo + it * T + lane * box, S - box);
        pblk = tab[p / bs];
        off = p % bs;
      }
      if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
      if (lane == 0) mbar_expect_tx(full0 + 8 * s, TILE_BYTES);
      __syncwarp();
      if (lane < n_box) {
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(kt + c * T * ROWB + lane * box * ROWB, &map,
                      full0 + 8 * s, 64 * c, 0, off, pblk);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  // q into shared memory, 16-byte pieces, padded rows (conflict-free
  // ldmatrix); rows past H are zero
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sbase + Q_OFF);
  const __nv_bfloat16* qb = q + (long long)slot * H * W;
  for (int i = threadIdx.x; i < HMAX * (W / 8); i += WARPS * 32) {
    const int r = i / (W / 8), c8 = i % (W / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < H) v = *reinterpret_cast<const uint4*>(qb + r * W + c8 * 8);
    *reinterpret_cast<uint4*>(qs + r * QROW + c8 * 8) = v;
  }
  float* const ssm = reinterpret_cast<float*>(sbase + S_OFF);  // [2][16][T]
  consumers_sync();

  const uint32_t qa0 = smem_u32(qs);
  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;   // rows g and g + 8
  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;
  const uint32_t qrow = qa0 + ((mr + 8 * (mi & 1)) * QROW + 8 * (mi >> 1)) * 2;
  const int krow = warp * 8 + mr;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t kt = base + s * TILE_BYTES;
    const int t0 = k_lo + it * T;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

    // scores of this warp's 8 positions for the 16 heads
    float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 6
    for (int kk = 0; kk < W / 32; ++kk) {          // two k-steps a pass
      uint32_t b[4], a[4];
      ldsm_x4(tile_at(kt, krow, 4 * kk + mi), b);
      ldsm_x4(qrow + kk * 64, a);
      mma_bf16(sc, a, b[0], b[1]);
      ldsm_x4(qrow + kk * 64 + 32, a);
      mma_bf16(sc, a, b[2], b[3]);
    }
    // element i: head g + 8 (i / 2), position t0 + 8 warp + 2 tq + i % 2
    float* sb = ssm + (it & 1) * HMAX * T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = t0 + warp * 8 + 2 * tq + (i & 1);
      sc[i] = key < k_hi ? sc[i] * sl2 : -INFINITY;
    }
    *reinterpret_cast<float2*>(sb + g * T + warp * 8 + 2 * tq) =
        make_float2(sc[0], sc[1]);
    *reinterpret_cast<float2*>(sb + (g + 8) * T + warp * 8 + 2 * tq) =
        make_float2(sc[2], sc[3]);
    consumers_sync();

    // the tile's softmax step for all 16 heads, in every warp: this
    // thread's positions 8 j + 2 tq + e of rows g (r0) and g + 8 (r1)
    float r0[8], r1[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(sb + g * T + 8 * j
                                                        + 2 * tq);
      const float2 v = *reinterpret_cast<const float2*>(sb + (g + 8) * T
                                                        + 8 * j + 2 * tq);
      r0[2 * j] = u.x;
      r0[2 * j + 1] = u.y;
      r1[2 * j] = v.x;
      r1[2 * j + 1] = v.y;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, r0[i]);
      mx1 = fmaxf(mx1, r1[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // p as hi and lo A fragments of the two 16-position k-steps
    uint32_t ph[2][4], pl[2][4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e0 = ex2(r0[2 * j] - m0), e1 = ex2(r0[2 * j + 1] - m0);
      const float e2 = ex2(r1[2 * j] - m1), e3 = ex2(r1[2 * j + 1] - m1);
      ps0 += e0 + e1;
      ps1 += e2 + e3;
      const int ks = j / 2, hl = j % 2;      // positions 16 ks + 8 hl + ...
      split_bf16(e0, e1, &ph[ks][2 * hl], &pl[ks][2 * hl]);
      split_bf16(e2, e3, &ph[ks][2 * hl + 1], &pl[ks][2 * hl + 1]);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }
    // PV over this warp's 128 columns: the rows' first 512 columns are V
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int vrow = 16 * ks + (mi % 2) * 8 + mr;
#pragma unroll
      for (int pi = 0; pi < NT / 2; ++pi) {
        uint32_t b[4];
        ldsm_x4_trans(tile_at(kt, vrow, 16 * warp + 2 * pi + mi / 2), b);
        mma_bf16(acc[2 * pi], ph[ks], b[0], b[1]);
        mma_bf16(acc[2 * pi], pl[ks], b[0], b[1]);
        mma_bf16(acc[2 * pi + 1], ph[ks], b[2], b[3]);
        mma_bf16(acc[2 * pi + 1], pl[ks], b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int col0 = warp * (LAT / WARPS) + 2 * tq;
  if (part == nullptr) {
    const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + (long long)slot * H * LAT;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int c = col0 + 8 * i;
      if (g < H)
        *reinterpret_cast<__nv_bfloat162*>(ob + g * LAT + c) =
            __floats2bfloat162_rn(acc[i][0] * i0, acc[i][1] * i0);
      if (g + 8 < H)
        *reinterpret_cast<__nv_bfloat162*>(ob + (g + 8) * LAT + c) =
            __floats2bfloat162_rn(acc[i][2] * i1, acc[i][3] * i1);
    }
    return;
  }
  float* pb = part + ((long long)slot * gridDim.x + split) * HMAX * (LAT + 2);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c = col0 + 8 * i;
    *reinterpret_cast<float2*>(pb + g * (LAT + 2) + c) =
        make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(pb + (g + 8) * (LAT + 2) + c) =
        make_float2(acc[i][2], acc[i][3]);
  }
  if (warp == 0 && tq == 0) {
    pb[g * (LAT + 2) + LAT] = m0;
    pb[g * (LAT + 2) + LAT + 1] = l0;
    pb[(g + 8) * (LAT + 2) + LAT] = m1;
    pb[(g + 8) * (LAT + 2) + LAT + 1] = l1;
  }
}

// Grid (b, H), LAT threads: row (slot, head) of out from the n_splits
// partials, combined in split order.
__global__ void __launch_bounds__(LAT)
paged_mla_combine_kernel(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ out, int H, int n_splits) {
  const int slot = blockIdx.x, r = blockIdx.y, c = threadIdx.x;
  const long long step = (long long)HMAX * (LAT + 2);
  const float* pb = part + (long long)slot * n_splits * step + r * (LAT + 2);
  float M = NEG;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, pb[i * step + LAT]);
  float L = 0.0f, A = 0.0f;
  for (int i = 0; i < n_splits; ++i) {
    const float* e = pb + i * step;
    const float w = exp2f(e[LAT] - M);
    L += e[LAT + 1] * w;
    A += e[c] * w;
  }
  out[((long long)slot * H + r) * LAT + c] =
      __float2bfloat16(A / fmaxf(L, 1e-30f));
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q: (b, H, 576) bf16,
// contiguous, 16-byte aligned, H <= 16; pool: (n_blocks, bs, 576) bf16,
// rows contiguous, block and row strides p_blk, p_row in elements (each a
// multiple of 8), 16-byte aligned; bs a multiple of 8; tables: int32 (b,
// max_blocks), row stride t_sb; lengths: int64 (b,); out: (b, H, 512)
// bf16; part: f32 workspace of b * n_splits * 16 * 514 floats (unused
// with one split); split_len a multiple of 32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or 10000 + the CUresult when
// the TMA descriptor cannot be encoded.
extern "C" int paged_mla_decode_launch(
    const void* q, const void* pool, int n_blocks, int bs, long long p_blk,
    long long p_row, const void* tables, long long t_sb, int max_blocks,
    const void* lengths, void* part, void* out, int b, int H, int n_splits,
    int split_len, float scale, cudaStream_t stream) {
  const int box = (bs & -bs) < T ? (bs & -bs) : T;   // gcd(bs, T)
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const CUresult r = encode_pool_bf16(&map, fn, pool, n_blocks, bs, 1, W,
                                      2 * p_blk, 2 * p_row, 2 * p_row, box);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)paged_mla_kernel, ALLOC, &attr_set);
  if (e != 0) return e;
  paged_mla_kernel<<<dim3(n_splits, b), THREADS, ALLOC, stream>>>(
      map, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(tables), t_sb,
      static_cast<const long long*>(lengths),
      n_splits > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<__nv_bfloat16*>(out), max_blocks * bs, bs, box, H,
      split_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_mla_combine_kernel<<<dim3(b, H), LAT, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), H,
      n_splits);
  return (int)cudaGetLastError();
}
