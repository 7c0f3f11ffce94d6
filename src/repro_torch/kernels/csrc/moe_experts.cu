// Grouped INT8 experts of the MoE decode step for Hopper (sm_90a): each
// routed expert's int8 weights are read once, and run only over the tokens
// routed to it.
//
// Replaces no TPU kernel: the JAX package leaves the experts to XLA (three
// dequant einsums that run every expert over every token,
// `repro/models/moe.py:moe_apply`'s T <= C path).  The function is that
// path's for an INT8 expert leaf {"q", "scale"}: for assignment a = (t, j)
// of token t to its j-th expert e = ids[t, j],
//   h[a]      = bf16( silu(x[t] . Wg[e] * sg[e]) * (x[t] . Wu[e] * su[e]) )
//   out[t, j] = bf16( h[a] . Wd[e] * sd[e] )
// with the dot products summed in f32 over bf16 x and int8 weights decoded
// exactly (the magic-number conversion of csrc/int8_gemm.cu), the
// per-channel scale and SiLU in f32, and one rounding to bf16 each.  The
// caller weights out[t, j] by the router and sums over j in j order.
//
// What bounds it on an H100 SXM: the expert weights, one byte each.  A
// decode step routes T * k assignments (32 x 4 over 60 experts, 128 x 6
// over 64 in the benchmark's cells), so an expert sees 0 to ~30 rows:
// 2 operations per weight byte per row, 16 to 96 per byte in all, far
// below the ~295 where the bf16 tensor cores become the limit.  The bound
// is the touched experts' bytes at 3.35 TB/s; every choice serves bytes.
//
// Design.  Two kernels, one template: `moe_expert_kernel<true>` (gate and
// up, SiLU, grid (ceil(f / 128) chunks, E)) and `<false>` (down, grid
// (ceil(d / 256) chunks, E)).  A block of 4 warps owns one expert and two panels
// of 128 output channels (gate and up of the same channels; or two
// neighbouring panels of down).
//   1. Routing in the block.  The threads scan the step's T * k expert ids
//      (int64, as torch.topk returns them) 1,024 at a time with warp ballots
//      and collect the assignments of their expert in ascending order, at
//      most 32 at a time (`collect`); a block whose expert has none
//      returns before it loads a weight byte.  No host read, no extra
//      kernel, no atomics.
//   2. A 4-stage cp.async ring of 64-row pieces: both panels' int8 rows
//      (128 bytes each, whole L2 lines; rows padded to 144 bytes so the
//      fragment loads below meet no bank conflict) and the routed rows of
//      the activations (x gathered by token for gate / up, h by
//      assignment for down), 23 KB a stage, two blocks an SM.
//   3. mma.sync m16n8k16 with the weights as A (swap-AB): 16 output
//      channels are the 16 rows and the routed rows the n columns, so 2
//      rows or 30 waste no 64-row wgmma tile.  Warp w owns channels
//      32w .. 32w + 31 of each panel; one 32-bit load of 4 channels of one
//      weight row gives one weight of 4 fragment rows (row g of a tile is
//      channel 4g + 2h, row g + 8 is 4g + 2h + 1), decoded to bf16 in
//      registers.  Up to 4 n tiles (32 rows, a pass) are walked against
//      each staged piece, so HBM is read once for an expert with up to 32
//      rows.  An expert with more takes them in passes of 32, dealt out
//      round-robin to `chunks` neighbouring blocks of the same column tile
//      (grid x = tiles x chunks, chosen by the wrapper from T k / E): they
//      run side by side, the later reads of the same weights mostly from
//      L2, so a busy expert does not leave its blocks running alone at the
//      end of the launch.
//   4. Epilogue: the f32 sums x the per-channel scale in f32 (gate / up:
//      silu(g) * u in f32), one rounding to bf16, 4 channels a thread in
//      one 8-byte store to the assignment's row.
// Every sum is in a fixed order and there are no atomics, so two calls,
// and a captured step and its replay, give the same bits.
//
// Contract (checked by kernels/moe_experts.py): K % 64 == 0 and N % 32 ==
// 0 for every panel (d and f); x, h, out, the weights and the scales
// contiguous and 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr int THREADS = 128;             // 4 warps
constexpr int KS = 64;                   // weight rows per stage
constexpr int STAGES = 4;                // ring depth
constexpr int PANEL = 128;               // channels per panel (32 a warp)
constexpr int WROW = PANEL + 16;         // bytes per staged weight row
constexpr int NTOK = 32;                 // rows per pass: 4 mma n tiles
constexpr int NT = NTOK / 8;
constexpr int XROW = KS + 8;             // bf16 per staged activation row
constexpr int W_STAGE = 2 * KS * WROW;   // two panels: 18,432 bytes
constexpr int X_STAGE = NTOK * XROW * 2; // 4,608 bytes
constexpr int STAGE = W_STAGE + X_STAGE;
constexpr int SMEM = STAGES * STAGE;     // 92,160 bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// int8 byte j of `u` (already xor 0x80: offset binary) as an exact float:
// the byte goes into the mantissa of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ float i8_to_f32(uint32_t u, int j) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j))
         - 8388736.0f;
}

// Bytes j of (offset-binary) weight words lo and hi -> bf16x2 bits, lo's
// byte in the low half.  Exact: int8 values fit bf16's mantissa.
__device__ __forceinline__ uint32_t pair_bf16x2(uint32_t lo, uint32_t hi,
                                                int j) {
  __nv_bfloat162 v = __floats2bfloat162_rn(i8_to_f32(lo, j),
                                           i8_to_f32(hi, j));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int SCAN = 8;                  // ids a thread reads per scan step

struct Routing {
  int rows[NTOK];                        // the pass's assignments, ascending
  int count[SCAN][THREADS / 32];         // hits per (scan slot, warp)
  int cursor;                            // where the next pass's scan starts
};

// The next (at most NTOK) assignments a >= cursor with ids[a] == e, in
// ascending order, into r.rows; returns how many.  Called by every thread
// of the block; `cursor` moves past the last one taken.  Each step reads
// SCAN * THREADS ids at once (one load latency: the decode cells' 768 ids
// take one step).
__device__ int collect(Routing& r, const long long* __restrict__ ids,
                       int n_assign, int e, int& cursor) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int base = cursor; base < n_assign; base += SCAN * THREADS) {
    long long v[SCAN];
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      const int i = base + j * THREADS + threadIdx.x;
      v[j] = i < n_assign ? ids[i] : -1;
    }
    unsigned m[SCAN];
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      m[j] = __ballot_sync(0xFFFFFFFFu, v[j] == (long long)e);
      if (lane == 0) r.count[j][warp] = __popc(m[j]);
    }
    __syncthreads();
    int before = n;                  // hits ahead of scan slot j
#pragma unroll
    for (int j = 0; j < SCAN; ++j) {
      int mine = before, total = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        const int c = r.count[j][w];
        mine += w < warp ? c : 0;
        total += c;
      }
      if ((m[j] >> lane) & 1u) {
        const int rank = mine + __popc(m[j] & below);
        const int a = base + j * THREADS + threadIdx.x;
        if (rank < NTOK) r.rows[rank] = a;
        if (rank == NTOK - 1) r.cursor = a + 1;
      }
      before += total;
    }
    __syncthreads();                 // rows, cursor and counts are read
    if (before >= NTOK) {
      cursor = r.cursor;
      return NTOK;
    }
    n = before;
  }
  cursor = n_assign;
  return n;
}

// GATED: gate / up -> h (out rows of N = f), activations x gathered by
// token (a / topk).  Otherwise down -> out (rows of N = d), activations h
// by assignment.  w0, w1: the (E, K, N) int8 stacks (w1 unused for down);
// s0, s1: their (E, N) f32 scales.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 2)
moe_expert_kernel(const __nv_bfloat16* __restrict__ act,
                  const long long* __restrict__ ids, int n_assign, int topk,
                  const int8_t* __restrict__ w0,
                  const int8_t* __restrict__ w1,
                  const float* __restrict__ s0, const float* __restrict__ s1,
                  __nv_bfloat16* __restrict__ out, int K, int N,
                  int chunks) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Routing route;
  // column tile bx, row chunk r: passes r, r + chunks, r + 2 chunks, ...
  const int e = blockIdx.y, bx = blockIdx.x / chunks,
            r = blockIdx.x % chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, kq = lane % 4;
  const long long expert_off = (long long)e * K * N;
  // panel p: its weight stack, scale and first channel
  const int8_t* const wp[2] = {w0 + expert_off,
                               (GATED ? w1 : w0) + expert_off};
  const float* const sp[2] = {s0 + (long long)e * N,
                              (GATED ? s1 : s0) + (long long)e * N};
  const int col0[2] = {GATED ? bx * PANEL : bx * 2 * PANEL,
                       GATED ? bx * PANEL : bx * 2 * PANEL + PANEL};
  const int nk = K / KS;
  int cursor = 0;

  for (int pass = 0;; ++pass) {
    const int n = collect(route, ids, n_assign, e, cursor);
    if (n == 0) return;        // no (more) rows: not a weight byte read
    if (pass % chunks != r) continue;     // another block's rows

    // stage q of the ring: weight rows [q KS, q KS + KS) of both panels
    // and the pass's activation rows, columns [q KS, q KS + KS)
    auto load_stage = [&](int q) {
      uint8_t* const st = smem + (q % STAGES) * STAGE;
      const int k0 = q * KS;
#pragma unroll
      for (int j = 0; j < 2 * KS * 8 / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        const int p = i / (KS * 8), row = (i / 8) % KS, c = i % 8;
        const int col = col0[p] + c * 16;
        if (col < N)
          cp_async16(st + p * KS * WROW + row * WROW + c * 16,
                     wp[p] + (long long)(k0 + row) * N + col);
      }
      __nv_bfloat16* const xs =
          reinterpret_cast<__nv_bfloat16*>(st + W_STAGE);
#pragma unroll
      for (int j = 0; j < NTOK * 8 / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        const int r = i / 8, c = i % 8;
        if (r < n) {
          const int a = route.rows[r];
          const long long src_row = GATED ? a / topk : a;
          cp_async16(xs + r * XROW + c * 8, act + src_row * K + k0 + c * 8);
        }
      }
    };

    float acc[2][2][NT][4];    // [panel][column pair h][n tile][fragment]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[p][h][t][v] = 0.0f;

#pragma unroll
    for (int q = 0; q < STAGES - 1; ++q) {
      if (q < nk) load_stage(q);
      cp_async_commit();
    }
    for (int kp = 0; kp < nk; ++kp) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const uint8_t* const st = smem + (kp % STAGES) * STAGE;
      const __nv_bfloat16* const xs =
          reinterpret_cast<const __nv_bfloat16*>(st + W_STAGE);
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        // weights: rows 2kq, 2kq+1, 2kq+8, 2kq+9 of the k16 step, the
        // warp's channels 4g .. 4g+3, both panels (offset binary)
        uint32_t a[2][2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint8_t* wr = st + p * KS * WROW + (ks * 16 + 2 * kq) * WROW
                              + warp * 32 + 4 * g;
          const uint32_t u0 =
              *reinterpret_cast<const uint32_t*>(wr) ^ 0x80808080u;
          const uint32_t u1 =
              *reinterpret_cast<const uint32_t*>(wr + WROW) ^ 0x80808080u;
          const uint32_t u2 =
              *reinterpret_cast<const uint32_t*>(wr + 8 * WROW) ^ 0x80808080u;
          const uint32_t u3 =
              *reinterpret_cast<const uint32_t*>(wr + 9 * WROW) ^ 0x80808080u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            a[p][h][0] = pair_bf16x2(u0, u1, 2 * h);       // row g
            a[p][h][1] = pair_bf16x2(u0, u1, 2 * h + 1);   // row g + 8
            a[p][h][2] = pair_bf16x2(u2, u3, 2 * h);
            a[p][h][3] = pair_bf16x2(u2, u3, 2 * h + 1);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t * 8 < n) {
            // B = the activations transposed: column g is row t*8 + g
            const __nv_bfloat16* xr = xs + (t * 8 + g) * XROW + ks * 16
                                      + 2 * kq;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mma_bf16(acc[p][h][t], a[p][h][0], a[p][h][1], a[p][h][2],
                         a[p][h][3], b0, b1);
          }
        }
      }
      const int q = kp + STAGES - 1;
      if (q < nk) load_stage(q);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();           // the ring is free for the next pass

    // epilogue: fragment (row g / g+8, column 2kq / 2kq+1) of tile (p, h,
    // t) is channel 4g + 2h (+1) of panel p, routed row t*8 + 2kq (+1)
    float4 sc[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ch = col0[p] + warp * 32 + 4 * g;
      sc[p] = ch < N ? *reinterpret_cast<const float4*>(sp[p] + ch)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = t * 8 + 2 * kq + i;
        if (r >= n) continue;
        const long long row = route.rows[r];
        float v[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float s[4] = {sc[p].x, sc[p].y, sc[p].z, sc[p].w};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              v[p][2 * h + hi] = acc[p][h][t][2 * hi + i] * s[2 * h + hi];
        }
        if (GATED) {
          const int ch = col0[0] + warp * 32 + 4 * g;
          if (ch < N) {
            float o[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[c] = v[0][c] / (1.0f + expf(-v[0][c])) * v[1][c];
            *reinterpret_cast<uint2*>(out + row * N + ch) =
                make_uint2(bf16x2_bits(o[0], o[1]), bf16x2_bits(o[2], o[3]));
          }
        } else {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int ch = col0[p] + warp * 32 + 4 * g;
            if (ch < N)
              *reinterpret_cast<uint2*>(out + row * N + ch) = make_uint2(
                  bf16x2_bits(v[p][0], v[p][1]), bf16x2_bits(v[p][2], v[p][3]));
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x: (T, d) bf16; ids: (T, k)
// int64 expert ids; wg, wu: (E, d, f) int8 with scales sg, su (E, f) f32;
// wd: (E, f, d) int8 with sd (E, d) f32; h: (T k, f) bf16 scratch; out:
// (T k, d) bf16.  d and f multiples of 64 and 32 as the header says.
// Launches the gate / up kernel, then the down kernel, on `stream` and
// returns the first cudaGetLastError() that is not 0 (0 on success).
extern "C" int moe_experts_launch(const void* x, const void* ids, int T,
                                  int topk, const void* wg, const void* sg,
                                  const void* wu, const void* su,
                                  const void* wd, const void* sd, void* h,
                                  void* out, int E, int d, int f, int chunks,
                                  cudaStream_t stream) {
  static unsigned long long attr_gate = 0, attr_down = 0;
  int err = hopper::allow_smem((const void*)moe_expert_kernel<true>, SMEM,
                               &attr_gate);
  if (err != 0) return err;
  err = hopper::allow_smem((const void*)moe_expert_kernel<false>, SMEM,
                           &attr_down);
  if (err != 0) return err;
  const int n_assign = T * topk;
  const auto* idp = static_cast<const long long*>(ids);
  moe_expert_kernel<true><<<dim3((f + PANEL - 1) / PANEL * chunks, E),
                            THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), idp, n_assign, topk,
      static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(sg), static_cast<const float*>(su),
      static_cast<__nv_bfloat16*>(h), d, f, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moe_expert_kernel<false><<<dim3((d + 2 * PANEL - 1) / (2 * PANEL) * chunks,
                                  E), THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(h), idp, n_assign, 1,
      static_cast<const int8_t*>(wd), nullptr,
      static_cast<const float*>(sd), nullptr,
      static_cast<__nv_bfloat16*>(out), f, d, chunks);
  return (int)cudaGetLastError();
}
