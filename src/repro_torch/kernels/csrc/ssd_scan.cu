// Mamba2 SSD chunked scan (arXiv:2405.21060) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan
// (_ssd_kernel), with ops.ssd_scan's expansion from groups to heads done by
// indexing (head h reads group h / (H / G)): x (B, L, H, P) and B/C
// (B, L, G, N) in fp32 or bf16, dt (B, L, H) and A (B, H) fp32, an optional
// initial state s0 (B, H, P, N) fp32; y (B, L, H, P) in x's dtype and the
// final state (B, H, P, N) fp32. Per chunk of Q tokens, with cum the
// within-chunk cumulative sum of dt·A:
//   y_q   = sum_{k<=q} (C_q·B_k) exp(cum_q - cum_k) dt_k x_k + exp(cum_q) S_in C_q
//   S_out = exp(cum_Q) S_in + sum_q exp(cum_Q - cum_q) dt_q x_q B_qᵀ
//
// What bounds it: bytes at serving shapes. mamba2-370m's prefill layer (B =
// 4 requests, L = 512, H = 32, P = 64, N = 128, Q = 128, bf16) reads x, B,
// C and dt once and writes y and the fp32 state (22 MB, 6.6 µs at 3.35
// TB/s) for the chunked dual form's four products over the causal pairs
// (3.8 GFLOP, 3.8 µs at the bf16 tensor-core peak): the two are close, so
// the products have to run on the tensor cores.
//
// Design. The TPU kernel walks the chunks of one (batch, head) in order on
// one core, carrying the state in VMEM; at one request that is only H = 32
// programs, and only the state carry is really sequential. So the scan is
// three launches, as ssd_chunked's stages:
//   1. chunk states, one block per (chunk, head, batch): the chunk's own
//      state contribution S_c = sum_q w_q x_q B_qᵀ, w_q = exp(cum_Q -
//      cum_q) dt_q (P × N, fp32), and exp-free cum_Q, into scratch;
//   2. ssd_state_pass, one thread per four state entries (per entry where
//      P·N is not a multiple of 4) of a (batch, head): the inter-chunk
//      recurrence S_in(c+1) = exp(cum_Q(c)) S_in(c) + S_c, in place over
//      the scratch (each chunk's slot ends up holding the state entering
//      it) and the final state. A thread issues the loads of 8 chunks
//      (contributions and cum_Q) before their dependent FMAs, so one round
//      trip to memory serves 8 steps of the recurrence, not one;
//   3. chunk outputs: the intra-chunk dual form and the carried state's
//      term, y in x's dtype.
// Stages 1 and 3 each have two kernels. bf16 inputs with P and N multiples
// of 16 take the tensor-core kernels (ssd_chunk_state_mma,
// ssd_chunk_out_mma) at any Q; fp32 inputs, and bf16 at other P or N, take
// the CUDA-core kernels (ssd_chunk_state, ssd_chunk_out). ssd_scan_stage()
// picks by dtype and shape: both pairs are hand-written and compute the same
// function. cum is computed by the same code, and so to the same fp32
// values, in every stage-1 and stage-3 kernel (scan_da: warp 0 alone, lane
// l adding its run of ceil(Q/32) consecutive tokens, a shuffle scan of the
// 32 run totals, then each lane its run's prefix sums from its offset). exp
// is expf (not __expf).
//
// Tensor-core kernels. Every product is mma.sync m16n8k16, bf16 × bf16 ->
// fp32, with ldmatrix fragment loads and 16-byte cp.async staging
// (mma_sm90.cuh, shared with flash_attention.cu). x, B and C arrive in bf16,
// so C·Bᵀ is exact products with fp32 sums. Each of the other three
// products has one fp32 operand: the scaled score (C_q·B_k) exp(cum_q -
// cum_k) dt_k, the carried state S_in, the weighted input w_q x_q. Rounding
// it once to bf16 moves a term by up to 2^-9 of itself (~0.006 rms in y at
// unit-normal inputs, past the 2e-3 absolute bound where |y| is small). So
// each is split into a bf16 pair, hi = bf16(v) and lo = bf16(v - hi), both
// rounded to nearest even, and multiplied by the exact bf16 operand twice
// (hi, then lo): the error drops to about 2^-17 of the term. The other
// operand is always exact, so there is no lo·lo term to drop. All sums are
// fp32. No atomics: two calls give the same bits.
// What bounds them now (tools/ssd_probe.py on the card): neither the
// bytes nor the tensor cores. mma.sync alone runs at ~620 TFLOP/s (6.2
// cycles an instruction per SM sub-partition), and the 1.5 million
// instructions of a call at the main shape (hi/lo pairs included) take ~10
// µs of it; a block's life is its loads'
// latency (the first wait queues behind the whole grid's copies, 5-6 µs),
// the ALU work around the products (an expf per live pair) and its
// barriers. Loads that gate the first compute (A, dt) are issued before the
// bulk copies.
// - ssd_chunk_state_mma, 4 warps per (chunk, head, batch): the chunk's x
//   (Q × P) and B (Q × N) rows by cp.async, exact; S_c = (w x)ᵀ·B with A =
//   xᵀ through ldmatrix.trans of the token-major x tile, each element times
//   its token's w_q and split into hi and lo in registers, and B through
//   ldmatrix.trans. A warp takes items of 16 rows of P × 128 columns of N
//   (one at P = 64, N = 128). Q is padded to a multiple of 16 with zero
//   rows. Shared memory 2·ceil16(Q)·(P + N + 20) bytes: 54,272 at Q = 128,
//   P = 64, N = 128 (four blocks an SM; 123 registers).
// - ssd_chunk_out_mma, 4 warps per (64 query rows, chunk, head, batch), a
//   one-dimensional grid with the last query tiles first (they see the most
//   keys). The block stages its C rows and the 64-key tiles of B and x at or
//   below its last row (cp.async, double-buffered where there is more than
//   one). The carried state's term exp(cum_q)·C_q·S_inᵀ is split over the
//   warps by columns: warp w takes all 64 rows × 16 rows of S_in, whose B
//   fragments it reads straight from the fp32 scratch (its own 8 KB at P =
//   64, N = 128) and splits into hi and lo in registers; the 64 × 64 result
//   goes to the row layout through key buffer 1 (free until key tile 1 is
//   issued), times exp(cum_q) per row. A first chunk without an initial
//   state skips it (its S_in is 0). Then, a warp owning 16 rows, for each
//   key tile the scores C·Bᵀ (on the diagonal tile only the key n-tiles with
//   a key at or below the warp's last row), scaled in registers by
//   exp(cum_q - cum_k) dt_k on live pairs and zeroed on dead ones, split
//   hi/lo straight from the accumulator fragment into the A operand of ·x (x
//   through ldmatrix.trans: the FlashAttention-2 register reuse of
//   flash_mma_kernel), two mma each. y in bf16 from the fp32 accumulator. P
//   goes in passes of 64 columns (one pass for P <= 64). Rows and keys past
//   Q are zero-filled by the copies and never stored. Shared memory (see
//   out_tiles_bytes) 71,680 bytes at Q = 128, P = 64, N = 128: three blocks
//   an SM, at most 168 registers (__launch_bounds__(128, 3); ptxas spills a
//   few bytes).
//
// CUDA-core kernels (fp32, and bf16 at other P or N), the first design. In
// stage 3 the Q × Q scores are tiled by 32 query rows (a 32 × Q
// tile in shared memory), so the block holds B (Q × (N+1)), x·dt (Q × P),
// S_in (P × (N+1)), a C tile (32 × N), a score tile (32 × Q) and cum:
// 165 KB at Q = 128, P = 64, N = 128 (rows padded by one float where
// neighbouring threads walk them). Products are plain fp32 FMAs on
// register tiles: a warp takes 4 tile rows (8 state rows in stage 1), a
// lane every 32nd key or column, so each shared-memory load feeds 2–3
// FMAs, not half of one as with one output per thread; the sums run in
// the order of the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // query rows per score tile (stage 3): 8 warps × 4
static_assert(kThreads == 8 * 32 && kTQ == 4 * (kThreads / 32), "4 tile rows a warp");
constexpr size_t kMaxSmem = 232448;
constexpr int kPassBatch = 8;      // chunks whose loads a state-pass thread issues together
constexpr int kMmaThreads = 128;   // tensor-core kernels: 4 warps
constexpr int kRows = 64;          // query rows per output block, keys per key tile
constexpr int kCols = 64;          // P columns per output pass
constexpr int kXStride = kCols + 8;  // row stride of an output block's x tile, elements
constexpr int kTurnStride = kCols + 4;  // row stride of the carried state's term, floats
constexpr int kStateCols = 128;    // N columns per item of the chunk-state kernel

using bf16 = __nv_bfloat16;

// Phase marks of the tensor-core kernels: empty here; tools/ssd_probe.cu
// defines it before including this file, to time a block's phases.
#ifndef SSD_MARK
#define SSD_MARK(i)
#endif

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Dims {
  int b, l, h, g, p, n, q, c;  // batch, length, heads, groups, P, N, chunk, chunks
};

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

size_t state_smem(const Dims& d) {
  return (static_cast<size_t>(d.q) * d.p + static_cast<size_t>(d.q) * d.n + d.q) *
         sizeof(float);
}

size_t out_smem(const Dims& d) {
  return (static_cast<size_t>(d.q) * (d.n + 1) + static_cast<size_t>(d.q) * d.p +
          static_cast<size_t>(d.p) * (d.n + 1) + static_cast<size_t>(kTQ) * d.n +
          static_cast<size_t>(kTQ) * d.q + d.q) *
         sizeof(float);
}

// ssd_chunk_state_mma: x (ceil16(Q) × (P + 8)) and B (ceil16(Q) × (N + 8))
// in bf16; cum and w (ceil16(Q) floats each)
size_t mma_state_smem(const Dims& d) {
  const size_t q16 = round_up(d.q, 16);
  return q16 * ((d.p + 8) + (d.n + 8)) * sizeof(bf16) + 2 * q16 * sizeof(float);
}

// ssd_chunk_out_mma's tiles: C (64 rows × (N + 8) bf16), key tile buffer
// 0 (B: 64 × (N + 8), x: 64 × kXStride, bf16) and buffer 1, which is at
// least the carried state's term in fp32 (64 × kTurnStride)
__host__ __device__ __forceinline__ size_t out_tiles_bytes(int n) {
  const size_t tile = (static_cast<size_t>(kRows) * (n + 8) + kRows * kXStride) * sizeof(bf16);
  const size_t turn = static_cast<size_t>(kRows) * kTurnStride * sizeof(float);
  return static_cast<size_t>(kRows) * (n + 8) * sizeof(bf16) + tile + (tile > turn ? tile : turn);
}

// ssd_chunk_out_mma: its tiles, then cum and dt (ceil64(Q) floats each)
size_t mma_out_smem(const Dims& d) {
  return out_tiles_bytes(d.n) + 2 * static_cast<size_t>(round_up(d.q, kRows)) * sizeof(float);
}

bool takes_mma(int bf16_in, const Dims& d) {
  return bf16_in && d.p % 16 == 0 && d.n % 16 == 0;
}

// In place over da[0, q) (dt·A per token, fp32): the inclusive prefix sums.
// Warp 0 alone, so the order of the adds depends on q only: lane l adds its
// run [l·r, l·r + r) of r = ceil(q / 32) tokens in order, a Hillis–Steele
// scan over shuffles gives the run totals' inclusive sums, and each lane
// writes its run's prefix sums from the sum of the runs before it. The
// adds are __fadd_rn (never fused). Ends with a barrier.
__device__ void scan_da(float* da, int q) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, r = (q + 31) / 32;
    const int i0 = min(lane * r, q), i1 = min(i0 + r, q);
    float tot = 0.f;
    for (int i = i0; i < i1; ++i) tot = __fadd_rn(tot, da[i]);
    float inc = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, inc, s);
      if (lane >= s) inc = __fadd_rn(inc, o);
    }
    float run = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) run = 0.f;
    for (int i = i0; i < i1; ++i) {
      run = __fadd_rn(run, da[i]);
      da[i] = run;
    }
  }
  __syncthreads();
}

// dt·A for the chunk's tokens, then its inclusive prefix sum (scan_da), in
// cum[0..Q). Ends with a barrier.
__device__ void chunk_cum(float* cum, const float* dt, float a, int64_t t0, int h, int hs,
                          int q) {
  for (int i = threadIdx.x; i < q; i += blockDim.x) cum[i] = __fmul_rn(dt[(t0 + i) * hs + h], a);
  __syncthreads();
  scan_da(cum, q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                float* __restrict__ states, float* __restrict__ cum_last, Dims d) {
  extern __shared__ float smem[];
  float* xw = smem;               // (Q, P): x_q · exp(cum_Q - cum_q) · dt_q
  float* bs = xw + d.q * d.p;     // (Q, N)
  float* cum = bs + d.q * d.n;    // (Q)
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g);
  const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
  chunk_cum(cum, dt, a[b * d.h + h], t0, h, d.h, d.q);
  const float last = cum[d.q - 1];
  for (int i = threadIdx.x; i < d.q * d.p; i += blockDim.x) {
    const int r = i / d.p, pp = i - r * d.p;
    const float w = expf(last - cum[r]) * dt[(t0 + r) * d.h + h];
    xw[i] = to_f32(x[((t0 + r) * d.h + h) * d.p + pp]) * w;
  }
  for (int i = threadIdx.x; i < d.q * d.n; i += blockDim.x) {
    const int r = i / d.n, nn = i - r * d.n;
    bs[i] = to_f32(bm[((t0 + r) * d.g + grp) * d.n + nn]);
  }
  __syncthreads();
  const int64_t slot = (static_cast<int64_t>(b) * d.c + ci) * d.h + h;
  float* out = states + slot * d.p * d.n;
  // register tiles: warp w takes 8 state rows p, lane l the columns
  // l + 32j (j < 4); tiles of 64 × 128 cover any (P, N)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p0 = 0; p0 < d.p; p0 += 64) {
    for (int n0 = 0; n0 < d.n; n0 += 128) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < d.q; ++r) {
        float xv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pp = p0 + warp * 8 + i;
          xv[i] = pp < d.p ? xw[r * d.p + pp] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n0 + lane + 32 * j;
          bv[j] = nn < d.n ? bs[r * d.n + nn] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pp = p0 + warp * 8 + i, nn = n0 + lane + 32 * j;
          if (pp < d.p && nn < d.n) out[pp * d.n + nn] = acc[i][j];
        }
    }
  }
  if (threadIdx.x == 0) cum_last[slot] = last;
}

// one step of the recurrence, s · exp(cum_Q) + S_c, on one entry or four
__device__ __forceinline__ float pass_step(float s, float decay, float c) {
  return s * decay + c;
}
__device__ __forceinline__ float4 pass_step(float4 s, float decay, float4 c) {
  return make_float4(s.x * decay + c.x, s.y * decay + c.y, s.z * decay + c.z,
                     s.w * decay + c.w);
}

// V = float (a thread an entry) or float4 (four entries, when P·N % 4 == 0
// and the state tensors are 16-byte aligned: four times the bytes in flight)
template <typename V>
__global__ void ssd_state_pass(float* __restrict__ states, const float* __restrict__ cum_last,
                               const float* __restrict__ s0, float* __restrict__ s_final,
                               Dims d) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int pn = d.p * d.n;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * kW;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int64_t first = static_cast<int64_t>(b) * d.c * d.h + h;  // chunk 0's slot
  V s = s0 != nullptr ? *reinterpret_cast<const V*>(s0 + bh * pn + e) : V{};
  for (int c0 = 0; c0 < d.c; c0 += kPassBatch) {
    V contrib[kPassBatch];
    float decay[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {  // the batch's loads, before any FMA
      if (c0 + j < d.c) {
        const int64_t slot = first + static_cast<int64_t>(c0 + j) * d.h;
        contrib[j] = *reinterpret_cast<const V*>(states + slot * pn + e);
        decay[j] = expf(cum_last[slot]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < d.c) {
        const int64_t slot = first + static_cast<int64_t>(c0 + j) * d.h;
        *reinterpret_cast<V*>(states + slot * pn + e) = s;  // the state entering chunk c0 + j
        s = pass_step(s, decay[j], contrib[j]);
      }
    }
  }
  *reinterpret_cast<V*>(s_final + bh * pn + e) = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const T* __restrict__ bm,
              const T* __restrict__ cm, const float* __restrict__ states, T* __restrict__ y,
              Dims d) {
  extern __shared__ float smem[];
  const int n1 = d.n + 1;
  float* bs = smem;               // (Q, N+1)
  float* xdt = bs + d.q * n1;     // (Q, P)
  float* s_in = xdt + d.q * d.p;  // (P, N+1): the state entering this chunk
  float* ct = s_in + d.p * n1;     // (kTQ, N)
  float* sc = ct + kTQ * d.n;     // (kTQ, Q)
  float* cum = sc + kTQ * d.q;    // (Q)
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g);
  const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
  chunk_cum(cum, dt, a[b * d.h + h], t0, h, d.h, d.q);
  for (int i = threadIdx.x; i < d.q * d.n; i += blockDim.x) {
    const int r = i / d.n, nn = i - r * d.n;
    bs[r * n1 + nn] = to_f32(bm[((t0 + r) * d.g + grp) * d.n + nn]);
  }
  for (int i = threadIdx.x; i < d.q * d.p; i += blockDim.x) {
    const int r = i / d.p, pp = i - r * d.p;
    xdt[i] = to_f32(x[((t0 + r) * d.h + h) * d.p + pp]) * dt[(t0 + r) * d.h + h];
  }
  const int64_t slot = (static_cast<int64_t>(b) * d.c + ci) * d.h + h;
  const float* st = states + slot * d.p * d.n;
  for (int i = threadIdx.x; i < d.p * d.n; i += blockDim.x) {
    const int pp = i / d.n, nn = i - pp * d.n;
    s_in[pp * n1 + nn] = st[i];
  }
  // register tiles: warp w takes tile rows 4w..4w+3, lane l the keys
  // (scores) or the columns of P (outputs) l + 32j
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < d.q; q0 += kTQ) {
    const int rows = min(kTQ, d.q - q0);
    const int kmax = q0 + rows;  // keys past the tile's last row are masked
    __syncthreads();  // staging done / the previous tile consumed
    for (int i = threadIdx.x; i < rows * d.n; i += blockDim.x) {
      const int r = i / d.n, nn = i - r * d.n;
      ct[i] = to_f32(cm[((t0 + q0 + r) * d.g + grp) * d.n + nn]);
    }
    __syncthreads();
    // scores (C_q·B_k) exp(cum_q - cum_k) for k <= q, else 0
    for (int k0 = 0; k0 < kmax; k0 += 128) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int nn = 0; nn < d.n; ++nn) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 4 + i;
          cv[i] = r < rows ? ct[r * d.n + nn] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = k0 + lane + 32 * j;
          bv[j] = kk < kmax ? bs[kk * n1 + nn] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = warp * 4 + i, kk = k0 + lane + 32 * j, qq = q0 + r;
          if (r < rows && kk < kmax)
            sc[r * d.q + kk] = kk <= qq ? acc[i][j] * expf(cum[qq] - cum[kk]) : 0.f;
        }
    }
    __syncthreads();
    // y = the dual form over the tile's keys + exp(cum_q) · C_q·S_inᵀ
    for (int p0 = 0; p0 < d.p; p0 += 64) {
      float diag[4][2], off[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) diag[i][j] = off[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kmax; ++kk) {
        float sv[4], xv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 4 + i;
          sv[i] = r < rows ? sc[r * d.q + kk] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pp = p0 + lane + 32 * j;
          xv[j] = pp < d.p ? xdt[kk * d.p + pp] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) diag[i][j] = fmaf(sv[i], xv[j], diag[i][j]);
      }
#pragma unroll 4
      for (int nn = 0; nn < d.n; ++nn) {
        float cv[4], sv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 4 + i;
          cv[i] = r < rows ? ct[r * d.n + nn] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pp = p0 + lane + 32 * j;
          sv[j] = pp < d.p ? s_in[pp * n1 + nn] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = warp * 4 + i, pp = p0 + lane + 32 * j, qq = q0 + r;
          if (r < rows && pp < d.p)
            y[((t0 + qq) * d.h + h) * d.p + pp] =
                from_f32<T>(diag[i][j] + expf(cum[qq]) * off[i][j]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, P % 16 == N % 16 == 0: the tensor-core kernels
// ---------------------------------------------------------------------------

// (v0, v1) split into bf16 pairs, hi = bf16(v) and lo = bf16(v - hi), both
// rounded to nearest even and packed as an mma fragment holds a row's two
// columns (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ bm,
                    float* __restrict__ states, float* __restrict__ cum_last, Dims d) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int q16 = round_up(d.q, 16);
  // row strides (elements) of 16·odd bytes: the 8 rows an ldmatrix phase
  // reads start in distinct groups of 4 banks
  const int PS = d.p + 8, NS = d.n + 8;
  bf16* sx = reinterpret_cast<bf16*>(ssd_smem);          // (q16, PS): x
  bf16* sb = sx + q16 * PS;                              // (q16, NS): B
  float* cum = reinterpret_cast<float*>(sb + q16 * NS);  // (q16)
  float* w = cum + q16;                                  // (q16): w_q, 0 past Q
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g);
  const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
  const int nch = d.n / 8, pch = d.p / 8;  // 16-byte chunks a row
  SSD_MARK(0);

  // A and dt first, so that their loads do not queue behind the copies; x and B
  // rows by cp.async (zero rows past Q), in flight while cum and w are
  // formed
  const float av = a[b * d.h + h];
  float dv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kMmaThreads;
    dv[j] = i < d.q ? dt[(t0 + i) * d.h + h] : 0.f;
  }
  for (int c = tid; c < q16 * nch; c += kMmaThreads) {
    const int r = c / nch, ch = c - r * nch;
    const bool in = r < d.q;
    cp_async16(smem_u32(sb + r * NS + ch * 8),
               bm + ((t0 + (in ? r : 0)) * d.g + grp) * d.n + ch * 8, in);
  }
  for (int c = tid; c < q16 * pch; c += kMmaThreads) {
    const int r = c / pch, ch = c - r * pch;
    const bool in = r < d.q;
    cp_async16(smem_u32(sx + r * PS + ch * 8), x + ((t0 + (in ? r : 0)) * d.h + h) * d.p + ch * 8,
               in);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kMmaThreads;
    if (i < q16) {
      w[i] = dv[j];
      cum[i] = __fmul_rn(dv[j], av);
    }
  }
  for (int i = tid + 2 * kMmaThreads; i < q16; i += kMmaThreads) {
    const float v = i < d.q ? dt[(t0 + i) * d.h + h] : 0.f;
    w[i] = v;
    cum[i] = __fmul_rn(v, av);
  }
  __syncthreads();
  scan_da(cum, d.q);
  SSD_MARK(1);
  const float last = cum[d.q - 1];
  for (int i = tid; i < d.q; i += kMmaThreads) w[i] = expf(last - cum[i]) * w[i];
  cp_async_wait<0>();
  __syncthreads();
  SSD_MARK(2);

  // S_c (P × N) = (w x)ᵀ·B. A = xᵀ through ldmatrix.trans of the
  // token-major x tile, each element times its token's w_q and split into
  // hi and lo in registers; B through ldmatrix.trans of the token-major B
  // tile. Per-lane offsets (elements): A rows (lane & 7) + 8·(lane >> 4),
  // column half (lane >> 3) & 1; B rows (lane & 7) + 8·((lane >> 3) & 1),
  // column half lane >> 4. A warp takes items of 16 rows of P × 128
  // columns of N.
  const int64_t slot = (static_cast<int64_t>(b) * d.c + ci) * d.h + h;
  float* out = states + slot * d.p * d.n;
  const int a_lane = ((lane & 7) + ((lane >> 4) << 3)) * PS + ((lane >> 3) & 1) * 8;
  const int b_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * NS + (lane >> 4) * 8;
  const int n_items = (d.n + kStateCols - 1) / kStateCols, items = d.p / 16 * n_items;
  for (int it = warp; it < items; it += kMmaThreads / 32) {
    const int p0 = it / n_items * 16, n0 = it % n_items * kStateCols;
    const int nt = min(kStateCols, d.n - n0) / 8;  // n-tiles of 8 columns (even)
    float acc[kStateCols / 8][4];
#pragma unroll
    for (int j = 0; j < kStateCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < q16; k0 += 16) {
      // a[0], a[1]: tokens k0 + 2·tig, + 1; a[2], a[3]: the same + 8
      uint32_t ax[4], ah[4], al[4];
      ldsm_x4_trans(smem_u32(sx + k0 * PS + p0 + a_lane), ax);
      const float2 w0 = *reinterpret_cast<const float2*>(w + k0 + 2 * tig);
      const float2 w8 = *reinterpret_cast<const float2*>(w + k0 + 8 + 2 * tig);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ax[i]));
        const float2 wi = i < 2 ? w0 : w8;
        split2(f.x * wi.x, f.y * wi.y, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < kStateCols / 8; j += 2) {
        if (j < nt) {
          uint32_t bv[4];
          ldsm_x4_trans(smem_u32(sb + k0 * NS + n0 + j * 8 + b_lane), bv);
          mma_bf16(acc[j], ah, bv[0], bv[1]);
          mma_bf16(acc[j], al, bv[0], bv[1]);
          mma_bf16(acc[j + 1], ah, bv[2], bv[3]);
          mma_bf16(acc[j + 1], al, bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kStateCols / 8; ++j) {
      if (j < nt) {
        float* o = out + static_cast<int64_t>(p0 + gr) * d.n + n0 + j * 8 + 2 * tig;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * d.n) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  SSD_MARK(3);
  if (tid == 0) cum_last[slot] = last;
}

__global__ void __launch_bounds__(kMmaThreads, 3)
ssd_chunk_out_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const bf16* __restrict__ bm,
                  const bf16* __restrict__ cm, const float* __restrict__ states,
                  const float* __restrict__ s0, bf16* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int NS = d.n + 8;  // row stride of the C and B tiles (elements)
  const int q64 = round_up(d.q, kRows);
  bf16* sc = reinterpret_cast<bf16*>(ssd_smem);  // (64, NS): C of the block's rows
  // key tile buffers 0 and 1, buf_elems apart: B (64, NS) and x (64,
  // kXStride) each; buffer 1 also holds the carried state's term on its
  // way from the column layout to the row layout
  const int buf_elems = kRows * (NS + kXStride);
  bf16* sb = sc + kRows * NS;  // buffer 0's B
  bf16* sx = sb + kRows * NS;  // buffer 0's x
  float* turn = reinterpret_cast<float*>(sb + buf_elems);  // (64, kTurnStride)
  float* cum = reinterpret_cast<float*>(ssd_smem + out_tiles_bytes(d.n));  // (q64)
  float* sdt = cum + q64;                                                  // (q64)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int per_tile = d.c * d.h * d.b;
  const int qt = q64 / kRows - 1 - static_cast<int>(blockIdx.x) / per_tile;  // last first
  const int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int ci = rem % d.c, h = rem / d.c % d.h, b = rem / (d.c * d.h);
  const int grp = h / (d.h / d.g);
  const int q0 = qt * kRows;
  const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
  const int64_t slot = (static_cast<int64_t>(b) * d.c + ci) * d.h + h;
  const bool carry = ci > 0 || s0 != nullptr;   // S_in is 0 otherwise
  const bool warp_live = q0 + warp * 16 < d.q;  // the warp has a row to write
  const int nch = d.n / 8;                      // 16-byte chunks of a B or C row
  const int ksteps = d.n / 16;
  const int64_t bc_row = static_cast<int64_t>(d.g) * d.n;  // between tokens
  const int64_t x_row = static_cast<int64_t>(d.h) * d.p;
  const bf16* cb = cm + grp * d.n;
  const bf16* bb = bm + grp * d.n;
  const bf16* xb = x + static_cast<int64_t>(h) * d.p;
  const float* st = states + slot * d.p * d.n;  // S_in (P × N), fp32
  SSD_MARK(0);

  for (int c = tid; c < kRows * nch; c += kMmaThreads) {
    const int r = c / nch, ch = c - r * nch;
    const bool in = q0 + r < d.q;
    cp_async16(smem_u32(sc + r * NS + ch * 8), cb + (t0 + (in ? q0 + r : 0)) * bc_row + ch * 8,
               in);
  }
  // B and x rows of key tile t (x columns [p0, p0 + pw)) into buffer buf
  auto load_keys = [&](int t, int buf, int p0, int pw) {
    for (int c = tid; c < kRows * nch; c += kMmaThreads) {
      const int r = c / nch, ch = c - r * nch;
      const int k = t * kRows + r;
      const bool in = k < d.q;
      cp_async16(smem_u32(sb + buf * buf_elems + r * NS + ch * 8),
                 bb + (t0 + (in ? k : 0)) * bc_row + ch * 8, in);
    }
    const int xch = pw / 8;
    for (int c = tid; c < kRows * xch; c += kMmaThreads) {
      const int r = c / xch, ch = c - r * xch;
      const int k = t * kRows + r;
      const bool in = k < d.q;
      cp_async16(smem_u32(sx + buf * buf_elems + r * kXStride + ch * 8),
                 xb + (t0 + (in ? k : 0)) * x_row + p0 + ch * 8, in);
    }
  };
  // The carried state's term, exp(cum_q)·C_q·S_inᵀ, is split over the
  // warps by columns: warp w takes all 64 rows × S_in rows [p0 + 16w, p0 +
  // 16w + 16), its B fragments read straight from the fp32 scratch (each
  // warp its own 8 KB at P = 64, N = 128; no shared memory) and split into
  // hi and lo in registers. b0 of n-tile jj at k-step kk is S_in[p0 + 16w +
  // 8·jj + gr][16·kk + 2·tig, + 1], b1 the same + 8. Up to 8 k-steps are
  // read at once.
  float2 sfr[8][2][2];
  auto load_state = [&](int p0, int pw, int kc) {
    const int pc = 16 * warp;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (pc < pw && kc + kk < ksteps) {
          const float* src =
              st + static_cast<int64_t>(p0 + pc + 8 * jj + gr) * d.n + 16 * (kc + kk) + 2 * tig;
          sfr[kk][jj][0] = *reinterpret_cast<const float2*>(src);
          sfr[kk][jj][1] = *reinterpret_cast<const float2*>(src + 8);
        }
      }
    }
  };

  // A and dt first, so that their loads do not queue behind the copies; then the
  // first pass's key tile 0 and state fragments, in flight while cum is
  // formed
  const float av = a[b * d.h + h];
  float dv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kMmaThreads;
    dv[j] = i < d.q ? dt[(t0 + i) * d.h + h] : 0.f;
  }
  load_keys(0, 0, 0, min(kCols, d.p));
  cp_async_commit();  // C and key tile 0
  if (carry) load_state(0, min(kCols, d.p), 0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kMmaThreads;
    if (i < q64) {
      sdt[i] = dv[j];
      cum[i] = __fmul_rn(dv[j], av);
    }
  }
  for (int i = tid + 2 * kMmaThreads; i < q64; i += kMmaThreads) {
    const float v = i < d.q ? dt[(t0 + i) * d.h + h] : 0.f;
    sdt[i] = v;
    cum[i] = __fmul_rn(v, av);
  }
  __syncthreads();
  scan_da(cum, d.q);  // zeros past Q stay zeros
  SSD_MARK(1);

  // per-lane ldmatrix offsets (elements): C (the A operand) rows lane & 15,
  // column half lane >> 4; B (the B operand from a row-major (key, n) tile)
  // rows (lane & 7) + 8·(lane >> 4), column half (lane >> 3) & 1; x (the B
  // operand through .trans) rows (lane & 7) + 8·((lane >> 3) & 1), column
  // half lane >> 4
  const uint32_t c_base = smem_u32(sc + (lane & 15) * NS + (lane >> 4) * 8);
  const uint32_t c_addr = c_base + warp * 16 * NS * 2;  // the warp's 16 rows
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * NS + ((lane >> 3) & 1) * 8;
  const int x_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kXStride + (lane >> 4) * 8;
  const int r0 = warp * 16 + gr;  // this thread's rows r0 and r0 + 8 of the tile
  const float cq0 = cum[q0 + r0], cq1 = cum[q0 + r0 + 8];

  for (int p0 = 0; p0 < d.p; p0 += kCols) {
    const int pw = min(kCols, d.p - p0), pt = pw / 8;  // columns, n-tiles (even)
    if (p0 > 0) {  // the last pass ended on a barrier: every buffer is free
      load_keys(0, 0, p0, pw);
      cp_async_commit();
      if (carry) load_state(p0, pw, 0);
    }
    float acc[kCols / 8][4];
    if (!carry) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    } else {
      cp_async_wait<0>();  // C (and key tile 0)
      __syncthreads();
      SSD_MARK(2);
      // columns [16w, 16w + 16) of the pass, all 64 rows: 4 m-tiles × 2
      // n-tiles, S_in as hi + lo
      float off[4][2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) off[mt][jj][0] = off[mt][jj][1] = off[mt][jj][2] =
                                           off[mt][jj][3] = 0.f;
      const bool cols_live = 16 * warp < pw;
      for (int kc = 0; kc < ksteps; kc += 8) {
        if (kc > 0) load_state(p0, pw, kc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (cols_live && kc + kk < ksteps) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                split2(sfr[kk][jj][i].x, sfr[kk][jj][i].y, bh[jj][i], bl[jj][i]);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              uint32_t af[4];
              ldsm_x4(c_base + (mt * 16 * NS + (kc + kk) * 16) * 2, af);
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                mma_bf16(off[mt][jj], af, bh[jj][0], bh[jj][1]);
                mma_bf16(off[mt][jj], af, bl[jj][0], bl[jj][1]);
              }
            }
          }
        }
      }
      // to the row layout through buffer 1 (free until key tile 1 is
      // issued below)
      if (cols_live) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float* o = turn + (mt * 16 + gr) * kTurnStride + 16 * warp + 8 * jj + 2 * tig;
            *reinterpret_cast<float2*>(o) = make_float2(off[mt][jj][0], off[mt][jj][1]);
            *reinterpret_cast<float2*>(o + 8 * kTurnStride) =
                make_float2(off[mt][jj][2], off[mt][jj][3]);
          }
      }
      __syncthreads();
      const float e0 = expf(cq0), e1 = expf(cq1);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        if (j < pt) {
          const float* o = turn + r0 * kTurnStride + 8 * j + 2 * tig;
          const float2 u0 = *reinterpret_cast<const float2*>(o);
          const float2 u1 = *reinterpret_cast<const float2*>(o + 8 * kTurnStride);
          acc[j][0] = u0.x * e0;
          acc[j][1] = u0.y * e0;
          acc[j][2] = u1.x * e1;
          acc[j][3] = u1.y * e1;
        }
      }
      __syncthreads();  // buffer 1 is free again
      SSD_MARK(3);
    }

    for (int t = 0; t <= qt; ++t) {  // key tiles 0..qt: the keys at or below the rows
      const int buf = t & 1;
      if (t < qt) load_keys(t + 1, buf ^ 1, p0, pw);
      cp_async_commit();
      cp_async_wait<1>();  // everything but key tile t + 1 has landed
      __syncthreads();
      if (warp_live) {
        // scores C·Bᵀ over key tile t; on the diagonal tile (t == qt) only
        // the key n-tiles up to the warp's last row hold a live pair
        const bool diag = t == qt;
        const int live_nt = diag ? 2 * warp + 2 : kRows / 8;
        const uint32_t b_addr = smem_u32(sb + buf * buf_elems + k_lane);
        float s[kRows / 8][4];
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < ksteps; ++kk) {
          uint32_t af[4];
          ldsm_x4(c_addr + kk * 32, af);
#pragma unroll
          for (int j = 0; j < kRows / 8; j += 2) {
            if (j < live_nt) {
              uint32_t bk[4];
              ldsm_x4(b_addr + (j * 8 * NS + kk * 16) * 2, bk);
              mma_bf16(s[j], af, bk[0], bk[1]);
              mma_bf16(s[j + 1], af, bk[2], bk[3]);
            }
          }
        }
        // scaled by exp(cum_q - cum_k) dt_k on live pairs (k <= q), else 0
        const int k0 = t * kRows;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          if (j < live_nt) {
            const int kj = k0 + j * 8 + 2 * tig;
            const float2 ck = *reinterpret_cast<const float2*>(cum + kj);
            const float2 dk = *reinterpret_cast<const float2*>(sdt + kj);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0 + r0 + (e >> 1) * 8;
              const float cq = e < 2 ? cq0 : cq1;
              const float c_k = e & 1 ? ck.y : ck.x, d_k = e & 1 ? dk.y : dk.x;
              s[j][e] = !diag || kj + (e & 1) <= qi ? s[j][e] * (expf(cq - c_k) * d_k) : 0.f;
            }
          }
        }
        // acc += scores·x: score n-tiles 2kk and 2kk + 1 are the A fragment
        // of k-step kk, as hi and lo
        const uint32_t x_addr = smem_u32(sx + buf * buf_elems + x_lane);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          if (2 * kk < live_nt) {
            uint32_t ah[4], al[4];
            split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
            split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
            split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
            split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < kCols / 8; j += 2) {
              if (j < pt) {
                uint32_t bv[4];
                ldsm_x4_trans(x_addr + (kk * 16 * kXStride + j * 8) * 2, bv);
                mma_bf16(acc[j], ah, bv[0], bv[1]);
                mma_bf16(acc[j], al, bv[0], bv[1]);
                mma_bf16(acc[j + 1], ah, bv[2], bv[3]);
                mma_bf16(acc[j + 1], al, bv[2], bv[3]);
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with buf before tile t + 2 lands in it
    }
    cp_async_wait<0>();
    SSD_MARK(4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r0 + 8 * i;
      if (q < d.q) {
        bf16* yrow = y + ((t0 + q) * d.h + h) * d.p + p0 + 2 * tig;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          if (j < pt)
            *reinterpret_cast<__nv_bfloat162*>(yrow + j * 8) =
                __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }
  }
  SSD_MARK(5);
}

template <typename K>
cudaError_t allow_max_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  done = err == cudaSuccess;
  return err;
}

int run_state_pass(float* states, const float* cum_last, const float* s0, float* s_final,
                   const Dims& d, cudaStream_t stream) {
  const int pn = d.p * d.n;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(states) |
                          reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s_final);
  if (pn % 4 == 0 && bases % 16 == 0) {
    const dim3 grid((pn / 4 + kThreads - 1) / kThreads, d.h, d.b);
    ssd_state_pass<float4><<<grid, kThreads, 0, stream>>>(states, cum_last, s0, s_final, d);
  } else {
    const dim3 grid((pn + kThreads - 1) / kThreads, d.h, d.b);
    ssd_state_pass<float><<<grid, kThreads, 0, stream>>>(states, cum_last, s0, s_final, d);
  }
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
        const float* s0, void* y, float* s_final, float* states, float* cum_last,
        const Dims& d, int stage, cudaStream_t stream) {
  static bool state_ready = false, out_ready = false;
  const dim3 grid(d.c, d.h, d.b);
  if (stage == 0) {
    const cudaError_t err = allow_max_smem(ssd_chunk_state<T>, state_ready);
    if (err != cudaSuccess) return err;
    ssd_chunk_state<T><<<grid, kThreads, state_smem(d), stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), states, cum_last, d);
  } else if (stage == 1) {
    return run_state_pass(states, cum_last, s0, s_final, d, stream);
  } else {
    const cudaError_t err = allow_max_smem(ssd_chunk_out<T>, out_ready);
    if (err != cudaSuccess) return err;
    ssd_chunk_out<T><<<grid, kThreads, out_smem(d), stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
        static_cast<const T*>(cm), states, static_cast<T*>(y), d);
  }
  return cudaGetLastError();
}

// the same stages with the tensor-core kernels (bf16, P % 16 == N % 16 == 0)
int run_mma(const bf16* x, const float* dt, const float* a, const bf16* bm, const bf16* cm,
            const float* s0, bf16* y, float* s_final, float* states, float* cum_last,
            const Dims& d, int stage, cudaStream_t stream) {
  static bool state_ready = false, out_ready = false;
  if (stage == 0) {
    const cudaError_t err = allow_max_smem(ssd_chunk_state_mma, state_ready);
    if (err != cudaSuccess) return err;
    ssd_chunk_state_mma<<<dim3(d.c, d.h, d.b), kMmaThreads, mma_state_smem(d), stream>>>(
        x, dt, a, bm, states, cum_last, d);
  } else if (stage == 1) {
    return run_state_pass(states, cum_last, s0, s_final, d, stream);
  } else {
    const cudaError_t err = allow_max_smem(ssd_chunk_out_mma, out_ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks =
        static_cast<int64_t>(round_up(d.q, kRows) / kRows) * d.c * d.h * d.b;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    ssd_chunk_out_mma<<<static_cast<unsigned>(blocks), kMmaThreads, mma_out_smem(d), stream>>>(
        x, dt, a, bm, cm, states, s0, y, d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One stage of the scan (0: chunk states, 1: state pass, 2: outputs), all
// tensors contiguous: x (B, L, H, P), bm/cm (B, L, G, N) of one dtype (fp32,
// bf16 = 0; bf16, bf16 = 1); dt (B, L, H), a (B, H), s0 (B, H, P, N) or
// null, s_final (B, H, P, N), states (B, L/Q, H, P, N) and cum_last
// (B, L/Q, H) scratch, all fp32; y (B, L, H, P) in x's dtype. bf16 with P
// and N multiples of 16 runs the tensor-core kernels, whose 16-byte copies
// need x, bm, cm and y to start on a 16-byte boundary
// (cudaErrorMisalignedAddress otherwise); every other input the CUDA-core
// kernels. Returns cudaGetLastError() after the launch.
int ssd_scan_stage(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const float* s0, void* y, float* s_final, float* states,
                   float* cum_last, int b, int l, int h, int g, int p, int n, int chunk,
                   int bf16, int stage, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      chunk <= 0 || l % chunk != 0 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const Dims d{b, l, h, g, p, n, chunk, l / chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_mma(bf16, d)) {
    if (mma_state_smem(d) > kMaxSmem || mma_out_smem(d) > kMaxSmem) return cudaErrorInvalidValue;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                            reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y);
    if (bases % 16 != 0) return cudaErrorMisalignedAddress;
    return run_mma(static_cast<const __nv_bfloat16*>(x), dt, a,
                   static_cast<const __nv_bfloat16*>(bm), static_cast<const __nv_bfloat16*>(cm),
                   s0, static_cast<__nv_bfloat16*>(y), s_final, states, cum_last, d, stage, s);
  }
  if (state_smem(d) > kMaxSmem || out_smem(d) > kMaxSmem) return cudaErrorInvalidValue;
  return bf16 ? run<__nv_bfloat16>(x, dt, a, bm, cm, s0, y, s_final, states, cum_last, d,
                                   stage, s)
              : run<float>(x, dt, a, bm, cm, s0, y, s_final, states, cum_last, d, stage, s);
}

}  // extern "C"
