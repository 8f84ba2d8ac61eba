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
// the products run on the tensor cores and the loads are kept in flight
// under them.
//
// The scheme: two launches a call, on every route.
//   0. the state walk: one block per (column slice of the state, head,
//      batch) walks the chunks in order and keeps its slice of the state on
//      chip, as the TPU kernel carries it in VMEM: at chunk c it publishes
//      S_in(c) (the state entering the chunk) to the scratch `states`, then
//      S <- exp(cum_Q) S + sum_q w_q x_q B_qᵀ, w_q = exp(cum_Q - cum_q) dt_q;
//      at the end it writes the final state. Column slices of the state are
//      independent, which gives the walk B·H·N/cols blocks (cols 64 or 128).
//      It also writes each token's cum and dt, head-major ((B, H, L)
//      scratch), for stage 1.
//   1. the outputs: the intra-chunk dual form and the carried state's term
//      exp(cum_q) C_q·S_inᵀ, y in x's dtype; chunks in parallel.
// So the chunk states cross L2 twice, written once by the walk and read
// once by the outputs (chunk states from a parallel stage and a separate
// inter-chunk pass would move them four times: written, read and rewritten,
// read). No floating-point atomics anywhere: two calls give the same bits.
// The walk is sequential over the chunks of a (head, batch) only: at one
// request and a long prompt (L = 4,096, 32 chunks) its 64 blocks each take
// 32 steps, while the outputs have 32 chunks × heads of parallel work.
//
// Routes: a fixed rule of (dtype, P, N), the wrapper's route(), passed in
// as `route` (its index in the wrapper's ROUTES):
// - 2, bf16, P = 64, N a multiple of 64: ssd_state_wgmma + ssd_out_wgmma;
// - 1, fp32, P and N multiples of 16: ssd_state_tf32 + ssd_out_tf32;
// - 0, every other shape (either dtype): ssd_state_walk + ssd_chunk_out,
//   the CUDA cores (no configured model has such a shape).
// cum is the same scan in every kernel that forms it (scan_warp: one warp,
// lane l adding its run of ceil(Q/32) consecutive tokens, a shuffle scan of
// the 32 run totals, then each lane its run's prefix sums from its offset).
//
// bf16 splits (route 2). x, B and C arrive in bf16, so C·Bᵀ is exact
// products with fp32 sums. Each of the other three products has one fp32
// operand: the scaled score (C_q·B_k) exp(cum_q - cum_k) dt_k, the carried
// state S_in, the weighted input w_q x_q. Rounding it once to bf16 moves a
// term by up to 2^-9 of itself (~0.006 rms in y at unit-normal inputs, past
// the 2e-3 absolute bound where |y| is small). So each is split into a bf16
// pair, hi = bf16(v) and lo = bf16(v - hi), both rounded to nearest even,
// and multiplied by the exact bf16 operand twice (hi, then lo): the error
// drops to about 2^-17 of the term. The other operand is always exact, so
// there is no lo·lo term to drop. All sums are fp32.
//
// ssd_state_wgmma (route 2, stage 0): block (N/cols column slices, H, B),
// cols = 128 where the wrapper's walk_cols finds a block for most SMs that
// way (x read once a head, m64n128 products), else 64; one consumer
// warpgroup, a TMA warp and a parameter warp.
// - The TMA warp's lane 0 keeps a ring of 4 token tiles full: x (64 tokens
//   × P) and B (64 tokens × the block's cols of N) arrive by TMA (4-d
//   tensor maps over (P, H, L, B) and (N, G, L, B), 128-byte swizzled boxes
//   zero-filled past L) on the slot's full mbarrier; the consumers free a
//   slot with one arrival on its empty mbarrier.
// - The parameter warp forms each chunk's w_q and exp(cum_Q) (dt by 4-byte
//   cp.async three chunks ahead, the scan, expf) into a ring of 4 parameter
//   slots with their own mbarriers, so the consumers never wait on a scan.
// - The consumers hold their 64 × cols slice of the state in the wgmma
//   accumulator (cols / 2 fp32 registers a thread). A chunk: publish S_in,
//   scale by exp(cum_Q), then for each token tile 4 k-steps of wgmma
//   m64n{cols}k16
//   with A = (w x)ᵀ from registers (ldmatrix.trans of the swizzled
//   token-major x tile, each element times its token's w_q, split hi/lo:
//   two products a k-step) and B = the B tile through the transpose bit;
//   tile t + 1's fragments are formed while tile t's products run. Tokens
//   past the chunk (a ragged Q) weigh 0.
// - S_in is published as the outputs kernel's operand: a hi/lo bf16 image of
//   the (P, N) state, for each 64-column panel its hi panel then its lo
//   panel (P rows × 128 bytes, 128-byte swizzled: row p's 16-byte chunk j at
//   j ^ (p % 8)), the same 4 bytes an entry as fp32. The consumers write it
//   into a shared staging buffer (two, in turn) and one thread stores the
//   block's panels with one bulk copy (scattered 4-byte global stores of the
//   fragments made the walk 60 % slower on the card). The split is made
//   once per chunk, in the walk, not once per query tile.
//
// ssd_out_wgmma (route 2, stage 1). Block = (pair of 64-row query tiles,
// chunk, group of hb heads of one B/C group, batch), a one-dimensional grid
// with the last row pairs first (they see the most keys); two consumer
// warpgroups (one query tile each, setmaxnreg 232) and a producer
// warpgroup (setmaxnreg 40) of which one warp works.
// - The heads of a group share B and C, so they share the C rows, the key
//   tiles of B and the raw scores C·Bᵀ: the block stages them once (TMA,
//   one mbarrier), and the warpgroups form the pair's three score tiles
//   once (wgmma m64n64k16, both operands K-major in shared memory: query
//   tile 0's diagonal, query tile 1's diagonal and previous) into shared
//   memory (in B's place where they fit there), kept over the hb heads;
//   keys further back, only at Q > 128, are formed again a head. The
//   warpgroups swap query tiles head by head, so each takes the tile with
//   two key tiles every other head (with fixed tiles the second did 4/3 of
//   the first's products a head, and the first waited). hb is the
//   wrapper's heads_per_block: a function of the shape and the SM count.
// - Per head, a ring of up to 4 slots (as many as fit): the head's x tiles
//   (TMA), its S_in image (one bulk copy, when it has a carried state: a
//   chunk past the first, or an initial state), and its cum·log2(e) and dt
//   (the walk's scratch, by the producer warp's 4-byte cp.async, which
//   arrive on the slot's barrier as they land). The next heads' loads run
//   under this head's products.
// - Per head and warpgroup: acc = C·S_inᵀ as one wgmma m64n128k16 a k-step
//   over the image's hi and lo panels stacked (N = 64 + 64), the halves
//   summed and times 2^(cum_q·log2 e) per row; then per key tile at or
//   below the rows the raw scores times 2^((cum_q - cum_k)·log2 e)·dt_k on
//   live pairs and 0 on dead ones, split hi/lo straight from the
//   accumulator layout into the A fragments of wgmma m64n64k16 with x (the
//   transpose bit) as B. y in bf16 from the fp32 accumulator. Rows past Q
//   are never stored; keys past Q are dead; tiles past L are zero-filled.
// - Registers and ptxas: a block of 288 threads got no more than the 168
//   registers a thread of a 384-thread block, and spilled; it allots 168
//   here too, and the variants that kept more live (the next tile's
//   fragments beside this one's, the scores in registers beside a second
//   set) spilled or serialised their wgmma (C7512). An array that is a
//   wgmma accumulator on one branch and filled by loads on another made
//   ptxas serialise every wgmma of the kernel (C7515): each accumulator
//   here is written by wgmma alone (the recomputed scores have their own).
//
// fp32 (route 1): 3xTF32 on mma.sync m16n8k8. Each fp32 operand v is split
// into hi = v with its 13 low mantissa bits cleared (a tf32 value) and lo
// = v - hi (exact in fp32; the tensor core reads it as tf32 by ignoring the
// same 13 bits, so lo counts to 2^-10 of itself), two integer/fp32 ops and
// no cvt; each product sums lo·hi + hi·lo + hi·hi with fp32 accumulation
// (lo·lo dropped): about 2^-20 of each term, far inside the 2e-3 bound
// where one TF32 product is not. The three products of a k-step are issued
// over all n-tiles in turn (lo·hi of every n-tile, then hi·lo, then hi·hi),
// so back-to-back mma.sync write different accumulators (issued product by
// product, each waits on the one before). mma.sync and not wgmma: wgmma's
// tf32 form takes both operands K-major from shared memory, so x and B
// (token-major) would need transposed copies and each operand's hi and lo
// parts their own shared tiles; mma.sync takes fragments from registers,
// where the split is made
// as they are loaded (kernel 8's flash_tf32_kernel does the same).
// - ssd_state_tf32: block (64 rows of P × 64 columns of N, H, B), 4 warps of
//   16 state rows (acc 8 n-tiles × 4 registers); token tiles of 32 and each
//   chunk's dt by cp.async in a ring of 4 stages; A = (w x)ᵀ, B = the B
//   tile; publishes S_in as fp32.
// - ssd_out_tf32: block (64 query rows, chunk, head, batch), 4 warps of 16
//   rows; C rows, key tile 0 and S_in (in the place of key buffer 1) by one
//   cp.async group, cum and dt from the walk's scratch. The carried term
//   C·S_inᵀ, then per 32-key tile at or below a warp's rows the scores
//   C·Bᵀ, scaled and zeroed as above, as the A operand of ·x: a score
//   n-tile's two values of a row are its k slots tig and tig + 4 with x's
//   rows permuted the same way, so no shuffle. P in passes of 64 columns.
//   Row strides pad by 4 floats (C, B, S_in, x) or 8 (the walk's x and B)
//   so that every fragment load hits 32 banks.
//
// CUDA-core kernels (route 0), the first design: ssd_state_walk stages a
// chunk's w x (64 columns of P) and B (128 columns of N) in shared memory
// and adds it into register tiles (a warp 8 state rows, a lane every 32nd
// column); ssd_chunk_out tiles the Q × Q scores by 32 query rows. Products
// are plain fp32 FMAs.
//
// What bounds it now (tools/ssd_probe.py on the card, mamba2-370m's
// prefill layer): the outputs kernel's heads take 2.9 µs each against 2.0
// µs of their products at the bf16 tensor-core peak (one block an SM, two
// warpgroups, the scaling and splits of the scores between products); the
// walk (one block an SM, 128 columns) spends a fifth of its life before its
// first tile (dt and the first tiles from memory) and the rest on its
// products, one warpgroup waiting on each tile's. fp32: mma.sync's tf32
// rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // CUDA-core kernels
constexpr int kTQ = 32;        // query rows per score tile (ssd_chunk_out): 8 warps × 4
static_assert(kThreads == 8 * 32 && kTQ == 4 * (kThreads / 32), "4 tile rows a warp");
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// route 1 (3xTF32)
constexpr int kTfThreads = 128;  // 4 warps
constexpr int kTfTok = 32;       // tokens per tile of the walk
constexpr int kTfKeys = 32;      // keys per tile of the outputs
constexpr int kTfRows = 64;      // query rows per output block (4 warps × 16)
constexpr int kTfCols = 64;      // state columns per walk block, y columns per pass
constexpr int kTfStages = 4;     // token tiles (and chunk dt) in flight in the walk

// route 2 (wgmma)
constexpr int kWgStages = 4;             // the walk's ring of token tiles
constexpr int kParamSlots = 4;           // the walk's ring of chunk parameters
constexpr int kTile = 64 * 128;          // one 128-byte-swizzled panel of 64 rows: a TMA box
constexpr int kStateThreads = 128 + 64;  // a consumer warpgroup, a TMA and a parameter warp
constexpr int kOutThreads = 3 * 128;     // two consumer warpgroups + a producer warpgroup
constexpr int kOutSlots = 4;             // the most head slots in ssd_out_wgmma's ring

enum Route { kCudaCore = 0, kTf32 = 1, kWgmma = 2 };

using bf16 = __nv_bfloat16;

// Phase marks (thread 0 of a block): empty here; tools/ssd_probe.cu defines
// it before including this file, to time a block's phases.
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
__host__ __device__ __forceinline__ int div_up(int v, int m) { return (v + m - 1) / m; }

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// In place over da[0, q) (dt·A per token, fp32): the inclusive prefix
// sums, by the 32 lanes of one warp, so the order of the adds depends on q
// only: lane l adds its run [l·r, l·r + r) of r = ceil(q / 32) tokens in
// order, a Hillis–Steele scan over shuffles gives the run totals'
// inclusive sums, and each lane writes its run's prefix sums from the sum
// of the runs before it. The adds are __fadd_rn (never fused). The warp's
// writes to da must precede the call (__syncwarp); ends with __syncwarp.
__device__ void scan_warp(float* da, int q, int lane) {
  const int r = (q + 31) / 32;
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
  __syncwarp();
}

// scan_warp by warp 0 of the block; ends with a barrier
__device__ void scan_da(float* da, int q) {
  if (threadIdx.x < 32) scan_warp(da, q, threadIdx.x);
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

// (v0, v1) split into bf16 pairs, hi = bf16(v) and lo = bf16(v - hi), both
// rounded to nearest even and packed as an mma fragment holds a row's two
// columns (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// route 0: the CUDA cores
// ---------------------------------------------------------------------------

// ssd_state_walk: w x (Q × min(P, 64)), B (Q × min(N, 128)), cum (Q) floats
size_t walk_smem(const Dims& d) {
  return static_cast<size_t>(d.q) * (min(d.p, 64) + min(d.n, 128) + 1) * sizeof(float);
}

size_t out_smem(const Dims& d) {
  return (static_cast<size_t>(d.q) * (d.n + 1) + static_cast<size_t>(d.q) * d.p +
          static_cast<size_t>(d.p) * (d.n + 1) + static_cast<size_t>(kTQ) * d.n +
          static_cast<size_t>(kTQ) * d.q + d.q) *
         sizeof(float);
}

// Block (64 × 128 tile of the state, head, batch); warp w takes 8 state
// rows, lane l the columns l + 32j (j < 4).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_walk(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const float* __restrict__ s0, float* __restrict__ states,
               float* __restrict__ s_final, Dims d) {
  extern __shared__ float smem[];
  const int ps = min(d.p, 64), ns = min(d.n, 128);  // row strides of the staged tiles
  float* xw = smem;             // (Q, ps): x_q · exp(cum_Q - cum_q) · dt_q
  float* bs = xw + d.q * ps;    // (Q, ns)
  float* cum = bs + d.q * ns;   // (Q)
  const int n_nt = (d.n + 127) / 128;
  const int p0 = static_cast<int>(blockIdx.x) / n_nt * 64;
  const int n0 = static_cast<int>(blockIdx.x) % n_nt * 128;
  const int pw = min(64, d.p - p0), nw = min(128, d.n - n0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g);
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = warp * 8 + i, nn = lane + 32 * j;
      acc[i][j] = s0 != nullptr && pp < pw && nn < nw
                      ? s0[(bh * d.p + p0 + pp) * d.n + n0 + nn]
                      : 0.f;
    }
  for (int ci = 0; ci < d.c; ++ci) {
    // S_in(ci): every chunk's, ssd_chunk_out reads them all
    float* out = states + ((static_cast<int64_t>(b) * d.c + ci) * d.h + h) * d.p * d.n;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = warp * 8 + i, nn = lane + 32 * j;
        if (pp < pw && nn < nw) out[(p0 + pp) * d.n + n0 + nn] = acc[i][j];
      }
    const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
    chunk_cum(cum, dt, a[bh], t0, h, d.h, d.q);  // its first barrier ends the last chunk's sums
    const float last = cum[d.q - 1];
    for (int i = threadIdx.x; i < d.q * ps; i += blockDim.x) {
      const int r = i / ps, pp = i - r * ps;
      const float w = expf(last - cum[r]) * dt[(t0 + r) * d.h + h];
      xw[i] = pp < pw ? to_f32(x[((t0 + r) * d.h + h) * d.p + p0 + pp]) * w : 0.f;
    }
    for (int i = threadIdx.x; i < d.q * ns; i += blockDim.x) {
      const int r = i / ns, nn = i - r * ns;
      bs[i] = nn < nw ? to_f32(bm[((t0 + r) * d.g + grp) * d.n + n0 + nn]) : 0.f;
    }
    __syncthreads();
    const float decay = expf(last);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
#pragma unroll 4
    for (int r = 0; r < d.q; ++r) {
      float xv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = warp * 8 + i < ps ? xw[r * ps + warp * 8 + i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = lane + 32 * j < ns ? bs[r * ns + lane + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = warp * 8 + i, nn = lane + 32 * j;
      if (pp < pw && nn < nw) s_final[(bh * d.p + p0 + pp) * d.n + n0 + nn] = acc[i][j];
    }
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
// route 1: fp32 in 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (a tf32
// value), lo = x - hi exactly, passed as fp32 bits: the tensor core reads
// a tf32 operand by ignoring the same 13 bits, so lo counts truncated to
// tf32 (2^-10 of itself, ~2^-20 of x). Two integer/fp32 ops, no cvt.
__device__ __forceinline__ void split_tz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void tz_frag(float a0, float a1, float a2, float a3,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tz(a0, hi[0], lo[0]);
  split_tz(a1, hi[1], lo[1]);
  split_tz(a2, hi[2], lo[2]);
  split_tz(a3, hi[3], lo[3]);
}

// acc[j] += a · b_j (mma.sync m16n8k8 tf32) for the n-tiles j < nt in
// 3xTF32: lo·hi, then hi·lo, then hi·hi, each over all n-tiles in turn, so
// that back-to-back products write different accumulators
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&acc)[NT][4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[NT][2],
                                           const uint32_t (&blo)[NT][2], int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j], ahi, bhi[j][0], bhi[j][1]);
}

// ssd_state_tf32: a ring of kTfStages x tiles (kTfTok, 64 + 8), B tiles
// (kTfTok, kTfCols + 8) and chunk dt (Q), then cum Q, w ceil32(Q) (floats)
size_t tf32_state_smem(const Dims& d) {
  return (kTfStages * (static_cast<size_t>(kTfTok) * (64 + 8) + kTfTok * (kTfCols + 8) + d.q) +
          static_cast<size_t>(d.q) + round_up(d.q, kTfTok)) *
         sizeof(float);
}

// ssd_out_tf32: C (kTfRows, N + 4), key buffer 0 (B (kTfKeys, N + 4), x
// (kTfKeys, P + 4)), key buffer 1 (as large, or S_in (P, N + 4) if larger),
// cum and dt (ceil64(Q) each)
__host__ __device__ __forceinline__ size_t tf32_key_floats(int p, int n) {
  return static_cast<size_t>(kTfKeys) * (n + 4) + static_cast<size_t>(kTfKeys) * (p + 4);
}
size_t tf32_out_smem(const Dims& d) {
  const size_t buf = tf32_key_floats(d.p, d.n), sin = static_cast<size_t>(d.p) * (d.n + 4);
  return (static_cast<size_t>(kTfRows) * (d.n + 4) + buf + (buf > sin ? buf : sin) +
          2 * static_cast<size_t>(round_up(d.q, kTfRows))) *
         sizeof(float);
}

__global__ void __launch_bounds__(kTfThreads)
ssd_state_tf32(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ s0, float* __restrict__ states,
               float* __restrict__ s_final, float* __restrict__ cum_out,
               float* __restrict__ dt_out, Dims d) {
  extern __shared__ __align__(16) float tf_smem[];
  constexpr int XS = 64 + 8, BS = kTfCols + 8;  // row strides (floats): 32 banks a fragment
  float* sx = tf_smem;                          // kTfStages × (kTfTok, XS)
  float* sb = sx + kTfStages * kTfTok * XS;     // kTfStages × (kTfTok, BS)
  float* sdt = sb + kTfStages * kTfTok * BS;    // kTfStages × Q: a chunk's dt
  float* cum = sdt + kTfStages * d.q;           // Q
  float* w = cum + d.q;                         // ceil32(Q): w_q, 0 past Q
  const int n_nt = div_up(d.n, kTfCols);
  const int p0 = static_cast<int>(blockIdx.x) / n_nt * 64;
  const int n0 = static_cast<int>(blockIdx.x) % n_nt * kTfCols;
  const int pw = min(64, d.p - p0), nw = min(kTfCols, d.n - n0);  // multiples of 16
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g);
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int tiles = div_up(d.q, kTfTok), nt = nw / 8, n_tiles = d.c * tiles;
  const bool rows_live = 16 * warp < pw;  // pw is a multiple of 16
  const float av = a[bh];
  SSD_MARK(0);

  // the state's rows p0 + 16·warp + gr (+ 8), columns n0 + 8j + 2·tig (+ 1)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = p0 + 16 * warp + gr + 8 * (e >> 1), nn = n0 + 8 * j + 2 * tig + (e & 1);
      acc[j][e] = s0 != nullptr && rows_live && j < nt ? s0[(bh * d.p + pp) * d.n + nn] : 0.f;
    }

  // Token tile t (tokens [c·Q + 32j, + 32) of batch b, zero past L) into
  // stage t % kTfStages, with the chunk's dt beside its first tile: one
  // cp.async group a tile (an empty one past the last)
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int c = t / tiles, j = t % tiles, st = t % kTfStages;
      const int tok0 = c * d.q + kTfTok * j;
      if (j == 0) {
        float* dst = sdt + (c % kTfStages) * d.q;
        const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(c) * d.q;
        for (int i = tid; i < d.q; i += kTfThreads)
          cp_async4(smem_u32(dst + i), dt + (t0 + i) * d.h + h);
      }
      const int xch = pw / 4, bch = nw / 4;  // 16-byte chunks a row
      for (int k = tid; k < kTfTok * xch; k += kTfThreads) {
        const int r = k / xch, ch = k - r * xch;
        const int tok = tok0 + r;
        const bool in = tok < d.l;
        const int64_t row = static_cast<int64_t>(b) * d.l + (in ? tok : 0);
        cp_async16(smem_u32(sx + (st * kTfTok + r) * XS + ch * 4),
                   x + (row * d.h + h) * d.p + p0 + ch * 4, in);
      }
      for (int k = tid; k < kTfTok * bch; k += kTfThreads) {
        const int r = k / bch, ch = k - r * bch;
        const int tok = tok0 + r;
        const bool in = tok < d.l;
        const int64_t row = static_cast<int64_t>(b) * d.l + (in ? tok : 0);
        cp_async16(smem_u32(sb + (st * kTfTok + r) * BS + ch * 4),
                   bm + (row * d.g + grp) * d.n + n0 + ch * 4, in);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kTfStages - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    const int c = t / tiles, j = t % tiles, st = t % kTfStages;
    issue(t + kTfStages - 1);  // into the stage tile t - 1 freed
    cp_async_wait<kTfStages - 1>();  // tile t (and, at j = 0, its chunk's dt)
    __syncthreads();
    if (j == 0) {
      const float* dtc = sdt + (c % kTfStages) * d.q;
      for (int i = tid; i < d.q; i += kTfThreads) cum[i] = __fmul_rn(dtc[i], av);
      __syncthreads();
      scan_da(cum, d.q);
      const float last = cum[d.q - 1];
      const int64_t o0 = bh * d.l + static_cast<int64_t>(c) * d.q;
      for (int i = tid; i < round_up(d.q, kTfTok); i += kTfThreads) {
        w[i] = i < d.q ? expf(last - cum[i]) * dtc[i] : 0.f;
        if (blockIdx.x == 0 && i < d.q) {  // cum and dt, head-major, for ssd_out_tf32
          cum_out[o0 + i] = cum[i];
          dt_out[o0 + i] = dtc[i];
        }
      }
      // publish S_in(c): ssd_out_tf32 reads it for a chunk past the first,
      // or with an initial state
      if ((c > 0 || s0 != nullptr) && rows_live) {
        float* out = states + ((static_cast<int64_t>(b) * d.c + c) * d.h + h) * d.p * d.n;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          if (jn < nt) {
            const int pp = p0 + 16 * warp + gr, nn = n0 + 8 * jn + 2 * tig;
            *reinterpret_cast<float2*>(out + static_cast<int64_t>(pp) * d.n + nn) =
                make_float2(acc[jn][0], acc[jn][1]);
            *reinterpret_cast<float2*>(out + static_cast<int64_t>(pp + 8) * d.n + nn) =
                make_float2(acc[jn][2], acc[jn][3]);
          }
        }
      }
      const float decay = expf(last);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] *= decay;
      __syncthreads();  // w
      if (c == 0) SSD_MARK(1);
    }
    if (rows_live) {
      const float* xt = sx + st * kTfTok * XS + 16 * warp + gr;
      const float* bt = sb + st * kTfTok * BS + gr;
      const float* wt = w + kTfTok * j;
#pragma unroll
      for (int kk = 0; kk < kTfTok / 8; ++kk) {
        const int k0 = 8 * kk;
        const float w0 = wt[k0 + tig], w1 = wt[k0 + tig + 4];
        // A = (w x)ᵀ: rows p (gr, gr + 8), columns tokens (tig, tig + 4)
        uint32_t ahi[4], alo[4], bhi[8][2], blo[8][2];
        tz_frag(xt[(k0 + tig) * XS] * w0, xt[(k0 + tig) * XS + 8] * w0,
                xt[(k0 + tig + 4) * XS] * w1, xt[(k0 + tig + 4) * XS + 8] * w1, ahi, alo);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          split_tz(bt[(k0 + tig) * BS + 8 * jn], bhi[jn][0], blo[jn][0]);
          split_tz(bt[(k0 + tig + 4) * BS + 8 * jn], bhi[jn][1], blo[jn][1]);
        }
        mma3_tiles<8>(acc, ahi, alo, bhi, blo, nt);
      }
    }
    __syncthreads();  // stage st is free for tile t + kTfStages
  }
  cp_async_wait<0>();
  SSD_MARK(2);
  if (rows_live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        const int pp = p0 + 16 * warp + gr, nn = n0 + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(s_final + (bh * d.p + pp) * d.n + nn) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(s_final + (bh * d.p + pp + 8) * d.n + nn) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  SSD_MARK(3);
}

__global__ void __launch_bounds__(kTfThreads, 2)
ssd_out_tf32(const float* __restrict__ x, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ states,
             const float* __restrict__ cum_in, const float* __restrict__ dt_in, int has_s0,
             float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float tf_smem[];
  const int NS = d.n + 4, XS = d.p + 4;  // row strides (floats)
  const int q64 = round_up(d.q, kTfRows);
  const size_t buf_floats = tf32_key_floats(d.p, d.n);
  const size_t sin_floats = static_cast<size_t>(d.p) * NS;
  float* sc = tf_smem;                                  // (kTfRows, NS): C of the block's rows
  float* buf0 = sc + kTfRows * NS;                      // B (kTfKeys, NS), x (kTfKeys, XS)
  float* buf1 = buf0 + buf_floats;                      // the same, or S_in (P, NS)
  float* scum = buf1 + (buf_floats > sin_floats ? buf_floats : sin_floats);  // (q64)
  float* sdt = scum + q64;                                                   // (q64)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int per_tile = d.c * d.h * d.b;
  const int qt = q64 / kTfRows - 1 - static_cast<int>(blockIdx.x) / per_tile;  // last first
  const int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int ci = rem % d.c, h = rem / d.c % d.h, b = rem / (d.c * d.h);
  const int grp = h / (d.h / d.g);
  const int q0 = qt * kTfRows;
  const int64_t t0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(ci) * d.q;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const bool carry = ci > 0 || has_s0;  // S_in is 0 otherwise
  const int nkeys = min(q0 + kTfRows, d.q), nkt = div_up(nkeys, kTfKeys);
  const int nch = d.n / 4, xch = d.p / 4;  // 16-byte chunks a row
  const float* st = states + ((static_cast<int64_t>(b) * d.c + ci) * d.h + h) * d.p * d.n;
  SSD_MARK(0);

  auto load_keys = [&](int t, float* buf) {
    for (int k = tid; k < kTfKeys * nch; k += kTfThreads) {
      const int r = k / nch, ch = k - r * nch;
      const int kj = t * kTfKeys + r;
      const bool in = kj < d.q;
      cp_async16(smem_u32(buf + r * NS + ch * 4),
                 bm + ((t0 + (in ? kj : 0)) * d.g + grp) * d.n + ch * 4, in);
    }
    float* bx = buf + kTfKeys * NS;
    for (int k = tid; k < kTfKeys * xch; k += kTfThreads) {
      const int r = k / xch, ch = k - r * xch;
      const int kj = t * kTfKeys + r;
      const bool in = kj < d.q;
      cp_async16(smem_u32(bx + r * XS + ch * 4),
                 x + ((t0 + (in ? kj : 0)) * d.h + h) * d.p + ch * 4, in);
    }
  };
  auto load_state = [&]() {
    for (int k = tid; k < d.p * nch; k += kTfThreads) {
      const int r = k / nch, ch = k - r * nch;
      cp_async16(smem_u32(buf1 + r * NS + ch * 4), st + static_cast<int64_t>(r) * d.n + ch * 4,
                 true);
    }
  };
  for (int k = tid; k < kTfRows * nch; k += kTfThreads) {
    const int r = k / nch, ch = k - r * nch;
    const bool in = q0 + r < d.q;
    cp_async16(smem_u32(sc + r * NS + ch * 4),
               cm + ((t0 + (in ? q0 + r : 0)) * d.g + grp) * d.n + ch * 4, in);
  }
  for (int i = tid; i < q64; i += kTfThreads) {
    const bool in = i < d.q;
    scum[i] = in ? cum_in[bh * d.l + static_cast<int64_t>(ci) * d.q + i] : 0.f;
    sdt[i] = in ? dt_in[bh * d.l + static_cast<int64_t>(ci) * d.q + i] : 0.f;
  }

  const int r0 = 16 * warp + gr;  // this thread's rows r0 and r0 + 8 of the block
  const bool warp_live = q0 + 16 * warp < d.q;
  const float* crow0 = sc + r0 * NS + tig;  // A rows gr, gr + 8 of the warp, column tig
  const float* crow1 = crow0 + 8 * NS;

  for (int p0 = 0; p0 < d.p; p0 += kTfCols) {
    const int pt = min(kTfCols, d.p - p0) / 8;  // n-tiles of y (P % 16 == 0: even)
    if (p0 > 0) __syncthreads();  // the last pass's tiles are consumed
    load_keys(0, buf0);
    if (carry) load_state();
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (p0 == 0) SSD_MARK(1);
    const float cq0 = scum[q0 + r0], cq1 = scum[q0 + r0 + 8];
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (carry && warp_live) {  // exp(cum_q) · C·S_inᵀ
      for (int kk = 0; kk < d.n / 8; ++kk) {
        uint32_t ahi[4], alo[4], bhi[8][2], blo[8][2];
        tz_frag(crow0[8 * kk], crow1[8 * kk], crow0[8 * kk + 4], crow1[8 * kk + 4], ahi, alo);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < pt) {  // rows of S_in past P are not staged
            const float* srow = buf1 + (p0 + 8 * j + gr) * NS + 8 * kk + tig;
            split_tz(srow[0], bhi[j][0], blo[j][0]);
            split_tz(srow[4], bhi[j][1], blo[j][1]);
          }
        }
        mma3_tiles<8>(acc, ahi, alo, bhi, blo, pt);
      }
      const float e0 = expf(cq0), e1 = expf(cq1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    if (carry) __syncthreads();  // buffer 1 is free for key tile 1
    if (p0 == 0) SSD_MARK(2);
    for (int t = 0; t < nkt; ++t) {
      float* buf = t & 1 ? buf1 : buf0;
      if (t + 1 < nkt) load_keys(t + 1, t & 1 ? buf0 : buf1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int k0 = t * kTfKeys;
      if (warp_live && k0 <= q0 + 16 * warp + 15) {  // a key at or below a row of the warp
        // scores C·Bᵀ over the tile's 32 keys (4 n-tiles)
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        for (int kk = 0; kk < d.n / 8; ++kk) {
          uint32_t ahi[4], alo[4], bhi[4][2], blo[4][2];
          tz_frag(crow0[8 * kk], crow1[8 * kk], crow0[8 * kk + 4], crow1[8 * kk + 4], ahi, alo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* brow = buf + (8 * j + gr) * NS + 8 * kk + tig;
            split_tz(brow[0], bhi[j][0], blo[j][0]);
            split_tz(brow[4], bhi[j][1], blo[j][1]);
          }
          mma3_tiles<4>(s, ahi, alo, bhi, blo, 4);
        }
        // times exp(cum_q - cum_k) dt_k on live pairs (k <= q), else 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * tig + (e & 1), qi = q0 + r0 + 8 * (e >> 1);
            const float cq = e < 2 ? cq0 : cq1;
            s[j][e] = kj <= qi ? s[j][e] * (expf(cq - scum[kj]) * sdt[kj]) : 0.f;
          }
        }
        // acc += scores·x: n-tile j is k-step j, keys 8j + 2·tig (slot tig)
        // and + 1 (slot tig + 4), x's rows in the same order
        const float* bx = buf + kTfKeys * NS;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t ahi[4], alo[4], bhi[8][2], blo[8][2];
          tz_frag(s[j][0], s[j][2], s[j][1], s[j][3], ahi, alo);
          const float* x0 = bx + (8 * j + 2 * tig) * XS + p0 + gr;
#pragma unroll
          for (int dn = 0; dn < 8; ++dn) {
            if (dn < pt) {  // columns of x past P are not staged
              split_tz(x0[8 * dn], bhi[dn][0], blo[dn][0]);
              split_tz(x0[XS + 8 * dn], bhi[dn][1], blo[dn][1]);
            }
          }
          mma3_tiles<8>(acc, ahi, alo, bhi, blo, pt);
        }
      }
      __syncthreads();  // every warp is done with buf before tile t + 2 lands in it
    }
    if (p0 == 0) SSD_MARK(3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r0 + 8 * i;
      if (q < d.q) {
        float* yrow = y + ((t0 + q) * d.h + h) * d.p + p0 + 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < pt)
            *reinterpret_cast<float2*>(yrow + 8 * j) =
                make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      }
    }
  }
  SSD_MARK(4);
}

// ---------------------------------------------------------------------------
// route 2: bf16 on wgmma with TMA-fed tiles
// ---------------------------------------------------------------------------

// byte offset of 16-byte chunk ch (< 8) of row r in a 128-byte-swizzled
// panel at `panel` (1,024-byte aligned)
__device__ __forceinline__ uint32_t sw128(uint32_t panel, int r, int ch) {
  return panel + r * 128 + (((ch ^ r) & 7) << 4);
}

// ssd_state_wgmma's shared memory (from a 1,024-aligned base): the ring of
// token tiles (an x panel and the block's cols / 64 B panels each), two
// staging buffers of the published image (a hi and a lo panel for each of
// the block's column panels), kParamSlots parameter slots (cum and w over
// ceil64(Q) tokens, then exp(cum_Q) and padding), the mbarriers
__host__ __device__ __forceinline__ uint32_t wg_param_bytes(int q) {
  return (2 * round_up(q, 64) + 4) * 4;
}
size_t wg_state_smem(const Dims& d, int cols) {
  const int npn = cols / 64;
  return 1024 + kWgStages * (1 + npn) * kTile + 2 * 2 * npn * kTile +
         kParamSlots * wg_param_bytes(d.q) + 8 * 2 * (kWgStages + kParamSlots);
}

// The A fragments of a 64-token tile's 4 k-steps for the walk: A = (w x)ᵀ
// by ldmatrix.trans of the swizzled token-major x panel at xt (this lane
// addresses token row a_row of a k-step and 16-byte chunk a_ch), each
// element times its token's w (w points at the tile's first token), split
// into hi and lo
__device__ __forceinline__ void walk_frags(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                           uint32_t xt, const float* w, int a_row, int a_ch,
                                           int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ax[4];
    ldsm_x4_trans(sw128(xt, 16 * kk + a_row, a_ch), ax);
    // a[0], a[1]: tokens 16kk + 2·tig, + 1; a[2], a[3]: the same + 8
    const float2 w0 = *reinterpret_cast<const float2*>(w + 16 * kk + 2 * tig);
    const float2 w8 = *reinterpret_cast<const float2*>(w + 16 * kk + 8 + 2 * tig);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ax[i]));
      const float2 wi = i < 2 ? w0 : w8;
      split2(f.x * wi.x, f.y * wi.y, ah[kk][i], al[kk][i]);
    }
  }
}

// acc += (w x)ᵀ·B over one tile: 4 k-steps, hi then lo, B (the NC / 64
// panels from bt) through the transpose bit; committed, not waited for
template <int NC>
__device__ __forceinline__ void walk_issue(float (&acc)[NC / 2], const uint32_t (&ah)[4][4],
                                           const uint32_t (&al)[4][4], uint32_t bt) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(bt + kk * 16 * 128, kTile, 1024);
    if constexpr (NC == 64) {
      wgmma_rs_n64(acc, ah[kk], db);
      wgmma_rs_n64(acc, al[kk], db);
    } else {
      wgmma_rs_n128(acc, ah[kk], db);
      wgmma_rs_n128(acc, al[kk], db);
    }
  }
  wgmma_commit();
}

// NC: the state columns a block walks (64 or 128; the wrapper's walk_cols)
template <int NC>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ s0, bf16* __restrict__ images,
                float* __restrict__ s_final, float* __restrict__ cum_out,
                float* __restrict__ dt_out, Dims d) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int q64 = round_up(d.q, 64), tiles = q64 / 64;
  const uint32_t pbytes = wg_param_bytes(d.q);
  constexpr int NPN = NC / 64;                       // the block's 64-column panels
  constexpr uint32_t kSlot = (1 + NPN) * kTile;      // a token tile: x, then B's panels
  const uint32_t ring = base;
  const uint32_t staging = ring + kWgStages * kSlot;  // 2 × the block's image panels
  const uint32_t params = staging + 2 * 2 * NPN * kTile;
  float* gparams = reinterpret_cast<float*>(wg_smem + (params - raw));
  const uint32_t bars = params + kParamSlots * pbytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };
  auto pfull = [&](int s) { return bars + 8 * (2 * kWgStages + s); };
  auto pempty = [&](int s) { return bars + 8 * (2 * kWgStages + kParamSlots + s); };
  const int ns = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.h / d.g), n0 = NC * ns;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    for (int s = 0; s < kParamSlots; ++s) {
      mbar_init(pfull(s), 32);  // the parameter warp's 32 lanes
      mbar_init(pempty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  SSD_MARK(0);

  // the warp index broadcast from lane 0: every branch on it is uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid & 31;
  if (warp == 4) {  // the TMA warp: lane 0 keeps the ring of token tiles full
    if (lane == 0) {
      tma_prefetch_desc(&tm_x);
      tma_prefetch_desc(&tm_b);
      for (int it = 0; it < d.c * tiles; ++it) {
        const int s = it % kWgStages;
        const int t = it / tiles * d.q + 64 * (it % tiles);  // token of batch b
        mbar_wait(empty(s), ((it / kWgStages) & 1) ^ 1);  // a fresh slot passes
        const uint32_t slot = ring + s * kSlot;
        mbar_expect_tx(full(s), kSlot);
        tma_load_4d(slot, &tm_x, full(s), 0, h, t, b);
#pragma unroll
        for (int pn = 0; pn < NPN; ++pn)
          tma_load_4d(slot + (1 + pn) * kTile, &tm_b, full(s), n0 + 64 * pn, grp, t, b);
      }
    }
    return;
  }
  if (warp == 5) {  // the parameter warp: chunk c's cum, w and exp(cum_Q) into slot c % kParamSlots
    const float av = a[bh];
    // chunk c's dt into its slot's w by 4-byte cp.async, one group a chunk
    // (an empty one past the last): kParamSlots - 1 chunks' copies fly while
    // one is scanned
    auto fetch = [&](int c) {
      if (c < d.c) {
        const int ps = c % kParamSlots;
        mbar_wait(pempty(ps), ((c / kParamSlots) & 1) ^ 1);
        float* w = gparams + ps * (pbytes / 4) + q64;
        const int64_t tok0 = static_cast<int64_t>(b) * d.l + static_cast<int64_t>(c) * d.q;
        for (int i = lane; i < d.q; i += 32)
          cp_async4(smem_u32(w + i), dt + (tok0 + i) * d.h + h);
      }
      cp_async_commit();
    };
    for (int c = 0; c < kParamSlots - 1; ++c) fetch(c);
    for (int c = 0; c < d.c; ++c) {
      cp_async_wait<kParamSlots - 2>();  // chunk c's group
      __syncwarp();
      float* cum = gparams + (c % kParamSlots) * (pbytes / 4);
      float* w = cum + q64;
      for (int i = lane; i < q64; i += 32) {
        const float v = i < d.q ? w[i] : 0.f;
        w[i] = v;
        cum[i] = __fmul_rn(v, av);
      }
      __syncwarp();
      scan_warp(cum, d.q, lane);
      const float last = cum[d.q - 1];
      const int64_t o0 = bh * d.l + static_cast<int64_t>(c) * d.q;
      for (int i = lane; i < q64; i += 32) {
        if (ns == 0 && i < d.q) {  // cum·log2(e) and dt, head-major, for ssd_out_wgmma
          cum_out[o0 + i] = cum[i] * kLog2e;
          dt_out[o0 + i] = w[i];
        }
        w[i] = i < d.q ? expf(last - cum[i]) * w[i] : 0.f;
      }
      if (lane == 0) w[q64] = expf(last);
      __syncwarp();
      mbar_arrive(pfull(c % kParamSlots));
      fetch(c + kParamSlots - 1);  // waits until the consumers are done with chunk c - 1
    }
    return;
  }

  // the consumer warpgroup: the state's rows 16·warp + gr (+ 8) and columns
  // n0 + 8j + 2·tig (+ 1) in the wgmma accumulator layout
  const int gr = lane >> 2, tig = lane & 3;
  float acc[NC / 2];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = 16 * warp + gr + 8 * (e >> 1), nn = n0 + 8 * j + 2 * tig + (e & 1);
      acc[4 * j + e] = s0 != nullptr ? s0[(bh * d.p + pp) * d.n + nn] : 0.f;
    }
  const int a_row = (lane & 7) + 8 * (lane >> 4), a_ch = 2 * warp + ((lane >> 3) & 1);
  const int64_t img_elems = 2 * static_cast<int64_t>(d.p) * d.n;  // hi and lo of one (b, c, h)
  auto w_of = [&](int c) { return gparams + (c % kParamSlots) * (pbytes / 4) + q64; };
  // The tiles in one sequence over the chunks: tile t's products run while
  // tile t + 1's fragments are formed (f[0] and f[1] in turn)
  uint32_t f[2][2][4][4];
  const int n_tiles = d.c * tiles;
  mbar_wait(pfull(0), 0);
  mbar_wait(full(0), 0);
  walk_frags(f[0][0], f[0][1], ring, w_of(0), a_row, a_ch, tig);
  SSD_MARK(1);
  for (int t0 = 0; t0 < n_tiles; t0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = t0 + u;
      if (t < n_tiles) {
        const int c = t / tiles, j = t % tiles;
        if (j == 0) {
          // chunk c begins: publish S_in(c) as its hi/lo image (the hi panel
          // of columns ns, then its lo panel; row p at p·128 bytes, 16-byte
          // chunk jn at jn ^ (p % 8); the outputs read it for a chunk past
          // the first, or with an initial state) through staging buffer c %
          // 2 and one 16 KB bulk store, then S <- exp(cum_Q) S
          if (c > 0 || s0 != nullptr) {
            const uint32_t st = staging + (c & 1) * 2 * NPN * kTile;
            if (tid == 0) bulk_wait_read<1>();  // the store from this buffer two chunks ago
            named_barrier(1, 128);
#pragma unroll
            for (int jn = 0; jn < NC / 8; ++jn)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int pp = 16 * warp + gr + 8 * i;
                uint32_t hi, lo;
                split2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1], hi, lo);
                const uint32_t off = sw128(st + (jn / 8) * 2 * kTile, pp, jn % 8) + 4 * tig;
                st_shared_b32(off, hi);
                st_shared_b32(off + kTile, lo);
              }
            fence_proxy_async();
            named_barrier(1, 128);
            if (tid == 0) {
              bulk_store(images + ((static_cast<int64_t>(b) * d.c + c) * d.h + h) * img_elems +
                             static_cast<int64_t>(ns) * NPN * 2 * d.p * 64,
                         st, 2 * NPN * kTile);
              bulk_commit();
            }
          }
          const float decay = w_of(c)[q64];
#pragma unroll
          for (int e = 0; e < NC / 2; ++e) acc[e] *= decay;
        }
        const int s = t % kWgStages;
        walk_issue<NC>(acc, f[u][0], f[u][1], ring + s * kSlot + kTile);
        if (t + 1 < n_tiles) {  // the next tile's fragments, under this tile's products
          const int c1 = (t + 1) / tiles, j1 = (t + 1) % tiles, s1 = (t + 1) % kWgStages;
          if (j1 == 0) mbar_wait(pfull(c1 % kParamSlots), (c1 / kParamSlots) & 1);
          mbar_wait(full(s1), ((t + 1) / kWgStages) & 1);
          walk_frags(f[u ^ 1][0], f[u ^ 1][1], ring + s1 * kSlot, w_of(c1) + 64 * j1, a_row,
                     a_ch, tig);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (tid == 0) {
          mbar_arrive(empty(s));
          if (j == tiles - 1) mbar_arrive(pempty(c % kParamSlots));
        }
      }
    }
  }
  SSD_MARK(2);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pp = 16 * warp + gr + 8 * i, nn = n0 + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(s_final + (bh * d.p + pp) * d.n + nn) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  if (tid == 0) bulk_wait<0>();  // the images are written before the block's shared memory goes
  SSD_MARK(3);
}

// s = C·Bᵀ, the raw scores of a 64-row query tile (its C panels at ct)
// over a key tile (its B panels at bt): ksteps wgmma m64n64k16, both
// operands K-major; committed, not waited for
__device__ __forceinline__ void out_scores(float (&s)[32], uint32_t ct, uint32_t bt, int ksteps) {
  fence_regs(s);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t koff = (kk / 4) * kTile + (kk % 4) * 32;
    wgmma_ss_n64(s, smem_desc(ct + koff, 16, 1024), smem_desc(bt + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// The A fragments (hi and lo) of ·x over key tile k0 / 64: its raw scores
// sv (accumulator layout: rows r0, r0 + 8 of the chunk, keys k0 + 8j +
// 2·tig (+ 1)) times 2^((cum_q - cum_k) log2 e) dt_k with c2 =
// cum·log2(e), a dead pair (k > q, on the diagonal tile) 0; score n-tiles
// 2kk and 2kk + 1 are the fragment of k-step kk
__device__ __forceinline__ void out_frags(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                          float (&sv)[32], const float* scum, const float* sdt,
                                          int k0, int r0, float c2q0, float c2q1, int tig,
                                          bool diag) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kj = k0 + 8 * j + 2 * tig;
    const float2 ck = *reinterpret_cast<const float2*>(scum + kj);
    const float2 dk = *reinterpret_cast<const float2*>(sdt + kj);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = r0 + 8 * (e >> 1);
      const float c2q = e < 2 ? c2q0 : c2q1;
      const float c_k = e & 1 ? ck.y : ck.x, d_k = e & 1 ? dk.y : dk.x;
      sv[4 * j + e] =
          !diag || kj + (e & 1) <= qi ? sv[4 * j + e] * (ex2(c2q - c_k) * d_k) : 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split2(sv[8 * kk + 0], sv[8 * kk + 1], ah[kk][0], al[kk][0]);
    split2(sv[8 * kk + 2], sv[8 * kk + 3], ah[kk][1], al[kk][1]);
    split2(sv[8 * kk + 4], sv[8 * kk + 5], ah[kk][2], al[kk][2]);
    split2(sv[8 * kk + 6], sv[8 * kk + 7], ah[kk][3], al[kk][3]);
  }
}

// ssd_out_wgmma's shared memory, in byte offsets from a 1,024-aligned base:
// C (2 row tiles × N/64 panels), B (ceil64(Q)/64 key tiles × N/64 panels),
// then `slots` head slots of x (ceil64(Q)/64 key tiles), the S_in image
// (hi and lo, P·N·4 bytes), cum·log2(e) and dt (ceil64(Q) floats each),
// each slot rounded to 1,024; the pair's three shared score tiles (64 × 64
// fp32 each; in B's place where they fit there); then the mbarriers (C/B,
// full and empty a slot)
struct OutLayout {
  int nrt, npn;                   // 64-row tiles of the chunk, 64-column panels of N
  uint32_t b_off, slot_off, slot_bytes, img_off, cum_off, dt_off, sc_off, bar_off;
  size_t total;
};

__host__ __device__ __forceinline__ OutLayout out_layout(int q, int p, int n, int slots) {
  OutLayout o;
  o.nrt = div_up(q, 64);
  o.npn = n / 64;
  o.b_off = 2 * o.npn * kTile;
  o.slot_off = o.b_off + o.nrt * o.npn * kTile;
  o.img_off = o.nrt * kTile;  // after the x tiles
  o.cum_off = o.img_off + 4 * p * n;
  o.dt_off = o.cum_off + o.nrt * 64 * 4;
  o.slot_bytes = round_up(o.dt_off + o.nrt * 64 * 4, 1024);
  // the score tiles take B's place where B serves only them (Q <= 128: no
  // key tile is formed again) and is large enough (N >= 256)
  const uint32_t sc_bytes = 3 * 64 * 64 * 4;
  const bool in_b = o.nrt <= 2 && o.nrt * o.npn * kTile >= sc_bytes;
  o.sc_off = in_b ? o.b_off : o.slot_off + slots * o.slot_bytes;
  o.bar_off = o.slot_off + slots * o.slot_bytes + (in_b ? 0 : sc_bytes);
  o.total = 1024 + o.bar_off + 8 * (1 + 2 * slots);
  return o;
}

// the head slots ssd_out_wgmma runs with: as many as fit, at most kOutSlots
int out_slots(const Dims& d) {
  int slots = kOutSlots;
  while (slots > 1 && out_layout(d.q, d.p, d.n, slots).total > kMaxSmem) --slots;
  return slots;
}

__global__ void __launch_bounds__(kOutThreads, 1)
ssd_out_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_c, const bf16* __restrict__ images,
              const float* __restrict__ cum_in, const float* __restrict__ dt_in, int has_s0,
              bf16* __restrict__ y, Dims d, int hb, int slots) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const OutLayout L = out_layout(d.q, d.p, d.n, slots);
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = wg_smem + (base - raw);
  const uint32_t cb_bar = base + L.bar_off;
  auto full = [&](int s) { return cb_bar + 8 + 8 * s; };
  auto empty = [&](int s) { return cb_bar + 8 + 8 * (slots + s); };
  const int npairs = div_up(L.nrt, 2);
  const int hgroups = d.h / hb;
  const int per_pair = d.c * hgroups * d.b;
  const int rp = npairs - 1 - static_cast<int>(blockIdx.x) / per_pair;  // the last rows first
  const int rem = static_cast<int>(blockIdx.x) % per_pair;
  const int ci = rem % d.c, hg = rem / d.c % hgroups, b = rem / (d.c * hgroups);
  const int h0 = hg * hb, grp = h0 / (d.h / d.g);
  const bool carry = ci > 0 || has_s0;  // S_in is 0 otherwise
  const int nkt = min(2 * rp + 2, L.nrt);  // key tiles at or below the block's rows
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(cb_bar, 1);
    for (int s = 0; s < slots; ++s) {
      mbar_init(full(s), 33);  // lane 0's expect_tx, then all 32 lanes of the producer
      mbar_init(empty(s), 2);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  SSD_MARK(0);

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {  // the producer warpgroup: its first warp loads, the rest retire
    setmaxnreg_dec<40>();
    if (tid >= 256 + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      tma_prefetch_desc(&tm_x);
      tma_prefetch_desc(&tm_b);
      tma_prefetch_desc(&tm_c);
      const int rtc = min(2, L.nrt - 2 * rp);  // row tiles of the pair in the chunk
      mbar_expect_tx(cb_bar, (rtc + nkt) * L.npn * kTile);
      for (int w = 0; w < rtc; ++w)
        for (int pn = 0; pn < L.npn; ++pn)
          tma_load_4d(base + (w * L.npn + pn) * kTile, &tm_c, cb_bar, 64 * pn, grp,
                      ci * d.q + 64 * (2 * rp + w), b);
      for (int kt = 0; kt < nkt; ++kt)
        for (int pn = 0; pn < L.npn; ++pn)
          tma_load_4d(base + L.b_off + (kt * L.npn + pn) * kTile, &tm_b, cb_bar, 64 * pn, grp,
                      ci * d.q + 64 * kt, b);
    }
    const uint32_t img_bytes = 4 * d.p * d.n;  // hi and lo
    for (int i = 0; i < hb; ++i) {
      const int s = i % slots, h = h0 + i;
      mbar_wait(empty(s), ((i / slots) & 1) ^ 1);
      const uint32_t slot = base + L.slot_off + s * L.slot_bytes;
      if (lane == 0) {
        mbar_expect_tx(full(s), nkt * kTile + (carry ? img_bytes : 0));
        for (int kt = 0; kt < nkt; ++kt)
          tma_load_4d(slot + kt * kTile, &tm_x, full(s), 0, h, ci * d.q + 64 * kt, b);
        if (carry)
          bulk_load(slot + L.img_off,
                    images + ((static_cast<int64_t>(b) * d.c + ci) * d.h + h) * 2 * d.p * d.n,
                    img_bytes, full(s));
      }
      float* scum = reinterpret_cast<float*>(gbase + L.slot_off + s * L.slot_bytes + L.cum_off);
      float* sdt = reinterpret_cast<float*>(gbase + L.slot_off + s * L.slot_bytes + L.dt_off);
      const int64_t o0 = (static_cast<int64_t>(b) * d.h + h) * d.l + static_cast<int64_t>(ci) * d.q;
      // the chunk's cum·log2(e) and dt by 4-byte cp.async, whose landing
      // arrives on the slot's barrier (entries past Q keep stale values: they
      // meet only dead pairs and rows that are never stored)
      for (int k = lane; k < min(nkt * 64, d.q); k += 32) {
        cp_async4(smem_u32(scum + k), cum_in + o0 + k);
        cp_async4(smem_u32(sdt + k), dt_in + o0 + k);
      }
      cp_async_mbar_arrive(full(s));
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tw = tid & 127, warp = tw >> 5, lane = tid & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int ksteps = d.n / 16;
  const uint32_t bt0 = base + L.b_off;           // key tile kt at bt0 + kt·npn·kTile
  // The pair's raw scores, shared by the block's heads: warpgroup 0 forms
  // query tile 2rp's diagonal tile, warpgroup 1 query tile 2rp + 1's
  // diagonal and previous tiles, into shared memory (thread tw's 32 values
  // of tile t as 8 float4 at (t·8 + k)·128 + tw), so that either warpgroup
  // can take either query tile: the warpgroups swap tiles from head to
  // head, and the one with two key tiles changes every head.
  float4* scores = reinterpret_cast<float4*>(gbase + L.sc_off);
  mbar_wait(cb_bar, 0);
  SSD_MARK(1);
  float s1[32], s2[32];
  if (2 * rp + wg < L.nrt) {
    const int rt = 2 * rp + wg;
    const uint32_t ct = base + wg * L.npn * kTile;
    out_scores(s1, ct, bt0 + rt * L.npn * kTile, ksteps);
    if (wg == 1) out_scores(s2, ct, bt0 + (rt - 1) * L.npn * kTile, ksteps);
    wgmma_wait<0>();
    fence_regs(s1);
    if (wg == 1) fence_regs(s2);
  }
  named_barrier(1, 256);  // both warpgroups' products have read B
  if (2 * rp + wg < L.nrt) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      scores[(wg * 8 + k) * 128 + tw] =
          make_float4(s1[4 * k], s1[4 * k + 1], s1[4 * k + 2], s1[4 * k + 3]);
      if (wg == 1)
        scores[(16 + k) * 128 + tw] =
            make_float4(s2[4 * k], s2[4 * k + 1], s2[4 * k + 2], s2[4 * k + 3]);
    }
  }
  named_barrier(1, 256);  // the two consumer warpgroups
  for (int i = 0; i < hb; ++i) {
    const int s = i % slots, h = h0 + i;
    const int role = (wg + i) & 1;       // this head's query tile of the pair
    const int rt = 2 * rp + role;
    const bool live = rt < L.nrt;
    const int r0 = 64 * rt + 16 * warp + gr;  // this thread's rows r0 and r0 + 8 of the chunk
    const uint32_t ct = base + role * L.npn * kTile;  // the query tile's C rows
    mbar_wait(full(s), (i / slots) & 1);
    if (i == 0) SSD_MARK(2);
    const uint32_t slot = base + L.slot_off + s * L.slot_bytes;
    const unsigned char* gslot = gbase + L.slot_off + s * L.slot_bytes;
    const float* scum = reinterpret_cast<const float*>(gslot + L.cum_off);  // cum·log2(e)
    const float* sdt = reinterpret_cast<const float*>(gslot + L.dt_off);
    if (live) {
      const float c2q0 = scum[r0], c2q1 = scum[r0 + 8];  // cum_q·log2(e)
      float acc[32];
      if (carry) {
        // 2^(cum_q log2 e) · C·S_inᵀ: one m64n128k16 a k-step over the
        // image's hi and lo panels stacked (N = 64 + 64), the halves summed
        float two[64];
        fence_regs(two);
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk) {
          const uint32_t koff = (kk / 4) * kTile + (kk % 4) * 32;
          wgmma_ss_n128(two, smem_desc(ct + koff, 16, 1024),
                        smem_desc(slot + L.img_off + (kk / 4) * 2 * kTile + (kk % 4) * 32, 16,
                                  1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(two);
        const float e0 = ex2(c2q0), e1 = ex2(c2q1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 0] = (two[4 * j + 0] + two[32 + 4 * j + 0]) * e0;
          acc[4 * j + 1] = (two[4 * j + 1] + two[32 + 4 * j + 1]) * e0;
          acc[4 * j + 2] = (two[4 * j + 2] + two[32 + 4 * j + 2]) * e1;
          acc[4 * j + 3] = (two[4 * j + 3] + two[32 + 4 * j + 3]) * e1;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      }
      // acc += (scores of key tile kt, scaled by 2^((cum_q - cum_k) log2 e)
      // dt_k on live pairs and 0 on dead ones, as hi and lo) · x, over the
      // key tiles at or below the rows: the shared tiles from shared
      // memory, tiles further back (Q > 128) formed again
      for (int kt = 0; kt <= rt; ++kt) {
        uint32_t ah[4][4], al[4][4];
        if (kt < rt && !(role == 1 && kt + 1 == rt)) {
          float sr[32];  // a wgmma accumulator: no other instruction defines it
          out_scores(sr, ct, bt0 + kt * L.npn * kTile, ksteps);
          wgmma_wait<0>();
          fence_regs(sr);
          out_frags(ah, al, sr, scum, sdt, 64 * kt, r0, c2q0, c2q1, tig, false);
        } else {  // tile 0 or 1 (the diagonals) or 2 (query tile 1's previous)
          const int t = kt == rt ? role : 2;
          float sv[32];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float4 v = scores[(t * 8 + k) * 128 + tw];
            sv[4 * k] = v.x;
            sv[4 * k + 1] = v.y;
            sv[4 * k + 2] = v.z;
            sv[4 * k + 3] = v.w;
          }
          out_frags(ah, al, sv, scum, sdt, 64 * kt, r0, c2q0, c2q1, tig, kt == rt);
        }
        const uint32_t xt = slot + kt * kTile;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(xt + kk * 16 * 128, kTile, 1024);  // x: transposed
          wgmma_rs_n64(acc, ah[kk], db);
          wgmma_rs_n64(acc, al[kk], db);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int q = r0 + 8 * i2;
        if (q < d.q) {
          bf16* yrow =
              y + ((static_cast<int64_t>(b) * d.l + ci * d.q + q) * d.h + h) * d.p + 2 * tig;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * i2], acc[4 * j + 2 * i2 + 1]);
        }
      }
    }
    if (tw == 0) mbar_arrive(empty(s));
  }
  SSD_MARK(3);
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_max_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
  // every kernel of the scan on the SM's largest shared-memory split, so
  // that the walk and the outputs, launched back to back, never wait for
  // the SM to change it
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
int run_cuda_core(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
                  const float* s0, void* y, float* s_final, float* states, const Dims& d,
                  int stage, cudaStream_t stream) {
  static bool walk_ready = false, out_ready = false;
  if (stage == 0) {
    const cudaError_t err = allow_max_smem(ssd_state_walk<T>, walk_ready);
    if (err != cudaSuccess) return err;
    const int tiles = div_up(d.p, 64) * div_up(d.n, 128);
    ssd_state_walk<T><<<dim3(tiles, d.h, d.b), kThreads, walk_smem(d), stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), s0, states, s_final, d);
  } else {
    const cudaError_t err = allow_max_smem(ssd_chunk_out<T>, out_ready);
    if (err != cudaSuccess) return err;
    ssd_chunk_out<T><<<dim3(d.c, d.h, d.b), kThreads, out_smem(d), stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
        states, static_cast<T*>(y), d);
  }
  return cudaGetLastError();
}

int run_tf32(const float* x, const float* dt, const float* a, const float* bm, const float* cm,
             const float* s0, float* y, float* s_final, float* states, float* cum, float* dtt,
             const Dims& d, int stage, cudaStream_t stream) {
  static bool state_ready = false, out_ready = false;
  if (stage == 0) {
    const cudaError_t err = allow_max_smem(ssd_state_tf32, state_ready);
    if (err != cudaSuccess) return err;
    const int tiles = div_up(d.p, 64) * div_up(d.n, kTfCols);
    ssd_state_tf32<<<dim3(tiles, d.h, d.b), kTfThreads, tf32_state_smem(d), stream>>>(
        x, dt, a, bm, s0, states, s_final, cum, dtt, d);
  } else {
    const cudaError_t err = allow_max_smem(ssd_out_tf32, out_ready);
    if (err != cudaSuccess) return err;
    const int64_t blocks = static_cast<int64_t>(div_up(d.q, kTfRows)) * d.c * d.h * d.b;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    ssd_out_tf32<<<static_cast<unsigned>(blocks), kTfThreads, tf32_out_smem(d), stream>>>(
        x, bm, cm, states, cum, dtt, s0 != nullptr, y, d);
  }
  return cudaGetLastError();
}

template <int NC>
int launch_walk(const CUtensorMap& tm_x, const CUtensorMap& tm_b, const float* dt,
                const float* a, const float* s0, void* states, float* s_final, float* cum,
                float* dtt, const Dims& d, cudaStream_t stream) {
  static bool ready = false;
  const cudaError_t err = allow_max_smem(ssd_state_wgmma<NC>, ready);
  if (err != cudaSuccess) return err;
  ssd_state_wgmma<NC><<<dim3(d.n / NC, d.h, d.b), kStateThreads, wg_state_smem(d, NC), stream>>>(
      tm_x, tm_b, dt, a, s0, static_cast<bf16*>(states), s_final, cum, dtt, d);
  return cudaGetLastError();
}

int run_wgmma(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
              const float* s0, void* y, float* s_final, void* states, float* cum, float* dtt,
              const Dims& d, int hb, int cols, int stage, cudaStream_t stream) {
  static bool out_ready = false;
  CUtensorMap tm_x, tm_b;
  int err = blhw_tensor_map(&tm_x, x, d.b, d.l, d.h, d.p, 64);
  if (err == cudaSuccess) err = blhw_tensor_map(&tm_b, bm, d.b, d.l, d.g, d.n, 64);
  if (err != cudaSuccess) return err;
  if (stage == 0) {
    if (cols == 128)
      return launch_walk<128>(tm_x, tm_b, dt, a, s0, states, s_final, cum, dtt, d, stream);
    return launch_walk<64>(tm_x, tm_b, dt, a, s0, states, s_final, cum, dtt, d, stream);
  } else {
    CUtensorMap tm_c;
    err = blhw_tensor_map(&tm_c, cm, d.b, d.l, d.g, d.n, 64);
    if (err != cudaSuccess) return err;
    err = allow_max_smem(ssd_out_wgmma, out_ready);
    if (err != cudaSuccess) return err;
    const int slots = out_slots(d);
    const int64_t blocks =
        static_cast<int64_t>(div_up(div_up(d.q, 64), 2)) * d.c * (d.h / hb) * d.b;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    ssd_out_wgmma<<<static_cast<unsigned>(blocks), kOutThreads,
                    out_layout(d.q, d.p, d.n, slots).total, stream>>>(
        tm_x, tm_b, tm_c, static_cast<const bf16*>(states), cum, dtt, s0 != nullptr,
        static_cast<bf16*>(y), d, hb, slots);
  }
  return cudaGetLastError();
}

// the larger stage's shared memory on `route`
size_t route_smem(int route, const Dims& d, int cols) {
  if (route == kWgmma) {
    const size_t out = out_layout(d.q, d.p, d.n, 1).total, walk = wg_state_smem(d, cols);
    return out > walk ? out : walk;
  }
  if (route == kTf32) {
    const size_t out = tf32_out_smem(d), walk = tf32_state_smem(d);
    return out > walk ? out : walk;
  }
  const size_t out = out_smem(d), walk = walk_smem(d);
  return out > walk ? out : walk;
}

}  // namespace

extern "C" {

// One stage of the scan (0: the state walk, 1: the outputs) on `route`
// (the wrapper's ROUTES: 0 the CUDA cores, either dtype, any P and N; 1
// fp32 with P and N multiples of 16, 3xTF32; 2 bf16 with P = 64 and N a
// multiple of 64, wgmma), all tensors contiguous: x (B, L, H, P), bm/cm
// (B, L, G, N) of one dtype (fp32, bf16 = 0; bf16, bf16 = 1); dt (B, L, H),
// a (B, H), s0 (B, H, P, N) or null, s_final (B, H, P, N), all fp32; y
// (B, L, H, P) in x's dtype; scratch: states (B, L/Q, H, P, N) of 4-byte
// entries (fp32 on routes 0 and 1, hi/lo bf16 images on route 2), cum and
// dtt (B, H, L) fp32 (routes 1 and 2; route 2's cum is cum·log2(e)). hb:
// heads a block of route 2's outputs takes (dividing H / G; 1 elsewhere);
// cols: state columns a block of route 2's walk takes (64, or 128 where N
// % 128 == 0; 64 elsewhere). Routes 1 and 2 need x, bm, cm, y and states
// to start on a 16-byte boundary (cudaErrorMisalignedAddress otherwise).
// Returns cudaGetLastError() after the launch.
int ssd_scan_stage(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const float* s0, void* y, float* s_final, void* states,
                   float* cum, float* dtt, int b, int l, int h, int g, int p, int n, int chunk,
                   int bf16_in, int route, int hb, int cols, int stage, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      chunk <= 0 || l % chunk != 0 || h > 65535 || b > 65535 || stage < 0 || stage > 1)
    return cudaErrorInvalidValue;
  const Dims d{b, l, h, g, p, n, chunk, l / chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool route_ok =
      route == kCudaCore ||
      (route == kTf32 && !bf16_in && p % 16 == 0 && n % 16 == 0) ||
      (route == kWgmma && bf16_in && p == 64 && n % 64 == 0 && hb >= 1 && (h / g) % hb == 0 &&
       (cols == 64 || (cols == 128 && n % 128 == 0)));
  if (!route_ok || (route != kWgmma && (hb != 1 || cols != 64))) return cudaErrorInvalidValue;
  if (route_smem(route, d, cols) > kMaxSmem) return cudaErrorInvalidValue;
  if (route != kCudaCore) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
                            reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y) |
                            reinterpret_cast<uintptr_t>(states);
    if (bases % 16 != 0) return cudaErrorMisalignedAddress;
    if (cum == nullptr || dtt == nullptr) return cudaErrorInvalidValue;
  }
  if (route == kWgmma)
    return run_wgmma(x, dt, a, bm, cm, s0, y, s_final, states, cum, dtt, d, hb, cols, stage, s);
  if (route == kTf32)
    return run_tf32(static_cast<const float*>(x), dt, a, static_cast<const float*>(bm),
                    static_cast<const float*>(cm), s0, static_cast<float*>(y), s_final,
                    static_cast<float*>(states), cum, dtt, d, stage, s);
  float* st = static_cast<float*>(states);
  return bf16_in ? run_cuda_core<__nv_bfloat16>(x, dt, a, bm, cm, s0, y, s_final, st, d, stage, s)
                 : run_cuda_core<float>(x, dt, a, bm, cm, s0, y, s_final, st, d, stage, s);
}

}  // extern "C"
