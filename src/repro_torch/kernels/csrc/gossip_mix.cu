// Cluster-matched gossip mix C' = W · C on the packed (N, X) plane, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/gossip_mix.py:
// gossip_mix_flat (W·C), gossip_mix_fused_dp
// (W·(c_old + scale ⊙ (c_new − c_old) + σ·noise)), gossip_mix_stack
// (W·C_s for every slab s of an (S, N, X) stack, in one launch),
// gossip_mix_sparse (W·C for the sparse exchange, skipping dead slabs) and
// gossip_mix_dequant_masked (W·(q ⊙ repeat(scale) ⊙ M) over an int8
// payload, the sparse exchange's numerator with an int8/int4 codec).
//
// What bounds it: every output column reads the N inputs of its column
// once and writes M outputs (M = N but for the masked dequant mix), 2MN
// FLOPs per column, so the arithmetic intensity is about N/4 FLOP/B in
// fp32 — memory-bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores) below N ≈ 80.
//
// Design: one thread owns one column of X, so the plane is streamed once
// with coalesced 4-byte loads (rows of an odd X are not 16-byte aligned,
// which rules out vector loads on every row). N is cut into chunks of NB
// rows (NB = 8, 16, 24, 32, 40, 48 or 64, the smallest that holds max(M,
// N) when it is <= 64, else 64); a block stages the matching NB×NB chunk
// of W in shared memory (every thread reads the same W entry: a
// broadcast), and each thread keeps NB fp32 accumulators for one chunk of
// output rows. The column's inputs are read through a per-element
// prologue in groups of kGroup = 4 rows: the group's loads are issued
// together, then kGroup·NB FMAs consume them. Small groups keep a thread
// at 36–78 registers (up to 32 rows), so many warps per SM carry loads in
// flight, while each warp touches only a few rows at a time; on the H100,
// loading all NB rows (or 8) at once measured slower at X = 4,194,304,
// for the flat mix and more so for the fused DP mix, which reads three
// arrays per row. For M, N <= 64 there is one chunk and the plane is read
// exactly once; a larger M re-reads it once per chunk of 64 output rows.
// Accumulation is fp32 FMA on the CUDA cores, never TF32. The fused-DP
// and dequant prologues round each step as the plain PyTorch versions do
// (no contraction), so the two differ only in the order of the sum over j.
//
// Past 32 rows: mix_kernel_wide. Up to 32 rows mix_kernel is the first
// design, unchanged. The 40-, 48- and 64-row chunks replace two passes
// over the plane at N in (32, 64], the second of which kept only N − 32
// of its 32 accumulators busy (at N = 37, 5). The chunk alone did not
// beat torch.matmul at (S, N, X) = (3, 37, 100,003), and neither did
// threads that split a column's rows (they share the column's loads, so
// they add no distinct bytes in flight). What did (tools/mix_variants.py,
// on the H100): each thread loads the next group of 4 rows while it mixes
// the current one; the 40-row chunk mixes 2 columns 128 apart a thread
// (kPer, 80 accumulators) with no branch around that prefetch
// (kBranchless); the 48- and 64-row chunks cap their registers through
// __launch_bounds__'s blocks-per-SM hint (kMinBlocks). Each output's FMAs
// run in the same order as in mix_kernel, so the results are the same
// bits. Folding this into mix_kernel's template, even compiled to one
// column and no prefetch, slowed its N = 20 rows past L2 by 26–44 %
// (chip_smoke.py): the two kernels stay apart.
//
// The narrow plane: mix_kernel_narrow. At the main path's width (N = 20,
// X = 17,226, 1.4 MB, resident in L2) a call takes a few µs and is bound
// by latency, not bytes: mix_kernel runs 135 blocks of 4 warps on 132 SMs,
// and each thread waits on 6 dependent round trips (W staged, then five
// groups of 4 rows), 7 in the sparse mix (the activity first). A square
// W (M = N) of at most 32 rows over a plane narrower than kNarrowMaxX
// columns takes a kernel of its own, whatever the prologue: the flat and
// sparse mixes (kernels 1, 5), the fused DP mix (kernel 2, the DP rounds'
// exchange: three fp32 loads and a scale a row; at an even X only below
// kDpVecMinX), the masked dequant mix
// (kernel 6) and, from gossip_mix_dequant.cu through gossip_mix.cuh, the
// dequant mix on the square W (kernel 4, the dense exchange with an
// int8/int4 codec). Every load a thread needs (its share of W, its rows of
// its column and, sparse, the column's activity) is issued before the
// block's one barrier. Past 8
// rows four threads share a column (a block: 32 columns, one warp per row
// group; 539 blocks at X = 17,226), meet in a shared tile and each mix
// NB/4 output rows from all N rows; up to 8 rows one thread mixes its
// column from registers. NB is N rounded up to 4, not 8: at N = 20
// mix_kernel's 24-row chunk issues 20 % more FMAs. A prologue's at(col)
// does its per-column work once a thread (the dequant mixes' scale column,
// col / qblock; the fused DP mix's column pointers), not once a row. Each
// output sums j ascending from 0.f, as in mix_kernel and the serving
// template: the same bits.
// tools/mix_variants.py at (20, 17,226), ms: mix_kernel 0.00436; one round
// trip, a thread a column 0.00369, NB 20 0.00330; 4 threads a column
// 0.00268; torch.matmul 0.00360; float2 loads of the tile gained little.
// Kernel 3, a W that is not square, and every plane past the narrow one
// keep the kernels above, but kernels 6 and 2 (below).
//
// Kernels 6 and 2 past the narrow plane: mix_kernel_masked_vec and
// mix_kernel_dp_vec. In mix_kernel's
// per-element prologue each row of a column costs three scalar loads (a
// 1-byte quantum: one 32-byte sector a warp, a scale and an fp32 mask
// entry) and a division for the scale column; past L2 it reached 34 % of
// its byte bound where kernel 1 reached 67 %. Where the rows allow it (X,
// Xp and qblock multiples of 4, the operands 16-byte aligned) a thread
// owns 4 adjacent columns: a char4 of quanta, a float4 of mask and one
// scale a row, and float4 stores, so each warp request moves 4× the bytes
// and each W entry read from shared memory feeds 4 FMAs. The dead-column
// test goes by warp (128 columns), after the one barrier that stages W.
// Up to 32 rows; other shapes keep mix_kernel. It is a kernel of its own,
// as mix_kernel_wide is, for the same reason: mix_kernel stays as it is.
// The fused DP mix reads three fp32 arrays a row (c_old, c_new, the noise)
// and a scale, in scalar loads past L2 under mix_kernel (0.618 ms at (20,
// 4,194,304), σ > 0: 65 % of its byte bound). Where X is even and the
// planes 8-byte aligned, mix_kernel_dp_vec gives a thread 2 adjacent
// columns: three float2 loads and one scale a row in groups of 4 rows,
// float2 stores, each step of the prologue rounded alone as in FusedDP.
// It takes over from the narrow kernel at kDpVecMinX = 49,152 columns,
// below kNarrowMaxX: with three arrays a row the narrow plane's loads
// outgrow one round trip sooner (the measured crossover is beside it).
// tools/mix_variants.py dp at (20, 4,194,304), σ = 0.5, ms: mix_kernel
// 0.618; 2 columns a thread, groups of 4, 0.4348 (92 % of the bound);
// 4 columns 0.4362, 1 column 0.4387, groups of 2 0.4417–0.4451; at (20,
// 1,000,000) 2 columns in groups of 4 led too (0.1073; at σ = 0 1 column,
// 0.0832 against 0.0839). The designs timed: tools/mix_variants.py
// (masked and dp modes), PERF.md.
//
// The stack mix is the same kernel over a 2-D grid: blockIdx.y selects
// the slab s, whose offset s·N·X is taken in int64_t (at S = 4, N = 32,
// X = 2^24 it passes 2^31). Every slab shares the one W; each block
// stages its chunks of W as above, so a slab with N <= 64 is read once
// and one with N > 64 once per chunk of 64 output rows, like a flat
// plane. A flat plane is the stack of one slab (gridDim.y = 1).
//
// The sparse mixes add a per-block activity test: the block's columns
// (128; 256 in the 40-row chunk; 32 or 128 in the narrow kernel) read
// their entries of the column-activity vector (a column is live iff any
// client keeps it), and __syncthreads_or decides on the device, with no
// host sync, whether any is live. A dead block writes exact zeros to its
// outputs and never reads the plane (the plane is zero on dead columns, so
// the mix is zero there anyway: the skip saves the read, it does not
// change the result). A live block runs the mix unchanged. In the narrow
// kernel the test is its one barrier, so a dead block has loaded its rows
// already and drops them: below kNarrowMaxX the plane (at most 8 MB) sits
// in L2, and a second round trip for the live blocks cost more than those
// reads (tools/mix_variants.py, (20, 17,226), 80 % of the blocks dead:
// 0.00234 against 0.00255 ms; random d0.2 masks 0.00280 against 0.00283).
// gossip_mix_sparse's least traffic is 4·(N² + X + N·X_live + N·X)
// bytes: W, the activity vector, the live columns of C, and the whole
// output. gossip_mix_dequant_masked reads,
// per live column, N int8 quanta, N fp32 mask entries and the N scales of
// its block (L1-resident across the block's columns), so its fp32 mask is
// 4× its int8 payload: 4·M·N + N·Xp_live + 4·N·Xp_live/qblock + 4·N·X_live + 4·X +
// 4·M·Xp bytes. An earlier version on the serving kernel's template
// (gossip_mix_dequant.cu: output rows in blocks of 8, a block's columns
// dequantized once per row block, activity found by scanning the mask)
// re-read the payload and mask once per row block and measured 2.35 ms
// past L2 against a 0.229 ms bound, slower than its plain version.
// mix_kernel_masked_vec tests activity by warp (128 columns) instead: a
// warp none of whose columns is live writes zeros and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gossip_mix.cuh"

namespace {

using gossip_mix::aligned;

constexpr int kThreads = 128;  // columns per block
constexpr int kGroup = 4;      // input rows whose loads are in flight together

// A prologue reads input row j at element offset k of the plane (or
// stack) and returns the value the mix consumes. A prologue with kSkip
// also says whether column col is live (any client keeps it).
// mix_kernel_narrow, whose threads keep one column, first takes the
// column's prologue, at(col), and reads its rows through that: the
// dequant prologues find their scale column there once, not once a row.
struct Identity {
  static constexpr bool kSkip = false;
  const float* c;
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    return __ldg(c + k);
  }
  __device__ __forceinline__ Identity at(int64_t) const { return *this; }
};

// The sparse exchange's plane: zero on the columns active[col] == 0.
struct SparseIdentity {
  static constexpr bool kSkip = true;
  const float* c;
  const float* active;  // (X,) fp32 {0,1}
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    return __ldg(c + k);
  }
  __device__ __forceinline__ bool live(int64_t col) const {
    return __ldg(active + col) != 0.f;
  }
  __device__ __forceinline__ SparseIdentity at(int64_t) const { return *this; }
};

// q ⊙ repeat(scale, qblock) on the int8 payload (N, Xp): kernel 4 on the
// square W of the narrow plane (Xp < kNarrowMaxX, so a column fits 32
// bits). Only mix_kernel_narrow takes it, through at(col).
struct Dequant {
  static constexpr bool kSkip = false;
  const int8_t* q;     // (N, Xp)
  const float* scale;  // (N, Xp / qblock)
  uint32_t nq, qblock;
  struct Column {
    const int8_t* q;
    const float* scale;  // row 0's scale of the column's block
    uint32_t nq;
    __device__ __forceinline__ float operator()(int j, int64_t k) const {
      return __fmul_rn(static_cast<float>(__ldg(q + k)), __ldg(scale + j * nq));
    }
  };
  __device__ __forceinline__ Column at(int64_t col) const {
    return {q, scale + static_cast<uint32_t>(col) / qblock, nq};
  }
};

// q ⊙ repeat(scale, qblock) ⊙ mask on the int8 payload (N, Xp); the mask
// and the activity vector have the logical width x <= xp, and columns
// past it are dead. The column index fits 32 bits (the wrapper checks
// Xp < 2^31).
struct MaskedDequant {
  static constexpr bool kSkip = true;
  const int8_t* q;      // (N, Xp)
  const float* scale;   // (N, Xp / qblock)
  const float* mask;    // (N, X)
  const float* active;  // (X,)
  int64_t x, xp;
  uint32_t nq, qblock;
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    const uint32_t col = static_cast<uint32_t>(k - static_cast<int64_t>(j) * xp);
    const float v = __fmul_rn(static_cast<float>(__ldg(q + k)),
                              __ldg(scale + static_cast<int64_t>(j) * nq + col / qblock));
    const float m = col < x ? __ldg(mask + static_cast<int64_t>(j) * x + col) : 0.f;
    return __fmul_rn(v, m);
  }
  __device__ __forceinline__ bool live(int64_t col) const {
    return col < x && __ldg(active + col) != 0.f;
  }
  struct Column {
    const int8_t* q;
    const float* scale;  // row 0's scale of the column's block
    const float* mask;   // row 0's mask entry of the column
    int64_t x;
    uint32_t nq;
    bool in_mask;        // col < x; else the mask reads as 0
    __device__ __forceinline__ float operator()(int j, int64_t k) const {
      const float v = __fmul_rn(static_cast<float>(__ldg(q + k)), __ldg(scale + j * nq));
      return __fmul_rn(v, in_mask ? __ldg(mask + j * x) : 0.f);
    }
  };
  __device__ __forceinline__ Column at(int64_t col) const {
    return {q, scale + static_cast<uint32_t>(col) / qblock, mask + col, x, nq, col < x};
  }
};

// c_old + scale ⊙ (c_new − c_old) [+ σ·noise] on the (N, X) planes.
template <bool kNoise>
struct FusedDP {
  static constexpr bool kSkip = false;
  const float* c_old;
  const float* c_new;
  const float* scale;  // (N,) per-client clip scale
  const float* noise;  // (N, X); unused unless kNoise
  float sigma;
  int64_t x;           // the row stride
  // one entry, each step rounded alone as the plain version rounds it
  __device__ __forceinline__ static float sanitized(float co, float cn, float s, float sigma,
                                                    float nz) {
    float v = __fadd_rn(co, __fmul_rn(s, __fsub_rn(cn, co)));
    if (kNoise) v = __fadd_rn(v, __fmul_rn(sigma, nz));
    return v;
  }
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    return sanitized(__ldg(c_old + k), __ldg(c_new + k), __ldg(scale + j), sigma,
                     kNoise ? __ldg(noise + k) : 0.f);
  }
  struct Column {
    const float* c_old;  // row 0's entry of the column
    const float* c_new;
    const float* noise;  // null unless kNoise
    const float* scale;
    int64_t x;
    float sigma;
    __device__ __forceinline__ float operator()(int j, int64_t) const {
      const int64_t k = j * x;
      return sanitized(__ldg(c_old + k), __ldg(c_new + k), __ldg(scale + j), sigma,
                       kNoise ? __ldg(noise + k) : 0.f);
    }
  };
  __device__ __forceinline__ Column at(int64_t col) const {
    return {c_old + col, c_new + col, kNoise ? noise + col : nullptr, scale, x, sigma};
  }
};

// out[s, i, col] = sum_j w[i, j] * prologue(row j of slab s, col) for the
// m output rows over n input rows, one thread per column of slab s =
// blockIdx.y. With Prologue::kSkip, a block none of whose columns is live
// writes zeros and reads no input.
template <int NB, class Prologue>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ w, Prologue in, float* __restrict__ out, int m,
           int n, int64_t x) {
  static_assert(NB % kGroup == 0, "a group never reads past the staged W chunk");
  __shared__ float sw[NB][NB];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n * x + col;   // input slab + column
  const int64_t obase = static_cast<int64_t>(blockIdx.y) * m * x + col;  // output slab + column
  const bool live = col < x;
  if constexpr (Prologue::kSkip) {
    // every thread of the block reaches this barrier, so the whole block
    // takes the same branch
    if (!__syncthreads_or(live && in.live(col))) {
      if (live) {
        for (int i = 0; i < m; ++i) out[obase + static_cast<int64_t>(i) * x] = 0.f;
      }
      return;
    }
  }
  for (int i0 = 0; i0 < m; i0 += NB) {
    float acc[NB];
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) acc[ii] = 0.f;
    for (int j0 = 0; j0 < n; j0 += NB) {
      __syncthreads();  // the previous chunk's readers of sw are done
      for (int t = threadIdx.x; t < NB * NB; t += kThreads) {
        const int i = i0 + t / NB, j = j0 + t % NB;
        sw[t / NB][t % NB] = (i < m && j < n) ? w[static_cast<int64_t>(i) * n + j] : 0.f;
      }
      __syncthreads();
      const int jn = min(NB, n - j0);
#pragma unroll 1
      for (int jg = 0; jg < jn; jg += kGroup) {
        float v[kGroup];  // kGroup independent loads in flight, then kGroup·NB FMAs
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int j = j0 + jg + jj;
          v[jj] = (live && jg + jj < jn) ? in(j, base + j * x) : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
          for (int ii = 0; ii < NB; ++ii) acc[ii] = fmaf(sw[ii][jg + jj], v[jj], acc[ii]);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int ii = 0; ii < NB; ++ii) {
        if (i0 + ii < m) out[obase + static_cast<int64_t>(i0 + ii) * x] = acc[ii];
      }
    }
  }
}

// The chunks past 32 rows (see the header). The 40-row chunk mixes 2
// columns a thread and prefetches without a branch (chip_smoke.py at (3,
// 37, 100,003): 0.0581 ms; with the branch, 0.0672); the 48- and 64-row
// chunks mix one, prefetch behind a branch and cap registers at 102 and
// 128 (tools/mix_variants.py: without the branch or the cap, slower).
template <int NB>
constexpr int kPer = NB == 40 ? 2 : 1;  // columns one thread mixes, kThreads apart
template <int NB>
constexpr bool kBranchless = NB == 40;  // no branch around the prefetch
template <int NB>
constexpr int kMinBlocks = NB == 48 ? 5 : NB == 64 ? 4 : 1;  // 1: no cap

// mix_kernel for NB = 40, 48 or 64: each thread mixes kPer<NB> columns
// and loads the next group of rows while it mixes the current one.
template <int NB, class Prologue>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NB>)
mix_kernel_wide(const float* __restrict__ w, Prologue in, float* __restrict__ out, int m,
                int n, int64_t x) {
  static_assert(NB > 32 && NB % kGroup == 0, "the chunks past 32 rows");
  constexpr int C = kPer<NB>;
  __shared__ float sw[NB][NB];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads * C + threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n * x + col;   // input slab + column
  const int64_t obase = static_cast<int64_t>(blockIdx.y) * m * x + col;  // output slab + column
  bool live[C];
#pragma unroll
  for (int c = 0; c < C; ++c) live[c] = col + c * kThreads < x;
  if constexpr (Prologue::kSkip) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) any = any || (live[c] && in.live(col + c * kThreads));
    if (!__syncthreads_or(any)) {  // as in mix_kernel
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (live[c]) {
          for (int i = 0; i < m; ++i) {
            out[obase + c * kThreads + static_cast<int64_t>(i) * x] = 0.f;
          }
        }
      }
      return;
    }
  }
  for (int i0 = 0; i0 < m; i0 += NB) {
    float acc[NB][C];
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[ii][c] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += NB) {
      __syncthreads();  // the previous chunk's readers of sw are done
      for (int t = threadIdx.x; t < NB * NB; t += kThreads) {
        const int i = i0 + t / NB, j = j0 + t % NB;
        sw[t / NB][t % NB] = (i < m && j < n) ? w[static_cast<int64_t>(i) * n + j] : 0.f;
      }
      __syncthreads();
      const int jn = min(NB, n - j0);
      // kGroup·C loads in flight while kGroup·NB·C FMAs consume the last ones
      float v[kGroup][C], ahead[kGroup][C];
      auto load = [&](int jg, float (&dst)[kGroup][C]) {
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int j = j0 + jg + jj;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dst[jj][c] = (live[c] && jg + jj < jn) ? in(j, base + c * kThreads + j * x) : 0.f;
          }
        }
      };
      load(0, ahead);
#pragma unroll 1
      for (int jg = 0; jg < jn; jg += kGroup) {
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
          for (int c = 0; c < C; ++c) v[jj][c] = ahead[jj][c];
        }
        // rows past jn read as 0, so the branch only skips the last group's
        // loads; without it the loads and the FMAs below are one basic
        // block, which ptxas schedules loads first (with it, it placed the
        // 40-row chunk's loads after the FMAs)
        if (kBranchless<NB> || jg + kGroup < jn) load(jg + kGroup, ahead);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
          for (int ii = 0; ii < NB; ++ii) {
            const float wv = sw[ii][jg + jj];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[ii][c] = fmaf(wv, v[jj][c], acc[ii][c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (live[c]) {
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) {
          if (i0 + ii < m) {
            out[obase + c * kThreads + static_cast<int64_t>(i0 + ii) * x] = acc[ii][c];
          }
        }
      }
    }
  }
}

// The narrow plane (see the header): a square W of N <= 32 rows over a
// plane narrower than kNarrowMaxX columns, NB = N rounded up to 4.
constexpr int kNarrowThreads = 128;
// Threads a column: past 8 rows 4 (32 columns a block, one warp a row
// group); up to 8 one, which keeps its column's rows in registers.
template <int NB>
constexpr int kNarrowSplit = NB <= 8 ? 1 : 4;
// The width below which a square W takes mix_kernel_narrow: the first
// width at which the flat mix lost to mix_kernel at some N. Measured by
// tools/mix_variants.py crossover (H100 80GB HBM3, 700 W; mix_kernel_narrow
// ÷ mix_kernel at N = 1, 4, 8, …, 32, X = 17,226 to 4,194,304): 0.60–0.76
// at X = 17,226 and 0.71–0.85 at 32,768, every N; at 65,536 1.04 and 1.05
// at N = 24 and 32.
constexpr int64_t kNarrowMaxX = 65536;
// The width from which the fused DP mix (kernel 2) at an even X, with
// planes 8-byte aligned, takes mix_kernel_dp_vec rather than
// mix_kernel_narrow; an odd X or an unaligned plane keeps the narrow
// kernel up to kNarrowMaxX, where it beat mix_kernel at every N (÷
// mix_kernel 0.45–0.92). Measured by tools/mix_variants.py dp (H100 80GB
// HBM3, 700 W; σ = 0.5, N = 1, 4, 8, …, 32): mix_kernel_narrow ÷
// mix_kernel_dp_vec 1.02–1.31 at X = 49,152 and 1.02–1.43 at 65,536, every
// N; at 32,768 0.89–0.94 at N = 12, 16, 24, 28, 32.
constexpr int64_t kDpVecMinX = 49152;

// out[i, col] = sum_j w[i, j] * prologue(row j, col) for the n rows of a
// flat plane. Every load of the block is issued before its one barrier:
// W, the thread's rows tr, tr + S, … of its column and, with
// Prologue::kSkip, the column's activity, so a block none of whose
// columns is live writes zeros after the barrier and drops the rows it
// loaded. Past 8 rows the S = 4 threads of a column meet in a shared tile
// (sc) and thread (tc, tr) mixes output rows tr·NB/4 … of column tc from
// all n rows; each output sums j ascending from 0.f, as mix_kernel does.
template <int NB, class Prologue>
__global__ void __launch_bounds__(kNarrowThreads)
mix_kernel_narrow(const float* __restrict__ w, Prologue in, float* __restrict__ out, int n,
                  int64_t x) {
  constexpr int S = kNarrowSplit<NB>;
  constexpr int BC = kNarrowThreads / S;                                // columns a block
  constexpr int RB = NB / S;                                            // output rows a thread
  constexpr int WPT = (NB * NB + kNarrowThreads - 1) / kNarrowThreads;  // W entries a thread
  static_assert(NB % kGroup == 0 && NB % S == 0 && NB <= 32, "the narrow chunks");
  __shared__ float sw[NB][NB];
  __shared__ float sc[S == 1 ? 1 : NB][S == 1 ? 1 : BC];  // the column tile, past 8 rows
  const int tc = threadIdx.x % BC, tr = threadIdx.x / BC;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * BC + tc;
  const bool live = col < x;
  const auto cin = in.at(col);  // the column's prologue
  float wv[WPT], cv[RB];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kNarrowThreads, i = t / NB, j = t % NB;
    wv[k] = (i < n && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int j = tr + k * S;
    cv[k] = (live && j < n) ? cin(j, j * x + col) : 0.f;
  }
  bool any = false;
  if constexpr (Prologue::kSkip) any = live && in.live(col);
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kNarrowThreads;
    if (t < NB * NB) sw[t / NB][t % NB] = wv[k];
  }
  if constexpr (S > 1) {
#pragma unroll
    for (int k = 0; k < RB; ++k) sc[tr + k * S][tc] = cv[k];
  }
  const int r0 = tr * RB;
  if constexpr (Prologue::kSkip) {
    if (!__syncthreads_or(any)) {  // the whole block takes the same branch
      if (live) {
        for (int i = r0; i < min(n, r0 + RB); ++i) out[static_cast<int64_t>(i) * x + col] = 0.f;
      }
      return;
    }
  } else {
    __syncthreads();
  }
  float acc[RB];
#pragma unroll
  for (int ii = 0; ii < RB; ++ii) acc[ii] = 0.f;
#pragma unroll
  for (int jg = 0; jg < NB; jg += kGroup) {
    if (jg < n) {  // rows past n are 0 in sw and in the column
      float v[kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        if constexpr (S == 1) {
          v[jj] = cv[jg + jj];
        } else {
          v[jj] = sc[jg + jj][tc];
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
        for (int ii = 0; ii < RB; ++ii) acc[ii] = fmaf(sw[r0 + ii][jg + jj], v[jj], acc[ii]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int ii = 0; ii < RB; ++ii) {
      if (r0 + ii < n) out[static_cast<int64_t>(r0 + ii) * x + col] = acc[ii];
    }
  }
}

// f(std::integral_constant<int, NB>{}) with NB = rows rounded up to 4
// (rows <= 32): the chunk of the kernels that take up to 32 rows in one.
template <class F>
void with_nb(int rows, F&& f) {
  switch ((rows + kGroup - 1) / kGroup) {
    case 1: f(std::integral_constant<int, 4>{}); break;
    case 2: f(std::integral_constant<int, 8>{}); break;
    case 3: f(std::integral_constant<int, 12>{}); break;
    case 4: f(std::integral_constant<int, 16>{}); break;
    case 5: f(std::integral_constant<int, 20>{}); break;
    case 6: f(std::integral_constant<int, 24>{}); break;
    case 7: f(std::integral_constant<int, 28>{}); break;
    default: f(std::integral_constant<int, 32>{}); break;
  }
}

// mix_kernel_narrow with NB = n rounded up to 4 (n <= 32)
template <class Prologue>
void launch_narrow(const float* w, Prologue in, float* out, int n, int64_t x,
                   cudaStream_t stream) {
  with_nb(n, [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    constexpr int64_t cols = kNarrowThreads / kNarrowSplit<NB>;  // per block
    const unsigned grid = static_cast<unsigned>((x + cols - 1) / cols);
    mix_kernel_narrow<NB, Prologue><<<grid, kNarrowThreads, 0, stream>>>(w, in, out, n, x);
  });
}

// A square W of at most 32 rows over a plane narrower than kNarrowMaxX:
// the shapes mix_kernel_narrow takes.
constexpr bool narrow_plane(int m, int n, int64_t x) {
  return m == n && n <= 32 && x < kNarrowMaxX;
}

// Kernel 6 past the narrow plane (see the header): a thread owns kVec
// adjacent columns, a block 512, a warp 128.
constexpr int kVec = 4;
constexpr int kVecThreads = 128;

// out[i, col + t] = sum_j w[i, j] * (q ⊙ repeat(scale) ⊙ mask)[j, col + t],
// t < kVec, for m, n <= NB rows; x, xp and qblock are multiples of kVec,
// so a thread's columns lie all in the mask or all past it and share one
// scale block. W is staged before the block's one barrier; then a warp
// none of whose columns is live writes zeros and reads nothing. Each
// output sums j ascending from 0.f, as mix_kernel does: the same bits.
template <int NB>
__global__ void __launch_bounds__(kVecThreads)
mix_kernel_masked_vec(const float* __restrict__ w, MaskedDequant in, float* __restrict__ out,
                      int m, int n) {
  static_assert(NB % kGroup == 0 && NB <= 32, "up to 32 rows");
  constexpr int WPT = (NB * NB + kVecThreads - 1) / kVecThreads;  // W entries a thread
  __shared__ float sw[NB][NB];
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kVecThreads + threadIdx.x) * kVec;
  const bool in_plane = col < in.xp;
  const bool in_mask = col < in.x;
  float wv[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kVecThreads, i = t / NB, j = t % NB;
    wv[k] = (i < m && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
  bool live = false;
  if (in_mask) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(in.active + col));
    live = a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
  }
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kVecThreads;
    if (t < NB * NB) sw[t / NB][t % NB] = wv[k];
  }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + col);  // output row i at o + i * orow
  const int64_t orow = in.xp / kVec;
  if (!__any_sync(0xffffffffu, live)) {
    if (in_plane) {
      for (int i = 0; i < m; ++i) o[i * orow] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int8_t* qc = in.q + col;
  const float* sc = in.scale + static_cast<uint32_t>(col) / in.qblock;  // found once
  const float* mc = in.mask + col;
  float acc[NB][kVec];
#pragma unroll
  for (int ii = 0; ii < NB; ++ii) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[ii][t] = 0.f;
  }
#pragma unroll
  for (int jg = 0; jg < NB; jg += kGroup) {
    if (jg < n) {  // rows past n are 0 in sw and in v
      // a row: a char4 of quanta, its block's scale and a float4 of mask
      float v[kGroup][kVec];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = jg + jj;
        char4 c4 = make_char4(0, 0, 0, 0);
        float s = 0.f;
        float4 mk = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in_plane && j < n) {
          c4 = __ldg(reinterpret_cast<const char4*>(qc + j * in.xp));
          s = __ldg(sc + static_cast<int64_t>(j) * in.nq);
          if (in_mask) mk = __ldg(reinterpret_cast<const float4*>(mc + j * in.x));
        }
        v[jj][0] = __fmul_rn(__fmul_rn(static_cast<float>(c4.x), s), mk.x);
        v[jj][1] = __fmul_rn(__fmul_rn(static_cast<float>(c4.y), s), mk.y);
        v[jj][2] = __fmul_rn(__fmul_rn(static_cast<float>(c4.z), s), mk.z);
        v[jj][3] = __fmul_rn(__fmul_rn(static_cast<float>(c4.w), s), mk.w);
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) {
          const float wij = sw[ii][jg + jj];
#pragma unroll
          for (int t = 0; t < kVec; ++t) acc[ii][t] = fmaf(wij, v[jj][t], acc[ii][t]);
        }
      }
    }
  }
  if (in_plane) {
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) {
      if (ii < m) o[ii * orow] = make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    }
  }
}

// mix_kernel_masked_vec with NB = max(m, n) rounded up to 4 (<= 32)
void launch_masked_vec(const float* w, const MaskedDequant& in, float* out, int m, int n,
                       cudaStream_t stream) {
  with_nb(max(m, n), [&](auto nb) {
    constexpr int64_t cols = kVecThreads * kVec;  // per block
    const unsigned grid = static_cast<unsigned>((in.xp + cols - 1) / cols);
    mix_kernel_masked_vec<decltype(nb)::value><<<grid, kVecThreads, 0, stream>>>(w, in, out, m,
                                                                                n);
  });
}

// Kernel 2 past the narrow plane (see the header): a thread owns V
// adjacent columns (V floats of c_old, c_new and, with noise, noise a row,
// and one scale), a block kVecThreads·V; the shipped design is kDpVec
// columns in row groups of kDpGroup (tools/mix_variants.py dp).
constexpr int kDpVec = 2;
constexpr int kDpGroup = 4;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (V == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// out[i, col + t] = sum_j w[i, j] * sanitized(j, col + t), t < V, for a
// square W of n <= NB rows; x is a multiple of V and the planes V·4-byte
// aligned. W is staged before the block's one barrier; then each group of
// G rows issues its 3·G (2·G without noise) vector loads and G scales
// together. Each output sums j ascending from 0.f, as mix_kernel does: the
// same bits.
template <int NB, int V, int G, bool kNoise>
__global__ void __launch_bounds__(kVecThreads)
mix_kernel_dp_vec(const float* __restrict__ w, FusedDP<kNoise> in, float* __restrict__ out,
                  int n) {
  static_assert(NB % G == 0 && NB <= 32 && (V == 1 || V == 2 || V == 4), "up to 32 rows");
  constexpr int WPT = (NB * NB + kVecThreads - 1) / kVecThreads;  // W entries a thread
  __shared__ float sw[NB][NB];
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kVecThreads + threadIdx.x) * V;
  float wv[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kVecThreads, i = t / NB, j = t % NB;
    wv[k] = (i < n && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kVecThreads;
    if (t < NB * NB) sw[t / NB][t % NB] = wv[k];
  }
  __syncthreads();
  if (col >= in.x) return;
  const float* co = in.c_old + col;
  const float* cn = in.c_new + col;
  const float* nz = kNoise ? in.noise + col : nullptr;
  float acc[NB][V];
#pragma unroll
  for (int ii = 0; ii < NB; ++ii) {
#pragma unroll
    for (int t = 0; t < V; ++t) acc[ii][t] = 0.f;
  }
#pragma unroll
  for (int jg = 0; jg < NB; jg += G) {
    if (jg < n) {  // rows past n are 0 in sw and in v
      float a[G][V], b[G][V], z[G][V], s[G], v[G][V];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int j = jg + jj;
#pragma unroll
        for (int t = 0; t < V; ++t) a[jj][t] = b[jj][t] = z[jj][t] = 0.f;
        s[jj] = 0.f;
        if (j < n) {
          const int64_t k = j * in.x;
          load_vec<V>(co + k, a[jj]);
          load_vec<V>(cn + k, b[jj]);
          if (kNoise) load_vec<V>(nz + k, z[jj]);
          s[jj] = __ldg(in.scale + j);
        }
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
#pragma unroll
        for (int t = 0; t < V; ++t) {
          v[jj][t] = FusedDP<kNoise>::sanitized(a[jj][t], b[jj][t], s[jj], in.sigma, z[jj][t]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) {
          const float wij = sw[ii][jg + jj];
#pragma unroll
          for (int t = 0; t < V; ++t) acc[ii][t] = fmaf(wij, v[jj][t], acc[ii][t]);
        }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < NB; ++ii) {
    if (ii < n) store_vec<V>(out + ii * in.x + col, acc[ii]);
  }
}

// mix_kernel_dp_vec with NB = n rounded up to 4 (n <= 32)
template <int V, int G, bool kNoise>
void launch_dp_vec(const float* w, const FusedDP<kNoise>& in, float* out, int n,
                   cudaStream_t stream) {
  with_nb(n, [&](auto nb) {
    constexpr int64_t cols = kVecThreads * V;  // per block
    const unsigned grid = static_cast<unsigned>((in.x + cols - 1) / cols);
    mix_kernel_dp_vec<decltype(nb)::value, V, G, kNoise><<<grid, kVecThreads, 0, stream>>>(
        w, in, out, n);
  });
}

// The shapes mix_kernel_dp_vec takes: from kDpVecMinX columns, up to 32
// rows, x a multiple of kDpVec and the planes aligned to kDpVec floats.
template <bool kNoise>
bool dp_vec_shape(const FusedDP<kNoise>& in, const float* out, int n) {
  constexpr uintptr_t bytes = sizeof(float) * kDpVec;
  return in.x >= kDpVecMinX && n <= 32 && in.x % kDpVec == 0 &&
         aligned(in.c_old, bytes) && aligned(in.c_new, bytes) && aligned(out, bytes) &&
         (!kNoise || aligned(in.noise, bytes));
}

template <int NB, class Prologue>
void launch_nb(const float* w, Prologue in, float* out, int slabs, int m, int n, int64_t x,
               cudaStream_t stream) {
  if constexpr (NB <= 32) {
    const dim3 grid(static_cast<unsigned>((x + kThreads - 1) / kThreads),
                    static_cast<unsigned>(slabs));
    mix_kernel<NB, Prologue><<<grid, kThreads, 0, stream>>>(w, in, out, m, n, x);
  } else {
    constexpr int64_t cols = kThreads * kPer<NB>;  // per block
    const dim3 grid(static_cast<unsigned>((x + cols - 1) / cols), static_cast<unsigned>(slabs));
    mix_kernel_wide<NB, Prologue><<<grid, kThreads, 0, stream>>>(w, in, out, m, n, x);
  }
}

// Mixes `slabs` consecutive (n, x) planes into (m, x) outputs with the
// same (m, n) W. With kNarrow (the flat, sparse and masked dequant mixes),
// one plane of the narrow_plane shape takes mix_kernel_narrow.
template <bool kNarrow = false, class Prologue>
int launch(const float* w, Prologue in, float* out, int slabs, int m, int n, int64_t x,
           void* stream) {
  if (slabs > 0 && m > 0 && n > 0 && x > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows = max(m, n);
    if (kNarrow && slabs == 1 && narrow_plane(m, n, x)) {
      if constexpr (kNarrow) launch_narrow(w, in, out, n, x, s);
    } else if (rows <= 8) {
      launch_nb<8>(w, in, out, slabs, m, n, x, s);
    } else if (rows <= 16) {
      launch_nb<16>(w, in, out, slabs, m, n, x, s);
    } else if (rows <= 24) {
      launch_nb<24>(w, in, out, slabs, m, n, x, s);
    } else if (rows <= 32) {
      launch_nb<32>(w, in, out, slabs, m, n, x, s);
    } else if (rows <= 40) {
      launch_nb<40>(w, in, out, slabs, m, n, x, s);
    } else if (rows <= 48) {
      launch_nb<48>(w, in, out, slabs, m, n, x, s);
    } else {
      launch_nb<64>(w, in, out, slabs, m, n, x, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace gossip_mix {

bool launch_dequant_narrow(const float* w, const int8_t* q, const float* scales, float* out,
                           int m, int n, int64_t xp, int64_t qblock, cudaStream_t stream) {
  if (!narrow_plane(m, n, xp)) return false;
  const Dequant in{q, scales, static_cast<uint32_t>(xp / qblock), static_cast<uint32_t>(qblock)};
  launch_narrow(w, in, out, n, xp, stream);
  return true;
}

}  // namespace gossip_mix

extern "C" {

// C' = W · C. w (n, n), c and out (n, x), fp32, contiguous, on the device.
int gossip_mix_flat(const float* w, const float* c, float* out, int n,
                    long long x, void* stream) {
  return launch<true>(w, Identity{c}, out, 1, n, n, x, stream);
}

// C'_s = W · C_s for every s. w (n, n); c and out (s, n, x), fp32,
// contiguous, on the device; s <= 65535 (the grid's y extent).
int gossip_mix_stack(const float* w, const float* c, float* out, int s, int n,
                     long long x, void* stream) {
  return launch(w, Identity{c}, out, s, n, n, x, stream);
}

// C' = W · C for C zero on the columns where col_active (x,) is 0; a block
// of 128 columns all inactive writes zeros without reading C (narrower
// than kNarrowMaxX: of 32 or 128 columns, after reading it).
int gossip_mix_sparse(const float* w, const float* c, const float* col_active, float* out,
                      int n, long long x, void* stream) {
  return launch<true>(w, SparseIdentity{c, col_active}, out, 1, n, n, x, stream);
}

// out (m, xp) = w (m, n) · (q (n, xp) int8 ⊙ repeat(scales (n, xp/qblock), qblock)
// ⊙ mask (n, x)), the mask read as 0 on columns >= x; columns none of
// which col_active (x,) marks live are written as zeros, a block of 128
// (a warp of 128 in mix_kernel_masked_vec) without reading q, the scales
// or the mask (the narrow plane: a block of 32 or 128, after reading
// them). All contiguous on the device; x <= xp < 2^31, xp % qblock == 0.
// The narrow plane takes mix_kernel_narrow; else up to 32 rows with x,
// xp and qblock multiples of 4 and 16-byte aligned operands (q 4-byte)
// mix_kernel_masked_vec; else mix_kernel.
int gossip_mix_dequant_masked(const float* w, const int8_t* q, const float* scales,
                              const float* mask, const float* col_active, float* out, int m,
                              int n, long long x, long long xp, long long qblock,
                              void* stream) {
  const MaskedDequant in{q, scales, mask, col_active, x, xp,
                         static_cast<uint32_t>(xp / qblock), static_cast<uint32_t>(qblock)};
  if (m > 0 && n > 0 && xp > 0 && !narrow_plane(m, n, xp) && max(m, n) <= 32 &&
      x % kVec == 0 && xp % kVec == 0 && qblock % kVec == 0 && aligned(q, kVec) &&
      aligned(mask, 16) && aligned(col_active, 16) && aligned(out, 16)) {
    launch_masked_vec(w, in, out, m, n, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
  }
  return launch<true>(w, in, out, 1, m, n, xp, stream);
}

// C' = W · (c_old + scale ⊙ (c_new − c_old) [+ sigma · noise]); noise is
// read only when sigma > 0 (it may be null otherwise). scale is (n,). Up
// to 32 rows from kDpVecMinX columns, x even and the planes 8-byte
// aligned, mix_kernel_dp_vec; else the narrow plane mix_kernel_narrow;
// else mix_kernel (or mix_kernel_wide past 32 rows).
int gossip_mix_fused_dp(const float* w, const float* c_old, const float* c_new,
                        const float* scale, const float* noise, float sigma,
                        float* out, int n, long long x, void* stream) {
  auto run = [&](auto in) {
    if (n > 0 && x > 0 && dp_vec_shape(in, out, n)) {
      launch_dp_vec<kDpVec, kDpGroup>(w, in, out, n, static_cast<cudaStream_t>(stream));
      return static_cast<int>(cudaGetLastError());
    }
    return launch<true>(w, in, out, 1, n, n, x, stream);
  };
  if (sigma > 0.f) return run(FusedDP<true>{c_old, c_new, scale, noise, sigma, x});
  return run(FusedDP<false>{c_old, c_new, scale, nullptr, 0.f, x});
}

}  // extern "C"
