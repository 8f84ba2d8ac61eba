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
// groups of 4 rows), 7 in the sparse mix (the activity first). The flat
// and sparse mixes of N <= 32 rows below kNarrowMaxX columns take a kernel
// of their own. Every load a thread needs (its share of W, its rows of its
// column and, sparse, the column's activity) is issued before the block's
// one barrier. Past 8 rows four threads share a column (a block: 32
// columns, one warp per row group; 539 blocks at X = 17,226), meet in a
// shared tile and each mix NB/4 output rows from all N rows; up to 8 rows
// one thread mixes its column from registers. NB is N rounded up to 4, not
// 8: at N = 20 mix_kernel's 24-row chunk issues 20 % more FMAs. Each
// output sums j ascending from 0.f, as in mix_kernel: the same bits.
// tools/mix_variants.py at (20, 17,226), ms: mix_kernel 0.00436; one round
// trip, a thread a column 0.00369, NB 20 0.00330; 4 threads a column
// 0.00268; torch.matmul 0.00360; float2 loads of the tile gained little.
// Kernels 2, 3 and 6, and every plane past the narrow one, keep the
// kernels above.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kGroup = 4;      // input rows whose loads are in flight together

// A prologue reads input row j at element offset k of the plane (or
// stack) and returns the value the mix consumes. A prologue with kSkip
// also says whether column col is live (any client keeps it).
struct Identity {
  static constexpr bool kSkip = false;
  const float* c;
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    return __ldg(c + k);
  }
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
};

template <bool kNoise>
struct FusedDP {
  static constexpr bool kSkip = false;
  const float* c_old;
  const float* c_new;
  const float* scale;  // (N,) per-client clip scale
  const float* noise;  // (N, X); unused unless kNoise
  float sigma;
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    const float co = __ldg(c_old + k);
    float v = __fadd_rn(co, __fmul_rn(__ldg(scale + j), __fsub_rn(__ldg(c_new + k), co)));
    if (kNoise) v = __fadd_rn(v, __fmul_rn(sigma, __ldg(noise + k)));
    return v;
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

// The narrow plane (see the header): the flat and sparse mixes of N <= 32
// rows below kNarrowMaxX columns, NB = N rounded up to 4.
constexpr int kNarrowThreads = 128;
// Threads a column: past 8 rows 4 (32 columns a block, one warp a row
// group); up to 8 one, which keeps its column's rows in registers.
template <int NB>
constexpr int kNarrowSplit = NB <= 8 ? 1 : 4;
// The width below which the flat and sparse mixes take mix_kernel_narrow:
// the first width at which it lost to mix_kernel at some N. Measured by
// tools/mix_variants.py crossover (H100 80GB HBM3, 700 W; mix_kernel_narrow
// ÷ mix_kernel at N = 1, 4, 8, …, 32, X = 17,226 to 4,194,304): 0.60–0.76
// at X = 17,226 and 0.71–0.85 at 32,768, every N; at 65,536 1.04 and 1.05
// at N = 24 and 32.
constexpr int64_t kNarrowMaxX = 65536;

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
  float wv[WPT], cv[RB];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kNarrowThreads, i = t / NB, j = t % NB;
    wv[k] = (i < n && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int j = tr + k * S;
    cv[k] = (live && j < n) ? in(j, j * x + col) : 0.f;
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

template <int NB, class Prologue>
void launch_narrow_nb(const float* w, Prologue in, float* out, int n, int64_t x,
                      cudaStream_t stream) {
  constexpr int64_t cols = kNarrowThreads / kNarrowSplit<NB>;  // per block
  const unsigned grid = static_cast<unsigned>((x + cols - 1) / cols);
  mix_kernel_narrow<NB, Prologue><<<grid, kNarrowThreads, 0, stream>>>(w, in, out, n, x);
}

// mix_kernel_narrow with NB = n rounded up to 4 (n <= 32)
template <class Prologue>
void launch_narrow(const float* w, Prologue in, float* out, int n, int64_t x,
                   cudaStream_t stream) {
  switch ((n + kGroup - 1) / kGroup) {
    case 1: launch_narrow_nb<4>(w, in, out, n, x, stream); break;
    case 2: launch_narrow_nb<8>(w, in, out, n, x, stream); break;
    case 3: launch_narrow_nb<12>(w, in, out, n, x, stream); break;
    case 4: launch_narrow_nb<16>(w, in, out, n, x, stream); break;
    case 5: launch_narrow_nb<20>(w, in, out, n, x, stream); break;
    case 6: launch_narrow_nb<24>(w, in, out, n, x, stream); break;
    case 7: launch_narrow_nb<28>(w, in, out, n, x, stream); break;
    default: launch_narrow_nb<32>(w, in, out, n, x, stream); break;
  }
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
// same (m, n) W. With kNarrow (the flat and sparse mixes), a plane of at
// most 32 rows narrower than kNarrowMaxX takes mix_kernel_narrow.
template <bool kNarrow = false, class Prologue>
int launch(const float* w, Prologue in, float* out, int slabs, int m, int n, int64_t x,
           void* stream) {
  if (slabs > 0 && m > 0 && n > 0 && x > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows = max(m, n);
    if (kNarrow && slabs == 1 && m == n && n <= 32 && x < kNarrowMaxX) {
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
// ⊙ mask (n, x)), the mask read as 0 on columns >= x; a block of 128
// columns none of which col_active (x,) marks live writes zeros without
// reading q, the scales or the mask. All contiguous on the device;
// x <= xp < 2^31, xp % qblock == 0.
int gossip_mix_dequant_masked(const float* w, const int8_t* q, const float* scales,
                              const float* mask, const float* col_active, float* out, int m,
                              int n, long long x, long long xp, long long qblock,
                              void* stream) {
  const MaskedDequant in{q, scales, mask, col_active, x, xp,
                         static_cast<uint32_t>(xp / qblock), static_cast<uint32_t>(qblock)};
  return launch(w, in, out, 1, m, n, xp, stream);
}

// C' = W · (c_old + scale ⊙ (c_new − c_old) [+ sigma · noise]); noise is
// read only when sigma > 0 (it may be null otherwise). scale is (n,).
int gossip_mix_fused_dp(const float* w, const float* c_old, const float* c_new,
                        const float* scale, const float* noise, float sigma,
                        float* out, int n, long long x, void* stream) {
  if (sigma > 0.f) {
    return launch(w, FusedDP<true>{c_old, c_new, scale, noise, sigma}, out, 1, n, n, x,
                  stream);
  }
  return launch(w, FusedDP<false>{c_old, c_new, scale, nullptr, 0.f}, out, 1, n, n, x,
                stream);
}

}  // extern "C"
