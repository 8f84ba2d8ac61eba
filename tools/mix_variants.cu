// Variants of the gossip mix template (src/repro_torch/kernels/csrc/
// gossip_mix.cu, W·C over an (S, N, X) stack, plain fp32 prologue), built
// and timed side by side by tools/mix_variants.py. Not part of the port:
// it measures which design the template takes past 32 rows.
//
// mixv<NB, G, P, C, S, MB, B>: NB rows per chunk of W; G input rows whose
// loads are issued together; P: the next group's loads are issued before
// the current group is mixed; C columns per thread, kThreads / S apart;
// S threads share a column, each with NB / S of its output rows; MB the
// blocks-per-SM hint of __launch_bounds__ (1: none); B: no branch around
// the prefetch (the last group's loads read rows past the chunk as 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int NB, int G, bool P, int C, int S, int MB, bool B>
__global__ void __launch_bounds__(kThreads, MB)
mixv(const float* __restrict__ w, const float* __restrict__ c, float* __restrict__ out, int m,
     int n, int64_t x) {
  constexpr int L = kThreads / S, RB = NB / S;
  constexpr int WS = NB + G;  // W rows padded so a group never reads past one
  __shared__ float sw[NB][WS];
  const int r0 = static_cast<int>(threadIdx.x / L) * RB;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * L * C + threadIdx.x % L;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n * x + col;
  const int64_t obase = static_cast<int64_t>(blockIdx.y) * m * x + col;
  bool live[C];
#pragma unroll
  for (int q = 0; q < C; ++q) live[q] = col + q * L < x;
  for (int i0 = 0; i0 < m; i0 += NB) {
    float acc[RB][C];
#pragma unroll
    for (int ii = 0; ii < RB; ++ii)
#pragma unroll
      for (int q = 0; q < C; ++q) acc[ii][q] = 0.f;
    for (int j0 = 0; j0 < n; j0 += NB) {
      __syncthreads();
      for (int t = threadIdx.x; t < NB * WS; t += kThreads) {
        const int i = i0 + t / WS, jl = t % WS, j = j0 + jl;
        sw[t / WS][jl] = (jl < NB && i < m && j < n) ? w[static_cast<int64_t>(i) * n + j] : 0.f;
      }
      __syncthreads();
      const int jn = min(NB, n - j0);
      float v[G][C], ahead[G][C];
      auto load = [&](int jg, float (&dst)[G][C]) {
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const int j = j0 + jg + jj;
            dst[jj][q] = (live[q] && jg + jj < jn) ? __ldg(c + base + q * L + j * x) : 0.f;
          }
      };
      if (P) load(0, ahead);
#pragma unroll 1
      for (int jg = 0; jg < jn; jg += G) {
        if (P) {
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
#pragma unroll
            for (int q = 0; q < C; ++q) v[jj][q] = ahead[jj][q];
          if (B || jg + G < jn) load(jg + G, ahead);
        } else {
          load(jg, v);
        }
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int ii = 0; ii < RB; ++ii) {
            const float wv = sw[r0 + ii][jg + jj];
#pragma unroll
            for (int q = 0; q < C; ++q) acc[ii][q] = fmaf(wv, v[jj][q], acc[ii][q]);
          }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (live[q])
#pragma unroll
        for (int ii = 0; ii < RB; ++ii)
          if (i0 + r0 + ii < m)
            out[obase + q * L + static_cast<int64_t>(i0 + r0 + ii) * x] = acc[ii][q];
  }
}

template <int NB, int G, bool P, int C, int S, int MB, bool B>
int run(const float* w, const float* c, float* o, int s, int n, long long x, void* st) {
  constexpr int cols = kThreads / S * C;
  const dim3 grid(static_cast<unsigned>((x + cols - 1) / cols), static_cast<unsigned>(s));
  mixv<NB, G, P, C, S, MB, B><<<grid, kThreads, 0, static_cast<cudaStream_t>(st)>>>(w, c, o, n, n,
                                                                                x);
  return cudaGetLastError();
}

}  // namespace

// name: NB, G, prefetch, columns a thread, threads a column, blocks-per-SM
// hint, no branch around the prefetch
#define VARIANT(name, NB, G, P, C, S, MB, B)                                                   \
  extern "C" int name(const float* w, const float* c, float* o, int s, int n, long long x, \
                      void* st) {                                                         \
    return run<NB, G, P, C, S, MB, B>(w, c, o, s, n, x, st);                                 \
  }

VARIANT(nb24_first, 24, 4, false, 1, 1, 1, false)
VARIANT(nb24_prefetch, 24, 4, true, 1, 1, 1, false)
VARIANT(nb24_prefetch_2col, 24, 4, true, 2, 1, 1, false)
VARIANT(nb40_first, 40, 4, false, 1, 1, 1, false)
VARIANT(nb40_rows_split2, 40, 4, false, 1, 2, 1, false)
VARIANT(nb40_rows_split4_4col, 40, 4, false, 4, 4, 1, false)
VARIANT(nb40_group8, 40, 8, false, 1, 1, 1, false)
VARIANT(nb40_prefetch, 40, 4, true, 1, 1, 1, false)
VARIANT(nb40_prefetch_2col, 40, 4, true, 2, 1, 1, false)
VARIANT(nb40_prefetch_2col_nobranch, 40, 4, true, 2, 1, 1, true)
VARIANT(nb48_first, 48, 4, false, 1, 1, 1, false)
VARIANT(nb48_prefetch, 48, 4, true, 1, 1, 1, false)
VARIANT(nb48_prefetch_2col, 48, 4, true, 2, 1, 1, false)
VARIANT(nb48_prefetch_cap5, 48, 4, true, 1, 1, 5, false)
VARIANT(nb48_prefetch_cap5_nobranch, 48, 4, true, 1, 1, 5, true)
VARIANT(nb64_first, 64, 4, false, 1, 1, 1, false)
VARIANT(nb64_prefetch, 64, 4, true, 1, 1, 1, false)
VARIANT(nb64_prefetch_2col, 64, 4, true, 2, 1, 1, false)
VARIANT(nb64_prefetch_cap4, 64, 4, true, 1, 1, 4, false)
VARIANT(nb64_prefetch_cap4_nobranch, 64, 4, true, 1, 1, 4, true)
