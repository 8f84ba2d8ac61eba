// Variants of the gossip mix (src/repro_torch/kernels/csrc/gossip_mix.cu,
// W·C over an (S, N, X) stack), built and timed side by side by
// tools/mix_variants.py. Not part of the port: it measures which design
// the shipped kernels take. The shipped source is included, so its
// kernels (mix_kernel, mix_kernel_wide, mix_kernel_narrow) are timed as
// they are, beside the variants, in one build.
//
// mixv<NB, G, P, C, S, MB, B> (past 32 rows): NB rows per chunk of W; G
// input rows whose loads are issued together; P: the next group's loads
// are issued before the current group is mixed; C columns per thread,
// kThreads / S apart; S threads share a column, each with NB / S of its
// output rows; MB the blocks-per-SM hint of __launch_bounds__ (1: none);
// B: no branch around the prefetch (the last group's loads read rows past
// the chunk as 0).
//
// mixn<NB, T, S, F2, SP> (the narrow plane: N <= 32, the plane resident
// in L2): every load a thread needs is issued before the block's one
// barrier. NB rows (a multiple of 4, >= n); T threads a block; S threads
// share a column: S = 1 keeps the column's NB rows in the thread's
// registers, S > 1 stages the block's (NB, T / S) tile of C in shared
// memory and each thread mixes NB / S output rows of one column; F2: the
// tile is loaded as float2 (X even); SP: 0 dense, 1 sparse with the
// activity loaded beside the plane and the dead-block test on the one
// barrier (a dead block drops what it loaded), 2 sparse with the activity
// and W in the first round trip and the plane in a second.

#include "../src/repro_torch/kernels/csrc/gossip_mix.cu"

namespace mixvar {

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

constexpr int kG = 4;  // rows per group of FMAs, as in mix_kernel

template <int NB, int T, int S, bool F2, int SP>
__global__ void __launch_bounds__(T)
mixn(const float* __restrict__ w, const float* __restrict__ c, const float* __restrict__ act,
     float* __restrict__ out, int n, int64_t x) {
  constexpr int BC = T / S;   // columns a block
  constexpr int RB = NB / S;  // output rows a thread
  static_assert(NB % kG == 0 && NB % S == 0 && T % S == 0 && (S == 1 || BC % 32 == 0),
                "a warp shares one row group");
  static_assert(!F2 || (S > 1 && (NB * BC / 2) % T == 0), "float2 tile");
  constexpr int WPT = (NB * NB + T - 1) / T;                   // W entries a thread
  constexpr int TPT = S == 1 ? NB : F2 ? NB * BC / 2 / T : NB / S;  // plane loads a thread
  __shared__ float sw[NB][NB];
  __shared__ float sc[S == 1 ? 1 : NB][S == 1 ? 1 : BC];
  const int tc = threadIdx.x % BC, tr = threadIdx.x / BC;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BC;
  const int64_t col = col0 + tc;
  const bool live = col < x;
  const int r0 = tr * RB;

  float wr[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * T, i = t / NB, j = t % NB;
    wr[k] = (t < NB * NB && i < n && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
  bool any = false;
  if constexpr (SP != 0) any = live && __ldg(act + col) != 0.f;

  float v[S == 1 ? NB : 1];
  float tv[S == 1 ? 1 : F2 ? 2 * TPT : TPT];
  auto load_plane = [&]() {
    if constexpr (S == 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = (live && j < n) ? __ldg(c + j * x + col) : 0.f;
    } else if constexpr (!F2) {
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int j = tr + k * S;
        tv[k] = (live && j < n) ? __ldg(c + j * x + col) : 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int e = threadIdx.x + k * T, j = e / (BC / 2), pc = 2 * (e % (BC / 2));
        const int64_t cc = col0 + pc;
        const float2 p = (j < n && cc < x)
                             ? __ldg(reinterpret_cast<const float2*>(c + j * x + cc))
                             : make_float2(0.f, 0.f);
        tv[2 * k] = p.x;
        tv[2 * k + 1] = p.y;
      }
    }
  };
  auto store_tile = [&]() {
    if constexpr (S > 1 && !F2) {
#pragma unroll
      for (int k = 0; k < TPT; ++k) sc[tr + k * S][tc] = tv[k];
    } else if constexpr (S > 1) {
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int e = threadIdx.x + k * T, j = e / (BC / 2), pc = 2 * (e % (BC / 2));
        sc[j][pc] = tv[2 * k];
        sc[j][pc + 1] = tv[2 * k + 1];
      }
    }
  };
  if constexpr (SP != 2) load_plane();
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * T;
    if (t < NB * NB) sw[t / NB][t % NB] = wr[k];
  }
  if constexpr (SP != 2) store_tile();
  if constexpr (SP != 0) {
    if (!__syncthreads_or(any)) {
      if (live) {
        for (int i = r0; i < min(n, r0 + RB); ++i) out[static_cast<int64_t>(i) * x + col] = 0.f;
      }
      return;
    }
  } else {
    __syncthreads();
  }
  if constexpr (SP == 2) {
    load_plane();
    if constexpr (S > 1) {
      store_tile();
      __syncthreads();
    }
  }
  float acc[RB];
#pragma unroll
  for (int ii = 0; ii < RB; ++ii) acc[ii] = 0.f;
#pragma unroll
  for (int jg = 0; jg < NB; jg += kG) {
    if (jg < n) {
      float vv[kG];
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
        if constexpr (S == 1) {
          vv[jj] = v[jg + jj];
        } else {
          vv[jj] = sc[jg + jj][tc];
        }
      }
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
#pragma unroll
        for (int ii = 0; ii < RB; ++ii) acc[ii] = fmaf(sw[r0 + ii][jg + jj], vv[jj], acc[ii]);
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

template <int NB, int T, int S, bool F2, int SP>
int run_narrow(const float* w, const float* c, const float* act, float* o, int n, long long x,
               void* st) {
  constexpr int cols = T / S;
  const unsigned grid = static_cast<unsigned>((x + cols - 1) / cols);
  mixn<NB, T, S, F2, SP><<<grid, T, 0, static_cast<cudaStream_t>(st)>>>(w, c, act, o, n, x);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace mixvar

// name: NB, G, prefetch, columns a thread, threads a column, blocks-per-SM
// hint, no branch around the prefetch
#define VARIANT(name, NB, G, P, C, S, MB, B)                                                   \
  extern "C" int name(const float* w, const float* c, float* o, int s, int n, long long x, \
                      void* st) {                                                         \
    return mixvar::run<NB, G, P, C, S, MB, B>(w, c, o, s, n, x, st);                         \
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

// the narrow candidates, named n<NB>_t<T>_s<S>[_f2][_sp1|_sp2]:
// (w, c, act, out, n, x, stream); act is read by the sparse ones only
#define NARROW(name, NB, T, S, F2, SP)                                                        \
  extern "C" int name(const float* w, const float* c, const float* act, float* o, int n,     \
                      long long x, void* st) {                                             \
    return mixvar::run_narrow<NB, T, S, F2, SP>(w, c, act, o, n, x, st);                      \
  }

NARROW(n24_t128_s1, 24, 128, 1, false, 0)
NARROW(n24_t64_s1, 24, 64, 1, false, 0)
NARROW(n24_t32_s1, 24, 32, 1, false, 0)
NARROW(n20_t128_s1, 20, 128, 1, false, 0)
NARROW(n20_t64_s1, 20, 64, 1, false, 0)
NARROW(n24_t128_s2, 24, 128, 2, false, 0)
NARROW(n24_t128_s4, 24, 128, 4, false, 0)
NARROW(n24_t256_s4, 24, 256, 4, false, 0)
NARROW(n24_t96_s3, 24, 96, 3, false, 0)
NARROW(n20_t128_s4, 20, 128, 4, false, 0)
NARROW(n20_t160_s5, 20, 160, 5, false, 0)
NARROW(n20_t128_s2, 20, 128, 2, false, 0)
NARROW(n24_t128_s4_f2, 24, 128, 4, true, 0)
NARROW(n20_t160_s5_f2, 20, 160, 5, true, 0)
NARROW(n24_t128_s1_sp1, 24, 128, 1, false, 1)
NARROW(n24_t128_s1_sp2, 24, 128, 1, false, 2)
NARROW(n24_t64_s1_sp1, 24, 64, 1, false, 1)
NARROW(n24_t128_s4_sp1, 24, 128, 4, false, 1)
NARROW(n24_t128_s4_sp2, 24, 128, 4, false, 2)
NARROW(n20_t128_s4_sp1, 20, 128, 4, false, 1)
NARROW(n20_t128_s4_sp2, 20, 128, 4, false, 2)
NARROW(n4_t128_s1, 4, 128, 1, false, 0)
NARROW(n4_t128_s2, 4, 128, 2, false, 0)
NARROW(n8_t128_s1, 8, 128, 1, false, 0)
NARROW(n8_t128_s2, 8, 128, 2, false, 0)
NARROW(n8_t64_s1, 8, 64, 1, false, 0)
NARROW(n32_t128_s1, 32, 128, 1, false, 0)
NARROW(n32_t128_s4, 32, 128, 4, false, 0)
NARROW(n32_t64_s1, 32, 64, 1, false, 0)
NARROW(n32_t128_s2, 32, 128, 2, false, 0)

// mix_kernel as shipped (the chunk launch() takes for n rows), dense and
// sparse, with the narrow signature; and an empty kernel, one block of 32
extern "C" int first_flat(const float* w, const float* c, const float* act, float* o, int n,
                          long long x, void* st) {
  (void)act;
  const cudaStream_t s = static_cast<cudaStream_t>(st);
  if (n <= 8) launch_nb<8>(w, Identity{c}, o, 1, n, n, x, s);
  else if (n <= 16) launch_nb<16>(w, Identity{c}, o, 1, n, n, x, s);
  else if (n <= 24) launch_nb<24>(w, Identity{c}, o, 1, n, n, x, s);
  else launch_nb<32>(w, Identity{c}, o, 1, n, n, x, s);
  return cudaGetLastError();
}

extern "C" int first_sparse(const float* w, const float* c, const float* act, float* o, int n,
                            long long x, void* st) {
  const cudaStream_t s = static_cast<cudaStream_t>(st);
  const SparseIdentity in{c, act};
  if (n <= 8) launch_nb<8>(w, in, o, 1, n, n, x, s);
  else if (n <= 16) launch_nb<16>(w, in, o, 1, n, n, x, s);
  else if (n <= 24) launch_nb<24>(w, in, o, 1, n, n, x, s);
  else launch_nb<32>(w, in, o, 1, n, n, x, s);
  return cudaGetLastError();
}

// mix_kernel_narrow as shipped, whatever the width (launch() takes it
// below kNarrowMaxX only)
extern "C" int narrow_flat(const float* w, const float* c, const float* act, float* o, int n,
                           long long x, void* st) {
  (void)act;
  launch_narrow(w, Identity{c}, o, n, x, static_cast<cudaStream_t>(st));
  return cudaGetLastError();
}

extern "C" int narrow_sparse(const float* w, const float* c, const float* act, float* o, int n,
                             long long x, void* st) {
  launch_narrow(w, SparseIdentity{c, act}, o, n, x, static_cast<cudaStream_t>(st));
  return cudaGetLastError();
}

extern "C" int empty(void* st) {
  mixvar::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(st)>>>();
  return cudaGetLastError();
}
