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
//
// mixdq<NB, VEC, G, P, CS> (kernel 6, the masked dequant mix, past the
// narrow plane: mix_kernel_masked_vec's candidates): a thread owns VEC
// adjacent columns (a char4 or char2 of quanta, one scale and a float4 or
// float2 of mask a row); NB rows (a multiple of 4 and of G, >= m and n);
// G rows whose loads are issued together; P: the next group's raw loads
// are issued before the current group is dequantized and mixed; CS:
// streaming stores (st.global.cs). W is staged before one barrier and the
// dead-column test goes by warp, as in the shipped kernel.
//
// mixnp<NB, T, S, Prologue> (the narrow plane with a prologue read
// through at(col): kernel 4 on the square W, kernels 6 and 2):
// mix_kernel_narrow with T threads a block and S threads a column (T / S
// columns a block), the prologue read through at(col) as in the shipped
// kernel.
//
// Kernel 2 (the fused DP mix) past the narrow plane: the shipped
// mix_kernel_dp_vec<NB, V, G, kNoise> at other V (columns a thread) and G
// (rows whose loads are issued together), launched whatever the shape.

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

// one row of a thread's VEC columns as loaded: quanta, scale, mask
template <int VEC>
struct RawRow {
  int8_t q[VEC];
  float s;
  float mk[VEC];
};

template <int VEC>
__device__ __forceinline__ void load_row(const MaskedDequant& in, const int8_t* qc,
                                         const float* sc, const float* mc, int j, bool ok,
                                         bool in_mask, RawRow<VEC>& r) {
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    r.q[t] = 0;
    r.mk[t] = 0.f;
  }
  r.s = 0.f;
  if (!ok) return;
  if constexpr (VEC == 4) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(qc + j * in.xp));
    r.q[0] = c.x; r.q[1] = c.y; r.q[2] = c.z; r.q[3] = c.w;
  } else {
    const char2 c = __ldg(reinterpret_cast<const char2*>(qc + j * in.xp));
    r.q[0] = c.x; r.q[1] = c.y;
  }
  r.s = __ldg(sc + static_cast<int64_t>(j) * in.nq);
  if (in_mask) {
    if constexpr (VEC == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(mc + j * in.x));
      r.mk[0] = f.x; r.mk[1] = f.y; r.mk[2] = f.z; r.mk[3] = f.w;
    } else {
      const float2 f = __ldg(reinterpret_cast<const float2*>(mc + j * in.x));
      r.mk[0] = f.x; r.mk[1] = f.y;
    }
  }
}

template <int NB, int VEC, int G, bool P, bool CS>
__global__ void __launch_bounds__(kThreads)
mixdq(const float* __restrict__ w, MaskedDequant in, float* __restrict__ out, int m, int n) {
  static_assert(NB % G == 0 && NB <= 32 && (VEC == 2 || VEC == 4), "the candidates");
  constexpr int WPT = (NB * NB + kThreads - 1) / kThreads;
  __shared__ float sw[NB][NB];
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const bool in_plane = col < in.xp, in_mask = col < in.x;
  float wv[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kThreads, i = t / NB, j = t % NB;
    wv[k] = (i < m && j < n) ? __ldg(w + i * n + j) : 0.f;
  }
  bool live = false;
  if (in_mask) {
    if constexpr (VEC == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(in.active + col));
      live = a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
    } else {
      const float2 a = __ldg(reinterpret_cast<const float2*>(in.active + col));
      live = a.x != 0.f || a.y != 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * kThreads;
    if (t < NB * NB) sw[t / NB][t % NB] = wv[k];
  }
  __syncthreads();
  const int64_t orow = in.xp;
  if (!__any_sync(0xffffffffu, live)) {
    if (in_plane) {
      for (int i = 0; i < m; ++i) {
#pragma unroll
        for (int t = 0; t < VEC; ++t) out[i * orow + col + t] = 0.f;
      }
    }
    return;
  }
  const int8_t* qc = in.q + col;
  const float* sc = in.scale + static_cast<uint32_t>(col) / in.qblock;
  const float* mc = in.mask + col;
  float acc[NB][VEC];
#pragma unroll
  for (int ii = 0; ii < NB; ++ii)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[ii][t] = 0.f;
  RawRow<VEC> cur[G], ahead[G];
  if (P) {
#pragma unroll
    for (int jj = 0; jj < G; ++jj) load_row<VEC>(in, qc, sc, mc, jj, in_plane && jj < n, in_mask,
                                                ahead[jj]);
  }
#pragma unroll
  for (int jg = 0; jg < NB; jg += G) {
    if (jg < n) {
      if (P) {
#pragma unroll
        for (int jj = 0; jj < G; ++jj) cur[jj] = ahead[jj];
        if (jg + G < n) {
#pragma unroll
          for (int jj = 0; jj < G; ++jj) {
            const int j = jg + G + jj;
            load_row<VEC>(in, qc, sc, mc, j, in_plane && j < n, in_mask, ahead[jj]);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const int j = jg + jj;
          load_row<VEC>(in, qc, sc, mc, j, in_plane && j < n, in_mask, cur[jj]);
        }
      }
      float v[G][VEC];
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          v[jj][t] = __fmul_rn(__fmul_rn(static_cast<float>(cur[jj].q[t]), cur[jj].s),
                               cur[jj].mk[t]);
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) {
          const float wij = sw[ii][jg + jj];
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[ii][t] = fmaf(wij, v[jj][t], acc[ii][t]);
        }
    }
  }
  if (in_plane) {
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) {
      if (ii < m) {
        float* o = out + ii * orow + col;
        if constexpr (VEC == 4) {
          const float4 f = make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
          if (CS) __stcs(reinterpret_cast<float4*>(o), f);
          else *reinterpret_cast<float4*>(o) = f;
        } else {
          const float2 f = make_float2(acc[ii][0], acc[ii][1]);
          if (CS) __stcs(reinterpret_cast<float2*>(o), f);
          else *reinterpret_cast<float2*>(o) = f;
        }
      }
    }
  }
}

template <int NB, int VEC, int G, bool P, bool CS>
int run_masked(const float* w, const int8_t* q, const float* sc, const float* mask,
               const float* act, float* o, int m, int n, long long x, long long xp,
               long long qblock, void* st) {
  const MaskedDequant in{q, sc, mask, act, x, xp, static_cast<uint32_t>(xp / qblock),
                         static_cast<uint32_t>(qblock)};
  constexpr int64_t cols = kThreads * VEC;
  const unsigned grid = static_cast<unsigned>((xp + cols - 1) / cols);
  mixdq<NB, VEC, G, P, CS><<<grid, kThreads, 0, static_cast<cudaStream_t>(st)>>>(w, in, o, m,
                                                                                  n);
  return cudaGetLastError();
}

template <int NB, int T, int S, class Prologue>
__global__ void __launch_bounds__(T)
mixnp(const float* __restrict__ w, Prologue in, float* __restrict__ out, int n, int64_t x) {
  constexpr int BC = T / S, RB = NB / S, WPT = (NB * NB + T - 1) / T;
  static_assert(NB % kG == 0 && NB % S == 0 && T % S == 0 && (S == 1 || BC % 32 == 0),
                "a warp shares one row group");
  __shared__ float sw[NB][NB];
  __shared__ float sc[S == 1 ? 1 : NB][S == 1 ? 1 : BC];
  const int tc = threadIdx.x % BC, tr = threadIdx.x / BC;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * BC + tc;
  const bool live = col < x;
  const auto cin = in.at(col);
  float wv[WPT], cv[RB];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int t = threadIdx.x + k * T, i = t / NB, j = t % NB;
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
    const int t = threadIdx.x + k * T;
    if (t < NB * NB) sw[t / NB][t % NB] = wv[k];
  }
  if constexpr (S > 1) {
#pragma unroll
    for (int k = 0; k < RB; ++k) sc[tr + k * S][tc] = cv[k];
  }
  const int r0 = tr * RB;
  if constexpr (Prologue::kSkip) {
    if (!__syncthreads_or(any)) {
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
  for (int jg = 0; jg < NB; jg += kG) {
    if (jg < n) {
      float v[kG];
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
        if constexpr (S == 1) {
          v[jj] = cv[jg + jj];
        } else {
          v[jj] = sc[jg + jj][tc];
        }
      }
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
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

template <int NB, int T, int S, class Prologue>
void run_np(const float* w, Prologue in, float* o, int n, int64_t x, void* st) {
  constexpr int cols = T / S;
  const unsigned grid = static_cast<unsigned>((x + cols - 1) / cols);
  mixnp<NB, T, S, Prologue><<<grid, T, 0, static_cast<cudaStream_t>(st)>>>(w, in, o, n, x);
}

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

// kernel 6's candidates past the narrow plane, named dq_v<VEC>_nb<NB>_g<G>
// [_pf][_cs], with gossip_mix_dequant_masked's signature; and the shipped
// kernels launched whatever the shape: mix_kernel (as before
// mix_kernel_masked_vec and mix_kernel_narrow took kernel 6),
// mix_kernel_masked_vec and mix_kernel_narrow
#define MASKED(name, NB, VEC, G, P, CS)                                                      \
  extern "C" int name(const float* w, const int8_t* q, const float* sc, const float* mask,   \
                      const float* act, float* o, int m, int n, long long x, long long xp,    \
                      long long qblock, void* st) {                                         \
    return mixvar::run_masked<NB, VEC, G, P, CS>(w, q, sc, mask, act, o, m, n, x, xp, qblock, \
                                                 st);                                       \
  }

MASKED(dq_v4_nb20_g4, 20, 4, 4, false, false)
MASKED(dq_v4_nb20_g2, 20, 4, 2, false, false)
MASKED(dq_v4_nb20_g4_pf, 20, 4, 4, true, false)
MASKED(dq_v4_nb20_g4_cs, 20, 4, 4, false, true)
MASKED(dq_v4_nb24_g4, 24, 4, 4, false, false)
MASKED(dq_v4_nb24_g8, 24, 4, 8, false, false)
MASKED(dq_v2_nb20_g4, 20, 2, 4, false, false)
MASKED(dq_v2_nb20_g4_pf, 20, 2, 4, true, false)

namespace {
MaskedDequant masked_in(const int8_t* q, const float* sc, const float* mask, const float* act,
                        long long x, long long xp, long long qblock) {
  return {q, sc, mask, act, x, xp, static_cast<uint32_t>(xp / qblock),
          static_cast<uint32_t>(qblock)};
}
}  // namespace

extern "C" int first_masked(const float* w, const int8_t* q, const float* sc, const float* mask,
                            const float* act, float* o, int m, int n, long long x, long long xp,
                            long long qblock, void* st) {
  return launch(w, masked_in(q, sc, mask, act, x, xp, qblock), o, 1, m, n, xp, st);
}

extern "C" int vec_masked(const float* w, const int8_t* q, const float* sc, const float* mask,
                          const float* act, float* o, int m, int n, long long x, long long xp,
                          long long qblock, void* st) {
  launch_masked_vec(w, masked_in(q, sc, mask, act, x, xp, qblock), o, m, n,
                    static_cast<cudaStream_t>(st));
  return cudaGetLastError();
}

extern "C" int narrow_masked(const float* w, const int8_t* q, const float* sc,
                             const float* mask, const float* act, float* o, int m, int n,
                             long long x, long long xp, long long qblock, void* st) {
  (void)m;
  launch_narrow(w, masked_in(q, sc, mask, act, x, xp, qblock), o, n, xp,
                static_cast<cudaStream_t>(st));
  return cudaGetLastError();
}

// the narrow plane's prologue candidates, named nq_<NB>_t<T>_s<S> (kernel
// 6, gossip_mix_dequant_masked's signature) and nd_<NB>_t<T>_s<S> (kernel
// 4 on the square W: w, q, scales, out, n, xp, qblock, stream); and the
// shipped route of kernel 4 on the square W (mix_kernel_narrow, Dequant)
#define NARROW_MASKED(name, NB, T, S)                                                       \
  extern "C" int name(const float* w, const int8_t* q, const float* sc, const float* mask,   \
                      const float* act, float* o, int m, int n, long long x, long long xp,    \
                      long long qblock, void* st) {                                         \
    (void)m;                                                                                \
    mixvar::run_np<NB, T, S>(w, masked_in(q, sc, mask, act, x, xp, qblock), o, n, xp, st);   \
    return cudaGetLastError();                                                              \
  }
#define NARROW_DEQUANT(name, NB, T, S)                                                      \
  extern "C" int name(const float* w, const int8_t* q, const float* sc, float* o, int n,     \
                      long long xp, long long qblock, void* st) {                           \
    const Dequant in{q, sc, static_cast<uint32_t>(xp / qblock),                             \
                     static_cast<uint32_t>(qblock)};                                        \
    mixvar::run_np<NB, T, S>(w, in, o, n, xp, st);                                          \
    return cudaGetLastError();                                                              \
  }

NARROW_MASKED(nq_20_t128_s4, 20, 128, 4)
NARROW_MASKED(nq_20_t256_s4, 20, 256, 4)
NARROW_MASKED(nq_20_t128_s2, 20, 128, 2)
NARROW_MASKED(nq_20_t160_s5, 20, 160, 5)
NARROW_MASKED(nq_20_t320_s5, 20, 320, 5)
NARROW_MASKED(nq_24_t256_s8, 24, 256, 8)
NARROW_MASKED(nq_20_t128_s1, 20, 128, 1)
NARROW_DEQUANT(nd_20_t128_s4, 20, 128, 4)
NARROW_DEQUANT(nd_20_t256_s4, 20, 256, 4)
NARROW_DEQUANT(nd_20_t128_s2, 20, 128, 2)
NARROW_DEQUANT(nd_20_t160_s5, 20, 160, 5)
NARROW_DEQUANT(nd_24_t256_s8, 24, 256, 8)

extern "C" int narrow_dequant(const float* w, const int8_t* q, const float* sc, float* o, int n,
                              long long xp, long long qblock, void* st) {
  gossip_mix::launch_dequant_narrow(w, q, sc, o, n, n, xp, qblock, static_cast<cudaStream_t>(st));
  return cudaGetLastError();
}

// kernel 2's variants, with gossip_mix_fused_dp's signature: mix_kernel as
// shipped before the narrow plane and mix_kernel_dp_vec took kernel 2
// (first_dp), mix_kernel_narrow whatever the width (narrow_dp), the narrow
// plane's other splits (ndp_<NB>_t<T>_s<S>), mix_kernel_dp_vec as shipped
// (vec_dp) and at other V and G (dpv_v<V>_g<G>), whatever the shape (x a
// multiple of V, the planes V·4-byte aligned)
namespace {
template <class F>
int with_dp(const float* co, const float* cn, const float* sc, const float* nz, float sigma,
            long long x, F&& f) {
  if (sigma > 0.f) f(FusedDP<true>{co, cn, sc, nz, sigma, x});
  else f(FusedDP<false>{co, cn, sc, nullptr, 0.f, x});
  return cudaGetLastError();
}
}  // namespace

#define DP_VARIANT(name, body)                                                                \
  extern "C" int name(const float* w, const float* co, const float* cn, const float* sc,     \
                      const float* nz, float sigma, float* o, int n, long long x, void* st) { \
    const cudaStream_t s = static_cast<cudaStream_t>(st);                                    \
    return with_dp(co, cn, sc, nz, sigma, x, [&](auto in) { body; });                        \
  }

DP_VARIANT(first_dp, launch(w, in, o, 1, n, n, x, st))
DP_VARIANT(narrow_dp, launch_narrow(w, in, o, n, x, s))
DP_VARIANT(vec_dp, (launch_dp_vec<kDpVec, kDpGroup>(w, in, o, n, s)))
DP_VARIANT(ndp_20_t128_s4, (mixvar::run_np<20, 128, 4>(w, in, o, n, x, st)))
DP_VARIANT(ndp_20_t256_s4, (mixvar::run_np<20, 256, 4>(w, in, o, n, x, st)))
DP_VARIANT(ndp_20_t128_s2, (mixvar::run_np<20, 128, 2>(w, in, o, n, x, st)))
DP_VARIANT(ndp_20_t160_s5, (mixvar::run_np<20, 160, 5>(w, in, o, n, x, st)))
DP_VARIANT(ndp_20_t320_s5, (mixvar::run_np<20, 320, 5>(w, in, o, n, x, st)))
DP_VARIANT(ndp_24_t256_s8, (mixvar::run_np<24, 256, 8>(w, in, o, n, x, st)))
DP_VARIANT(ndp_20_t128_s1, (mixvar::run_np<20, 128, 1>(w, in, o, n, x, st)))
DP_VARIANT(dpv_v1_g2, (launch_dp_vec<1, 2>(w, in, o, n, s)))
DP_VARIANT(dpv_v1_g4, (launch_dp_vec<1, 4>(w, in, o, n, s)))
DP_VARIANT(dpv_v2_g2, (launch_dp_vec<2, 2>(w, in, o, n, s)))
DP_VARIANT(dpv_v2_g4, (launch_dp_vec<2, 4>(w, in, o, n, s)))
DP_VARIANT(dpv_v4_g2, (launch_dp_vec<4, 2>(w, in, o, n, s)))
DP_VARIANT(dpv_v4_g4, (launch_dp_vec<4, 4>(w, in, o, n, s)))
