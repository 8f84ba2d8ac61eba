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
// TB/s) for the chunked dual form's four products, at most 2·B·L·H·(Q·N +
// Q·P + 2·P·N) FLOPs (5.4 GFLOP with full Q × Q blocks, 5.4 µs at the bf16
// tensor-core peak): the two are close, and this kernel's fp32 CUDA-core
// products are far from either.
//
// Design. The TPU kernel walks the chunks of one (batch, head) in order on
// one core, carrying the state in VMEM; at one request that is only H = 32
// programs, and only the state carry is really sequential. So the scan is
// three launches, as ssd_chunked's stages:
//   1. ssd_chunk_state, one block per (chunk, head, batch): the chunk's own
//      state contribution sum_q exp(cum_Q - cum_q) dt_q x_q B_qᵀ (P × N,
//      fp32) and exp-free cum_Q, into scratch;
//   2. ssd_state_pass, one thread per (batch, head, state entry): the
//      inter-chunk recurrence S_in(c+1) = exp(cum_Q(c)) S_in(c) + S_c, in
//      place over the scratch (each chunk's slot ends up holding the state
//      entering it) and the final state;
//   3. ssd_chunk_out, one block per (chunk, head, batch): the intra-chunk
//      dual form and the carried state's term, y in x's dtype.
// Block-local cum is a serial fp32 prefix sum (Q ≤ 256 adds), recomputed in
// stages 1 and 3 from the same inputs in the same order. exp is expf (not
// __expf). In stage 3 the Q × Q scores are tiled by 32 query rows (a 32 × Q
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

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // query rows per score tile (stage 3): 8 warps × 4
static_assert(kThreads == 8 * 32 && kTQ == 4 * (kThreads / 32), "4 tile rows a warp");
constexpr size_t kMaxSmem = 232448;

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

// dt·A for the chunk's tokens, then its inclusive prefix sum (serial, one
// thread), in cum[0..Q). Ends with a barrier.
__device__ void chunk_cum(float* cum, const float* dt, float a, int64_t t0, int h, int hs,
                          int q) {
  for (int i = threadIdx.x; i < q; i += blockDim.x) cum[i] = dt[(t0 + i) * hs + h] * a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < q; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  __syncthreads();
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

__global__ void ssd_state_pass(float* __restrict__ states, const float* __restrict__ cum_last,
                               const float* __restrict__ s0, float* __restrict__ s_final,
                               Dims d) {
  const int pn = d.p * d.n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * d.h + h;
  float s = s0 != nullptr ? s0[bh * pn + e] : 0.f;
  for (int ci = 0; ci < d.c; ++ci) {
    const int64_t slot = (static_cast<int64_t>(b) * d.c + ci) * d.h + h;
    float* st = states + slot * pn + e;
    const float contrib = *st;
    *st = s;  // the state entering chunk ci
    s = s * expf(cum_last[slot]) + contrib;
  }
  s_final[bh * pn + e] = s;
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

template <typename K>
cudaError_t allow_max_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  done = err == cudaSuccess;
  return err;
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
    const dim3 g2((d.p * d.n + kThreads - 1) / kThreads, d.h, d.b);
    ssd_state_pass<<<g2, kThreads, 0, stream>>>(states, cum_last, s0, s_final, d);
  } else {
    const cudaError_t err = allow_max_smem(ssd_chunk_out<T>, out_ready);
    if (err != cudaSuccess) return err;
    ssd_chunk_out<T><<<grid, kThreads, out_smem(d), stream>>>(
        static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
        static_cast<const T*>(cm), states, static_cast<T*>(y), d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One stage of the scan (0: chunk states, 1: state pass, 2: outputs), all
// tensors contiguous: x (B, L, H, P), bm/cm (B, L, G, N) of one dtype (fp32,
// bf16 = 0; bf16, bf16 = 1); dt (B, L, H), a (B, H), s0 (B, H, P, N) or
// null, s_final (B, H, P, N), states (B, L/Q, H, P, N) and cum_last
// (B, L/Q, H) scratch, all fp32; y (B, L, H, P) in x's dtype. Returns
// cudaGetLastError() after the launch.
int ssd_scan_stage(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, const float* s0, void* y, float* s_final, float* states,
                   float* cum_last, int b, int l, int h, int g, int p, int n, int chunk,
                   int bf16, int stage, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      chunk <= 0 || l % chunk != 0 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const Dims d{b, l, h, g, p, n, chunk, l / chunk};
  if (state_smem(d) > kMaxSmem || out_smem(d) > kMaxSmem) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(x, dt, a, bm, cm, s0, y, s_final, states, cum_last, d,
                                   stage, s)
              : run<float>(x, dt, a, bm, cm, s0, y, s_final, states, cum_last, d, stage, s);
}

}  // extern "C"
