// Variants of the serving template behind kernels 4 and 7
// (src/repro_torch/kernels/csrc/gossip_mix_dequant.cu: gossip_mix_dequant
// and mixture_mix_dequant4 at M = B requests over S clusters), built and
// timed side by side by tools/mix_variants.py's serving mode. Not part of
// the port: it measures which design the shipped kernels take. The
// shipped source is included, so its entry points and mix_dequant_stream
// are timed as built.
//
// parent: the template as it stood before mix_dequant_stream (one thread a
// 4-column group, kRows = 8 rows a block, W staged in shared memory
// between two barriers, the scale column (col + t) / qblock a column),
// kept verbatim below as the bits every variant is held to.
//
// s_r<R>_u<U>_t<T>[_np][_full]: stream_var<NB = 2, R, U, T, PF> below,
// mix_dequant_stream generalised (R output rows a block, U 16-byte
// column groups a thread per tile, 128 columns apart, T threads a block);
// on a persistent grid (as many blocks as the card holds at once, each
// striding over the tiles) with the next tile's loads issued before the
// current tile's stores, or _np: each tile's loads at its own start;
// _full: the grid covers every tile (one step of it below 2^31 columns).
// s_r<R>_u1_t128_full_np is the shipped kernel's design.
//
// ls_r<R>_{sync,wlate,sync_wlate}: mix_dequant_stream's design with the
// block's warps held in step as the template's are (a barrier between the
// loads and the stores; W read after the plane). pdiv1: the template with
// its scale column found once a thread (point 1 alone).
//
// bulk_u<U>: M = 1 only; stream_var's persistent loop with each warp's
// U·128 output columns written to shared memory and copied out by one
// lane with a 1-D bulk copy (cp.async.bulk.global.shared::cta, no tensor
// map), double-buffered: a buffer is rewritten once its copy has been
// read.

#include "../src/repro_torch/kernels/csrc/gossip_mix_dequant.cu"

namespace parent12 {

using gossip_mix::aligned;

constexpr int kThreads = 128;  // column groups per block
constexpr int kRows = 8;       // output rows per block (grid.y)

// A plane dequantizes row j of the thread's VEC columns from col; sb[t]
// is column col + t's scale column, (col + t) / qblock, found once a
// thread.
template <int VEC>
struct Int8Plane {
  const int8_t* q;     // (N, Xp)
  const float* scale;  // (N, nq)
  int64_t xp, nq, qblock;
  __device__ __forceinline__ void operator()(int j, int64_t col, const int64_t (&sb)[VEC],
                                             float (&v)[VEC]) const {
    const int8_t* p = q + j * xp + col;
    int8_t raw[VEC];
    if constexpr (VEC == 4) {
      const char4 c4 = __ldg(reinterpret_cast<const char4*>(p));
      raw[0] = c4.x; raw[1] = c4.y; raw[2] = c4.z; raw[3] = c4.w;
    } else if constexpr (VEC == 2) {
      const char2 c2 = __ldg(reinterpret_cast<const char2*>(p));
      raw[0] = c2.x; raw[1] = c2.y;
    } else {
      raw[0] = __ldg(p);
    }
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      v[t] = __fmul_rn(static_cast<float>(raw[t]), __ldg(scale + j * nq + sb[t]));
    }
  }
};

template <int VEC>
struct Int4Plane {
  static_assert(VEC == 2 || VEC == 4, "one or two packed bytes per thread");
  const uint8_t* packed;  // (S, Xp/2)
  const float* scale;     // (S, nq)
  int64_t xp, nq, qblock;
  static __device__ __forceinline__ float nibble(unsigned v) {
    return static_cast<float>(static_cast<int>(v) - 16 * static_cast<int>(v > 7u));
  }
  __device__ __forceinline__ void operator()(int j, int64_t col, const int64_t (&sb)[VEC],
                                             float (&v)[VEC]) const {
    const uint8_t* p = packed + j * (xp / 2) + col / 2;
    unsigned bytes[VEC / 2];
    if constexpr (VEC == 4) {
      const uchar2 b2 = __ldg(reinterpret_cast<const uchar2*>(p));
      bytes[0] = b2.x; bytes[1] = b2.y;
    } else {
      bytes[0] = __ldg(p);
    }
#pragma unroll
    for (int t = 0; t < VEC; t += 2) {
      // a nibble pair shares one scale block: qblock is even
      const float s = __ldg(scale + j * nq + sb[t]);
      v[t] = __fmul_rn(nibble(bytes[t / 2] & 0xFu), s);
      v[t + 1] = __fmul_rn(nibble(bytes[t / 2] >> 4), s);
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load_out(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    a[0] = f.x; a[1] = f.y; a[2] = f.z; a[3] = f.w;
  } else if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    a[0] = f.x; a[1] = f.y;
  } else {
    a[0] = *p;
  }
}

// streaming (evict-first) stores: each output is written once
template <int VEC>
__device__ __forceinline__ void store_out(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
    __stcs(p, a[0]);
  }
}

// out[i, col] = sum_j w[i, j] * plane(j, col); one thread per VEC columns,
// blockIdx.y picks kRows output rows.
template <int NB, int VEC, class Plane>
__global__ void __launch_bounds__(kThreads)
mix_dequant_kernel(const float* __restrict__ w, Plane plane, float* __restrict__ out,
                   int m, int n, int64_t xp) {
  __shared__ float sw[kRows][NB];
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const bool live = col < xp;
  const int r0 = blockIdx.y * kRows;
  const int rn = min(kRows, m - r0);
  int64_t sb[VEC];  // the scale column of each of the thread's columns
#pragma unroll
  for (int t = 0; t < VEC; ++t) sb[t] = live ? (col + t) / plane.qblock : 0;
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int jn = min(NB, n - j0);
    float c[NB][VEC];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      if (live && jj < jn) {
        plane(j0 + jj, col, sb, c[jj]);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) c[jj][t] = 0.f;
      }
    }
    __syncthreads();  // the previous chunk's readers of sw are done
    for (int t = threadIdx.x; t < kRows * NB; t += kThreads) {
      const int r = t / NB, jj = t % NB;
      sw[r][jj] = (r < rn && jj < jn) ? w[static_cast<int64_t>(r0 + r) * n + j0 + jj] : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int r = 0; r < rn; ++r) {
        float* o = out + static_cast<int64_t>(r0 + r) * xp + col;
        float acc[VEC];
        if (j0 == 0) {
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
        } else {
          load_out<VEC>(o, acc);  // this thread's own partial sum
        }
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          if (jj < jn) {
            const float wv = sw[r][jj];
#pragma unroll
            for (int t = 0; t < VEC; ++t) acc[t] = fmaf(wv, c[jj][t], acc[t]);
          }
        }
        store_out<VEC>(o, acc);
      }
    }
  }
}

template <int NB, int VEC, class Plane>
void launch_nb(const float* w, Plane plane, float* out, int m, int n, int64_t xp,
               cudaStream_t stream) {
  const int64_t groups = xp / VEC;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
                  static_cast<unsigned>((m + kRows - 1) / kRows));
  mix_dequant_kernel<NB, VEC, Plane><<<grid, kThreads, 0, stream>>>(w, plane, out, m, n, xp);
}

template <int VEC, class Plane>
void launch_vec(const float* w, Plane plane, float* out, int m, int n, int64_t xp,
                cudaStream_t s) {
  if (n <= 2) {
    launch_nb<2, VEC>(w, plane, out, m, n, xp, s);
  } else if (n <= 4) {
    launch_nb<4, VEC>(w, plane, out, m, n, xp, s);
  } else if (n <= 8) {
    launch_nb<8, VEC>(w, plane, out, m, n, xp, s);
  } else {
    launch_nb<16, VEC>(w, plane, out, m, n, xp, s);
  }
}


// the template with the scale column found once a thread (qblock % VEC
// == 0): point 1 alone
template <int NB, int VEC, class Plane>
__global__ void __launch_bounds__(kThreads)
mix_dequant_kernel_div1(const float* __restrict__ w, Plane plane, float* __restrict__ out,
                   int m, int n, int64_t xp) {
  __shared__ float sw[kRows][NB];
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const bool live = col < xp;
  const int r0 = blockIdx.y * kRows;
  const int rn = min(kRows, m - r0);
  int64_t sb[VEC];  // the scale column of each of the thread's columns
#pragma unroll
  const int64_t sb0 = live ? col / plane.qblock : 0;  // qblock % VEC == 0: one scale
  for (int t = 0; t < VEC; ++t) sb[t] = sb0;
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int jn = min(NB, n - j0);
    float c[NB][VEC];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      if (live && jj < jn) {
        plane(j0 + jj, col, sb, c[jj]);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) c[jj][t] = 0.f;
      }
    }
    __syncthreads();  // the previous chunk's readers of sw are done
    for (int t = threadIdx.x; t < kRows * NB; t += kThreads) {
      const int r = t / NB, jj = t % NB;
      sw[r][jj] = (r < rn && jj < jn) ? w[static_cast<int64_t>(r0 + r) * n + j0 + jj] : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int r = 0; r < rn; ++r) {
        float* o = out + static_cast<int64_t>(r0 + r) * xp + col;
        float acc[VEC];
        if (j0 == 0) {
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
        } else {
          load_out<VEC>(o, acc);  // this thread's own partial sum
        }
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          if (jj < jn) {
            const float wv = sw[r][jj];
#pragma unroll
            for (int t = 0; t < VEC; ++t) acc[t] = fmaf(wv, c[jj][t], acc[t]);
          }
        }
        store_out<VEC>(o, acc);
      }
    }
  }
}

template <class Plane>
int run_div1(const float* w, const Plane& plane, float* out, int m, int n, cudaStream_t s) {
  if (n > 2 || plane.xp % 4 || plane.qblock % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((plane.xp / 4 + kThreads - 1) / kThreads),
                  static_cast<unsigned>((m + kRows - 1) / kRows));
  mix_dequant_kernel_div1<2, 4, Plane><<<grid, kThreads, 0, s>>>(w, plane, out, m, n, plane.xp);
  return static_cast<int>(cudaGetLastError());
}

int run8(const float* w, const int8_t* q, const float* scales, float* out, int m, int n,
         int64_t xp, int64_t qblock, cudaStream_t s) {
  const int64_t nq = xp / qblock;
  if (xp % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
    launch_vec<4>(w, Int8Plane<4>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
  } else if (xp % 2 == 0 && aligned(q, 2) && aligned(out, 8)) {
    launch_vec<2>(w, Int8Plane<2>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
  } else {
    launch_vec<1>(w, Int8Plane<1>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int run4(const float* u, const uint8_t* packed, const float* scales, float* out, int b, int s,
         int64_t xp, int64_t qblock, cudaStream_t st) {
  const int64_t nq = xp / qblock;
  if (xp % 4 == 0 && aligned(packed, 2) && aligned(out, 16)) {
    launch_vec<4>(u, Int4Plane<4>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
  } else {
    launch_vec<2>(u, Int4Plane<2>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace parent12

namespace servar {

constexpr int kGroupStride = 128;  // columns between a thread's groups: a warp's 32 × 4

// The raw quanta and scales of the thread's U groups, the first at col
// (group u at col + u · kGroupStride, scale column sb[u]), NB plane rows
// each; groups past xp and rows past n are zeros.
template <int NB, int U, class Quad>
__device__ __forceinline__ void fetch(const Quad& plane, int n, int64_t col,
                                      const int64_t (&sb)[U], typename Quad::Raw (&raw)[U][NB],
                                      float (&s)[U][NB]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      if (jj < n && col + u * kGroupStride < plane.xp) {
        raw[u][jj] = plane.raw(jj, col + u * kGroupStride);
        s[u][jj] = __ldg(plane.scale + jj * plane.nq + sb[u]);
      } else {
        raw[u][jj] = {};
        s[u][jj] = 0.f;
      }
    }
  }
}

// out[r0 + r, group] = sum_j wr[r][j] · dequant(group of row j), j
// ascending from 0.f, for the thread's live groups and the block's rn rows.
template <int NB, int R, int U, class Quad>
__device__ __forceinline__ void mix_store(const float (&wr)[R][NB], int rn, int n, int64_t col,
                                          int64_t xp, const typename Quad::Raw (&raw)[U][NB],
                                          const float (&s)[U][NB], float* out) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t c = col + u * kGroupStride;
    if (c < xp) {
      float v[NB][4];
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) Quad::decode(raw[u][jj], s[u][jj], v[jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rn) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) {
            if (jj < n) {
#pragma unroll
              for (int t = 0; t < 4; ++t) acc[t] = fmaf(wr[r][jj], v[jj][t], acc[t]);
            }
          }
          __stcs(reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * xp + c),
                 make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
      }
    }
  }
}

// mix_dequant_stream generalised: U groups a thread a tile, T threads a
// block, a persistent grid (blocks of the launcher), a prefetch (PF).
// out (m, xp) = w (m, n) · plane, n <= NB <= 4, xp and qblock multiples of
// 4. blockIdx.y takes R output rows;
// each block strides over the tiles of T · U · 4 columns from blockIdx.x,
// gridDim.x · T · U · 4 = dq · qblock + dr columns a step (dq and dr from
// the launcher; gridDim.x · T · U · 4 < 2^31). PF: the next tile's loads
// are issued before the current tile's stores.
template <int NB, int R, int U, int T, bool PF, class Quad>
__global__ void __launch_bounds__(T)
stream_var(const float* __restrict__ w, Quad plane, float* __restrict__ out, int m,
                   int n, int64_t tiles, int64_t dq, int dr) {
  static_assert(T % 32 == 0, "whole warps");
  using Raw = typename Quad::Raw;
  constexpr int64_t kTile = static_cast<int64_t>(T) * U * 4;
  const int64_t xp = plane.xp;
  const int qb = static_cast<int>(plane.qblock);
  const int r0 = blockIdx.y * R;
  const int rn = min(R, m - r0);
  float wr[R][NB];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      wr[r][jj] = (r < rn && jj < n) ? __ldg(w + static_cast<int64_t>(r0 + r) * n + jj) : 0.f;
    }
  }
  float* o = out + static_cast<int64_t>(r0) * xp;
  // group u of the thread: tile · kTile + (warp · U + u) · 128 + lane · 4;
  // the first tile's columns lie below 2^31
  int64_t tile = blockIdx.x;
  const unsigned first = static_cast<unsigned>(tile * kTile) +
                         (threadIdx.x / 32) * U * kGroupStride + (threadIdx.x % 32) * 4;
  int64_t col = first;
  // each group's scale column and its remainder, in 32 bits here and
  // advanced by dq and dr a step: no 64-bit division in the kernel
  int64_t sb[U];
  int rem[U];
  sb[0] = first / static_cast<unsigned>(qb);
  rem[0] = static_cast<int>(first % static_cast<unsigned>(qb));
  const int q128 = kGroupStride / qb, r128 = kGroupStride % qb;
#pragma unroll
  for (int u = 1; u < U; ++u) {
    sb[u] = sb[u - 1] + q128;
    rem[u] = rem[u - 1] + r128;
    if (rem[u] >= qb) {
      rem[u] -= qb;
      ++sb[u];
    }
  }
  Raw raw[U][NB];
  float s[U][NB];
  if constexpr (PF) {
    if (tile < tiles) fetch<NB, U>(plane, n, col, sb, raw, s);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTile;
  for (; tile < tiles; tile += gridDim.x) {
    if constexpr (!PF) fetch<NB, U>(plane, n, col, sb, raw, s);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rem[u] += dr;
      sb[u] += dq;
      if (rem[u] >= qb) {
        rem[u] -= qb;
        ++sb[u];
      }
    }
    if constexpr (PF) {
      Raw next_raw[U][NB];
      float next_s[U][NB];
      if (tile + gridDim.x < tiles) fetch<NB, U>(plane, n, col + step, sb, next_raw, next_s);
      mix_store<NB, R, U, Quad>(wr, rn, n, col, xp, raw, s, o);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int jj = 0; jj < NB; ++jj) {
          raw[u][jj] = next_raw[u][jj];
          s[u][jj] = next_s[u][jj];
        }
      }
    } else {
      mix_store<NB, R, U, Quad>(wr, rn, n, col, xp, raw, s, o);
    }
    col += step;
  }
}

// blocks of a kernel resident on the card at once: SMs × blocks an SM
template <class K>
int64_t resident_blocks(K* kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return static_cast<int64_t>(std::max(sms, 1)) * std::max(per_sm, 1);
}

// stream_var<NB, R, U, T, PF> on min(tiles, blocks / grid.y)
// blocks a row of the grid (and fewer than 2^31 columns a step); blocks:
// the persistent grid's size (the kernel's resident blocks when 0).
template <int NB, int R, int U, int T, bool PF, class Quad>
void launch_stream_var(const float* w, const Quad& plane, float* out, int m, int n,
                   cudaStream_t stream, int64_t blocks = 0) {
  if (blocks <= 0) {
    static const int64_t resident =  // per instantiation
        resident_blocks(stream_var<NB, R, U, T, PF, Quad>, T);
    blocks = resident;
  }
  constexpr int64_t kTile = static_cast<int64_t>(T) * U * 4;
  const int64_t tiles = (plane.xp + kTile - 1) / kTile;
  const int gy = (m + R - 1) / R;
  const int64_t gx = std::min({tiles, std::max<int64_t>(1, blocks / gy),
                               ((int64_t{1} << 31) - 1) / kTile});
  const int64_t step = gx * kTile;
  stream_var<NB, R, U, T, PF, Quad>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), T, 0, stream>>>(
          w, plane, out, m, n, tiles, step / plane.qblock,
          static_cast<int>(step % plane.qblock));
}

// stream_var<NB = 2, R, U, T, PF> on the persistent grid of its resident
// blocks, or with Full on every tile (one step of the grid below 2^31
// columns, as the shipped kernel's); S = 2 only
template <int R, int U, int T, bool PF, bool Full, class Quad>
int run_stream(const float* w, const Quad& plane, float* out, int m, int n, void* st) {
  if (n > 2 || plane.xp % 4 || plane.qblock % 4) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int64_t kTile = static_cast<int64_t>(T) * U * 4;
  const int64_t blocks = Full ? ((plane.xp + kTile - 1) / kTile) * ((m + R - 1) / R) : 0;
  launch_stream_var<2, R, U, T, PF>(w, plane, out, m, n, static_cast<cudaStream_t>(st), blocks);
  return static_cast<int>(cudaGetLastError());
}

// mix_dequant_stream (one group a thread, every tile) with the block's
// warps held in step as the template's are: SYNC, a barrier between the
// loads and the stores; WLATE, W read after the plane (the template's
// order) rather than before it
template <int NB, int R, bool SYNC, bool WLATE, class Quad>
__global__ void __launch_bounds__(128)
lockstep(const float* __restrict__ w, Quad plane, float* __restrict__ out, int m, int n,
         int64_t tiles, int64_t dq, int dr) {
  constexpr unsigned kTile = 512;
  using Raw = typename Quad::Raw;
  const int64_t xp = plane.xp;
  const int qb = static_cast<int>(plane.qblock);
  const int r0 = blockIdx.y * R;
  const int rn = min(R, m - r0);
  float wr[R][NB];
  if constexpr (!WLATE) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int jj = 0; jj < NB; ++jj)
        wr[r][jj] = (r < rn && jj < n) ? __ldg(w + static_cast<int64_t>(r0 + r) * n + jj) : 0.f;
  }
  float* o = out + static_cast<int64_t>(r0) * xp;
  const unsigned first = blockIdx.x * kTile + threadIdx.x * 4;
  int64_t sb = first / static_cast<unsigned>(qb);
  int rem = static_cast<int>(first % static_cast<unsigned>(qb));
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTile;
  int64_t col = first;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool live = col < xp;
    Raw raw[NB];
    float s[NB];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      raw[jj] = {};
      s[jj] = 0.f;
      if (live && jj < n) {
        raw[jj] = plane.raw(jj, col);
        s[jj] = __ldg(plane.scale + jj * plane.nq + sb);
      }
    }
    if constexpr (WLATE) {
      if (tile == blockIdx.x) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < NB; ++jj)
            wr[r][jj] =
                (r < rn && jj < n) ? __ldg(w + static_cast<int64_t>(r0 + r) * n + jj) : 0.f;
      }
    }
    float v[NB][4];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) Quad::decode(raw[jj], s[jj], v[jj]);
    if constexpr (SYNC) __syncthreads();
    if (live) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rn) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) {
            if (jj < n) {
#pragma unroll
              for (int t = 0; t < 4; ++t) acc[t] = fmaf(wr[r][jj], v[jj][t], acc[t]);
            }
          }
          __stcs(reinterpret_cast<float4*>(o + static_cast<int64_t>(r) * xp + col),
                 make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
      }
    }
    rem += dr;
    sb += dq;
    if (rem >= qb) {
      rem -= qb;
      ++sb;
    }
    col += step;
  }
}

template <int R, bool SYNC, bool WLATE, class Quad>
int run_lockstep(const float* w, const Quad& plane, float* out, int m, int n, void* st) {
  if (n > 2 || plane.xp % 4 || plane.qblock % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (plane.xp + 511) / 512;
  const int64_t gx = std::min(tiles, ((int64_t{1} << 31) - 1) / 512);
  const int64_t step = gx * 512;
  lockstep<2, R, SYNC, WLATE, Quad>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>((m + R - 1) / R)), 128, 0,
         static_cast<cudaStream_t>(st)>>>(w, plane, out, m, n, tiles, step / plane.qblock,
                                          static_cast<int>(step % plane.qblock));
  return static_cast<int>(cudaGetLastError());
}

// one row (M = 1): stream_var's persistent loop, the stores staged in
// shared memory and written by a bulk copy a warp
template <int U, int T, class Quad>
__global__ void __launch_bounds__(T)
mix_dequant_bulk(const float* __restrict__ w, Quad plane, float* __restrict__ out, int n,
                 int64_t tiles, int64_t dq, int dr) {
  using Raw = typename Quad::Raw;
  constexpr int kWarps = T / 32;
  constexpr int64_t kTile = static_cast<int64_t>(T) * U * 4;
  __shared__ float4 stage[2][kWarps][U * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t xp = plane.xp;
  const int qb = static_cast<int>(plane.qblock);
  float wr[2];
  wr[0] = __ldg(w);
  wr[1] = n > 1 ? __ldg(w + 1) : 0.f;
  int64_t tile = blockIdx.x;
  const unsigned first = static_cast<unsigned>(tile * kTile) + warp * U * kGroupStride + lane * 4;
  int64_t col = first;
  int64_t sb[U];
  int rem[U];
  sb[0] = first / static_cast<unsigned>(qb);
  rem[0] = static_cast<int>(first % static_cast<unsigned>(qb));
  const int q128 = kGroupStride / qb, r128 = kGroupStride % qb;
#pragma unroll
  for (int u = 1; u < U; ++u) {
    sb[u] = sb[u - 1] + q128;
    rem[u] = rem[u - 1] + r128;
    if (rem[u] >= qb) {
      rem[u] -= qb;
      ++sb[u];
    }
  }
  Raw raw[U][2];
  float s[U][2];
  if (tile < tiles) fetch<2, U>(plane, n, col, sb, raw, s);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTile;
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rem[u] += dr;
      sb[u] += dq;
      if (rem[u] >= qb) {
        rem[u] -= qb;
        ++sb[u];
      }
    }
    Raw next_raw[U][2];
    float next_s[U][2];
    if (tile + gridDim.x < tiles) fetch<2, U>(plane, n, col + step, sb, next_raw, next_s);
    const int buf = it & 1;
    if (lane == 0) {
      // the copy issued from this buffer two tiles ago has read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) Quad::decode(raw[u][jj], s[u][jj], v[jj]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (jj < n) {
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[t] = fmaf(wr[jj], v[jj][t], acc[t]);
        }
      }
      stage[buf][warp][u * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      const int64_t c0 = col;  // lane 0's group 0: the warp's first column
      const int64_t cols = xp - c0 < U * kGroupStride ? xp - c0 : U * kGroupStride;
      if (cols > 0) {
        const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(&stage[buf][warp][0]));
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     :: "l"(out + c0), "r"(src), "r"(static_cast<uint32_t>(cols * 4))
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        raw[u][jj] = next_raw[u][jj];
        s[u][jj] = next_s[u][jj];
      }
    }
    col += step;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int U, class Quad>
int run_bulk(const float* w, const Quad& plane, float* out, int m, int n, void* st) {
  constexpr int T = 128;
  if (m != 1 || n > 2 || plane.xp % 4 || plane.qblock % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int64_t resident = resident_blocks(mix_dequant_bulk<U, T, Quad>, T);
  constexpr int64_t kTile = static_cast<int64_t>(T) * U * 4;
  const int64_t tiles = (plane.xp + kTile - 1) / kTile;
  const int64_t gx = std::min(tiles, resident);
  const int64_t step = gx * kTile;
  mix_dequant_bulk<U, T, Quad><<<static_cast<unsigned>(gx), T, 0, static_cast<cudaStream_t>(st)>>>(
      w, plane, out, n, tiles, step / plane.qblock, static_cast<int>(step % plane.qblock));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace servar

// the parent template's plane view of the same operands
inline parent12::Int8Plane<4> parent12_plane(const Int8Quad& p) {
  return {p.q, p.scale, p.xp, p.nq, p.qblock};
}
inline parent12::Int4Plane<4> parent12_plane(const Int4Quad& p) {
  return {p.packed, p.scale, p.xp, p.nq, p.qblock};
}

// every variant in both codecs: <name>_i8 (gossip_mix_dequant's
// signature) and <name>_i4 (mixture_mix_dequant4's)
#define SERVE_VARIANT(name, call)                                                          \
  extern "C" int name##_i8(const float* w, const int8_t* q, const float* sc, float* o,     \
                           int m, int n, long long xp, long long qb, void* st) {           \
    const Int8Quad plane{q, sc, xp, xp / qb, qb};                                        \
    return call;                                                                         \
  }                                                                                      \
  extern "C" int name##_i4(const float* w, const uint8_t* q, const float* sc, float* o,    \
                           int m, int n, long long xp, long long qb, void* st) {           \
    const Int4Quad plane{q, sc, xp, xp / qb, qb};                                        \
    return call;                                                                         \
  }
#define STREAM(name, R, U, T, PF, FULL) \
  SERVE_VARIANT(name, (servar::run_stream<R, U, T, PF, FULL>(w, plane, o, m, n, st)))

extern "C" int parent_i8(const float* w, const int8_t* q, const float* sc, float* o, int m,
                         int n, long long xp, long long qb, void* st) {
  return parent12::run8(w, q, sc, o, m, n, xp, qb, static_cast<cudaStream_t>(st));
}
extern "C" int parent_i4(const float* w, const uint8_t* q, const float* sc, float* o, int m,
                         int n, long long xp, long long qb, void* st) {
  return parent12::run4(w, q, sc, o, m, n, xp, qb, static_cast<cudaStream_t>(st));
}

STREAM(s_r1_u1_t128_full_np, 1, 1, 128, false, true)
STREAM(s_r1_u1_t64_full_np, 1, 1, 64, false, true)
STREAM(s_r1_u1_t256_full_np, 1, 1, 256, false, true)
STREAM(s_r1_u2_t128_full_np, 1, 2, 128, false, true)
STREAM(s_r1_u1_t128_full, 1, 1, 128, true, true)
STREAM(s_r1_u1_t128, 1, 1, 128, true, false)
STREAM(s_r1_u2_t128, 1, 2, 128, true, false)
STREAM(s_r1_u4_t128, 1, 4, 128, true, false)
STREAM(s_r1_u4_t128_np, 1, 4, 128, false, false)
STREAM(s_r2_u1_t128_full_np, 2, 1, 128, false, true)
STREAM(s_r4_u1_t128_full_np, 4, 1, 128, false, true)
STREAM(s_r4_u2_t128_full_np, 4, 2, 128, false, true)
STREAM(s_r4_u1_t128_full, 4, 1, 128, true, true)
STREAM(s_r4_u1_t128, 4, 1, 128, true, false)
STREAM(s_r4_u2_t128, 4, 2, 128, true, false)
STREAM(s_r4_u4_t128, 4, 4, 128, true, false)
STREAM(s_r8_u1_t128_full_np, 8, 1, 128, false, true)
STREAM(s_r8_u1_t256_full_np, 8, 1, 256, false, true)
STREAM(s_r16_u1_t128_full_np, 16, 1, 128, false, true)
STREAM(s_r8_u1_t128_full, 8, 1, 128, true, true)
STREAM(s_r8_u1_t128, 8, 1, 128, true, false)
STREAM(s_r8_u4_t128, 8, 4, 128, true, false)
SERVE_VARIANT(ls_r1_sync, (servar::run_lockstep<1, true, false>(w, plane, o, m, n, st)))
SERVE_VARIANT(ls_r4_sync, (servar::run_lockstep<4, true, false>(w, plane, o, m, n, st)))
SERVE_VARIANT(ls_r4_wlate, (servar::run_lockstep<4, false, true>(w, plane, o, m, n, st)))
SERVE_VARIANT(ls_r4_sync_wlate, (servar::run_lockstep<4, true, true>(w, plane, o, m, n, st)))
SERVE_VARIANT(pdiv1, (parent12::run_div1(w, parent12_plane(plane), o, m, n,
                                         static_cast<cudaStream_t>(st))))
SERVE_VARIANT(bulk_u2, (servar::run_bulk<2>(w, plane, o, m, n, st)))
SERVE_VARIANT(bulk_u4, (servar::run_bulk<4>(w, plane, o, m, n, st)))
