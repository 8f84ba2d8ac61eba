// Fused dequantize + mix over a quantized plane, out = W · dequant(P), for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/gossip_mix.py:
//   gossip_mix_dequant   (_mix_dequant_kernel): W (M, N) fp32 over an int8
//       plane q (N, Xp) with fp32 scales (N, Xp/qblock), one scale per
//       qblock columns; out (M, Xp) fp32. M = N for gossip with a codec,
//       M = B requests over N = S clusters for int8 serving.
//   mixture_mix_dequant4 (_mixture_dequant4_kernel): U (B, S) over the
//       bit-packed int4 plane (S, Xp/2) uint8, element 2i in the low nibble
//       of byte i and 2i+1 in the high one, both two's-complement 4-bit;
//       qblock is even, so a nibble pair never straddles a scale block.
//
// Which shapes take which kernel. gossip_mix_dequant on a square W (M =
// N <= 32) over a plane narrower than 65,536 columns (kNarrowMaxX) is the
// dense exchange with an int8/int4 codec (N = 20 clients, Xp = 17,408 on
// the main path): a few µs, bound by latency, not bytes. It takes
// gossip_mix.cu's mix_kernel_narrow (through gossip_mix.cuh), whose
// threads issue every load before one barrier. Serving and the LM mix (M
// = B requests over N = S <= 4 clusters) take mix_dequant_stream when
// Xp and qblock are multiples of 4, the rows 16-byte aligned and M is not
// 3 or 4; every other shape (M = 3 or 4, N > 4, an odd or unaligned
// width, a qblock that is not a multiple of 4) takes the general
// template, mix_dequant_kernel.
// mixture_mix_dequant4 is only ever served. Every kernel sums each output
// j ascending from 0.f over the same rounded dequant products, so an
// output row has the same bits whatever M is and whichever kernel runs.
//
// What bounds them: the output. The LM mix at one request (olmoe-1b-7b:
// M = 1, S = 2, Xp = 6,919,620,608) reads 13.8 GB of int8 plane and 0.87
// GB of scales and writes 27.7 GB of fp32; serving (B = 256, S = 2, Xp =
// 17,280) reads ~37 KB and writes 17.7 MB. 2·M·N FLOPs per output column:
// bytes, not operations, and most of them the (M, Xp) stores.
//
// mix_dequant_stream: a thread owns one group of 4 adjacent columns (one
// 16-byte store a row; neighbouring threads write neighbouring groups, so
// each warp store is a coalesced 512-byte run, st.global.cs, evict-first:
// the output is written once and read once, by the forward that follows)
// for the block's R output rows (1, 2 or 4 by M; grid.y splits M past 4:
// on the H100 8 or 16 rows a block measured slower at B = 20 to 1,024).
// The four columns of a group share one scale (qblock % 4 == 0): one
// scale load a plane row, its index found in 32 bits once a thread. W's
// R × NB entries (NB ≤ 4) are loaded into registers; there is no shared
// memory and no barrier, and every plane row's loads are issued before
// the first is decoded, so a thread's loads are all in flight at once and
// its stores follow them. The grid covers the width, each step of it
// below 2^31 columns: past that a block strides on, and the scale index
// advances by the step's quotient and remainder by qblock (an add and a
// compare). The general template, which served these shapes before,
// makes one 64-bit division a column and passes two barriers for a
// single store a thread at M = 1: 38-42 % of the byte bound on the H100
// at olmoe-1b-7b's one-request mix, where this kernel reaches 86-87 %
// (PERF.md). tools/mix_variants.py serving times the designs that lost:
// a persistent grid of resident blocks, 2 to 8 groups a thread, the next
// tile's loads issued before the current stores, 1-D bulk copies of each
// warp's output from shared memory, other rows and threads a block.
//
// mix_dequant_kernel (the general template): one thread owns VEC adjacent
// columns (4 when the rows allow 16-byte stores, else 2 or 1) and finds
// their scale columns, (col + t) / qblock, once; it dequantizes its
// columns of NB plane rows into registers once, then walks kRows = 8
// output rows (grid.y splits M), each a chain of fp32 FMAs over j in
// order and one vector store. The block's kRows × NB slice of W sits in
// shared memory. N is taken in chunks of NB ≤ 16 rows; past the first
// chunk a thread adds into the outputs it wrote itself (a
// read-modify-write of its own columns), so any N ≥ 1 is correct.
//
// Both round each dequant product on its own (__fmul_rn) as the plain
// PyTorch version does; accumulation is fp32 FMA on the CUDA cores, never
// TF32, so kernel and plain version differ only in the order of the sum
// over j.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gossip_mix.cuh"

namespace {

using gossip_mix::aligned;

constexpr int kThreads = 128;  // column groups per block
constexpr int kRows = 8;       // output rows per block (grid.y)

// a two's-complement 4-bit value held in the low bits of v, as fp32
__device__ __forceinline__ float nibble(unsigned v) {
  return static_cast<float>(static_cast<int>(v) - 16 * static_cast<int>(v > 7u));
}

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

// mix_dequant_stream's view of a plane: a group of 4 adjacent columns of
// row j, their raw quanta (raw) and their one scale (qblock % 4 == 0),
// dequantized as the template's planes do (decode).
struct Int8Quad {
  using Raw = char4;
  const int8_t* q;     // (N, Xp)
  const float* scale;  // (N, nq)
  int64_t xp, nq, qblock;
  __device__ __forceinline__ Raw raw(int j, int64_t col) const {
    return __ldg(reinterpret_cast<const char4*>(q + j * xp + col));
  }
  static __device__ __forceinline__ void decode(Raw r, float s, float (&v)[4]) {
    v[0] = __fmul_rn(static_cast<float>(r.x), s);
    v[1] = __fmul_rn(static_cast<float>(r.y), s);
    v[2] = __fmul_rn(static_cast<float>(r.z), s);
    v[3] = __fmul_rn(static_cast<float>(r.w), s);
  }
};

struct Int4Quad {
  using Raw = uchar2;
  const uint8_t* packed;  // (S, Xp/2)
  const float* scale;     // (S, nq)
  int64_t xp, nq, qblock;
  __device__ __forceinline__ Raw raw(int j, int64_t col) const {
    return __ldg(reinterpret_cast<const uchar2*>(packed + j * (xp / 2) + col / 2));
  }
  static __device__ __forceinline__ void decode(Raw r, float s, float (&v)[4]) {
    v[0] = __fmul_rn(nibble(r.x & 0xFu), s);
    v[1] = __fmul_rn(nibble(static_cast<unsigned>(r.x) >> 4), s);
    v[2] = __fmul_rn(nibble(r.y & 0xFu), s);
    v[3] = __fmul_rn(nibble(static_cast<unsigned>(r.y) >> 4), s);
  }
};

constexpr int kStreamThreads = 128;  // 4-column groups a block of mix_dequant_stream

// out (m, xp) = w (m, n) · plane, n <= NB <= 4, xp and qblock multiples of
// 4 (see the header): a thread mixes one group of 4 adjacent columns a
// tile (tile = blockIdx.x: kStreamThreads · 4 columns) for the block's R
// output rows (blockIdx.y). The grid covers every tile, but one of its
// steps stays below 2^31 columns: past that (olmoe-1b-7b's plane) each
// block strides on by gridDim.x tiles, gridDim.x · kStreamThreads · 4 =
// dq · qblock + dr columns (dq, dr from the launcher), and the scale
// column advances by dq and dr: the kernel divides only in 32 bits, once.
template <int NB, int R, class Quad>
__global__ void __launch_bounds__(kStreamThreads)
mix_dequant_stream(const float* __restrict__ w, Quad plane, float* __restrict__ out, int m,
                   int n, int64_t dq, int dr) {
  constexpr unsigned kTile = kStreamThreads * 4;
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
  const unsigned first = blockIdx.x * kTile + threadIdx.x * 4;  // < 2^31
  int64_t sb = first / static_cast<unsigned>(qb);  // the group's scale column
  int rem = static_cast<int>(first % static_cast<unsigned>(qb));
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTile;
  for (int64_t col = first; col < xp; col += step) {
    // every row's loads before the first use of one: a decode between
    // them would wait out a load's latency per plane row
    typename Quad::Raw raw[NB];
    float s[NB];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      raw[jj] = {};
      s[jj] = 0.f;
      if (jj < n) {
        raw[jj] = plane.raw(jj, col);
        s[jj] = __ldg(plane.scale + jj * plane.nq + sb);
      }
    }
    float v[NB][4];
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) Quad::decode(raw[jj], s[jj], v[jj]);
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
    rem += dr;
    sb += dq;
    if (rem >= qb) {
      rem -= qb;
      ++sb;
    }
  }
}

template <int NB, int R, class Quad>
void launch_stream(const float* w, const Quad& plane, float* out, int m, int n,
                   cudaStream_t stream) {
  constexpr int64_t kTile = kStreamThreads * 4;
  const int64_t gx = std::min((plane.xp + kTile - 1) / kTile, ((int64_t{1} << 31) - 1) / kTile);
  const int64_t step = gx * kTile;
  mix_dequant_stream<NB, R, Quad>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>((m + R - 1) / R)),
         kStreamThreads, 0, stream>>>(w, plane, out, m, n, step / plane.qblock,
                                      static_cast<int>(step % plane.qblock));
}

// the stream kernel's shapes: up to 4 plane rows, 4-column groups that
// share a scale, 16-byte output rows, M not 3 or 4 and at most 65,535
// blocks of 4 rows (grid.y). At M = 4 (the dense LMs' four-request mix)
// the template's warps, held in step by its barriers, store as fast as
// any variant of the stream kernel measured on the H100
// (tools/mix_variants.py serving), so M = 3 and 4 keep it.
inline bool stream_shape(int m, int n, int64_t xp, int64_t qblock) {
  return (m <= 2 || (m > 4 && m <= 4 * 65535)) && n <= 4 && xp % 4 == 0 && qblock % 4 == 0 &&
         qblock < (int64_t{1} << 30);
}

// R output rows a block by M (1, 2 or 4; grid.y splits M past 4), NB
// plane rows by N (2 or 4)
template <class Quad>
void launch_stream_shape(const float* w, const Quad& plane, float* out, int m, int n,
                         cudaStream_t s) {
  auto by_rows = [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    if (m == 1) {
      launch_stream<NB, 1>(w, plane, out, m, n, s);
    } else if (m == 2) {
      launch_stream<NB, 2>(w, plane, out, m, n, s);
    } else {
      launch_stream<NB, 4>(w, plane, out, m, n, s);
    }
  };
  if (n <= 2) {
    by_rows(std::integral_constant<int, 2>{});
  } else {
    by_rows(std::integral_constant<int, 4>{});
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

}  // namespace

extern "C" {

// out (m, xp) = w (m, n) · (q (n, xp) int8 ⊙ repeat(scales (n, xp/qblock), qblock)).
// All contiguous on the device; xp % qblock == 0. A square W of the
// narrow plane takes gossip_mix.cu's mix_kernel_narrow, n <= 4 with xp and
// qblock multiples of 4 and q, out aligned mix_dequant_stream, every other
// shape mix_dequant_kernel (see the header).
int gossip_mix_dequant(const float* w, const int8_t* q, const float* scales, float* out,
                       int m, int n, long long xp, long long qblock, void* stream) {
  if (m > 0 && n > 0 && xp > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nq = xp / qblock;
    if (gossip_mix::launch_dequant_narrow(w, q, scales, out, m, n, xp, qblock, s)) {
      return static_cast<int>(cudaGetLastError());
    }
    if (stream_shape(m, n, xp, qblock) && aligned(q, 4) && aligned(out, 16)) {
      launch_stream_shape(w, Int8Quad{q, scales, xp, nq, qblock}, out, m, n, s);
    } else if (xp % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
      launch_vec<4>(w, Int8Plane<4>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
    } else if (xp % 2 == 0 && aligned(q, 2) && aligned(out, 8)) {
      launch_vec<2>(w, Int8Plane<2>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
    } else {
      launch_vec<1>(w, Int8Plane<1>{q, scales, xp, nq, qblock}, out, m, n, xp, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out (b, xp) = u (b, s) · (unpack4(packed (s, xp/2) uint8) ⊙ repeat(scales, qblock)).
// All contiguous on the device; qblock even, xp % qblock == 0; out is
// 8-byte aligned (the wrapper allocates it).
int mixture_mix_dequant4(const float* u, const uint8_t* packed, const float* scales,
                         float* out, int b, int s, long long xp, long long qblock,
                         void* stream) {
  if (b > 0 && s > 0 && xp > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t nq = xp / qblock;
    if (stream_shape(b, s, xp, qblock) && aligned(packed, 2) && aligned(out, 16)) {
      launch_stream_shape(u, Int4Quad{packed, scales, xp, nq, qblock}, out, b, s, st);
    } else if (xp % 4 == 0 && aligned(packed, 2) && aligned(out, 16)) {
      launch_vec<4>(u, Int4Plane<4>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
    } else {
      launch_vec<2>(u, Int4Plane<2>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
