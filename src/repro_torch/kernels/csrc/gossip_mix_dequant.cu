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
// threads issue every load before one barrier, where the template below
// makes two passes over N > 16 rows, each a chain of dependent steps
// (plane loads, W staged, 8 rows of stores). Every other shape takes the
// template below: serving (M = B requests over S clusters, the output
// 100× the plane), the LM mix (S = 2, Xp past 10^9) and wide planes, at
// 67–81 % of their byte bound on the H100 (chip_smoke.py). mixture_mix_dequant4 is only ever served.
// Both sum each output j ascending from 0.f over the same rounded dequant
// products, so a square W gets the same bits from either kernel.
//
// What bounds the template: the output. At the serving shapes (B = 256,
// S = 2, Xp = 17,280) the kernel reads ~37 KB of plane and writes 17.7 MB
// of fp32, 2·M·N FLOPs per output column: bytes, not operations, and
// almost all of them the (M, Xp) stores.
//
// Design: one thread owns VEC adjacent columns (4 when the rows allow
// 16-byte stores, else 2 or 1), and finds their scale columns, (col + t) /
// qblock, once. It dequantizes its columns of NB plane rows into
// registers once (int8: one char4 load per row; int4: one 2-byte load per
// row, i.e. four nibbles), then walks kRows output rows, each a chain of
// fp32 FMAs over j = 0..N-1 in order and one vector store: neighbouring
// threads write neighbouring 16-byte pieces, so each warp store is one
// coalesced 512-byte run. The stores stream (st.global.cs, evict-first):
// the output is written once and read once, by the forward that follows.
// The block's kRows × NB slice of W sits in shared memory (every thread
// reads the same entry: a broadcast). grid.y splits the M rows into
// blocks of kRows = 8, so a batch of 256 requests is 32 × 34 blocks, about
// eight resident per SM, and each block re-reads only its columns' few
// plane bytes (L2-resident). On the H100, 32 rows per block with plain
// stores (2 blocks per SM at B = 256) measured slower at B = 256 and
// 1,024, and 4 rows no better than 8. N is taken in chunks of NB ≤ 16
// rows; past the first chunk a thread adds into the outputs it wrote
// itself (a read-modify-write of its own columns), so any N ≥ 1 is
// correct and N ≤ 16 writes each output once. The dequant product is
// rounded on its own (__fmul_rn) as the plain PyTorch version's is;
// accumulation is fp32 FMA on the CUDA cores, never TF32, so the two
// differ only in the order of the sum over j.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gossip_mix.cuh"

namespace {

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

}  // namespace

extern "C" {

// out (m, xp) = w (m, n) · (q (n, xp) int8 ⊙ repeat(scales (n, xp/qblock), qblock)).
// All contiguous on the device; xp % qblock == 0. A square W of the
// narrow plane takes gossip_mix.cu's mix_kernel_narrow, every other shape
// mix_dequant_kernel (see the header).
int gossip_mix_dequant(const float* w, const int8_t* q, const float* scales, float* out,
                       int m, int n, long long xp, long long qblock, void* stream) {
  if (m > 0 && n > 0 && xp > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t nq = xp / qblock;
    if (gossip_mix::launch_dequant_narrow(w, q, scales, out, m, n, xp, qblock, s)) {
      return static_cast<int>(cudaGetLastError());
    }
    if (xp % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
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
    if (xp % 4 == 0 && aligned(packed, 2) && aligned(out, 16)) {
      launch_vec<4>(u, Int4Plane<4>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
    } else {
      launch_vec<2>(u, Int4Plane<2>{packed, scales, xp, nq, qblock}, out, b, s, xp, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
