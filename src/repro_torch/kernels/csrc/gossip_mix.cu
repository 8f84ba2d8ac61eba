// Cluster-matched gossip mix C' = W · C on the packed (N, X) plane, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernels src/repro/kernels/gossip_mix.py:
// gossip_mix_flat (W·C), gossip_mix_fused_dp
// (W·(c_old + scale ⊙ (c_new − c_old) + σ·noise)) and gossip_mix_stack
// (W·C_s for every slab s of an (S, N, X) stack, in one launch).
//
// What bounds it: every output column reads the N inputs of its column
// once and writes N outputs, 2N FLOPs per input element, so the
// arithmetic intensity is N/4 FLOP/B in fp32 — memory-bound on an H100
// (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores) below N ≈ 80.
//
// Design: one thread owns one column of X, so the plane is streamed once
// with coalesced 4-byte loads (rows of an odd X are not 16-byte aligned,
// which rules out vector loads on every row). N is cut into chunks of NB
// rows (NB = 8, 16, 24 or 32, the smallest that holds N when N <= 32); a
// block stages the matching NB×NB chunk of W in shared memory (every
// thread reads the same W entry: a broadcast), and each thread keeps NB
// fp32 accumulators for one chunk of output rows. The column's inputs are
// read through a per-element prologue in groups of kGroup = 4 rows: the
// group's loads are issued together, then kGroup·NB FMAs consume them.
// Small groups keep a thread at 36–78 registers, so many warps per SM
// carry loads in flight, while each warp touches only a few rows at a
// time; on the H100, loading all NB rows (or 8) at once measured slower
// at X = 4,194,304, for the flat mix and more so for the fused DP mix,
// which reads three arrays per row. For N <= 32 there is one chunk and
// the plane is read exactly once; a larger N re-reads it once per chunk
// of output rows. Accumulation is fp32 FMA on the CUDA cores, never
// TF32. The fused-DP prologue rounds each step as the plain PyTorch
// version does (no contraction), so the two differ only in the order of
// the sum over j.
//
// The stack mix is the same kernel over a 2-D grid: blockIdx.y selects
// the slab s, whose offset s·N·X is taken in int64_t (at S = 4, N = 32,
// X = 2^24 it passes 2^31). Every slab shares the one W; each block
// stages its chunks of W as above, so a slab with N > 32 re-reads its
// plane once per chunk of 32 output rows, like a flat plane. A flat plane
// is the stack of one slab (gridDim.y = 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // columns per block
constexpr int kGroup = 4;      // input rows whose loads are in flight together

// A prologue reads input row j at element offset k of the plane (or
// stack) and returns the value the mix consumes.
struct Identity {
  const float* c;
  __device__ __forceinline__ float operator()(int j, int64_t k) const {
    return __ldg(c + k);
  }
};

template <bool kNoise>
struct FusedDP {
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

// out[s, i, col] = sum_j w[i, j] * prologue(row j of slab s, col), one
// thread per column of slab s = blockIdx.y.
template <int NB, class Prologue>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ w, Prologue in, float* __restrict__ out,
           int n, int64_t x) {
  static_assert(NB % kGroup == 0, "a group never reads past the staged W chunk");
  __shared__ float sw[NB][NB];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * n * x + col;  // slab + column
  const bool live = col < x;
  for (int i0 = 0; i0 < n; i0 += NB) {
    float acc[NB];
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) acc[ii] = 0.f;
    for (int j0 = 0; j0 < n; j0 += NB) {
      __syncthreads();  // the previous chunk's readers of sw are done
      for (int t = threadIdx.x; t < NB * NB; t += kThreads) {
        const int i = i0 + t / NB, j = j0 + t % NB;
        sw[t / NB][t % NB] = (i < n && j < n) ? w[static_cast<int64_t>(i) * n + j] : 0.f;
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
        if (i0 + ii < n) out[base + (i0 + ii) * x] = acc[ii];
      }
    }
  }
}

template <int NB, class Prologue>
void launch_nb(const float* w, Prologue in, float* out, int slabs, int n, int64_t x,
               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((x + kThreads - 1) / kThreads),
                  static_cast<unsigned>(slabs));
  mix_kernel<NB, Prologue><<<grid, kThreads, 0, stream>>>(w, in, out, n, x);
}

// Mixes `slabs` consecutive (n, x) planes with the same W.
template <class Prologue>
int launch(const float* w, Prologue in, float* out, int slabs, int n, int64_t x,
           void* stream) {
  if (slabs > 0 && n > 0 && x > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 8) {
      launch_nb<8>(w, in, out, slabs, n, x, s);
    } else if (n <= 16) {
      launch_nb<16>(w, in, out, slabs, n, x, s);
    } else if (n <= 24) {
      launch_nb<24>(w, in, out, slabs, n, x, s);
    } else {
      launch_nb<32>(w, in, out, slabs, n, x, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// C' = W · C. w (n, n), c and out (n, x), fp32, contiguous, on the device.
int gossip_mix_flat(const float* w, const float* c, float* out, int n,
                    long long x, void* stream) {
  return launch(w, Identity{c}, out, 1, n, x, stream);
}

// C'_s = W · C_s for every s. w (n, n); c and out (s, n, x), fp32,
// contiguous, on the device; s <= 65535 (the grid's y extent).
int gossip_mix_stack(const float* w, const float* c, float* out, int s, int n,
                     long long x, void* stream) {
  return launch(w, Identity{c}, out, s, n, x, stream);
}

// C' = W · (c_old + scale ⊙ (c_new − c_old) [+ sigma · noise]); noise is
// read only when sigma > 0 (it may be null otherwise). scale is (n,).
int gossip_mix_fused_dp(const float* w, const float* c_old, const float* c_new,
                        const float* scale, const float* noise, float sigma,
                        float* out, int n, long long x, void* stream) {
  if (sigma > 0.f) {
    return launch(w, FusedDP<true>{c_old, c_new, scale, noise, sigma}, out, 1, n, x,
                  stream);
  }
  return launch(w, FusedDP<false>{c_old, c_new, scale, nullptr, 0.f}, out, 1, n, x,
                stream);
}

}  // extern "C"
