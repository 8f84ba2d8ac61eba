// GQA flash attention (causal or sliding window, online softmax) for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel): q (B, Lq, Hq, hd), k/v (B, Lkv, Hkv, hd),
// fp32 or bf16 in, fp32 softmax and accumulation, out (B, Lq, Hq, hd) in q's
// dtype. Query head h reads kv head h / (Hq / Hkv); scale = 1/sqrt(hd);
// positions are the plain row indices of q and of k (no offset, also when
// Lq != Lkv); causal keeps pos_q >= pos_k, a window keeps pos_q - pos_k <
// window. A row with no live key is 0 (acc / max(l, 1e-30), as the TPU
// kernel's finalize).
//
// What bounds it: bytes, barely. One prefill layer of olmo-1b (B = 4, L =
// 512, 16 heads, hd 128, bf16) moves 4·B·L·Hq·hd·2 bytes (q, k, v read
// once, out written once: 33.6 MB, 10.0 µs at 3.35 TB/s) for
// 4·B·Hq·hd·L(L+1)/2 FLOPs (4.3 GFLOP, 4.35 µs on the bf16 tensor cores at
// 989 TFLOP/s): the two are close, and this kernel, which runs its
// products on the CUDA cores in fp32 (67 TFLOP/s), is far from either.
//
// Design (simple first; tensor cores, TMA and warp specialisation are for a
// later kernel): one block of 256 threads per (q tile of 64 rows, q head,
// batch). The block computes the range of kv positions that any of its rows
// can see (causal: up to its last row; window: from its first row minus
// window + 1), the counterpart of models/attention._block_pairs, and walks
// only the 64-key tiles of that range: a fully masked tile is never read.
// Per tile, k and v are staged in shared memory as fp32 (rows padded to
// hd + 1 floats, so threads reading neighbouring rows hit distinct banks);
// S = q·kᵀ is computed 4 rows × 4 keys per thread into shared memory, scaled
// and masked; then 4 threads per query row take the row's max, p = exp(s -
// m_new) (0 where masked), the row sum and alpha = exp(m_old - m_new), and
// update the row's accumulator slice (hd/4 floats each, in registers) with
// acc = acc·alpha + p·v. m, l and acc are fp32 throughout; the product terms
// are plain fp32 FMAs (no TF32). Shared memory is (64 + 2·64)·(hd + 1)·4 +
// 64·65·4 bytes: 214,016 at hd = 256, under the 232,448 a block can opt in
// to. hd is a template parameter (16, 32, 64, 80, 96, 128, 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

__device__ __forceinline__ bool live_pair(int qi, int kj, int lq, int lkv, int causal,
                                          int window) {
  bool live = qi < lq && kj < lkv;
  if (causal) live = live && qi >= kj;
  if (window > 0) live = live && (qi - kj < window);
  return live;
}

constexpr size_t smem_bytes(int hd) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (hd + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int lq, int lkv, int hq, int hkv, int causal, int window,
             float scale) {
  static_assert(HD % 4 == 0, "4 threads share a row's accumulator");
  constexpr int S = HD + 1;  // padded row stride, floats
  constexpr int SP = kBK + 1;
  extern __shared__ float smem[];
  float* sq = smem;             // (kBQ, S)
  float* sk = sq + kBQ * S;     // (kBK, S)
  float* sv = sk + kBK * S;     // (kBK, S)
  float* sp = sv + kBK * S;     // (kBQ, SP) scores, then probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q_stride = static_cast<int64_t>(hq) * HD;   // between positions
  const int64_t kv_stride = static_cast<int64_t>(hkv) * HD;
  const T* qb = q + static_cast<int64_t>(b) * lq * q_stride + static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * lkv * kv_stride + static_cast<int64_t>(hk) * HD;
  const T* vb = v + static_cast<int64_t>(b) * lkv * kv_stride + static_cast<int64_t>(hk) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int qi = q0 + r;
    sq[r * S + d] = qi < lq ? to_f32(qb[qi * q_stride + d]) : 0.f;
  }

  // the kv positions any row of this tile can see
  const int q_last = min(q0 + kBQ, lq) - 1;
  int k_lo = 0, k_hi = lkv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(k_lo, q0 - window + 1);

  const int orow = tid >> 2, olane = tid & 3;       // softmax and accumulator owner
  const int sr0 = (tid >> 4) * 4, sc0 = tid & 15;   // 4 rows × 4 keys of S
  float m = kNegInf, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  if (k_lo <= k_hi) {
    for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
      const int k0 = t * kBK;
      __syncthreads();  // the previous tile is consumed (and q is staged)
      for (int i = tid; i < kBK * HD; i += kThreads) {
        const int r = i / HD, d = i - (i / HD) * HD;
        const int kj = k0 + r;
        const bool in = kj < lkv;
        sk[r * S + d] = in ? to_f32(kb[kj * kv_stride + d]) : 0.f;
        sv[r * S + d] = in ? to_f32(vb[kj * kv_stride + d]) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = sq[(sr0 + r) * S + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sk[(sc0 + 16 * j) * S + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc0 + 16 * j;
          sp[(sr0 + r) * SP + c] =
              live_pair(q0 + sr0 + r, k0 + c, lq, lkv, causal, window) ? s[r][j] * scale
                                                                        : kNegInf;
        }
      __syncthreads();

      // online softmax over this tile for row orow; lanes take keys olane + 4j
      float* prow = sp + orow * SP;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) mx = fmaxf(mx, prow[olane + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const int c = olane + 4 * j;
        const float p = live_pair(q0 + orow, k0 + c, lq, lkv, causal, window)
                            ? expf(prow[c] - m_new) : 0.f;
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m - m_new);
      l = l * alpha + sum;
      m = m_new;
      __syncwarp();  // the row's four lanes (one warp) see each other's p

#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] *= alpha;
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
        const float* vr = sv + j * S + olane;
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
      }
    }
  }

  const int qi = q0 + orow;
  if (qi < lq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow_ptr = o + ((static_cast<int64_t>(b) * lq + qi) * hq + h) * HD + olane;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) orow_ptr[4 * i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int lq, int lkv,
           int hq, int hkv, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(HD);
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lkv, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int lq, int lkv,
             int hq, int hkv, int hd, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 96: return launch<T, 96>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Lq, Hq, hd), k/v (B, Lkv, Hkv, hd), o (B, Lq, Hq, hd), all contiguous,
// one dtype: fp32 (bf16 = 0) or bf16 (bf16 = 1). window <= 0: no window.
// Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o, int b, int lq,
                    int lkv, int hq, int hkv, int hd, int causal, int window, int bf16,
                    void* stream) {
  if (b <= 0 || lq <= 0 || lkv <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 ||
      b > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, lq, lkv, hq, hkv, hd, causal, window, s)
              : dispatch<float>(q, k, v, o, b, lq, lkv, hq, hkv, hd, causal, window, s);
}

}  // extern "C"
