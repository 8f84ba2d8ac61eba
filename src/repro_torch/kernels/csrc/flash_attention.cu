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
// 989 TFLOP/s): the two are close, so both products have to run on the
// tensor cores and the k/v tiles have to arrive while the last ones are
// being used.
//
// bf16 inputs: flash_mma_kernel, FlashAttention-2 style on the tensor cores
// through mma.sync.aligned.m16n8k16 (bf16 × bf16 → fp32); the cp.async,
// ldmatrix and mma helpers are in mma_sm90.cuh, shared with ssd_scan.cu.
// - Rows. A block of 4 warps owns 64 rows, 16 per warp. Under GQA the rows
//   are the (position, head-in-group) pairs of ONE kv head, position-major
//   (row f is position f / G, query head hk·G + f % G), so the G query
//   heads that read a kv head share every k/v tile the block stages: a
//   tile is staged once per (64 rows, kv head, batch), never once per
//   query head. The grid is one-dimensional over (row tile, kv head,
//   batch), the last row tiles first: under a causal mask they see the
//   most keys, and starting them first shortens the tail.
// - Staging. q (64 rows) and the k and v tiles of kBK keys (64; 32 at hd
//   256, whose 64-row accumulator needs the registers) are copied to
//   shared memory as bf16 with 16-byte cp.async loads (rows past Lq·G or
//   Lkv are zero-filled by the copy). k/v are double-buffered: tile t+1 is
//   in flight while tile t computes. Rows are padded to hd + 8 elements,
//   so the eight 16-byte row segments an ldmatrix phase reads start in
//   eight distinct groups of 4 banks: no bank conflicts at any of the
//   seven head dims.
// - S = q·kᵀ. The warp's q fragments (16 × hd) are loaded once with
//   ldmatrix.x4 and kept in registers (hd <= 128; at hd 256 they are
//   re-read from shared memory per tile, again to leave registers to the
//   accumulator); k fragments come from ldmatrix.x4 on the key-major tile
//   (its rows are the B operand's columns). S lives in fp32 registers:
//   4 per n-tile of 8 keys per thread, rows lane/4 and lane/4 + 8.
// - Softmax. Scale (times log2 e, for exp2), mask, the row max across the
//   4 threads of a row (two shuffles), p = exp2(s - m_new), alpha =
//   exp2(m_old - m_new), all in fp32 registers. Only a tile that holds a
//   dead (row, key) pair is masked (the diagonal and window-edge tiles,
//   keys past Lkv); a dead key's score is -inf, and a row that has seen no
//   live key yet takes 0 as its exponent base, so its p and alpha are 0,
//   never exp(0). Tiles outside the kv range that any row of the block
//   can see (causal: up to its last position; window: from its first
//   position - window + 1) are never read.
// - O += P·V. Each pair of S n-tiles is, element for element, the A
//   fragment of one k-step of the second product: p is rounded to bf16 in
//   registers (round to nearest even) and fed straight to the mma; v comes
//   in through ldmatrix.x4.trans. The accumulator is fp32 (hd/2 registers
//   a thread), rescaled by alpha per tile.
// - Row sum. l is the sum of the ROUNDED p, the same values that weight v,
//   so the output is an exact convex combination of v rows up to fp32
//   sums: a row whose v are all equal gets that value. Against exact fp32
//   p, each weight is off by at most 2^-9 of itself, which moves the
//   output by at most 2^-9 · max|v| before its own bf16 rounding (in
//   practice far less: the errors have both signs). That is one to two
//   bf16 steps at |o| < 4, inside the 2e-2 bf16 bound. The plain version
//   (flash_attention_ref) rounds p to bf16 in the same place, relative to
//   the row's final max where the kernel rounds relative to the running
//   max of each tile.
// - Budget (ptxas -v in the build log). Shared memory (64 + 4·kBK)·(hd +
//   8)·2 bytes: 87,040 at hd 128, 101,376 at hd 256 (kBK 32), 56,320 at hd
//   80: two blocks (8 warps) per SM at hd 128 and 256. Registers per
//   thread hd/2 (accumulator) + 4·kBK/8 (S) + hd/4 (q, hd <= 128) plus
//   addresses and softmax state, under the 255 of __launch_bounds__(128).
//   What bounds it now: mma.sync issues at about half of Hopper's
//   tensor-core rate (wgmma, TMA and warp specialisation are later work),
//   and the exp2 of every score on the SFU.
// Every head dim the wrapper takes (16, 32, 64, 80, 96, 128, 256) runs on
// this kernel; none keeps the CUDA-core kernel below for bf16.
//
// fp32 inputs: flash_kernel, the first design, kept for fp32 only (TF32
// would break the 2e-5 fp32 bound). One block of 256 threads per (q tile
// of 64 rows, q head, batch) walks the live 64-key tiles; k and v are
// staged in shared memory as fp32 (rows padded to hd + 1 floats); S = q·kᵀ
// 4 rows × 4 keys per thread into shared memory; 4 threads per query row
// run the online softmax and acc = acc·alpha + p·v on the CUDA cores with
// plain fp32 FMAs. Shared memory (64 + 2·64)·(hd + 1)·4 + 64·65·4 bytes:
// 214,016 at hd = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile (fp32 kernel)
constexpr int kThreads = 256;  // fp32 kernel
constexpr int kMmaThreads = 128;  // bf16 kernel: 4 warps × 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool live_pair(int qi, int kj, int lq, int lkv, int causal,
                                          int window) {
  bool live = qi < lq && kj < lkv;
  if (causal) live = live && qi >= kj;
  if (window > 0) live = live && (qi - kj < window);
  return live;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

template <int HD>
struct MmaTile {
  static constexpr int kKeys = HD == 256 ? 32 : 64;  // keys per kv tile
  static constexpr int kStride = HD + 8;             // shared row stride, elements
  static constexpr int kChunks = HD / 8;             // 16-byte chunks per row
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr size_t kSmem =
      static_cast<size_t>(kBQ + 4 * kKeys) * kStride * sizeof(__nv_bfloat16);
};

// (lo, hi) rounded to a bf16 pair (lo in the low half, as an mma fragment
// holds its lower column); adds the rounded values to sum
__device__ __forceinline__ uint32_t pack_round(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int nb, int lq, int lkv, int hq, int hkv, int n_row_tiles, int causal,
                 int window, float scale_log2) {
  using T = MmaTile<HD>;
  constexpr int BK = T::kKeys, STR = T::kStride, CH = T::kChunks;
  constexpr int KS = HD / 16;  // k-steps of q·kᵀ over hd
  constexpr int NT = HD / 8;   // n-tiles of the output
  constexpr int NK = BK / 8;   // n-tiles of S
  static_assert(NT % 2 == 0 && NK % 2 == 0, "ldmatrix.x4 feeds two n-tiles");
  static_assert((kBQ * CH) % kMmaThreads == 0 && (BK * CH) % kMmaThreads == 0,
                "every thread issues the same number of copies");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(flash_smem);  // (kBQ, STR)
  __nv_bfloat16* sk = sq + kBQ * STR;                                 // 2 × (BK, STR)
  __nv_bfloat16* sv = sk + 2 * BK * STR;                              // 2 × (BK, STR)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = hkv * nb;
  const int rt = n_row_tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int hk = static_cast<int>(blockIdx.x) % per_tile % hkv;
  const int b = static_cast<int>(blockIdx.x) % per_tile / hkv;
  const int g = hq / hkv;
  const int rows = lq * g;  // (position, head-in-group) rows of kv head hk
  const int f0 = rt * kBQ;
  const int p_first = f0 / g, p_last = (min(f0 + kBQ, rows) - 1) / g;

  // q row f: position f / g, head hk·g + f % g
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * lq * hq + hk * g) * HD;
  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * lq * hq + hk * g) * HD;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * HD;  // between positions
  const int64_t kv_off = (static_cast<int64_t>(b) * lkv * hkv + hk) * HD;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

#pragma unroll
  for (int i = 0; i < kBQ * CH / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / CH, ch = c % CH;
    const int f = f0 + r;
    const bool in = f < rows;
    const int64_t row = in ? static_cast<int64_t>(f / g) * hq + f % g : 0;
    cp_async16(smem_u32(sq + r * STR + ch * 8), qb + row * HD + ch * 8, in);
  }
  auto load_kv = [&](int t, int buf) {
#pragma unroll
    for (int i = 0; i < BK * CH / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c / CH, ch = c % CH;
      const int kj = t * BK + r;
      const bool in = kj < lkv;
      const int64_t off = (in ? kj : 0) * kv_stride + ch * 8;
      const int s = (buf * BK + r) * STR + ch * 8;
      cp_async16(smem_u32(sk + s), kb + off, in);
      cp_async16(smem_u32(sv + s), vb + off, in);
    }
  };

  // the kv positions any row of this block can see
  int k_lo = 0, k_hi = lkv - 1;
  if (causal) k_hi = min(k_hi, p_last);
  if (window > 0) k_lo = max(k_lo, p_first - window + 1);
  const int t_lo = k_lo / BK, t_hi = k_lo <= k_hi ? k_hi / BK : t_lo - 1;
  if (t_lo <= t_hi) load_kv(t_lo, 0);
  cp_async_commit();  // q and the first tile

  const int gr = lane >> 2, tig = lane & 3;  // fragment row and column pair
  const int r0 = warp * 16 + gr;             // this thread's rows r0 and r0 + 8
  const int pos0 = (f0 + r0) / g, pos1 = (f0 + r0 + 8) / g;
  // per-lane ldmatrix offsets (elements): q/A rows lane & 15, column half
  // lane >> 4; k rows (lane & 7) + 8·(lane >> 4), column half (lane >> 3) & 1;
  // v (transposed) rows (lane & 7) + 8·((lane >> 3) & 1), column half lane >> 4
  const uint32_t q_addr =
      smem_u32(sq + (warp * 16 + (lane & 15)) * STR + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * STR + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * STR + (lane >> 4) * 8;

  float acc[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  uint32_t qf[T::kQInRegs ? KS : 1][4];

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile t + 1 has landed
    __syncthreads();
    if constexpr (T::kQInRegs) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);
      }
    }
    const uint32_t k_addr = smem_u32(sk + buf * BK * STR + k_lane);
    const uint32_t v_addr = smem_u32(sv + buf * BK * STR + v_lane);

    // S = q·kᵀ
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (T::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(q_addr + kk * 32, a);
      }
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bk[4];
        ldsm_x4(k_addr + (j * 8 * STR + kk * 16) * 2, bk);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask where the tile holds a dead pair, online softmax
    const int k0 = t * BK;
    const bool full = k0 + BK <= lkv && (!causal || k0 + BK - 1 <= p_first) &&
                      (window <= 0 || p_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int pos = e < 2 ? pos0 : pos1;
          const int kj = k0 + j * 8 + 2 * tig + (e & 1);
          bool live = kj < lkv;
          if (causal) live = live && pos >= kj;
          if (window > 0) live = live && pos - kj < window;
          if (!live) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NK; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      base[i] = mx == -INFINITY ? 0.f : mx;  // no live key yet: p and alpha are 0
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx;
    }
    uint32_t p[NK][2];  // bf16 pairs: row r0, row r0 + 8
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      p[j][0] = pack_round(exp2f(s[j][0] - base[0]), exp2f(s[j][1] - base[0]), sum[0]);
      p[j][1] = pack_round(exp2f(s[j][2] - base[1]), exp2f(s[j][3] - base[1]), sum[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P·V: S n-tiles 2kk and 2kk + 1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
      for (int d = 0; d < NT; d += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(v_addr + (kk * 16 * STR + d * 8) * 2, bv);
        mma_bf16(acc[d], a, bv[0], bv[1]);
        mma_bf16(acc[d + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before tile t + 2 lands in it
  }
  cp_async_wait<0>();  // a block with no live tile still has q in flight

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + r0 + 8 * i;
    if (f < rows) {
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow =
          ob + (static_cast<int64_t>(f / g) * hq + f % g) * HD + 2 * tig;
#pragma unroll
      for (int d = 0; d < NT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
            __floats2bfloat162_rn(acc[d][2 * i] / den, acc[d][2 * i + 1] / den);
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int b, int lq, int lkv,
               int hq, int hkv, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = MmaTile<HD>::kSmem;
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int64_t row_tiles = (static_cast<int64_t>(lq) * (hq / hkv) + kBQ - 1) / kBQ;
  const int64_t blocks = row_tiles * hkv * b;
  if (static_cast<int64_t>(lq) * (hq / hkv) > INT32_MAX - kBQ || blocks > INT32_MAX)
    return cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  flash_mma_kernel<HD><<<static_cast<unsigned>(blocks), kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), b, lq, lkv, hq,
      hkv, static_cast<int>(row_tiles), causal, window, scale_log2);
  return cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, int b, int lq,
                 int lkv, int hq, int hkv, int hd, int causal, int window,
                 cudaStream_t stream) {
  // 16-byte cp.async copies: every row starts on a 16-byte boundary when
  // the bases do (hd is a multiple of 8)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (bases % 16 != 0) return cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return launch_mma<16>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 32: return launch_mma<32>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 64: return launch_mma<64>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 80: return launch_mma<80>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 96: return launch_mma<96>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 128: return launch_mma<128>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 256: return launch_mma<256>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr size_t smem_bytes(int hd) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (hd + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int lq, int lkv, int hq,
             int hkv, int causal, int window, float scale) {
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
  const float* qb = q + static_cast<int64_t>(b) * lq * q_stride + static_cast<int64_t>(h) * HD;
  const float* kb = k + static_cast<int64_t>(b) * lkv * kv_stride + static_cast<int64_t>(hk) * HD;
  const float* vb = v + static_cast<int64_t>(b) * lkv * kv_stride + static_cast<int64_t>(hk) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int qi = q0 + r;
    sq[r * S + d] = qi < lq ? qb[qi * q_stride + d] : 0.f;
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
        sk[r * S + d] = in ? kb[kj * kv_stride + d] : 0.f;
        sv[r * S + d] = in ? vb[kj * kv_stride + d] : 0.f;
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
    float* orow_ptr = o + ((static_cast<int64_t>(b) * lq + qi) * hq + h) * HD + olane;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) orow_ptr[4 * i] = acc[i] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int lq, int lkv,
           int hq, int hkv, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(HD);
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lq, lkv, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o, int b, int lq,
                  int lkv, int hq, int hkv, int hd, int causal, int window,
                  cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 32: return launch<32>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 80: return launch<80>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 96: return launch<96>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    case 256: return launch<256>(q, k, v, o, b, lq, lkv, hq, hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Lq, Hq, hd), k/v (B, Lkv, Hkv, hd), o (B, Lq, Hq, hd), all contiguous,
// one dtype: fp32 (bf16 = 0) or bf16 (bf16 = 1; every base 16-byte aligned).
// window <= 0: no window. Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v, void* o, int b, int lq,
                    int lkv, int hq, int hkv, int hd, int causal, int window, int bf16,
                    void* stream) {
  if (b <= 0 || lq <= 0 || lkv <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 ||
      b > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_mma(q, k, v, o, b, lq, lkv, hq, hkv, hd, causal, window, s)
              : dispatch_fp32(q, k, v, o, b, lq, lkv, hq, hkv, hd, causal, window, s);
}

}  // extern "C"
