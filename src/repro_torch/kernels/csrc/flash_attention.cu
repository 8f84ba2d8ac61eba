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
// What bounds it. One prefill layer of olmo-1b (B = 4, L = 512, 16 heads,
// hd 128, causal, bf16) moves 33.6 MB (q, k, v read once, out written
// once: 10.0 µs at 3.35 TB/s) for 4.3 GFLOP (4.35 µs on the bf16 tensor
// cores at 989 TFLOP/s); whisper's encoder layer (B = 4, 1,500 frames, 8/8
// heads, hd 64, not causal) does 18.4 GFLOP over 24.6 MB, bound by
// operations (18.6 µs against 7.3 µs of bytes); its cross attention (64
// queries over 1,500 frames) is bound by bytes (3.8 µs) and has only 32
// (row tile, kv head, batch) blocks. So both products run on the tensor
// cores, k/v tiles arrive while earlier ones are in use, and a short
// query range splits its keys over more blocks.
//
// Routes: a fixed rule of (dtype, hd), the wrapper's route(), passed in as
// `route` (its index in the wrapper's ROUTES):
// - 0, fp32, every hd: flash_tf32_kernel (3xTF32 on the tensor cores);
// - 1, bf16, hd 16, 32, 80, 96: flash_mma_kernel (mma.sync; a 128-byte
//   swizzled wgmma panel is 64 elements of a row, which these rows do not
//   fill or split evenly);
// - 2, bf16, hd 64, 128, 256: flash_wgmma_kernel (below).
// Each may run with a kv split (the wrapper's split_plan, a function of the
// shape and the SM count; this file makes no plan and only checks one
// against kSplitAlign and kMaxSplit, the wrapper's SPLIT_ALIGN and
// MAX_SPLIT): chunk c of n_split covers keys [c·chunk, (c + 1)·chunk) (the
// last chunk up to Lkv; chunk a multiple of 128, so every kv tile lies in
// one chunk), each block writes its rows' fp32 (m, l, acc) to scratch,
// and flash_combine_kernel merges the chunks: M = max m_c, out = Σ
// 2^(m_c - M)·acc_c / max(Σ 2^(m_c - M)·l_c, 1e-30), a chunk with no live
// key (m_c = -inf) weighing 0.
//
// Rows (all routes). Under GQA a block's rows are the (position,
// head-in-group) pairs of ONE kv head, position-major (row f is position
// f / G, query head hk·G + f % G), so the G query heads that read a kv head
// share every k/v tile the block stages: a tile is read once per (row
// tile, kv chunk, kv head, batch), never once per query head. The grid is
// one-dimensional over (row tile, chunk, kv head, batch), the last row
// tiles first: under a causal mask they see the most keys. A block reads
// only the kv tiles some row of it can see (causal: up to its last
// position; window: from its first position - window + 1), and masks only
// a tile that holds a dead (row, key) pair (the diagonal, the window's
// edge, keys past Lkv). Online softmax in fp32 registers in the log2
// domain: scores scaled by log2(e)/sqrt(hd), a dead key's score -inf, and
// a row that has seen no live key yet takes 0 as its exponent base, so its
// p and alpha are 0, never exp(0). Ragged lengths: the copies zero-fill
// rows past Lq·G and keys past Lkv, and rows past Lq·G are never stored;
// no padded copy of q, k or v is made.
//
// flash_wgmma_kernel (bf16, hd 64/128/256). Warp-specialised: a producer
// warpgroup (setmaxnreg 24) whose thread 0 issues TMA loads, and two
// consumer warpgroups (setmaxnreg 240) of 64 rows each, 128 rows an item.
// At hd 64 and 128 the grid is persistent: one block an SM walks the
// (row tile, chunk, kv head, batch) items in a snake order (block b takes
// items b, 2·grid - 1 - b, 2·grid + b, ...), so the ring of k/v stages
// runs on across items and the next item's tiles load while the last one
// finishes; at hd 256 the item loop's registers do not fit beside the 128
// accumulators, and each block takes one item.
// - k and v arrive by TMA (tensor maps over (hd, Hkv, Lkv, B) encoded on
//   the host, passed as __grid_constant__ parameters; boxes of 64 elements
//   × kKeys keys, 128-byte swizzled, zero-filled past Lkv) into a ring of
//   3 stages (2 at hd 256) with full / empty mbarriers; each consumer
//   warpgroup releases a stage with one arrival once its products have
//   read it. q is copied by its warpgroup with 16-byte loads (all issued
//   before the first store) into the same swizzled layout: the folded rows
//   are an affine TMA box only when G divides 64, and q is read once an
//   item.
// - S = q·kᵀ: wgmma m64n{kKeys}k16, both operands in shared memory
//   (K-major), hd / 16 of them a tile.
// - O += P·V: p is rounded to bf16 in registers and is, pair of S n-tiles
//   by pair, the A fragment of wgmma m64n{hd}k16 (A from registers); v is
//   the B operand in shared memory, key-major, through the transpose bit.
//   The row sums l come from the tensor cores too: wgmma m64n8k16 of the
//   same bf16 p by a 1 KB tile of ones, so l is exactly the sum of the
//   rounded p that weight v, and no thread unpacks them.
// - The schedule. In a warpgroup, tile i's S product is issued, acc is
//   rescaled by tile i - 1's alpha while it runs, tile i - 1's P·V follows,
//   and tile i's softmax (one FFMA and one ex2 a score) runs while that
//   product does. The two warpgroups take turns to issue their products
//   (named barriers 3 and 4, FA3's ping-pong), so one's softmax runs under
//   the other's products; both walk every tile of the item, so their turns
//   pair up. No wgmma wait depends on a runtime condition and the
//   warpgroup index is broadcast from lane 0: ptxas then proves every
//   branch uniform and keeps the products in flight (a divergent path, or
//   a conditional wait, made it serialise them: C7514 and C7520 in the build
//   log).
// - The output: acc / l in bf16 is staged in the warpgroup's q panels and
//   written as 16-byte pieces of whole rows (4-byte stores from the
//   accumulator layout half-filled their sectors); with a kv split each
//   thread writes its fp32 partial rows as float2 (whole sectors).
// - kKeys 128 at hd 64 and 128, 64 at hd 256 (its 128 fp32 accumulator
//   registers leave less room for S).
// Shared memory: q 2 × 64·hd·2, k and v kStages × 2 × kKeys·hd·2, 1 KB of
// ones, 1 KB of alignment: 116,784 bytes at hd 64, 231,472 at 128, 198,688
// at 256.
// What bounds it now: the exp2 of every score on the SFU (16 a clock an
// SM) and the block's fixed costs beside the products; ablations on the
// card (tools/flash_phase.py's shapes) found the products alone and the
// softmax alone each about half of whisper's encoder layer, overlapped in
// part.
//
// flash_mma_kernel (bf16, hd 16/32/80/96): FlashAttention-2 style on
// mma.sync.aligned.m16n8k16. A block of 4 warps owns 64 rows, 16 per
// warp; q and double-buffered k/v tiles (64 keys) are copied with 16-byte
// cp.async (rows padded to hd + 8 elements: ldmatrix reads them without
// bank conflicts); q fragments stay in registers; k fragments come from
// ldmatrix.x4, v from ldmatrix.x4.trans; p is rounded to bf16 and fed as
// the second product's A fragment. mma.sync issues at about half of
// Hopper's tensor-core rate.
//
// bf16 rounding (both bf16 kernels): l is the sum of the ROUNDED p, the
// same values that weight v, so the output is an exact convex combination
// of v rows up to fp32 sums. Against exact fp32 p each weight is off by at
// most 2^-9 of itself, which moves the output by at most 2^-9 · max|v|
// before its own bf16 rounding: inside the 2e-2 bf16 bound. The plain
// version rounds p in the same place, relative to the row's final max
// where the kernels round relative to each tile's running max.
//
// flash_tf32_kernel (fp32, every hd): 3xTF32 on mma.sync.m16n8k8.tf32.
// Each fp32 operand x is split into tf32 parts hi = rn(x), lo = rn(x - hi)
// and each product sums lo·hi + hi·lo + hi·hi with fp32 accumulation
// (lo·lo, about 2^-22 of the product, is dropped): about fp32's precision,
// inside the 2e-5 bound, where plain TF32 (2^-11) is not. mma.sync and
// not wgmma: wgmma's tf32 form takes both operands K-major from shared
// memory, so v would need a transposed copy and each operand's hi and lo
// parts their own shared tiles; mma.sync takes fragments from registers,
// where the split is made as they are loaded. Layout as flash_mma_kernel
// (4 warps × 16 rows, double-buffered cp.async k/v tiles of 64 keys, 32 at
// hd >= 96), fp32 in shared memory: q and k rows padded to hd + 8 floats, v
// rows to hd + 4, so the float2 fragment loads of q and k and the scalar
// loads of v hit distinct banks. A fragment's k index is permuted (k slot
// t holds element 2t, slot t + 4 element 2t + 1, the same for both
// operands): a thread's two S values of a row are then its A fragment for
// P·V with no shuffle, and q and k fragments are float2 loads. p stays
// fp32. Shared memory (64·(hd + 8) + 2·kKeys·(2·hd + 12))·4 bytes: 103,424
// at hd 128 (two blocks an SM), 201,728 at hd 256.
// What bounds it: three tf32 products per product at mma.sync's rate, and
// the splits (two cvt and a subtraction per element of each fragment).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kMmaRows = 64;      // rows per block of the mma.sync kernels
constexpr int kMmaThreads = 128;  // their 4 warps × 16 rows
constexpr int kSplitAlign = 128;  // a chunk is a multiple of every kernel's kv tile
constexpr int kMaxSplit = 32;     // the combine kernel weighs one chunk per lane
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;      // (B, Lq, Hq, hd) in q's dtype (n_split == 1)
  float* part;  // (n_split, B, Hkv, Lq·G, hd): each chunk's unnormalised acc
  float2* ml;   // (n_split, B, Hkv, Lq·G): its running max (log2 units), row sum
  int nb, lq, lkv, hq, hkv;
  int n_row_tiles, n_split, chunk;
  int causal, window;
  float scale_log2;
};

// the block's place in the grid and the keys it reads
struct Geometry {
  int c, hk, b;      // kv chunk, kv head, batch
  int g, rows, f0;   // group size, folded rows of kv head hk, the block's first row
  int k_lo, k_hi;    // keys some row of the block can see in its chunk (inclusive)
};

template <int ROWS>
__device__ __forceinline__ Geometry geometry(const Params& p, int idx) {
  Geometry s;
  const int per_tile = p.n_split * p.hkv * p.nb;
  const int rt = p.n_row_tiles - 1 - idx / per_tile;  // the last row tiles first
  const int rest = idx % per_tile;
  s.c = rest / (p.hkv * p.nb);
  s.hk = rest % p.hkv;
  s.b = rest / p.hkv % p.nb;
  s.g = p.hq / p.hkv;
  s.rows = p.lq * s.g;
  s.f0 = rt * ROWS;
  const int p_first = s.f0 / s.g, p_last = (min(s.f0 + ROWS, s.rows) - 1) / s.g;
  s.k_lo = s.c * p.chunk;
  s.k_hi = s.c == p.n_split - 1 ? p.lkv - 1 : s.k_lo + p.chunk - 1;
  if (p.causal) s.k_hi = min(s.k_hi, p_last);
  if (p.window > 0) s.k_lo = max(s.k_lo, p_first - p.window + 1);
  return s;
}

// a tile of keys [k0, k0 + keys) holds no dead pair for positions
// [p_first, p_last]
__device__ __forceinline__ bool tile_full(const Params& p, int k0, int keys, int p_first,
                                          int p_last) {
  return k0 + keys <= p.lkv && (!p.causal || k0 + keys - 1 <= p_first) &&
         (p.window <= 0 || p_last - k0 < p.window);
}

// element offset / HD of folded row f (position f / G, query head hk·G +
// f % G) in q or o
__device__ __forceinline__ int64_t q_row(const Params& p, const Geometry& s, int f) {
  return (static_cast<int64_t>(s.b) * p.lq + f / s.g) * p.hq + s.hk * s.g + f % s.g;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}


// The rows f and f + 8 of a thread (accumulator layout: acc[4j + e] is row
// f + 8·(e / 2), column 8j + 2·tig + e % 2), l reduced over the row's four
// threads: out = acc / max(l, 1e-30), or with a kv split the chunk's
// partial (acc, and (m, l) from tig 0). Rows past Lq·G are not stored.
template <int HD, typename T>
__device__ __forceinline__ void finish_rows(const Params& p, const Geometry& s, int f,
                                            const float (&acc)[HD / 2], const float (&m)[2],
                                            const float (&l)[2], int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int fi = f + 8 * i;
    if (fi >= s.rows) continue;
    if (p.n_split == 1) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* orow = static_cast<T*>(p.o) + q_row(p, s, fi) * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store_pair<T>(orow + 8 * j, acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    } else {
      const int64_t row =
          ((static_cast<int64_t>(s.c) * p.nb + s.b) * p.hkv + s.hk) * s.rows + fi;
      float* prow = p.part + row * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store_pair<float>(prow + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      if (tig == 0) p.ml[row] = make_float2(m[i], l[i]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the max of row i's values of s (accumulator layout) in this thread, as
// a tree
template <int NK>
__device__ __forceinline__ float row_max(const float (&s)[NK * 4], int i) {
  float v[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) v[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
  for (int w = 1; w < NK; w *= 2)
#pragma unroll
    for (int j = 0; j + w < NK; j += 2 * w) v[j] = fmaxf(v[j], v[j + w]);
  return v[0];
}

// mask (only where the tile holds a dead pair) and the online softmax step
// over one tile's raw scores s (accumulator layout, NK n-tiles of 8 keys
// from k0) for rows at positions pos0 / pos1: s becomes p = 2^(s·c -
// base) in fp32 (c = log2(e)/sqrt(hd), one FFMA and one ex2 a score), m
// the new running max (log2 units); alpha is each row's rescale
template <int NK>
__device__ __forceinline__ void softmax_step(const Params& p, float (&s)[NK * 4], bool full,
                                             int k0, int pos0, int pos1, int tig, float (&m)[2],
                                             float (&alpha)[2]) {
  if (!full) {  // row r's live keys: [lo[r], hi[r]]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = r ? pos1 : pos0;
      hi[r] = p.causal ? min(pos, p.lkv - 1) : p.lkv - 1;
      lo[r] = p.window > 0 ? pos - p.window + 1 : INT32_MIN;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * tig + (e & 1);
        if (kj > hi[e >> 1] || kj < lo[e >> 1]) s[4 * j + e] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = row_max<NK>(s, i);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[i], mx * p.scale_log2);
    const float base = mx == -INFINITY ? 0.f : mx;  // no live key yet: p and alpha are 0
    alpha[i] = ex2(m[i] - base);
    m[i] = mx;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[4 * j + 2 * i] = ex2(fmaf(s[4 * j + 2 * i], p.scale_log2, -base));
      s[4 * j + 2 * i + 1] = ex2(fmaf(s[4 * j + 2 * i + 1], p.scale_log2, -base));
    }
  }
}

// (lo, hi) rounded to a bf16 pair (lo in the low half, as an mma fragment
// holds its lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the same, adding the rounded values to sum
__device__ __forceinline__ uint32_t pack_round(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the row sums' four threads
__device__ __forceinline__ void reduce_rows(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64 / 128 / 256: wgmma with TMA-fed k/v tiles
// ---------------------------------------------------------------------------

template <int HD>
struct WgTile {
  static constexpr int kConsumers = 2;                    // warpgroups of 64 rows
  static constexpr int kRows = 64 * kConsumers;           // rows per block
  static constexpr int kKeys = HD == 256 ? 64 : 128;      // keys per kv tile
  static constexpr int kStages = HD == 256 ? 2 : 3;       // the k/v ring
  static constexpr int kPanels = HD / 64;                 // 64-element panels of a row
  static constexpr int kQBytes = 64 * HD * 2;             // one warpgroup's q tile
  static constexpr int kKVBytes = kKeys * HD * 2;         // one k (or v) tile
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
  // one block an SM walking the work items; at hd 256 the item loop's
  // state does not fit beside the 128 accumulator registers: a block an item
  static constexpr bool kPersistent = HD != 256;
  static constexpr size_t kSmem = 1024 + kConsumers * kQBytes + 2 * kStages * kKVBytes +
                                  1024 + 16 * kStages;  // slack, tiles, ones, mbarriers
};

// 16-byte chunk ch of row r (< 64) of a 64-row tile of 128-byte-swizzled
// panels at base
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int r, int ch) {
  return base + (ch / 8) * (64 * 128) + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ int4 ld_shared_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, int4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "S tiles of 64 or 128 keys");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "head dims 64, 128, 256");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// the k-th work item of a block: in a persistent grid of `blocks`, items
// k·blocks + b for even k, (k + 1)·blocks - 1 - b for odd k (a snake, so
// the first items, the largest under a causal mask, pair with the last);
// else item b, then none
template <bool kPersistent>
__device__ __forceinline__ int block_item(int k, int blocks, int n_items) {
  const int b = static_cast<int>(blockIdx.x);
  if constexpr (!kPersistent) return k == 0 ? b : n_items;
  return (k & 1) ? (k + 1) * blocks - 1 - b : k * blocks + b;
}

template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ q, const Params p, int n_items) {
  using T = WgTile<HD>;
  constexpr int BK = T::kKeys, ST = T::kStages, CH = HD / 8;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t sq = (raw + 1023) & ~1023u;  // swizzled panels need 1,024-byte atoms
  const uint32_t sk = sq + T::kConsumers * T::kQBytes;
  const uint32_t sv = sk + ST * T::kKVBytes;
  const uint32_t ones = sv + ST * T::kKVBytes;  // 1 KB of bf16 1.0: the row sums' B
  const uint32_t full_bar = ones + 1024;           // ST full, then ST empty mbarriers
  const uint32_t empty_bar = full_bar + 8 * ST;
  const int blocks = static_cast<int>(gridDim.x);

  const int tid = threadIdx.x;
  if (tid < 64) {
    st_shared_v4(ones + 16 * tid, make_int4(0x3F803F80, 0x3F803F80, 0x3F803F80, 0x3F803F80));
    fence_proxy_async();
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_bar + 8 * i, 1);
      mbar_init(empty_bar + 8 * i, T::kConsumers);  // one arrival a warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index broadcast from lane 0: ptxas then knows every
  // branch on it is uniform, and issues the wgmma products without
  // serialising them
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == T::kConsumers) {  // the producer warpgroup: its thread 0 keeps the ring full
    setmaxnreg_dec<24>();
    if (tid % 128 == 0) {
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      int it = 0;  // tiles through the ring so far, over the block's items
      for (int k = 0;; ++k) {
        const int item = block_item<T::kPersistent>(k, blocks, n_items);
        if (item >= n_items) break;
        const Geometry s = geometry<T::kRows>(p, item);
        const int t_lo = s.k_lo / BK;
        const int n = s.k_lo <= s.k_hi ? s.k_hi / BK - t_lo + 1 : 0;
        for (int i = 0; i < n; ++i, ++it) {
          const int st = it % ST;
          mbar_wait(empty_bar + 8 * st, ((it / ST) & 1) ^ 1);  // a fresh stage passes
          mbar_expect_tx(full_bar + 8 * st, 2 * T::kKVBytes);
          const int k0 = (t_lo + i) * BK;
#pragma unroll
          for (int pn = 0; pn < T::kPanels; ++pn) {
            const uint32_t off = st * T::kKVBytes + pn * BK * 128;
            tma_load_4d(sk + off, &tm_k, full_bar + 8 * st, pn * 64, s.hk, k0, s.b);
            tma_load_4d(sv + off, &tm_v, full_bar + 8 * st, pn * 64, s.hk, k0, s.b);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int tw = tid % 128, warp = tw / 32, lane = tid % 32;
  const int gr = lane >> 2, tig = lane & 3;
  const uint32_t sqw = sq + wg * T::kQBytes;  // this warpgroup's q (and out) panels
  const uint64_t ones_desc = smem_desc(ones, 16, 1024);

  // Both warpgroups walk every tile of each item (a tile none of a
  // warpgroup's rows sees is masked whole), taking turns to issue their
  // products (bar.sync on their own barrier, bar.arrive on the other's):
  // one warpgroup's softmax runs while the other's products do. In a
  // warpgroup, tile i's S product is issued, acc is rescaled by tile i -
  // 1's alpha while it runs, tile i - 1's P·V product follows, and tile
  // i's softmax runs while that product does. No wait depends on a
  // runtime condition, so ptxas keeps the products in flight.
  static_assert(T::kConsumers == 2, "the turns alternate between two warpgroups");
  constexpr int kSched = 3;  // named barriers 3 (warpgroup 0's turn) and 4
  auto my_turn = [&]() { named_barrier(kSched + wg, 256); };
  auto next_turn = [&]() { named_barrier_arrive(kSched + 1 - wg, 256); };
  // ring slot j: stage j % ST, completed phase parity (j / ST) & 1; a
  // warpgroup releases a stage once its products have read it (a wgmma
  // completes for the whole warpgroup: one thread arrives)
  auto wait_full = [&](int j) { mbar_wait(full_bar + 8 * (j % ST), (j / ST) & 1); };
  auto release = [&](int j) {
    if (tw == 0) mbar_arrive(empty_bar + 8 * (j % ST));
  };
  if (wg > 0) next_turn();  // warpgroup 0 goes first

  int it = 0;
  for (int k = 0;; ++k) {
    const int item = block_item<T::kPersistent>(k, blocks, n_items);
    if (item >= n_items) break;
    const Geometry s = geometry<T::kRows>(p, item);
    const int t_lo = s.k_lo / BK;
    const int n_tiles = s.k_lo <= s.k_hi ? s.k_hi / BK - t_lo + 1 : 0;
    const int wf0 = s.f0 + 64 * wg;  // this warpgroup's first row
    {
      // rows wf0 .. wf0 + 63 into 128-byte-swizzled panels, zero past Lq·G:
      // every load issued before the first store
      constexpr int NQ = 64 * CH / 128;
      int4 val[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int c = tw + i * 128;
        const int f = wf0 + c / CH;
        val[i] = f < s.rows ? __ldg(reinterpret_cast<const int4*>(
                                  q + q_row(p, s, f) * HD + (c % CH) * 8))
                            : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int c = tw + i * 128;
        st_shared_v4(swizzled(sqw, c / CH, c % CH), val[i]);
      }
      fence_proxy_async();
    }
    named_barrier(1 + wg, 128);

    const int fr = wf0 + warp * 16 + gr;  // this thread's rows fr and fr + 8
    const int pos0 = fr / s.g, pos1 = (fr + 8) / s.g;
    const int wp_first = wf0 / s.g, wp_last = (min(wf0 + 64, s.rows) - 1) / s.g;
    float acc[HD / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
    uint32_t pa[BK / 16][4];  // p of the last tile softmaxed, bf16: the A fragments
    // the row sums as a product: lacc (+)= p · ones (16 × 8), every column
    // Σ of the rounded p of a row (lacc[0] row fr, lacc[2] row fr + 8)
    float lacc[4] = {0.f, 0.f, 0.f, 0.f};
    float alpha[2] = {1.f, 1.f};

    auto issue_s = [&](int j) {  // S = q·kᵀ: hd / 16 steps, 4 to a 64-element panel
      const uint32_t kt = sk + (j % ST) * T::kKVBytes;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;
        wgmma_ss<BK>(sc, smem_desc(sqw + (kk / 4) * (64 * 128) + koff, 16, 1024),
                     smem_desc(kt + (kk / 4) * (BK * 128) + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // O += P·V, v key-major (the transpose bit)
      const uint32_t vt = sv + (j % ST) * T::kKVBytes;
      fence_regs(acc);
      fence_regs(lacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<HD>(acc, pa[kk], smem_desc(vt + kk * 16 * 128, BK * 128, 1024));
        wgmma_rs_n8(lacc, pa[kk], ones_desc);
      }
      wgmma_commit();
    };
    auto softmax = [&](int i) {  // tile i's S to fp32 p in sc; m and alpha
      const int k0 = (t_lo + i) * BK;
      softmax_step<BK / 8>(p, sc, tile_full(p, k0, BK, wp_first, wp_last), k0, pos0, pos1,
                           tig, m, alpha);
    };
    auto pack = [&]() {  // p to bf16 in pa (S n-tiles 2kk, 2kk + 1: step kk)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto rescale = [&]() {
      lacc[0] *= alpha[0];
      lacc[1] *= alpha[0];
      lacc[2] *= alpha[1];
      lacc[3] *= alpha[1];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    };

    if (n_tiles > 0) {
      wait_full(it);
      my_turn();
      issue_s(it);
      next_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0);
      pack();
      for (int i = 1; i < n_tiles; ++i) {
        wait_full(it + i);
        my_turn();
        issue_s(it + i);
        rescale();
        issue_pv(it + i - 1);
        next_turn();
        wgmma_wait<1>();  // S has landed; P·V may still run
        fence_regs(sc);
        softmax(i);
        wgmma_wait<0>();  // P·V has read pa: the new p may go there
        fence_regs(acc);
        release(it + i - 1);
        pack();
      }
      rescale();
      issue_pv(it + n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(it + n_tiles - 1);
    }
    it += n_tiles;

    fence_regs(lacc);
    const float l[2] = {lacc[0], lacc[2]};  // whole rows: no reduction over the quad
    if (p.n_split > 1) {  // fp32 partials: each float2 store fills a 32-byte sector
      finish_rows<HD, __nv_bfloat16>(p, s, fr, acc, m, l, tig);
      continue;
    }
    // out = acc / l in bf16 into this warpgroup's q panels (its products
    // are done), then 16-byte rows to global memory
    const int r0 = warp * 16 + gr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
        st_shared_b32(swizzled(sqw, r0 + 8 * i, j) + 4 * tig,
                      *reinterpret_cast<const uint32_t*>(&v));
      }
    }
    named_barrier(1 + wg, 128);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int i = 0; i < 64 * CH / 128; ++i) {
      const int c = tw + i * 128;
      const int f = wf0 + c / CH;
      if (f < s.rows)
        *reinterpret_cast<int4*>(o + q_row(p, s, f) * HD + (c % CH) * 8) =
            ld_shared_v4(swizzled(sqw, c / CH, c % CH));
    }
    named_barrier(1 + wg, 128);  // the panels are read before the next q lands
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const Params& p,
                 cudaStream_t stream) {
  using T = WgTile<HD>;
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap tm_k, tm_v;
  int err = blhw_tensor_map(&tm_k, k, p.nb, p.lkv, p.hkv, HD, T::kKeys);
  if (err != cudaSuccess) return err;
  err = blhw_tensor_map(&tm_v, v, p.nb, p.lkv, p.hkv, HD, T::kKeys);
  if (err != cudaSuccess) return err;
  // a persistent grid: one block an SM walks the work items
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int64_t items = static_cast<int64_t>(p.n_row_tiles) * p.n_split * p.hkv * p.nb;
  const int blocks = static_cast<int>(T::kPersistent && sms < items ? sms : items);
  flash_wgmma_kernel<HD><<<blocks, T::kThreads, T::kSmem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), p, static_cast<int>(items));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, hd 16 / 32 / 80 / 96: mma.sync
// ---------------------------------------------------------------------------

template <int HD>
struct MmaTile {
  static constexpr int kKeys = 64;                   // keys per kv tile
  static constexpr int kStride = HD + 8;             // shared row stride, elements
  static constexpr int kChunks = HD / 8;             // 16-byte chunks per row
  static constexpr size_t kSmem =
      static_cast<size_t>(kMmaRows + 4 * kKeys) * kStride * sizeof(__nv_bfloat16);
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const Params p) {
  using T = MmaTile<HD>;
  constexpr int BK = T::kKeys, STR = T::kStride, CH = T::kChunks;
  constexpr int KS = HD / 16;  // k-steps of q·kᵀ over hd
  constexpr int NT = HD / 8;   // n-tiles of the output
  constexpr int NK = BK / 8;   // n-tiles of S
  static_assert(NT % 2 == 0 && NK % 2 == 0, "ldmatrix.x4 feeds two n-tiles");
  static_assert((kMmaRows * CH) % kMmaThreads == 0 && (BK * CH) % kMmaThreads == 0,
                "every thread issues the same number of copies");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(flash_smem);  // (64, STR)
  __nv_bfloat16* sk = sq + kMmaRows * STR;                            // 2 × (BK, STR)
  __nv_bfloat16* sv = sk + 2 * BK * STR;                              // 2 × (BK, STR)

  const Geometry s = geometry<kMmaRows>(p, static_cast<int>(blockIdx.x));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p_first = s.f0 / s.g, p_last = (min(s.f0 + kMmaRows, s.rows) - 1) / s.g;
  // q row f: position f / g, head hk·g + f % g
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(s.b) * p.lq * p.hq + s.hk * s.g) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.hkv) * HD;  // between positions
  const int64_t kv_off = (static_cast<int64_t>(s.b) * p.lkv * p.hkv + s.hk) * HD;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

#pragma unroll
  for (int i = 0; i < kMmaRows * CH / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / CH, ch = c % CH;
    const int f = s.f0 + r;
    const bool in = f < s.rows;
    const int64_t row = in ? static_cast<int64_t>(f / s.g) * p.hq + f % s.g : 0;
    cp_async16(smem_u32(sq + r * STR + ch * 8), qb + row * HD + ch * 8, in);
  }
  auto load_kv = [&](int t, int buf) {
#pragma unroll
    for (int i = 0; i < BK * CH / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c / CH, ch = c % CH;
      const int kj = t * BK + r;
      const bool in = kj < p.lkv;
      const int64_t off = (in ? kj : 0) * kv_stride + ch * 8;
      const int o = (buf * BK + r) * STR + ch * 8;
      cp_async16(smem_u32(sk + o), kb + off, in);
      cp_async16(smem_u32(sv + o), vb + off, in);
    }
  };

  const int t_lo = s.k_lo / BK, t_hi = s.k_lo <= s.k_hi ? s.k_hi / BK : t_lo - 1;
  if (t_lo <= t_hi) load_kv(t_lo, 0);
  cp_async_commit();  // q and the first tile

  const int gr = lane >> 2, tig = lane & 3;  // fragment row and column pair
  const int fr = s.f0 + warp * 16 + gr;      // this thread's rows fr and fr + 8
  const int pos0 = fr / s.g, pos1 = (fr + 8) / s.g;
  // per-lane ldmatrix offsets (elements): q/A rows lane & 15, column half
  // lane >> 4; k rows (lane & 7) + 8·(lane >> 4), column half (lane >> 3) & 1;
  // v (transposed) rows (lane & 7) + 8·((lane >> 3) & 1), column half lane >> 4
  const uint32_t q_addr =
      smem_u32(sq + (warp * 16 + (lane & 15)) * STR + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * STR + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * STR + (lane >> 4) * 8;

  float acc[NT * 4];
#pragma unroll
  for (int d = 0; d < NT * 4; ++d) acc[d] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  uint32_t qf[KS][4];

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile t + 1 has landed
    __syncthreads();
    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);
    }
    const uint32_t k_addr = smem_u32(sk + buf * BK * STR + k_lane);
    const uint32_t v_addr = smem_u32(sv + buf * BK * STR + v_lane);

    // S = q·kᵀ
    float sc[NK * 4];
#pragma unroll
    for (int j = 0; j < NK * 4; ++j) sc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bk[4];
        ldsm_x4(k_addr + (j * 8 * STR + kk * 16) * 2, bk);
        mma_bf16(*reinterpret_cast<float(*)[4]>(sc + 4 * j), qf[kk], bk[0], bk[1]);
        mma_bf16(*reinterpret_cast<float(*)[4]>(sc + 4 * j + 4), qf[kk], bk[2], bk[3]);
      }
    }

    const int k0 = t * BK;
    float alpha[2];
    softmax_step<NK>(p, sc, tile_full(p, k0, BK, p_first, p_last), k0, pos0, pos1, tig, m,
                     alpha);
    uint32_t pf[NK][2];  // bf16 pairs: row fr, row fr + 8
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      pf[j][0] = pack_round(sc[4 * j + 0], sc[4 * j + 1], sum[0]);
      pf[j][1] = pack_round(sc[4 * j + 2], sc[4 * j + 3], sum[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      acc[4 * d + 0] *= alpha[0];
      acc[4 * d + 1] *= alpha[0];
      acc[4 * d + 2] *= alpha[1];
      acc[4 * d + 3] *= alpha[1];
    }

    // O += P·V: S n-tiles 2kk and 2kk + 1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
      for (int d = 0; d < NT; d += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(v_addr + (kk * 16 * STR + d * 8) * 2, bv);
        mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4 * d), a, bv[0], bv[1]);
        mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 4 * d + 4), a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before tile t + 2 lands in it
  }
  cp_async_wait<0>();  // a block with no live tile still has q in flight
  reduce_rows(l);
  finish_rows<HD, __nv_bfloat16>(p, s, fr, acc, m, l, tig);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

template <int HD>
struct Tf32Tile {
  static constexpr int kKeys = HD >= 96 ? 32 : 64;  // keys per kv tile
  static constexpr int kQStride = HD + 8;           // q and k rows, floats
  static constexpr int kVStride = HD + 4;           // v rows, floats
  static constexpr size_t kSmem =
      (static_cast<size_t>(kMmaRows) * kQStride + 2 * kKeys * (kQStride + kVStride)) *
      sizeof(float);
};

// hi/lo tf32 parts of the four values of an A fragment
__device__ __forceinline__ void split_frag(float a0, float a1, float a2, float a3,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// d += a·b in 3xTF32: the small products first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bhi0, blo0, bhi1, blo1;
  split_tf32(b0, bhi0, blo0);
  split_tf32(b1, bhi1, blo1);
  float(&acc)[4] = *reinterpret_cast<float(*)[4]>(d);
  mma_tf32(acc, alo, bhi0, bhi1);
  mma_tf32(acc, ahi, blo0, blo1);
  mma_tf32(acc, ahi, bhi0, bhi1);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const Params p) {
  using T = Tf32Tile<HD>;
  constexpr int BK = T::kKeys, SQ = T::kQStride, SV = T::kVStride, CH = HD / 4;
  constexpr int NT = HD / 8;  // n-tiles of the output, and k-steps of q·kᵀ
  constexpr int NK = BK / 8;  // n-tiles of S, and k-steps of P·V
  static_assert((kMmaRows * CH) % kMmaThreads == 0 && (BK * CH) % kMmaThreads == 0,
                "every thread issues the same number of copies");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  float* sq = reinterpret_cast<float*>(flash_smem);  // (64, SQ)
  float* sk = sq + kMmaRows * SQ;                    // 2 × (BK, SQ)
  float* sv = sk + 2 * BK * SQ;                      // 2 × (BK, SV)

  const Geometry s = geometry<kMmaRows>(p, static_cast<int>(blockIdx.x));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p_first = s.f0 / s.g, p_last = (min(s.f0 + kMmaRows, s.rows) - 1) / s.g;
  const float* qb = q + (static_cast<int64_t>(s.b) * p.lq * p.hq + s.hk * s.g) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.hkv) * HD;
  const int64_t kv_off = (static_cast<int64_t>(s.b) * p.lkv * p.hkv + s.hk) * HD;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

#pragma unroll
  for (int i = 0; i < kMmaRows * CH / kMmaThreads; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = c / CH, ch = c % CH;
    const int f = s.f0 + r;
    const bool in = f < s.rows;
    const int64_t row = in ? static_cast<int64_t>(f / s.g) * p.hq + f % s.g : 0;
    cp_async16(smem_u32(sq + r * SQ + ch * 4), qb + row * HD + ch * 4, in);
  }
  auto load_kv = [&](int t, int buf) {
#pragma unroll
    for (int i = 0; i < BK * CH / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c / CH, ch = c % CH;
      const int kj = t * BK + r;
      const bool in = kj < p.lkv;
      const int64_t off = (in ? kj : 0) * kv_stride + ch * 4;
      cp_async16(smem_u32(sk + (buf * BK + r) * SQ + ch * 4), kb + off, in);
      cp_async16(smem_u32(sv + (buf * BK + r) * SV + ch * 4), vb + off, in);
    }
  };

  const int t_lo = s.k_lo / BK, t_hi = s.k_lo <= s.k_hi ? s.k_hi / BK : t_lo - 1;
  if (t_lo <= t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  const int gr = lane >> 2, tig = lane & 3;
  const int fr = s.f0 + warp * 16 + gr;
  const int pos0 = fr / s.g, pos1 = (fr + 8) / s.g;
  const float* qrow0 = sq + (warp * 16 + gr) * SQ + 2 * tig;  // A rows gr, gr + 8
  const float* qrow1 = qrow0 + 8 * SQ;

  float acc[NT * 4];
#pragma unroll
  for (int d = 0; d < NT * 4; ++d) acc[d] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = sk + buf * BK * SQ;
    const float* vt = sv + buf * BK * SV;

    // S = q·kᵀ; k slot tig holds element 2·tig of the step, slot tig + 4
    // element 2·tig + 1: one float2 load each for a0/a2, a1/a3, b0/b1
    float sc[NK * 4];
#pragma unroll
    for (int j = 0; j < NK * 4; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qrow0 + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qrow1 + 8 * kk);
      uint32_t ahi[4], alo[4];
      split_frag(x0.x, x1.x, x0.y, x1.y, ahi, alo);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(kt + (8 * j + gr) * SQ + 8 * kk + 2 * tig);
        mma_3xtf32(sc + 4 * j, ahi, alo, y.x, y.y);
      }
    }

    const int k0 = t * BK;
    float alpha[2];
    softmax_step<NK>(p, sc, tile_full(p, k0, BK, p_first, p_last), k0, pos0, pos1, tig, m,
                     alpha);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) sum += sc[4 * j + 2 * i] + sc[4 * j + 2 * i + 1];
      l[i] = l[i] * alpha[i] + sum;
    }
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      acc[4 * d + 0] *= alpha[0];
      acc[4 * d + 1] *= alpha[0];
      acc[4 * d + 2] *= alpha[1];
      acc[4 * d + 3] *= alpha[1];
    }

    // O += P·V: S n-tile j is the A fragment of k-step j (keys 2·tig and
    // 2·tig + 1 in slots tig and tig + 4); v rows 2·tig and 2·tig + 1
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ahi[4], alo[4];
      split_frag(sc[4 * j + 0], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3], ahi, alo);
      const float* v0 = vt + (8 * j + 2 * tig) * SV + gr;
#pragma unroll
      for (int d = 0; d < NT; ++d) mma_3xtf32(acc + 4 * d, ahi, alo, v0[8 * d], v0[SV + 8 * d]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  reduce_rows(l);
  finish_rows<HD, float>(p, s, fr, acc, m, l, tig);
}

// ---------------------------------------------------------------------------
// the kv split's merge
// ---------------------------------------------------------------------------

// One warp per folded row (b, hk, f); lane c weighs chunk c (n_split <= 32).
template <typename T>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part, const float2* __restrict__ ml,
                     T* __restrict__ o, int nb, int lq, int hq, int hkv, int hd, int n_split) {
  const int g = hq / hkv;
  const int64_t rows = static_cast<int64_t>(lq) * g;
  const int64_t total = rows * hkv * nb;  // rows of one chunk
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= total) return;
  const float2 mine = lane < n_split ? ml[lane * total + row] : make_float2(-INFINITY, 0.f);
  float mx = mine.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float w = mine.x == -INFINITY ? 0.f : exp2f(mine.x - mx);  // a dead chunk weighs 0
  float den = w * mine.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  den = fmaxf(den, 1e-30f);
  const int64_t f = row % rows, bh = row / rows;  // bh = b·hkv + hk
  const int64_t pos = f / g, b = bh / hkv, hk = bh % hkv;
  T* orow = o + ((b * lq + pos) * hq + hk * g + f % g) * hd;
  float4 sum[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int c = 0; c < n_split; ++c) {  // lane k·32 + lane: columns 4·(32k + lane) .. + 3
    const float wc = __shfl_sync(0xffffffffu, w, c);
    const float* prow = part + (c * total + row) * hd;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int d = 4 * (32 * k + lane);
      if (d < hd) {
        const float4 x = *reinterpret_cast<const float4*>(prow + d);
        sum[k].x += wc * x.x;
        sum[k].y += wc * x.y;
        sum[k].z += wc * x.z;
        sum[k].w += wc * x.w;
      }
    }
  }
  const float inv = 1.f / den;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = 4 * (32 * k + lane);
    if (d < hd) {
      store_pair(orow + d, sum[k].x * inv, sum[k].y * inv);
      store_pair(orow + d + 2, sum[k].z * inv, sum[k].w * inv);
    }
  }
}

int launch_combine(const Params& p, int hd, bool bf16, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.lq) * (p.hq / p.hkv) * p.hkv * p.nb;
  const int64_t blocks = (rows + 7) / 8;  // 8 warps a block
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (bf16)
    flash_combine_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        p.part, p.ml, static_cast<__nv_bfloat16*>(p.o), p.nb, p.lq, p.hq, p.hkv, hd,
        p.n_split);
  else
    flash_combine_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        p.part, p.ml, static_cast<float*>(p.o), p.nb, p.lq, p.hq, p.hkv, hd, p.n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <typename Kernel>
int configure(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const Params& p,
               cudaStream_t stream) {
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  const int err = configure(flash_mma_kernel<HD>, MmaTile<HD>::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(p.n_row_tiles) * p.n_split * p.hkv * p.nb;
  flash_mma_kernel<HD><<<static_cast<unsigned>(blocks), kMmaThreads, MmaTile<HD>::kSmem,
                         stream>>>(static_cast<const __nv_bfloat16*>(q),
                                   static_cast<const __nv_bfloat16*>(k),
                                   static_cast<const __nv_bfloat16*>(v), p);
  return cudaGetLastError();
}

template <int HD>
int launch_tf32(const void* q, const void* k, const void* v, const Params& p,
                cudaStream_t stream) {
  static bool configured = false;
  const int err = configure(flash_tf32_kernel<HD>, Tf32Tile<HD>::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(p.n_row_tiles) * p.n_split * p.hkv * p.nb;
  flash_tf32_kernel<HD><<<static_cast<unsigned>(blocks), kMmaThreads, Tf32Tile<HD>::kSmem,
                          stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v), p);
  return cudaGetLastError();
}

int rows_per_block(int r) { return r == 2 ? 128 : kMmaRows; }

int dispatch(int r, int hd, const void* q, const void* k, const void* v, const Params& p,
             cudaStream_t stream) {
#define FLASH_CASE(HD, FN) \
  case HD: return FN<HD>(q, k, v, p, stream);
  if (r == 2) {
    switch (hd) { FLASH_CASE(64, launch_wgmma) FLASH_CASE(128, launch_wgmma)
                  FLASH_CASE(256, launch_wgmma) }
  } else if (r == 1) {
    switch (hd) { FLASH_CASE(16, launch_mma) FLASH_CASE(32, launch_mma)
                  FLASH_CASE(80, launch_mma) FLASH_CASE(96, launch_mma) }
  } else {
    switch (hd) { FLASH_CASE(16, launch_tf32) FLASH_CASE(32, launch_tf32)
                  FLASH_CASE(64, launch_tf32) FLASH_CASE(80, launch_tf32)
                  FLASH_CASE(96, launch_tf32) FLASH_CASE(128, launch_tf32)
                  FLASH_CASE(256, launch_tf32) }
  }
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Lq, Hq, hd), k/v (B, Lkv, Hkv, hd), o (B, Lq, Hq, hd), all contiguous
// with 16-byte aligned bases, one dtype: fp32 on route 0 (3xTF32), bf16 on
// route 1 (mma.sync) and 2 (wgmma); a route not built for hd is refused.
// window <= 0: no window. n_split == 1: no kv split (chunk, part and ml
// unused); else the keys split in chunks of `chunk` (a multiple of 128,
// the last chunk up to Lkv), part (n_split, B, Hkv, Lq·Hq/Hkv, hd) and ml
// (n_split, B, Hkv, Lq·Hq/Hkv, 2) fp32 scratch, and a second launch merges
// them into o. Returns cudaGetLastError() after the launches.
int flash_attention(const void* q, const void* k, const void* v, void* o, void* part, void* ml,
                    int b, int lq, int lkv, int hq, int hkv, int hd, int causal, int window,
                    int route, int n_split, int chunk, void* stream) {
  if (b <= 0 || lq <= 0 || lkv <= 0 || hkv <= 0 || hq % hkv != 0 || n_split < 1 ||
      n_split > kMaxSplit)
    return cudaErrorInvalidValue;
  if (n_split > 1 && (part == nullptr || ml == nullptr || chunk <= 0 ||
                      chunk % kSplitAlign != 0 ||
                      static_cast<int64_t>(n_split - 1) * chunk >= lkv))
    return cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(ml);
  if (bases % 16 != 0) return cudaErrorMisalignedAddress;  // 16-byte copies and TMA
  if (route < 0 || route > 2) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(lq) * (hq / hkv);
  const int per_block = rows_per_block(route);
  const int64_t row_tiles = (rows + per_block - 1) / per_block;
  if (rows > INT32_MAX - per_block || row_tiles * n_split * hkv * b > INT32_MAX)
    return cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.ml = static_cast<float2*>(ml);
  p.nb = b;
  p.lq = lq;
  p.lkv = lkv;
  p.hq = hq;
  p.hkv = hkv;
  p.n_row_tiles = static_cast<int>(row_tiles);
  p.n_split = n_split;
  p.chunk = n_split == 1 ? lkv : chunk;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(hd));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dispatch(route, hd, q, k, v, p, s);
  if (err != cudaSuccess || n_split == 1) return err;
  return launch_combine(p, hd, route != 0, s);
}

}  // extern "C"
