// What gossip_mix.cu and gossip_mix_dequant.cu share: kernel 4
// (gossip_mix_dequant) on a square W of the narrow plane runs
// gossip_mix.cu's mix_kernel_narrow with its Dequant prologue, and both
// pick vector loads and stores by the operands' alignment.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gossip_mix {

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// out (n, xp) = w (n, n) · (q (n, xp) int8 ⊙ repeat(scales (n, xp/qblock),
// qblock)) through mix_kernel_narrow when the shape is the narrow plane's
// (m == n <= 32, xp < kNarrowMaxX), and true; else false, with nothing
// launched. m, n and xp are positive; xp % qblock == 0.
bool launch_dequant_narrow(const float* w, const int8_t* q, const float* scales, float* out,
                           int m, int n, int64_t xp, int64_t qblock, cudaStream_t stream);

}  // namespace gossip_mix
