// Phase marks of kernel 9's tensor-core kernels, for tools/ssd_probe.py.
//
// Includes the shipped src/repro_torch/kernels/csrc/ssd_scan.cu with
// SSD_MARK(i) defined: thread 0 of a block writes, at mark i, its SM's
// cycle counter (clock64) to slot i and the global nanosecond timer to slot
// 8 + i of the block's 16 slots, and its SM id to slot 15. The marks cost a
// few instructions and one store each; with the buffer unset (null) they
// write nothing. Everything else is the shipped code, built the shipped way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ unsigned long long* g_marks;  // (blocks, 16), or null

__device__ __forceinline__ unsigned long long probe_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned probe_smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void probe_mark(int i) {
  if (threadIdx.x != 0 || g_marks == nullptr) return;
  const unsigned long long block =
      blockIdx.x + static_cast<unsigned long long>(gridDim.x) *
                       (blockIdx.y + static_cast<unsigned long long>(gridDim.y) * blockIdx.z);
  unsigned long long* m = g_marks + block * 16;
  m[i] = clock64();
  m[8 + i] = probe_global_ns();
  if (i == 0) m[15] = probe_smid();
}

}  // namespace

#define SSD_MARK(i) probe_mark(i)

#include "../src/repro_torch/kernels/csrc/ssd_scan.cu"

extern "C" int probe_set_marks(void* p) {
  return cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}

// The mma.sync rate the kernels' products can reach: each warp runs 8
// independent m16n8k16 bf16 accumulators for `iters` rounds on operands
// held in registers (no memory traffic), and writes their sum.
__global__ void __launch_bounds__(128) probe_mma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x + i;  // bf16 pairs near 1
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe_mma_rate(float* out, int blocks, int iters, void* stream) {
  probe_mma_rate_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return cudaGetLastError();
}
