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
