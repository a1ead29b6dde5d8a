// Microbenchmark: the latency of one dependent float32 add (__fadd_rn)
// on this card, in SM cycles.  One thread runs a chain of `n` adds, each
// waiting on the one before, between two clock64() reads; chip_smoke.py
// runs two lengths and takes the difference over the extra adds, so the
// clock reads and the loop's own instructions cancel out.  The bound of
// K3's row mode at small M is K times this latency.  Not part of the
// port's kernel library: chip_smoke.py builds it on its own.
#include <cuda_runtime.h>

__global__ void fadd_chain_kernel(const float* __restrict__ step, int n,
                                  long long* __restrict__ cycles,
                                  float* __restrict__ sink) {
  const float b = step[0];
  float acc = step[1];
  long long t0, t1;
  // acc passes through both clock reads, so no add moves across them
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0), "+f"(acc)::"memory");
#pragma unroll 64
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, b);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1), "+f"(acc)::"memory");
  cycles[0] = t1 - t0;
  sink[0] = acc;
}

// step: two floats on the card (the addend and the start); cycles: one
// int64 on the card; sink: one float on the card (keeps the chain live).
extern "C" int fadd_chain_launch(const void* step, int n, void* cycles,
                                 void* sink, void* stream) {
  fadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)step, n, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}
