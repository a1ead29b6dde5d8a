// Ordered float32 row sums, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no Pallas kernel here.  It
// was added because the reference's float32 sums (its lookahead's frame
// mean and intra-cost sum, the motion-homogenisation group sums, the
// batched intra mode decision's CTU group sums) round in the order its
// CPU backend adds the terms, which for these sums is strictly left to
// right over the row-major terms.  A torch reduction fixes its own tree
// order, and so does Triton's tl.sum; a loop of torch adds would cost
// one launch per term.  This kernel adds each row in index order in one
// launch:
//     out[m] = (((0 + x[0, m]) + x[1, m]) + ...) + x[K-1, m]
// with xt the (K, M) float32 terms, reduced axis first, and out (M,).
//
// What bounds it on this card: device-memory traffic (one float read per
// term, one add per term).  Design: one thread per row m, so the adds of
// a row stay in one register in their order; the reduced axis comes
// first in memory so that the 32 threads of a warp, on consecutive rows,
// read 32 consecutive floats at every step.  The adds are __fadd_rn: no
// contraction into an FMA and no reassociation.  The loop is unrolled so
// that the loads of several steps are in flight while the adds wait on
// each other.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ordered_sum_kernel(const float* __restrict__ xt, float* __restrict__ out,
                   int k, int m) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const float* p = xt + i;
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, __ldg(p + (size_t)j * m));
  out[i] = acc;
}

}  // namespace

extern "C" int ordered_sum_launch(const void* xt, void* out, int k, int m,
                                  void* stream) {
  if (m <= 0) return 0;
  const int blocks = (m + kThreads - 1) / kThreads;
  ordered_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xt, (float*)out, k, m);
  return (int)cudaGetLastError();
}
