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
// A second mode, ordered_sum_lanes, keeps the order of the reference's
// TU sums (the sum over an n x n block of a fused element-wise term),
// which its CPU backend vectorises 8 lanes wide.  With the n*n terms of
// block m in xt[:, m] (row-major within the block):
//   n <= 8: lane r sums row r left to right; the n lanes then add as a
//           tree, lane j with lane j + n/2, and so on down to one;
//   n >= 16: row by row, lane j (j < 8) sums the row's terms j, j + 8,
//           j + 16, ... after the running sum is added into lane 0's
//           first term; the 8 lanes add as a tree (j with j + 4, then
//           j + 2, then 1), which gives the new running sum.
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

__global__ void __launch_bounds__(kThreads)
ordered_sum_lanes_kernel(const float* __restrict__ xt,
                         float* __restrict__ out, int n, int m) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const float* p = xt + i;
  auto at = [&](int r, int c) { return __ldg(p + (size_t)(r * n + c) * m); };
  float lane[8];
  float acc = 0.0f;
  if (n <= 8) {
    for (int r = 0; r < n; ++r) {
      float s = 0.0f;
      for (int c = 0; c < n; ++c) s = __fadd_rn(s, at(r, c));
      lane[r] = s;
    }
    for (int w = n / 2; w >= 1; w /= 2)
      for (int j = 0; j < w; ++j) lane[j] = __fadd_rn(lane[j], lane[j + w]);
    acc = lane[0];
  } else {
    for (int r = 0; r < n; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) lane[j] = at(r, j);
      lane[0] = __fadd_rn(acc, lane[0]);
      for (int c = 8; c < n; c += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) lane[j] = __fadd_rn(at(r, c + j), lane[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) lane[j] = __fadd_rn(lane[j], lane[j + 4]);
#pragma unroll
      for (int j = 0; j < 2; ++j) lane[j] = __fadd_rn(lane[j], lane[j + 2]);
      acc = __fadd_rn(lane[0], lane[1]);
    }
  }
  out[i] = acc;
}

}  // namespace

extern "C" int ordered_sum_lanes_launch(const void* xt, void* out, int n,
                                        int m, void* stream) {
  if (m <= 0) return 0;
  if (n != 1 && n != 2 && n != 4 && n != 8 && n % 8 != 0) return 1;
  const int blocks = (m + kThreads - 1) / kThreads;
  ordered_sum_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xt, (float*)out, n, m);
  return (int)cudaGetLastError();
}

extern "C" int ordered_sum_launch(const void* xt, void* out, int k, int m,
                                  void* stream) {
  if (m <= 0) return 0;
  const int blocks = (m + kThreads - 1) / kThreads;
  ordered_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xt, (float*)out, k, m);
  return (int)cudaGetLastError();
}
