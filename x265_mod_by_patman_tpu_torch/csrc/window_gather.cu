// Per-block window gather with edge clamping, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel x265_mod_by_patman_tpu/ops/pallas/gather.py
// (window_gather -> _gather_kernel, plus its pad_plane edge padding):
//     out[b, i, j] = plane[clamp(ys[b] + i, 0, H-1), clamp(xs[b] + j, 0, W-1)]
// with plane (H, W) int32, window starts ys/xs (B,) int32 and
// out (B, size, size) int32.  Reading the unpadded plane with
// per-coordinate clamping is HEVC's edge extension, so no padded copy of
// the plane is made (the TPU kernel needed one for aligned DMAs).
//
// What bounds it on this card: device-memory traffic.  It does no
// arithmetic beyond the clamps; it writes size^2 int32 per window and
// reads the plane (neighbouring windows overlap, so most reads hit L2).
//
// Design: a CTA owns several windows, i.e. one contiguous stretch of
// about 16 KB of the flat (B * size^2) output.  It first stages its
// windows' starts in shared memory with one flag each: a window that
// lies inside the plane horizontally skips the column clamps.  Then each
// thread writes 16-byte vectors of the stretch, from its first 16-byte
// boundary on (odd size^2 makes window starts straddle those
// boundaries, hence the flat view), kVec vectors per thread and pass
// with all their loads issued before any store (one pass unless a
// single window exceeds 4096 samples).  A vector's position costs one
// divide by size per vector, never one per sample: its four samples
// step along the row and wrap into the next row or window.  The few
// samples before the first boundary and after the last vector are
// stored one by one.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                       // 16-byte vectors per thread
constexpr int kOutPerCta = kThreads * kVec * 4;   // ints of output per CTA

struct Win {
  int y0, x0, inside;
};

__device__ inline int load(const int* __restrict__ plane, const Win& wn,
                           int i, int j, int h, int w) {
  const int y = min(max(wn.y0 + i, 0), h - 1);
  const int x = wn.inside ? wn.x0 + j : min(max(wn.x0 + j, 0), w - 1);
  return __ldg(plane + (size_t)y * w + x);
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const int* __restrict__ plane, const int* __restrict__ ys,
                     const int* __restrict__ xs, int* __restrict__ out,
                     int batch, int h, int w, int size, int per_cta) {
  extern __shared__ Win wins[];
  const int ss = size * size;
  const long long b0 = (long long)blockIdx.x * per_cta;
  const int nwin = (int)min((long long)per_cta, batch - b0);
  for (int k = threadIdx.x; k < nwin; k += kThreads) {
    const int x0 = xs[b0 + k];
    wins[k] = {ys[b0 + k], x0, x0 >= 0 && x0 + size <= w};
  }
  __syncthreads();

  const int total = nwin * ss;
  const long long first = b0 * ss;
  int* dst = out + first;
  const int head = (int)((4 - (first & 3)) & 3);   // to a 16-byte boundary
  const int nvec = total > head ? (total - head) >> 2 : 0;
  const float inv = 1.0f / size;

  for (int base = 0; base < nvec; base += kThreads * kVec) {
    int v[kVec][4];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = base + threadIdx.x + k * kThreads;
      if (q < nvec) {
        // (window, row, column) of the vector's first sample; with
        // e < 2^22 and size <= 1024 the float quotient of (e + 0.5) / size
        // floors exactly
        const int e = head + 4 * q;
        int row = (int)((e + 0.5f) * inv);
        int j = e - row * size;
        int wi = (int)((row + 0.5f) * inv);
        int i = row - wi * size;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v[k][t] = load(plane, wins[wi], i, j, h, w);
          if (++j == size) {
            j = 0;
            if (++i == size) {
              i = 0;
              wi = min(wi + 1, nwin - 1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = base + threadIdx.x + k * kThreads;
      if (q < nvec)
        reinterpret_cast<int4*>(dst + head)[q] =
            make_int4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
  // the samples before the first vector and after the last one
  const int tail = head + 4 * nvec;
  const int t = threadIdx.x;
  const int e = t < head ? t : tail + t - head;
  if (t < head + 3 && e < total) {
    const int row = e / size;
    const int wi = row / size;
    dst[e] = load(plane, wins[wi], row - wi * size, e - row * size, h, w);
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success).  `out` must be 16-byte
// aligned (torch allocations are).
extern "C" int window_gather_launch(const int* plane, const int* ys,
                                    const int* xs, int* out, int batch,
                                    int h, int w, int size, void* stream) {
  if (batch <= 0) return 0;
  if (size > 1024) return (int)cudaErrorInvalidValue;
  // whole windows per CTA, about kOutPerCta ints of output (at least one)
  const int per_cta = max(1, kOutPerCta / (size * size));
  const int grid = (batch + per_cta - 1) / per_cta;
  const size_t smem = (size_t)per_cta * sizeof(Win);
  window_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      plane, ys, xs, out, batch, h, w, size, per_cta);
  return (int)cudaGetLastError();
}
