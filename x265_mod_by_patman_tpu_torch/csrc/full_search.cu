// Fused integer full search (SAD grid + lambda * mv_bits + first-minimum
// argmin), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel x265_mod_by_patman_tpu/ops/pallas/sad.py
// (sad_grid -> _sad_kernel) together with what its caller
// full_search_batch_pallas (x265_mod_by_patman_tpu/ops/me.py) does around
// it: for each block b at (x0, y0) and each candidate (dy, dx) of the
// (2r+1)^2 grid, with the window and the source read from the planes
// with per-coordinate clamping (HEVC edge extension),
//     sad  = sum_{i,j<n} |ref[cy(y0-r+dy+i), cx(x0-r+dx+j)]
//                         - orig[cy(y0+i), cx(x0+j)]|
//     cost = sad + ((lambda_x256 * bits) >> 8),
//     bits = 2*bit_length(|mvx-pmx|) + 1 + 2*bit_length(|mvy-pmy|) + 1,
// with mv = 4 * (dx - r, dy - r), and returns the first minimum of cost
// in (dy, dx) row-major order as (mv_x, mv_y, cost) int32 per block.
// Optional per-block fullpel window centres (cx, cy) (the HME seeds of
// the reference's full_search_batch center_x / center_y) shift the
// window to (x0 + cx - r, y0 + cy - r) and every candidate's MV by
// 4 * (cx, cy); the source block stays at (x0, y0).
//
// What bounds it on this card: arithmetic.  At the main path's n = 16,
// r = 16 a block costs 1089 * 256 = 279K absolute differences, while its
// planes' bytes are read once from device memory (the windows of
// neighbouring blocks overlap, and the planes fit in L2).  Each
// difference is two fp32 instructions (a subtract, and an add of the
// absolute value), so the fp32 lanes' issue rate sets the floor.
//
// Design:
//  * Several blocks per CTA (7 at r = 16: 231 of 256 threads busy, 73 KB
//    of shared memory, 3 CTAs per SM).  Their (n+2r)^2 windows and n^2
//    sources are staged into shared memory straight from the planes,
//    with per-coordinate clamping, as fp32, and the SADs accumulate in
//    fp32: a sum is exact while n^2 * (largest sample) < 2^24, which
//    holds at n = 16 up to 12-bit samples (16^2 * 4095 = 1,048,320) and
//    would hold only just at n = 64 (16,773,120); the wrapper raises
//    beyond it.  The inner loop needs no conversion (16-bit samples
//    would save shared memory that r = 16 does not need).  The staging
//    issues the loads of several rows before it stores any; it is the
//    kernel's fixed cost beside the arithmetic.  No window tensor and no
//    cost grid ever reach device memory.
//  * Register blocking.  A thread owns one candidate row dy and a strip
//    of 33 consecutive dx (the whole row at r = 16; four strips at
//    r = 63), 33 accumulators in registers.  For each source row it
//    loads that row (n values, vector loads broadcast across the
//    block's threads) and slides along the window row, loading each of
//    its 33+n-1 samples once and using it for every (dx, j) pair it
//    feeds: 2 fp32 instructions per difference, about one shared-memory
//    load per 11 differences.  The window row stride is odd, so the 33
//    threads of a block (consecutive dy) hit distinct banks.
//  * Epilogue in registers: cost and bit count per candidate, a
//    thread-local first minimum, then one 64-bit atomicMin per thread on
//    the key (cost, candidate index) in shared memory, so ties go to the
//    lowest (dy, dx) index exactly as torch.argmin / jnp.argmin do.
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 33;           // candidate columns per thread
constexpr int kMaxSlots = 8;         // blocks per CTA
constexpr int kSmemBudget = 75 * 1024;    // 7 slots at r = 16: 3 CTAs/SM
constexpr int kMaxThreads = 512;     // r <= 63: at most 4 * 127 items

struct Geometry {
  int cy, chunks, items, wr, ws, slot_floats, slots, threads;
  size_t smem;
};

__host__ __device__ inline Geometry geometry(int n, int r) {
  Geometry g;
  g.cy = 2 * r + 1;
  g.chunks = (g.cy + kStrip - 1) / kStrip;
  g.items = g.chunks * g.cy;            // one thread per (strip, dy)
  g.wr = g.cy + n - 1;                  // window rows
  g.ws = g.chunks * kStrip + n - 1;     // window row stride (floats) ...
  g.ws |= 1;                            // ... odd: conflict-free rows
  // window + source (rounded to 4 floats for the source's vector loads)
  g.slot_floats = ((g.wr * g.ws + 3) & ~3) + n * n;
  const int per_slot = g.slot_floats * 4 + 8;   // + the argmin key
  int s = kSmemBudget / per_slot;
  s = s < kMaxThreads / g.items ? s : kMaxThreads / g.items;
  s = s < kMaxSlots ? s : kMaxSlots;
  g.slots = s < 1 ? 1 : s;
  g.threads = ((g.slots * g.items + 31) / 32) * 32;
  g.smem = (size_t)g.slots * g.slot_floats * 4 + (size_t)g.slots * 8;
  return g;
}

__device__ inline int clampi(int v, int hi) { return min(max(v, 0), hi); }

__device__ inline int bit_length(int v) {
  return 32 - __clz(v < 0 ? -v : v);
}

// N: block size; P: 32-lane passes over a staged row (row stride <= 32 P)
template <int N, int P>
__global__ void __launch_bounds__(kMaxThreads)
full_search_kernel(const int* __restrict__ ref, const int* __restrict__ orig,
                   int h, int w, const int* __restrict__ xs,
                   const int* __restrict__ ys, const int* __restrict__ pmx,
                   const int* __restrict__ pmy,
                   const int* __restrict__ cxs, const int* __restrict__ cys,
                   int lambda_x256,
                   int* __restrict__ out_mx, int* __restrict__ out_my,
                   int* __restrict__ out_cost, int batch, int r) {
  const Geometry g = geometry(N, r);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      smem + (size_t)g.slots * g.slot_floats);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b0 = blockIdx.x * g.slots;
  if (tid < g.slots) keys[tid] = ~0ull;

  // Stage windows and sources.  The rows of all slots form one list (a
  // slot's wr window rows, then its N source rows); each warp takes
  // 16 / P rows at a time, lanes along the rows (P passes of 32), and
  // issues all their loads before it stores any, so the L2 latency is
  // paid once per batch.  A row's slot comes from a float reciprocal
  // (exact at these sizes), not from an integer divide.
  constexpr int R = 16 / P;
  const int slot_rows = g.wr + N;
  const float inv_rows = 1.0f / slot_rows;
  for (int base = warp * R; base < g.slots * slot_rows;
       base += nwarps * R) {
    float v[R][P];
    int off[R], len[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int row = base + k;
      const int s = (int)((row + 0.5f) * inv_rows);
      const int i = row - s * slot_rows;
      const bool is_win = i < g.wr;
      const int b = min(b0 + s, batch - 1);
      const int ccx = cxs ? cxs[b] : 0, ccy = cys ? cys[b] : 0;
      const int y = is_win ? ys[b] + ccy - r + i : ys[b] + i - g.wr;
      const int x = is_win ? xs[b] + ccx - r : xs[b];
      const int* prow = (is_win ? ref : orig) + (size_t)clampi(y, h - 1) * w;
      off[k] = s * g.slot_floats +
               (is_win ? i * g.ws : g.slot_floats - N * N + (i - g.wr) * N);
      len[k] = s < g.slots ? (is_win ? g.ws : N) : 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = lane + 32 * p;
        if (j < len[k]) v[k][p] = (float)__ldg(prow + clampi(x + j, w - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = lane + 32 * p;
        if (j < len[k]) smem[off[k] + j] = v[k][p];
      }
    }
  }
  __syncthreads();

  const int s = tid / g.items;
  const int item = tid - s * g.items;
  const int chunk = item / g.cy;
  const int dy = item - chunk * g.cy;
  const int b = b0 + s;
  if (s < g.slots && b < batch) {
    const float* win = smem + (size_t)s * g.slot_floats;
    const float4* src4 = reinterpret_cast<const float4*>(
        win + g.slot_floats - N * N);
    float acc[kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) acc[k] = 0.f;
#pragma unroll 1
    for (int sy = 0; sy < N; ++sy) {
      float o[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 v = src4[sy * (N / 4) + q];
        o[4 * q] = v.x;
        o[4 * q + 1] = v.y;
        o[4 * q + 2] = v.z;
        o[4 * q + 3] = v.w;
      }
      const float* wrow = win + (dy + sy) * g.ws + chunk * kStrip;
#pragma unroll
      for (int x = 0; x < kStrip + N - 1; ++x) {
        const float wv = wrow[x];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int dx = x - j;
          if (dx >= 0 && dx < kStrip) acc[dx] += fabsf(wv - o[j]);
        }
      }
    }
    // Epilogue: the first minimum of this thread's strip, then the CTA's.
    const int px = pmx[b], py = pmy[b];
    const int ccx = cxs ? cxs[b] : 0, ccy = cys ? cys[b] : 0;
    const int mvy = (dy - r + ccy) * 4;
    const int ybits = 2 * bit_length(mvy - py) + 1;
    unsigned long long best = ~0ull;
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int cx = chunk * kStrip + k;
      if (cx < g.cy) {
        const int bits = 2 * bit_length((cx - r + ccx) * 4 - px) + 1 + ybits;
        const int cost = (int)acc[k] + ((lambda_x256 * bits) >> 8);
        const unsigned long long key =
            ((unsigned long long)((unsigned)cost ^ 0x80000000u) << 32) |
            (unsigned)(dy * g.cy + cx);
        best = key < best ? key : best;
      }
    }
    atomicMin(&keys[s], best);
  }
  __syncthreads();
  if (tid < g.slots && b0 + tid < batch) {
    const unsigned long long key = keys[tid];
    const int idx = (int)(key & 0xffffffffu);
    const int ky = idx / g.cy;
    const int kx = idx - ky * g.cy;
    const int b = b0 + tid;
    out_mx[b] = (kx - r + (cxs ? cxs[b] : 0)) * 4;
    out_my[b] = (ky - r + (cys ? cys[b] : 0)) * 4;
    out_cost[b0 + tid] = (int)((unsigned)(key >> 32) ^ 0x80000000u);
  }
}

template <int N, int P>
int launch_p(const Geometry& g, const int* ref, const int* orig, int h,
             int w, const int* xs, const int* ys, const int* pmx,
             const int* pmy, const int* cxs, const int* cys,
             int lambda_x256, int* out_mx, int* out_my,
             int* out_cost, int batch, int r, cudaStream_t stream) {
  if (g.smem > 48 * 1024) {  // above the default dynamic shared memory cap
    cudaError_t e = cudaFuncSetAttribute(
        full_search_kernel<N, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (batch + g.slots - 1) / g.slots;
  full_search_kernel<N, P><<<grid, g.threads, g.smem, stream>>>(
      ref, orig, h, w, xs, ys, pmx, pmy, cxs, cys, lambda_x256, out_mx,
      out_my, out_cost, batch, r);
  return (int)cudaGetLastError();
}

template <int N>
int launch(const int* ref, const int* orig, int h, int w, const int* xs,
           const int* ys, const int* pmx, const int* pmy, const int* cxs,
           const int* cys, int lambda_x256, int* out_mx, int* out_my,
           int* out_cost, int batch, int r, cudaStream_t stream) {
  const Geometry g = geometry(N, r);
  // r <= 16 (one strip): rows of at most 49 samples; r <= 63: 160
  if (g.ws <= 64)
    return launch_p<N, 2>(g, ref, orig, h, w, xs, ys, pmx, pmy, cxs, cys,
                          lambda_x256, out_mx, out_my, out_cost, batch, r,
                          stream);
  return launch_p<N, 5>(g, ref, orig, h, w, xs, ys, pmx, pmy, cxs, cys,
                        lambda_x256, out_mx, out_my, out_cost, batch, r,
                        stream);
}

}  // namespace

// Returns a cudaError_t code (0 on success); n must be 8 or 16 (checked
// by the Python wrapper), 0 <= r <= 63; cxs / cys may be null (no
// window centres).
extern "C" int full_search_launch(const int* ref, const int* orig, int h,
                                  int w, const int* xs, const int* ys,
                                  const int* pmx, const int* pmy,
                                  const int* cxs, const int* cys,
                                  int lambda_x256, int* out_mx, int* out_my,
                                  int* out_cost, int batch, int n, int r,
                                  void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 16)
    return launch<16>(ref, orig, h, w, xs, ys, pmx, pmy, cxs, cys,
                      lambda_x256, out_mx, out_my, out_cost, batch, r, st);
  if (n == 8)
    return launch<8>(ref, orig, h, w, xs, ys, pmx, pmy, cxs, cys,
                     lambda_x256, out_mx, out_my, out_cost, batch, r, st);
  return (int)cudaErrorInvalidValue;
}
