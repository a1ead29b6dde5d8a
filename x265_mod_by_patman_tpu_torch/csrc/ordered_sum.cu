// K3: ordered float32 sums, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no Pallas kernel here.  It
// was added because the reference's float32 sums (its lookahead's frame
// mean and intra-cost sum, the motion-homogenisation group sums, the
// batched intra mode decision's CTU group sums) round in the order its
// CPU backend adds the terms, which for these sums is strictly left to
// right over the row-major terms.  A torch reduction fixes its own tree
// order, and so does Triton's tl.sum; a loop of torch adds would cost
// one launch per term.  Row mode adds each output's terms in index order
// in one launch:
//     out[m] = (((0 + t(0, m)) + t(1, m)) + ...) + t(K-1, m)
// where the terms t(k, m) stay where the caller holds them: k walks up
// to two reduced axes and m up to four kept axes (what the call sites
// hand it), each axis a size and a stride (in floats), both in
// row-major order, so no copy of the terms is made first.
//
// Lane mode (ordered_sum_lanes) keeps the order of the reference's TU
// sums (the sum over an n x n block of a fused element-wise term), which
// its CPU backend vectorises 8 lanes wide.  With x(m, r, c) term (r, c)
// of block m (block, row and column strides given; n = 4, 8, 16 or 32,
// the TU sizes):
//   n <= 8: lane r sums row r left to right; the n lanes then add as a
//           tree, lane j with lane j + n/2, and so on down to one;
//   n >= 16: row by row, lane j (j < 8) sums the row's terms j, j + 8,
//           j + 16, ... after the running sum is added into lane 0's
//           first term; the 8 lanes add as a tree (j with j + 4, then
//           j + 2, then 1), which gives the new running sum.
// The n >= 16 order is one case of the chained lane mode
// (ordered_sum_chain_launch): W lanes (4, 8 or 16) per row, lane j summing
// the row's terms j, j + W, ... below column V after the running sum is
// added into lane 0's first term, the W lanes as a halving tree, then
// the row's terms V..n-1 one by one.  The reference's wavefront sums its
// TB bit estimates so, W and V set by its vectorisation: (W, V) = (8, 8)
// or (4, 8) at n = 8, (8, 8) or (8, 16) at n = 16 (ops.rdoq); its inter
// TU32 pre-pass (4, 12) or (8, 16) at n = 16 and (8, 16) or (16, 32) at
// n = 32.
// Every add is __fadd_rn: no contraction into an FMA, no reassociation,
// no atomics; the bits equal ops.numeric.osum_plain / lanes_sum_plain /
// chain_sum_plain.
//
// What bounds it on this card, and what the design does about it:
// * Row mode at K > 16 (the lookahead's 1 or 12 sums of 510 or 1024
//   terms): the chain of K dependent adds, K times the add latency
//   (about 4 cycles), which nothing can split.  Everything else comes
//   before it once and is kept short: one block of two warps per output
//   stages all of the terms (up to 2048 at a time) into shared memory
//   with cp.async, coalesced along the innermost reduced axis, and one
//   thread runs the chain from shared memory with the next eight terms
//   already in registers.  A ring of smaller chunks, one warp loading
//   two ahead while the other adds, was slower at K = 510 and 1024: the
//   loads are few and the barriers between chunks cost more than the
//   overlap saved.
// * Row mode at K <= 16 (the batched intra decision's 142,800 sums of 4
//   terms, the region groups, the 12 intra-cost window sums): the bytes.
//   One thread per output, consecutive outputs on consecutive threads,
//   all K loads in flight before the adds, the K reduced offsets passed
//   with the launch; blocks shrink until the grid covers every SM.
// * Lane mode: the bytes.  One thread per lane: at n <= 8 the n threads
//   of a block each read a row (16 or 32 bytes as float4 where the rows
//   are contiguous) and add it left to right, then the tree runs over
//   __shfl_xor_sync; at n >= 16 eight consecutive threads hold a block's
//   8 lanes, read each row's strips of 8 terms as 32 contiguous bytes,
//   and run the tree over __shfl_xor_sync within the group.  Only lane
//   0's n/8 + 3 adds a row wait on the running sum; the other lanes'
//   sums and the shuffles do not, so the next rows' loads and shuffles
//   overlap the chain.  The chained mode is the same kernel with W
//   threads a block and, below V = n, lane 0's tail of n - V adds.
//   Blocks shrink until the grid covers every SM.
#include <cuda_runtime.h>

namespace {

constexpr int kReduced = 2;          // reduced axes (fewer: size-1 pads)
constexpr int kKept = 4;             // kept axes (fewer: size-1 pads)
constexpr int kOneMax = 2048;        // terms staged at once, one output
constexpr int kDirectMaxK = 16;      // K of the direct kernel

// i / d for 0 <= i < 2^31 as a multiply-high and a shift (the divisor's
// magic number: mul = ceil(2^p / d), p = 31 + ceil(log2 d))
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv make_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int i, const FastDiv& f) {
  return f.d == 1 ? i : (int)(__umulhi((unsigned)i, f.mul) >> f.shr);
}

// the axes, outermost first; the wrapper pads the unused inner ones
// with size 1, stride 0, which add nothing to an offset
struct Layout {
  FastDiv rsize[kReduced], ksize[kKept];
  long long rstride[kReduced], kstride[kKept];
};

// offset (in floats) of row-major index i over N axes size / stride; the
// outermost axis takes what is left of i, without a division
template <int N>
__device__ __forceinline__ long long offset_of(int i, const FastDiv* size,
                                               const long long* stride) {
  long long off = 0;
#pragma unroll
  for (int a = N - 1; a >= 1; --a) {
    const int q = fdiv(i, size[a]);
    off += (long long)(i - q * size[a].d) * stride[a];
    i = q;
  }
  return off + (long long)i * stride[0];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// acc + p[0] + p[1] + ... (len terms, in order), the next eight terms
// loaded into registers while the current eight are added
__device__ __forceinline__ float chain(float acc, const float* p, int len) {
  int i = 0;
  if (len >= 8) {
    float cur[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cur[j] = p[j];
    for (i = 8; i + 8 <= len; i += 8) {
      float nxt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) nxt[j] = p[i + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, cur[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, cur[j]);
  }
  for (; i < len; ++i) acc = __fadd_rn(acc, p[i]);
  return acc;
}

// One output a block, 64 threads: the threads stage the terms into
// shared memory with cp.async (coalesced along the innermost reduced
// axis), up to kOneMax at a time, and thread 0 adds them in order.
__global__ void __launch_bounds__(64)
ordered_sum_one_kernel(const float* __restrict__ x, float* __restrict__ out,
                       Layout L, int k) {
  __shared__ float stage[kOneMax];
  const float* base = x + offset_of<kKept>(blockIdx.x, L.ksize, L.kstride);
  float acc = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kOneMax) {
    const int len = min(kOneMax, k - k0);
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(stage + i,
                base + offset_of<kReduced>(k0 + i, L.rsize, L.rstride));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x == 0) acc = chain(acc, stage, len);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// K <= kDirectMaxK: one thread per output, consecutive
// outputs on consecutive threads, all K loads in flight before the adds;
// the K reduced offsets come with the launch.
struct Terms {
  long long off[kDirectMaxK];
};

template <int KMAX>
__global__ void ordered_sum_direct_kernel(const float* __restrict__ x,
                                          float* __restrict__ out, Layout L,
                                          Terms T, int k, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float* p = x + offset_of<kKept>(i, L.ksize, L.kstride);
  // KMAX loads, none of them conditional, so that all are in flight
  // before the first add (offsets past K repeat the first term's)
  float v[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) v[j] = __ldg(p + T.off[j]);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) acc = __fadd_rn(acc, v[j]);
  out[i] = acc;
}

// Lane mode, n <= 8: thread r of each group of n sums row r of block
// blk left to right, then the n row sums add as a halving tree.
template <int N, bool VEC>
__global__ void lanes_narrow_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int m,
                                    long long sb, long long sr,
                                    long long sc) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long blk = tid / N;
  const int r = (int)(tid - blk * N);
  const bool valid = blk < m;
  float s = 0.0f;
  if (valid) {
    const float* p = x + blk * sb + r * sr;
    if (VEC) {
      float4 v[N / 4];
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        v[i] = __ldg(reinterpret_cast<const float4*>(p) + i);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        s = __fadd_rn(s, v[i].x);
        s = __fadd_rn(s, v[i].y);
        s = __fadd_rn(s, v[i].z);
        s = __fadd_rn(s, v[i].w);
      }
    } else {
      float v[N];
#pragma unroll
      for (int c = 0; c < N; ++c) v[c] = __ldg(p + c * sc);
#pragma unroll
      for (int c = 0; c < N; ++c) s = __fadd_rn(s, v[c]);
    }
  }
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, w, N));
  if (valid && r == 0) out[blk] = s;
}

// Chained lane mode (and the lane mode at n = 16, 32: W = 8, V = n): W
// consecutive threads hold block blk's lanes j = 0..W-1.
template <int N, int W, int V>
__global__ void lanes_chain_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int m,
                                   long long sb, long long sr,
                                   long long sc) {
  static_assert(V % W == 0 && V <= N, "V: a multiple of W, at most N");
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long blk = tid / W;
  const int j = (int)(tid % W);
  const bool valid = blk < m;
  // a group past the last block reads block 0 and stores nothing: all 32
  // lanes of the warp take part in the shuffles
  const float* p = x + (valid ? blk : 0) * sb;
  float acc = 0.0f;
#pragma unroll 4
  for (int r = 0; r < N; ++r) {
    const float* q = p + r * sr;
    float v[V / W];
#pragma unroll
    for (int i = 0; i < V / W; ++i) v[i] = __ldg(q + (W * i + j) * sc);
    // l: lane j's sum of the row's terms j, j + W, ... (lane 0's value
    // is not read by the others); a: lane 0's chain from the running sum
    float l = v[0];
    float a = __fadd_rn(acc, l);
#pragma unroll
    for (int i = 1; i < V / W; ++i) {
      l = __fadd_rn(v[i], l);
      a = __fadd_rn(v[i], a);
    }
    // the halving tree: lane j + w's partial sum into lane j's; lane 0's
    // chain takes each partial sum it would have added
#pragma unroll
    for (int w = W / 2; w >= 1; w /= 2) {
      const float o = __shfl_xor_sync(0xffffffffu, l, w, W);
      l = __fadd_rn(l, o);
      a = __fadd_rn(a, o);
    }
#pragma unroll
    for (int c = V; c < N; ++c) a = __fadd_rn(a, __ldg(q + c * sc));
    acc = a;
  }
  if (valid && j == 0) out[blk] = acc;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// threads a block for `total` threads in all: 256, halved (down to 32)
// until the grid has two blocks for every SM
int block_threads(long long total) {
  int bd = 256;
  while (bd > 32 && (total + bd - 1) / bd < 2LL * sm_count()) bd /= 2;
  return bd;
}

}  // namespace

// x: the first term's address; layout (int64, row-major, outermost
// first): 2 reduced sizes, 2 reduced strides, 4 kept sizes, 4 kept
// strides, unused inner axes of size 1; out: (M,) float32.
extern "C" int ordered_sum_launch(const void* x, void* out,
                                  const long long* layout, void* stream) {
  Layout L;
  long long k = 1, m = 1;
  for (int a = 0; a < kReduced; ++a) {
    L.rsize[a] = make_div((int)layout[a]);
    L.rstride[a] = layout[kReduced + a];
    k *= layout[a];
  }
  for (int a = 0; a < kKept; ++a) {
    L.ksize[a] = make_div((int)layout[2 * kReduced + a]);
    L.kstride[a] = layout[2 * kReduced + kKept + a];
    m *= layout[2 * kReduced + a];
  }
  if (k >= (1LL << 31) || m >= (1LL << 31)) return 1;
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  float* op = (float*)out;
  if (k == 0)   // no terms: every sum is the float32 zero it starts from
    return (int)cudaMemsetAsync(op, 0, (size_t)m * sizeof(float), st);
  if (k <= kDirectMaxK) {
    // the reduced offsets, row-major over the reduced axes
    Terms T;
    for (int j = 0; j < kDirectMaxK; ++j) {
      long long off = 0;
      int r = j < k ? j : 0;
      for (int a = kReduced - 1; a >= 0; --a) {
        off += (long long)(r % L.rsize[a].d) * L.rstride[a];
        r /= L.rsize[a].d;
      }
      T.off[j] = off;
    }
    const int bd = block_threads(m);
    const int blocks = (int)((m + bd - 1) / bd);
    if (k <= 4)
      ordered_sum_direct_kernel<4><<<blocks, bd, 0, st>>>(xp, op, L, T,
                                                          (int)k, (int)m);
    else if (k <= 8)
      ordered_sum_direct_kernel<8><<<blocks, bd, 0, st>>>(xp, op, L, T,
                                                          (int)k, (int)m);
    else
      ordered_sum_direct_kernel<kDirectMaxK><<<blocks, bd, 0, st>>>(
          xp, op, L, T, (int)k, (int)m);
    return (int)cudaGetLastError();
  }
  ordered_sum_one_kernel<<<(int)m, 64, 0, st>>>(xp, op, L, (int)k);
  return (int)cudaGetLastError();
}

// x: block 0's term (0, 0); n: 4, 8, 16 or 32; sb, sr, sc: block, row
// and column strides (floats); out: (M,) float32.
extern "C" int ordered_sum_lanes_launch(const void* x, void* out, int n,
                                        int m, long long sb, long long sr,
                                        long long sc, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  float* op = (float*)out;
  const long long total = (long long)m * (n <= 8 ? n : 8);
  const int bd = block_threads(total);
  const int blocks = (int)((total + bd - 1) / bd);
  const bool vec = sc == 1 && sr % 4 == 0 && sb % 4 == 0 &&
                   ((unsigned long long)x % 16) == 0;
  switch (n) {
    case 4:
      if (vec)
        lanes_narrow_kernel<4, true><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                            sr, sc);
      else
        lanes_narrow_kernel<4, false><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                             sr, sc);
      break;
    case 8:
      if (vec)
        lanes_narrow_kernel<8, true><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                            sr, sc);
      else
        lanes_narrow_kernel<8, false><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                             sr, sc);
      break;
    case 16:
      lanes_chain_kernel<16, 8, 16><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    case 32:
      lanes_chain_kernel<32, 8, 32><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    default:
      return 1;
  }
  return (int)cudaGetLastError();
}

// The chained lane mode: x block 0's term (0, 0); (n, w, v) one of (8, 8,
// 8), (8, 4, 8), (16, 8, 8), (16, 8, 16), (32, 8, 32), (16, 4, 12), (32,
// 8, 16), (32, 16, 32); sb, sr, sc: block,
// row and column strides (floats); out: (M,) float32.
extern "C" int ordered_sum_chain_launch(const void* x, void* out, int n,
                                        int w, int v, int m, long long sb,
                                        long long sr, long long sc,
                                        void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  float* op = (float*)out;
  const long long total = (long long)m * w;
  const int bd = block_threads(total);
  const int blocks = (int)((total + bd - 1) / bd);
  const int key = n * 10000 + w * 100 + v;
  switch (key) {
    case 80808:
      lanes_chain_kernel<8, 8, 8><<<blocks, bd, 0, st>>>(xp, op, m, sb, sr,
                                                         sc);
      break;
    case 80408:
      lanes_chain_kernel<8, 4, 8><<<blocks, bd, 0, st>>>(xp, op, m, sb, sr,
                                                         sc);
      break;
    case 160808:
      lanes_chain_kernel<16, 8, 8><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                          sr, sc);
      break;
    case 160816:
      lanes_chain_kernel<16, 8, 16><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    case 320832:
      lanes_chain_kernel<32, 8, 32><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    case 160412:
      lanes_chain_kernel<16, 4, 12><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    case 320816:
      lanes_chain_kernel<32, 8, 16><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                           sr, sc);
      break;
    case 321632:
      lanes_chain_kernel<32, 16, 32><<<blocks, bd, 0, st>>>(xp, op, m, sb,
                                                            sr, sc);
      break;
    default:
      return 1;
  }
  return (int)cudaGetLastError();
}
