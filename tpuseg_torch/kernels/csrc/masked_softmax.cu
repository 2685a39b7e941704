// Per-instance masked spatial softmax, forward and backward (Hopper).
//
// Replaces the TPU kernel tpuseg/kernels/masked_softmax.py::
// masked_softmax_pallas (Pallas body _kernel), which is forward-only; the JAX
// package differentiates its jnp path in training.  Here both directions are
// kernels.
//
//   forward   e (B, HW) f32, mask (B, N, HW) {0,1} f32 -> p (B, N, HW):
//             p[b,n,:] = softmax of e[b,:] over the pixels with mask > 0,
//             0 elsewhere; an instance with no pixel gives a row of zeros.
//   backward  g (B, N, HW), p -> de (B, HW):
//             dot[b,n]  = sum_hw p * g
//             de[b,hw]  = sum_n p[b,n,hw] * (g[b,n,hw] - dot[b,n])
//             (the mask gets no gradient).
//
// Bound on the card: bytes.  Per element the forward does one compare, two
// exps and a multiply against 12 bytes moved (mask and p; e is shared by the
// N rows of a sample and stays in L2), so the least time is
// (B*HW*4 + B*N*HW*8) / 3.35 TB/s.  The backward must read all of g, p only
// where g is nonzero, and write de: in training only the K instances the
// glimpse loop picked get a cotangent (K = 2 of 32 rows per sample), so its
// least time is (B*N*HW*4 + K*B*HW*4 + B*HW*4) / 3.35 TB/s there.
//
// Design.  It computes what the TPU kernel computes but not its blocking: the
// TPU kernel holds a whole (HW/128, 128) row in VMEM per grid cell; a row at
// full width is 65536 floats = 256 KB, more than a block's 227 KB of shared
// memory.  One thread block owns one (batch, instance) row:
//   pass 1  reads the mask and, where it is set, e; every thread keeps a
//           running (max, sum of exp(x - max)) (online softmax), and the
//           row's mask is packed into a bitmask in shared memory (8 KB at
//           HW = 65536, by warp ballots); the block then combines the pairs:
//           warp shuffles, one shared-memory step across warps;
//   pass 2  reads only the bits and, where a bit is set, e (an L2 hit:
//           256 KB per sample), and writes p = exp(e - max) / sum.  A row
//           with no pixel writes zeros without reading anything.
// The mask is read and p written with evict-first hints, so e stays in L2.
// Rows move as 16-byte vectors: a scalar head up to the first 16-byte
// boundary of the row (a row starts unaligned when HW is odd), float4 in
// the middle, a scalar tail; e, whose row may be aligned otherwise than the
// mask's, is then read as four scalars.  The backward is two launches.  One
// block per row reads g and, only where a float4 of g is nonzero (NaN counts
// as nonzero), p: it writes the row's dot and an "active" flag.  Then a
// kernel over pixel tiles loops over the active instances of its sample in
// ascending n, coalesced along HW.  A skipped row adds p * (0 - 0) = +0 (p
// is finite), so the result equals the sum over all rows; no atomics: the
// sum has a fixed order, so the gradient is the same from run to run.  (One
// launch on a persistent grid, blocks taking rows and then the sample's
// tiles from a counter, each tile waiting on its sample's rows, measured
// 10-20% slower in every case.)
//
// Split rows.  Under spatial sharding one instance's row of H*W pixels lies
// on several ranks, each holding some of its rows of pixels.  The split
// entry points put a collective between the launches that the whole-row
// kernels already separate:
//   forward   tpuseg_masked_softmax_stats writes each row's partial
//             (max, sum of exp(x - max)) over this rank's pixels (one block
//             a row, pass 1 above without the bitmask); the caller combines
//             the ranks' pairs (log-sum-exp), and tpuseg_masked_softmax_apply
//             writes p = exp(e - M) / S where the mask is set (0 where it is
//             not, or where the whole row has no pixel: S = 0), one thread
//             an element;
//   backward  tpuseg_masked_softmax_bwd_rows is the row pass (this rank's
//             share of each row's dot and its active flag); the caller
//             all-reduces both, then tpuseg_masked_softmax_bwd_tiles is the
//             tile pass on the global dots and flags.  A row active on any
//             rank is summed on every rank: where this rank's share of g is
//             zero it still adds p * (0 - dot).
// Each is bound by bytes like the whole-row kernels; the split forward
// reads the mask and e twice (once a launch).

#include <cuda_runtime.h>

#ifndef MS_UNROLL
#define MS_UNROLL 2  // forward pass 1: groups of 32 float4 per warp in flight
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;

struct MaxSum {
  float m;  // running maximum
  float s;  // sum of exp(x - m)
};

__device__ __forceinline__ void push(MaxSum& a, float v) {
  if (v <= a.m) {
    a.s += expf(v - a.m);
  } else {
    a.s = a.s * expf(a.m - v) + 1.f;
    a.m = v;
  }
}

__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Every thread returns the block's combined pair (same order everywhere).
__device__ __forceinline__ MaxSum block_combine(MaxSum a) {
  __shared__ MaxSum part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    MaxSum b{__shfl_xor_sync(kAll, a.m, o), __shfl_xor_sync(kAll, a.s, o)};
    a = combine(a, b);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = a;
  __syncthreads();
  MaxSum r = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = combine(r, part[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += part[w];
  return r;
}

// A row of `hw` floats at element offset `off` of a 16-byte aligned buffer:
// `head` scalars up to the first 16-byte boundary, `nv` float4 chunks, then
// scalars from `tail` to the end.
struct Split {
  int head, nv, tail;
};

__device__ __forceinline__ Split split_row(size_t off, int hw) {
  int head = static_cast<int>((4 - (off & 3)) & 3);
  if (head > hw) head = hw;
  const int nv = (hw - head) >> 2;
  return {head, nv, head + 4 * nv};
}

// Four consecutive floats at element offset `off`: one 16-byte load when
// `aligned` (off a multiple of 4), else four scalar loads.
__device__ __forceinline__ float4 ld4(const float* __restrict__ base,
                                      size_t off, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(base + off));
  return make_float4(__ldg(base + off), __ldg(base + off + 1),
                     __ldg(base + off + 2), __ldg(base + off + 3));
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;  // NaN: true
}

// Bytes of the forward's bitmask: 4 words per 32 chunks.
inline size_t bitmask_bytes(int hw) {
  const int groups = ((hw >> 2) + 31) >> 5;
  return static_cast<size_t>(groups) * 4 * sizeof(unsigned);
}

// grid: B * N blocks, one per (batch, instance) row.  Dynamic shared
// memory: the row's mask as bits; word 4 * (j / 32) + q holds, at bit
// j % 32, element q of float4 chunk j.
__global__ void __launch_bounds__(kThreads)
masked_softmax_fwd_kernel(const float* __restrict__ e,
                          const float* __restrict__ mask,
                          float* __restrict__ p, int n_ins, int hw) {
  extern __shared__ unsigned bits[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t roff = static_cast<size_t>(blockIdx.x) * hw;
  const size_t eoff = static_cast<size_t>(blockIdx.x / n_ins) * hw;
  const Split sp = split_row(roff, hw);
  const size_t ev = eoff + sp.head;  // e's element of chunk 0
  const bool e_al = (ev & 3) == 0;
  const float4* m4 = reinterpret_cast<const float4*>(mask + roff + sp.head);
  const int groups = (sp.nv + 31) >> 5;

  // pass 1: the head and tail scalars, then the chunks, MS_UNROLL groups of
  // 32 per warp in flight
  MaxSum acc{kNeg, 0.f};
  for (int i = threadIdx.x; i < sp.head; i += kThreads)
    if (mask[roff + i] > 0) push(acc, e[eoff + i]);
  for (int i = sp.tail + threadIdx.x; i < hw; i += kThreads)
    if (mask[roff + i] > 0) push(acc, e[eoff + i]);
  for (int g0 = warp; g0 < groups; g0 += MS_UNROLL * kWarps) {
    float4 mv[MS_UNROLL];
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u) {
      const int j = ((g0 + u * kWarps) << 5) + lane;
      mv[u] = j < sp.nv ? __ldcs(m4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < MS_UNROLL; ++u) {
      const int g = g0 + u * kWarps;
      if (g >= groups) break;  // warp-uniform
      const unsigned b0 = __ballot_sync(kAll, mv[u].x > 0);
      const unsigned b1 = __ballot_sync(kAll, mv[u].y > 0);
      const unsigned b2 = __ballot_sync(kAll, mv[u].z > 0);
      const unsigned b3 = __ballot_sync(kAll, mv[u].w > 0);
      if (lane < 4) bits[4 * g + lane] = lane == 0 ? b0 : lane == 1 ? b1
                                         : lane == 2 ? b2 : b3;
      const unsigned me = 1u << lane;
      if ((b0 | b1 | b2 | b3) & me) {
        const float4 x = ld4(e, ev + 4 * static_cast<size_t>((g << 5) + lane),
                             e_al);
        if (b0 & me) push(acc, x.x);
        if (b1 & me) push(acc, x.y);
        if (b2 & me) push(acc, x.z);
        if (b3 & me) push(acc, x.w);
      }
    }
  }
  acc = block_combine(acc);  // its barrier also publishes the bits

  float4* p4 = reinterpret_cast<float4*>(p + roff + sp.head);
  if (acc.s == 0.f) {  // no pixel: zeros (block-uniform)
    for (int j = threadIdx.x; j < sp.nv; j += kThreads)
      __stcs(p4 + j, make_float4(0.f, 0.f, 0.f, 0.f));
    for (int i = threadIdx.x; i < sp.head; i += kThreads) p[roff + i] = 0.f;
    for (int i = sp.tail + threadIdx.x; i < hw; i += kThreads)
      p[roff + i] = 0.f;
    return;
  }
  const float mx = acc.m, inv = 1.f / acc.s;
  for (int i = threadIdx.x; i < sp.head; i += kThreads)
    p[roff + i] = mask[roff + i] > 0 ? expf(e[eoff + i] - mx) * inv : 0.f;
  for (int i = sp.tail + threadIdx.x; i < hw; i += kThreads)
    p[roff + i] = mask[roff + i] > 0 ? expf(e[eoff + i] - mx) * inv : 0.f;
  // pass 2: the bits, and e where a bit is set
  for (int j = threadIdx.x; j < sp.nv; j += kThreads) {
    const int g = j >> 5;
    const unsigned me = 1u << (j & 31);
    const unsigned w0 = bits[4 * g], w1 = bits[4 * g + 1],
                   w2 = bits[4 * g + 2], w3 = bits[4 * g + 3];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((w0 | w1 | w2 | w3) & me) {
      const float4 x = ld4(e, ev + 4 * static_cast<size_t>(j), e_al);
      if (w0 & me) o.x = expf(x.x - mx) * inv;
      if (w1 & me) o.y = expf(x.y - mx) * inv;
      if (w2 & me) o.z = expf(x.z - mx) * inv;
      if (w3 & me) o.w = expf(x.w - mx) * inv;
    }
    __stcs(p4 + j, o);
  }
}

// One block: dot[row] = sum_hw p * g, reading p only where a float4 of g
// is nonzero; active[row] = 1 when any element of g's row is nonzero (or
// NaN), else 0 (and then dot[row] = 0).  Thread 0 writes both.
__device__ __forceinline__ void row_dot(const float* __restrict__ p,
                                        const float* __restrict__ g,
                                        float* __restrict__ dot,
                                        int* __restrict__ active, int row,
                                        int hw) {
  const size_t roff = static_cast<size_t>(row) * hw;
  const Split sp = split_row(roff, hw);
  const float4* p4 = reinterpret_cast<const float4*>(p + roff + sp.head);
  const float4* g4 = reinterpret_cast<const float4*>(g + roff + sp.head);
  float acc = 0.f;
  int any = 0;
  int i = threadIdx.x;
  // four float4 of g in flight per thread; the sum keeps the chunk order.
  // Where the thread's last four chunks of g were nonzero, p is loaded
  // beside g (a dense row streams both at once); else only where g is.
  bool beside = false;
  for (; i + 3 * kThreads < sp.nv; i += 4 * kThreads) {
    float4 b[4], a[4];
    bool nz[4], seen = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      b[u] = __ldg(g4 + i + u * kThreads);
      a[u] = beside ? __ldg(p4 + i + u * kThreads)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      nz[u] = nonzero(b[u]);
      seen |= nz[u];
      if (nz[u] && !beside) a[u] = __ldg(p4 + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (nz[u]) {
        acc += a[u].x * b[u].x + a[u].y * b[u].y + a[u].z * b[u].z +
               a[u].w * b[u].w;
        any = 1;
      }
    }
    beside = seen;
  }
  for (; i < sp.nv; i += kThreads) {
    const float4 b = __ldg(g4 + i);
    if (nonzero(b)) {
      const float4 a = __ldg(p4 + i);
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      any = 1;
    }
  }
  for (int k = threadIdx.x; k < sp.head + hw - sp.tail; k += kThreads) {
    const size_t o = roff + (k < sp.head ? k : sp.tail + k - sp.head);
    const float b = g[o];
    if (b != 0.f) {
      acc += p[o] * b;
      any = 1;
    }
  }
  any = __syncthreads_or(any);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    dot[row] = acc;
    active[row] = any;
  }
}

// grid: B * N blocks, one row each.
__global__ void __launch_bounds__(kThreads)
masked_softmax_dot_kernel(const float* __restrict__ p,
                          const float* __restrict__ g,
                          float* __restrict__ dot, int* __restrict__ active,
                          int hw) {
  row_dot(p, g, dot, active, blockIdx.x, hw);
}

constexpr int kTileThreads = 256;

// grid: (pixel tiles, B), HW a multiple of 4; de[b, hw] = sum over the
// active n, in order, of p * (g - dot[b, n]).  Thread j owns float4 chunk j
// of de's row.
__global__ void __launch_bounds__(kTileThreads)
masked_softmax_bwd_kernel(const float* __restrict__ p,
                          const float* __restrict__ g,
                          const float* __restrict__ dot,
                          const int* __restrict__ active,
                          float* __restrict__ de, int n_ins, int hw) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kTileThreads + threadIdx.x;
  if (j >= hw >> 2) return;
  const int row0 = b * n_ins;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < n_ins; ++n) {
    if (!__ldg(active + row0 + n)) continue;  // block-uniform
    const size_t off = static_cast<size_t>(row0 + n) * hw;
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + off) + j);
    const float4 c = __ldg(reinterpret_cast<const float4*>(g + off) + j);
    const float d = __ldg(dot + row0 + n);
    acc.x += a.x * (c.x - d);
    acc.y += a.y * (c.y - d);
    acc.z += a.z * (c.z - d);
    acc.w += a.w * (c.w - d);
  }
  reinterpret_cast<float4*>(de + static_cast<size_t>(b) * hw)[j] = acc;
}

// The same where rows start at different alignments (HW not a multiple of
// 4, so de's row and each instance's row may each need another scalar
// head): thread t of a tile owns pixels t, t + 256, t + 512, t + 768, every
// load a coalesced scalar, four pixels' loads in flight.  (A head / float4
// / tail body here, four scalar loads for each misaligned row, measured
// slower.)
__global__ void __launch_bounds__(kTileThreads)
masked_softmax_bwd_odd_kernel(const float* __restrict__ p,
                              const float* __restrict__ g,
                              const float* __restrict__ dot,
                              const int* __restrict__ active,
                              float* __restrict__ de, int n_ins, int hw) {
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * 4 * kTileThreads + threadIdx.x;
  const int row0 = b * n_ins;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n = 0; n < n_ins; ++n) {
    if (!__ldg(active + row0 + n)) continue;  // block-uniform
    const size_t rs = static_cast<size_t>(row0 + n) * hw;
    const float d = __ldg(dot + row0 + n);
    float a[4], c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kTileThreads;
      a[u] = i < hw ? __ldg(p + rs + i) : 0.f;
      c[u] = i < hw ? __ldg(g + rs + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += a[u] * (c[u] - d);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + u * kTileThreads;
    if (i < hw) de[static_cast<size_t>(b) * hw + i] = acc[u];
  }
}

// grid: B * N blocks, one per (batch, instance) row: the row's (max, sum of
// exp(x - max)) over the pixels whose mask is set, (-1e30, 0) for none.
__global__ void __launch_bounds__(kThreads)
masked_softmax_stats_kernel(const float* __restrict__ e,
                            const float* __restrict__ mask,
                            float* __restrict__ stats, int n_ins, int hw) {
  const size_t roff = static_cast<size_t>(blockIdx.x) * hw;
  const size_t eoff = static_cast<size_t>(blockIdx.x / n_ins) * hw;
  MaxSum acc{kNeg, 0.f};
  for (int i = threadIdx.x; i < hw; i += kThreads)
    if (__ldg(mask + roff + i) > 0) push(acc, __ldg(e + eoff + i));
  acc = block_combine(acc);
  if (threadIdx.x == 0) {
    stats[2 * static_cast<size_t>(blockIdx.x)] = acc.m;
    stats[2 * static_cast<size_t>(blockIdx.x) + 1] = acc.s;
  }
}

constexpr int kApplyThreads = 256;

// grid: (pixel tiles, B * N): p = exp(e - M) / S where the mask is set and
// the row has a pixel anywhere (S > 0), else 0.
__global__ void __launch_bounds__(kApplyThreads)
masked_softmax_apply_kernel(const float* __restrict__ e,
                            const float* __restrict__ mask,
                            const float* __restrict__ stats,
                            float* __restrict__ p, int n_ins, int hw) {
  const int row = blockIdx.y;
  const int i = blockIdx.x * kApplyThreads + threadIdx.x;
  if (i >= hw) return;
  const float mx = __ldg(stats + 2 * row), sum = __ldg(stats + 2 * row + 1);
  const size_t o = static_cast<size_t>(row) * hw + i;
  float v = 0.f;
  if (sum > 0.f && __ldg(mask + o) > 0) {
    const float x = __ldg(e + static_cast<size_t>(row / n_ins) * hw + i);
    v = expf(x - mx) * (1.f / sum);
  }
  p[o] = v;
}

}  // namespace

// Base pointers 16-byte aligned (the wrapper checks them); any HW.
extern "C" int tpuseg_masked_softmax_fwd(const void* e, const void* mask,
                                         void* p, int b, int n, int hw,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bitmask_bytes(hw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_softmax_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  masked_softmax_fwd_kernel<<<b * n, kThreads, smem, s>>>(
      static_cast<const float*>(e), static_cast<const float*>(mask),
      static_cast<float*>(p), n, hw);
  return cudaGetLastError();
}

// Two launches: the row dots and flags into `scratch` (2 * B * N floats of
// scratch: the dots, then the flags as ints), then de.
extern "C" int tpuseg_masked_softmax_bwd(const void* p, const void* g,
                                         void* scratch, void* de, int b,
                                         int n, int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* dot = static_cast<float*>(scratch);
  int* active = reinterpret_cast<int*>(dot + static_cast<size_t>(b) * n);
  float* def = static_cast<float*>(de);
  masked_softmax_dot_kernel<<<b * n, kThreads, 0, s>>>(pf, gf, dot, active,
                                                       hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (hw % 4 == 0) {
    dim3 grid((hw / 4 + kTileThreads - 1) / kTileThreads, b);
    masked_softmax_bwd_kernel<<<grid, kTileThreads, 0, s>>>(pf, gf, dot,
                                                            active, def, n,
                                                            hw);
  } else {
    dim3 grid((hw + 4 * kTileThreads - 1) / (4 * kTileThreads), b);
    masked_softmax_bwd_odd_kernel<<<grid, kTileThreads, 0, s>>>(
        pf, gf, dot, active, def, n, hw);
  }
  return cudaGetLastError();
}

// Split rows, forward launch 1: `stats` (B * N * 2 floats) gets each row's
// (max, sum of exp) over this rank's pixels.
extern "C" int tpuseg_masked_softmax_stats(const void* e, const void* mask,
                                           void* stats, int b, int n, int hw,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  masked_softmax_stats_kernel<<<b * n, kThreads, 0, s>>>(
      static_cast<const float*>(e), static_cast<const float*>(mask),
      static_cast<float*>(stats), n, hw);
  return cudaGetLastError();
}

// Split rows, forward launch 2: p from the rows' combined (max, sum).
extern "C" int tpuseg_masked_softmax_apply(const void* e, const void* mask,
                                           const void* stats, void* p, int b,
                                           int n, int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((hw + kApplyThreads - 1) / kApplyThreads, b * n);
  masked_softmax_apply_kernel<<<grid, kApplyThreads, 0, s>>>(
      static_cast<const float*>(e), static_cast<const float*>(mask),
      static_cast<const float*>(stats), static_cast<float*>(p), n, hw);
  return cudaGetLastError();
}

// Split rows, backward launch 1: this rank's share of each row's dot and
// its active flag into `scratch` (the dots, then the flags as ints).
extern "C" int tpuseg_masked_softmax_bwd_rows(const void* p, const void* g,
                                              void* scratch, int b, int n,
                                              int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dot = static_cast<float*>(scratch);
  int* active = reinterpret_cast<int*>(dot + static_cast<size_t>(b) * n);
  masked_softmax_dot_kernel<<<b * n, kThreads, 0, s>>>(
      static_cast<const float*>(p), static_cast<const float*>(g), dot, active,
      hw);
  return cudaGetLastError();
}

// Split rows, backward launch 2: de from the global dots and flags in
// `scratch` (laid out as bwd_rows writes it).
extern "C" int tpuseg_masked_softmax_bwd_tiles(const void* p, const void* g,
                                               const void* scratch, void* de,
                                               int b, int n, int hw,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  const float* dot = static_cast<const float*>(scratch);
  const int* active =
      reinterpret_cast<const int*>(dot + static_cast<size_t>(b) * n);
  float* def = static_cast<float*>(de);
  if (hw % 4 == 0) {
    dim3 grid((hw / 4 + kTileThreads - 1) / kTileThreads, b);
    masked_softmax_bwd_kernel<<<grid, kTileThreads, 0, s>>>(pf, gf, dot,
                                                            active, def, n,
                                                            hw);
  } else {
    dim3 grid((hw + 4 * kTileThreads - 1) / (4 * kTileThreads), b);
    masked_softmax_bwd_odd_kernel<<<grid, kTileThreads, 0, s>>>(
        pf, gf, dot, active, def, n, hw);
  }
  return cudaGetLastError();
}
