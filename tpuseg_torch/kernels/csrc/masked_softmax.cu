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
// (B*HW*4 + B*N*HW*8) / 3.35 TB/s.
//
// Design.  It computes what the TPU kernel computes but not its blocking: the
// TPU kernel holds a whole (HW/128, 128) row in VMEM per grid cell; a row at
// full width is 65536 floats = 256 KB, more than a block's 227 KB of shared
// memory, so a row is streamed twice instead.  One thread block owns one
// (batch, instance) row:
//   pass 1  every thread keeps a running (max, sum of exp(x - max)) over its
//           masked elements (online softmax), then the block combines the
//           pairs: warp shuffles, one shared-memory step across warps;
//   pass 2  re-reads e and the mask (L2 hits for e) and writes
//           p = exp(e - max) / sum.
// Rows whose length is a multiple of 4 move as 16-byte vectors.  The backward
// is two launches: one block per row for dot, then a kernel over pixel tiles
// that loops over the N instances in order, coalesced along HW.  No atomics:
// the sum over instances has a fixed order, so the gradient is the same from
// run to run.  Later work: skip all-zero rows of g (training touches only the
// chosen instance of each sample) and fuse the dot into the tile kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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
    MaxSum b{__shfl_xor_sync(0xffffffffu, a.m, o),
             __shfl_xor_sync(0xffffffffu, a.s, o)};
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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += part[w];
  return r;
}

// grid: B * N blocks, one per (batch, instance) row.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
masked_softmax_fwd_kernel(const float* __restrict__ e,
                          const float* __restrict__ mask,
                          float* __restrict__ p, int n_ins, int hw) {
  const int row = blockIdx.x;
  const float* er = e + static_cast<size_t>(row / n_ins) * hw;
  const float* mr = mask + static_cast<size_t>(row) * hw;
  float* pr = p + static_cast<size_t>(row) * hw;

  MaxSum acc{kNeg, 0.f};
  if (VEC) {
    const float4* e4 = reinterpret_cast<const float4*>(er);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    for (int i = threadIdx.x; i < (hw >> 2); i += kThreads) {
      const float4 ev = __ldg(e4 + i);
      const float4 mv = __ldg(m4 + i);
      if (mv.x > 0) push(acc, ev.x);
      if (mv.y > 0) push(acc, ev.y);
      if (mv.z > 0) push(acc, ev.z);
      if (mv.w > 0) push(acc, ev.w);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads)
      if (mr[i] > 0) push(acc, er[i]);
  }
  acc = block_combine(acc);
  const float mx = acc.m;
  const float inv = acc.s > 0.f ? 1.f / acc.s : 0.f;

  if (VEC) {
    const float4* e4 = reinterpret_cast<const float4*>(er);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    float4* p4 = reinterpret_cast<float4*>(pr);
    for (int i = threadIdx.x; i < (hw >> 2); i += kThreads) {
      const float4 ev = __ldg(e4 + i);
      const float4 mv = __ldg(m4 + i);
      float4 o;
      o.x = mv.x > 0 ? expf(ev.x - mx) * inv : 0.f;
      o.y = mv.y > 0 ? expf(ev.y - mx) * inv : 0.f;
      o.z = mv.z > 0 ? expf(ev.z - mx) * inv : 0.f;
      o.w = mv.w > 0 ? expf(ev.w - mx) * inv : 0.f;
      p4[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads)
      pr[i] = mr[i] > 0 ? expf(er[i] - mx) * inv : 0.f;
  }
}

// grid: B * N blocks; dot[row] = sum_hw p * g.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
masked_softmax_dot_kernel(const float* __restrict__ p,
                          const float* __restrict__ g,
                          float* __restrict__ dot, int hw) {
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  float acc = 0.f;
  if (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(p + base);
    const float4* g4 = reinterpret_cast<const float4*>(g + base);
    for (int i = threadIdx.x; i < (hw >> 2); i += kThreads) {
      const float4 a = __ldg(p4 + i);
      const float4 b = __ldg(g4 + i);
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads)
      acc += p[base + i] * g[base + i];
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) dot[blockIdx.x] = acc;
}

constexpr int kTileThreads = 256;

// grid: (pixel tiles, B); de[b, hw] = sum_n p * (g - dot[b, n]), n in order.
template <bool VEC>
__global__ void __launch_bounds__(kTileThreads)
masked_softmax_bwd_kernel(const float* __restrict__ p,
                          const float* __restrict__ g,
                          const float* __restrict__ dot,
                          float* __restrict__ de, int n_ins, int hw) {
  const int b = blockIdx.y;
  const size_t sample = static_cast<size_t>(b) * n_ins * hw;
  const float* dr = dot + static_cast<size_t>(b) * n_ins;
  const int i = blockIdx.x * kTileThreads + threadIdx.x;
  if (VEC) {
    if (i >= (hw >> 2)) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < n_ins; ++n) {
      const size_t off = sample + static_cast<size_t>(n) * hw;
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + off) + i);
      const float4 c = __ldg(reinterpret_cast<const float4*>(g + off) + i);
      const float d = __ldg(dr + n);
      acc.x += a.x * (c.x - d);
      acc.y += a.y * (c.y - d);
      acc.z += a.z * (c.z - d);
      acc.w += a.w * (c.w - d);
    }
    reinterpret_cast<float4*>(de + static_cast<size_t>(b) * hw)[i] = acc;
  } else {
    if (i >= hw) return;
    float acc = 0.f;
    for (int n = 0; n < n_ins; ++n) {
      const size_t off = sample + static_cast<size_t>(n) * hw + i;
      acc += p[off] * (g[off] - __ldg(dr + n));
    }
    de[static_cast<size_t>(b) * hw + i] = acc;
  }
}

}  // namespace

// Vector paths need rows that start 16-byte aligned: HW a multiple of 4 (the
// wrapper checks the base pointers).
extern "C" int tpuseg_masked_softmax_fwd(const void* e, const void* mask,
                                         void* p, int b, int n, int hw,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ef = static_cast<const float*>(e);
  const float* mf = static_cast<const float*>(mask);
  float* pf = static_cast<float*>(p);
  if ((hw % 4) == 0)
    masked_softmax_fwd_kernel<true><<<b * n, kThreads, 0, s>>>(ef, mf, pf, n,
                                                               hw);
  else
    masked_softmax_fwd_kernel<false><<<b * n, kThreads, 0, s>>>(ef, mf, pf, n,
                                                                hw);
  return cudaGetLastError();
}

// Two launches: dot (B * N floats of scratch), then de.
extern "C" int tpuseg_masked_softmax_bwd(const void* p, const void* g,
                                         void* dot, void* de, int b, int n,
                                         int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (hw % 4) == 0;
  const float* pf = static_cast<const float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* df = static_cast<float*>(dot);
  float* ef = static_cast<float*>(de);
  if (vec)
    masked_softmax_dot_kernel<true><<<b * n, kThreads, 0, s>>>(pf, gf, df, hw);
  else
    masked_softmax_dot_kernel<false><<<b * n, kThreads, 0, s>>>(pf, gf, df, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = vec ? hw >> 2 : hw;
  dim3 grid((cols + kTileThreads - 1) / kTileThreads, b);
  if (vec)
    masked_softmax_bwd_kernel<true><<<grid, kTileThreads, 0, s>>>(
        pf, gf, df, ef, n, hw);
  else
    masked_softmax_bwd_kernel<false><<<grid, kTileThreads, 0, s>>>(
        pf, gf, df, ef, n, hw);
  return cudaGetLastError();
}
