// SRU elementwise recurrence over time, forward and backward (Hopper).
//
// Replaces the TPU kernels of tpuseg/kernels/sru_scan.py: the forward
// (_fwd_kernel, reached by sru_scan_pallas and sru_scan_fused through _fwd)
// and the backward (_bwd_kernel, under _fused_bwd, whose per-column weight
// partials the JAX wrapper sums over the batch).
//
// Layout (the port's natural one, no repacking):
//   u (L, B, ndir, d, k) f32, k in {3, 4}, k innermost;  x (L, B, n_in);
//   weight_c, bias (2, ndir, d): the f half, then the r half;
//   c0, mask_c (B, ndir, d);  mask_pad (L, B), 1 = padded step;
//   h, c_all (L, B, ndir, d);  c_final (B, ndir, d).
// A column is one (batch, direction, hidden) index, col = b*W + o with
// W = ndir*d and o = dir*d + j; at step t its element sits at t*N + col
// (N = B*W) in every (L, B, ...) tensor, and at (t*N + col)*k in u.
// Direction 1 scans time reversed.
//
//   f_t = sigmoid(u1 + fb + c_{t-1} * fw)
//   r_t = sigmoid(u2 + rb + c_{t-1} * rw)
//   c~  = u0 + (c_{t-1} - u0) * f_t,      c_t = c~ (1 - p) + c_{t-1} p
//   h_t = (x' + (g(c_t) mc - x') r_t) (1 - p)
//       = g(c_t) mc r_t (1 - p)               (without the skip term)
// with x' = u3 (k = 4) or x * scale_x (k = 3), g = id / tanh / relu, p the
// pad flag of (t, b) (0 without mask_pad), mc the dropout mask (1 without).
//
// Bound on the card: bytes.  Per column and step the forward reads u (12 or
// 16 B) and x' (4 B when it comes from x) and writes h and c (8 B) against
// ~30 operations; the backward reads u, x, c and the cotangent of h and
// writes du (and dx), ~40 B.  At the language-model width (B = 32,
// d = 910) that is 24.5 MB per forward layer at L = 35: 7.3 us at 3.35 TB/s.
//
// Design.  One thread per column walks the L steps, keeping c in a register
// (the CUDA kernels of the SRU paper do the same; the TPU kernel instead
// packs columns direction-major into 128-lane rows, three extra passes over u
// that this card has no reason for).  Neighbouring threads hold neighbouring
// columns, so every step's loads and stores are coalesced; k = 4 rows move as
// one 16-byte vector.  The dependent chain through c leaves the loads idle,
// and with B*W = 29120 columns an SM holds only ~7 warps, so each thread
// loads kPrefetch steps ahead into a ring of registers: the step's inputs
// arrive while earlier steps compute.  The grid is (W / kThreads, B): small
// blocks spread the columns over all 132 SMs.  The forward writes every c_t,
// so the backward reads c_{t-1} back instead of recomputing it, and
// recomputes the gates from it.  The backward walks time the other way,
// carrying dc and four per-column partial sums (d weight_c, d bias); the
// last block of each column slice to finish (an arrival counter per slice)
// sums the partials of its slice over the batch, b = 0..B-1 in order, and
// resets the counter: one launch, no atomics on the values, so the weight
// gradients are bit-equal from run to run.

#include <cuda_runtime.h>

// threads per block (32 and 128 measured the same at the LM width) and
// steps loaded ahead (2 slower; 8 spills nothing but needs 140-150
// registers in the backward, which costs the bidirectional case a wave)
#ifndef SRU_THREADS
#define SRU_THREADS 64
#endif
#ifndef SRU_PREFETCH
#define SRU_PREFETCH 4
#endif

namespace {

constexpr int kThreads = SRU_THREADS;
constexpr int kPrefetch = SRU_PREFETCH;  // steps loaded ahead

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int ACT>
__device__ __forceinline__ float act(float c) {
  if (ACT == 1) return tanhf(c);
  if (ACT == 2) return fmaxf(c, 0.f);
  return c;
}

// g'(c), given c and g(c)
template <int ACT>
__device__ __forceinline__ float act_grad(float c, float g) {
  if (ACT == 1) return 1.f - g * g;
  if (ACT == 2) return c > 0.f ? 1.f : 0.f;
  return 1.f;
}

template <int K>
__device__ __forceinline__ float4 load_u(const float* __restrict__ u,
                                         size_t i) {
  if (K == 4) return __ldg(reinterpret_cast<const float4*>(u) + i);
  const float* p = u + i * 3;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
}

struct Column {
  int o, b, dir;
  size_t col;
  bool live;
  float fw, rw, fb, rb, mc;
};

// grid (slices of W, B): this thread's column, `live` false past W
__device__ __forceinline__ Column column(const float* weight_c,
                                         const float* bias,
                                         const float* mask_c, int width,
                                         int d) {
  Column c;
  c.o = blockIdx.x * kThreads + threadIdx.x;
  c.b = blockIdx.y;
  c.live = c.o < width;
  const int o = c.live ? c.o : 0;
  c.dir = o / d;
  c.col = static_cast<size_t>(c.b) * width + o;
  c.fw = weight_c[o];
  c.rw = weight_c[width + o];
  c.fb = bias[o];
  c.rb = bias[width + o];
  c.mc = mask_c ? mask_c[c.col] : 1.f;
  return c;
}

// One step's inputs.
struct Step {
  float4 u;
  float x, pad, gh, cp;
};

template <int K>
__device__ __forceinline__ void load_fwd(Step& in, const float* u,
                                         const float* x, const float* pad,
                                         int t, size_t n_cols, size_t col,
                                         int batch, int b) {
  const size_t i = static_cast<size_t>(t) * n_cols + col;
  in.u = load_u<K>(u, i);
  in.x = x ? __ldg(x + i) : 0.f;
  in.pad = pad ? __ldg(pad + static_cast<size_t>(t) * batch + b) : 0.f;
}

template <int K, int ACT>
__global__ void __launch_bounds__(kThreads)
sru_fwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
               const float* __restrict__ weight_c,
               const float* __restrict__ bias, const float* __restrict__ c0,
               const float* __restrict__ mask_c,
               const float* __restrict__ mask_pad, float* __restrict__ h,
               float* __restrict__ c_all, float* __restrict__ c_final,
               int length, int batch, int d, int ndir, int has_skip,
               float scale_x) {
  const int width = ndir * d;
  const size_t n_cols = static_cast<size_t>(batch) * width;
  const Column cl = column(weight_c, bias, mask_c, width, d);
  if (!cl.live) return;
  const bool rev = cl.dir == 1;
  const float* xs = has_skip && K == 3 ? x : nullptr;
  Step ring[kPrefetch];
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q)
    if (q < length)
      load_fwd<K>(ring[q], u, xs, mask_pad, rev ? length - 1 - q : q, n_cols,
                  cl.col, batch, cl.b);
  float c = c0 ? c0[cl.col] : 0.f;
  for (int s0 = 0; s0 < length; s0 += kPrefetch) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int s = s0 + q;
      if (s >= length) break;
      const Step in = ring[q];
      const int nx = s + kPrefetch;
      if (nx < length)
        load_fwd<K>(ring[q], u, xs, mask_pad, rev ? length - 1 - nx : nx,
                    n_cols, cl.col, batch, cl.b);
      const int t = rev ? length - 1 - s : s;
      const size_t i = static_cast<size_t>(t) * n_cols + cl.col;
      const float4 ut = in.u;
      const float f = sigmoid(ut.y + cl.fb + c * cl.fw);
      const float r = sigmoid(ut.z + cl.rb + c * cl.rw);
      float ct = ut.x + (c - ut.x) * f;
      float keep = 1.f;
      if (mask_pad) {
        const float p = in.pad;
        keep = 1.f - p;
        ct = ct * keep + c * p;
      }
      const float g = act<ACT>(ct) * cl.mc;
      float ht;
      if (has_skip) {
        const float xp = K == 4 ? ut.w : in.x * scale_x;
        ht = xp + (g - xp) * r;
      } else {
        ht = g * r;
      }
      if (mask_pad) ht *= keep;
      h[i] = ht;
      c_all[i] = ct;
      c = ct;
    }
  }
  c_final[cl.col] = c;
}

template <int K>
__device__ __forceinline__ void load_bwd(Step& in, const float* u,
                                         const float* x, const float* pad,
                                         const float* c_all, const float* gh,
                                         float c0v, int t, bool rev,
                                         int length, size_t n_cols,
                                         size_t col, int batch, int b) {
  load_fwd<K>(in, u, x, pad, t, n_cols, col, batch, b);
  in.gh = __ldg(gh + static_cast<size_t>(t) * n_cols + col);
  // c_{t-1}: the state the forward held before step t (c0 before its first)
  const bool first = rev ? t == length - 1 : t == 0;
  in.cp = first ? c0v
                : __ldg(c_all + static_cast<size_t>(rev ? t + 1 : t - 1) *
                                    n_cols + col);
}

// part: (4, N) per-column partials of d fw, d rw, d fb, d rb; dwb (4, W)
// their batch sums; counters: one per column slice, zero on entry and on
// exit.
template <int K, int ACT>
__global__ void __launch_bounds__(kThreads)
sru_bwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
               const float* __restrict__ weight_c,
               const float* __restrict__ bias, const float* __restrict__ c0,
               const float* __restrict__ mask_c,
               const float* __restrict__ mask_pad,
               const float* __restrict__ c_all, const float* __restrict__ gh,
               const float* __restrict__ gc_final, float* __restrict__ gu,
               float* __restrict__ gx, float* __restrict__ part,
               float* __restrict__ gc0, float* __restrict__ dwb,
               unsigned* __restrict__ counters, int length, int batch, int d,
               int ndir, int has_skip, float scale_x) {
  const int width = ndir * d;
  const size_t n_cols = static_cast<size_t>(batch) * width;
  const Column cl = column(weight_c, bias, mask_c, width, d);
  if (cl.live) {
    const bool rev = cl.dir == 1;
    const float* xs = has_skip && K == 3 ? x : nullptr;
    const float c0v = c0 ? c0[cl.col] : 0.f;
    float gc = gc_final[cl.col];
    float afw = 0.f, arw = 0.f, afb = 0.f, arb = 0.f;
    // the forward's steps in reverse: direction 0 from t = L-1 down to 0,
    // direction 1 from t = 0 up
    Step ring[kPrefetch];
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q)
      if (q < length)
        load_bwd<K>(ring[q], u, xs, mask_pad, c_all, gh, c0v,
                    rev ? q : length - 1 - q, rev, length, n_cols, cl.col,
                    batch, cl.b);
    float c = c_all[static_cast<size_t>(rev ? 0 : length - 1) * n_cols +
                    cl.col];
    for (int s0 = 0; s0 < length; s0 += kPrefetch) {
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q) {
        const int s = s0 + q;
        if (s >= length) break;
        const Step in = ring[q];
        const int nx = s + kPrefetch;
        if (nx < length)
          load_bwd<K>(ring[q], u, xs, mask_pad, c_all, gh, c0v,
                      rev ? nx : length - 1 - nx, rev, length, n_cols, cl.col,
                      batch, cl.b);
        const int t = rev ? s : length - 1 - s;
        const size_t i = static_cast<size_t>(t) * n_cols + cl.col;
        const float cp = in.cp;
        const float4 ut = in.u;
        const float f = sigmoid(ut.y + cl.fb + cp * cl.fw);
        const float r = sigmoid(ut.z + cl.rb + cp * cl.rw);
        float p = 0.f, ght = in.gh;
        if (mask_pad) {
          p = in.pad;
          ght *= 1.f - p;
        }
        const float gv = act<ACT>(c);
        const float g = gv * cl.mc;
        float dr, gxp = 0.f;
        if (has_skip) {
          const float xp = K == 4 ? ut.w : in.x * scale_x;
          dr = ght * (g - xp);
          gxp = ght * (1.f - r);
        } else {
          dr = ght * g;
        }
        const float gct = ght * r * cl.mc * act_grad<ACT>(c, gv) + gc;
        const float gcc = gct * (1.f - p);  // through c~
        const float du0 = gcc * (1.f - f);
        const float du1 = gcc * (cp - ut.x) * f * (1.f - f);
        const float du2 = dr * r * (1.f - r);
        gc = gcc * f + du1 * cl.fw + du2 * cl.rw + gct * p;
        afw += du1 * cp;
        arw += du2 * cp;
        afb += du1;
        arb += du2;
        if (K == 4) {
          reinterpret_cast<float4*>(gu)[i] = make_float4(du0, du1, du2, gxp);
        } else {
          float* q3 = gu + i * 3;
          q3[0] = du0;
          q3[1] = du1;
          q3[2] = du2;
          if (gx) gx[i] = gxp * scale_x;
        }
        c = cp;
      }
    }
    gc0[cl.col] = gc;
    part[cl.col] = afw;
    part[n_cols + cl.col] = arw;
    part[2 * n_cols + cl.col] = afb;
    part[3 * n_cols + cl.col] = arb;
  }
  // the batch sum of this slice's partials, by the slice's last block
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (cl.live) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    const float* q = part + cl.o;
    for (int b = 0; b < batch; ++b) {
      const size_t at = static_cast<size_t>(b) * width;
      s0 += __ldcg(q + at);
      s1 += __ldcg(q + n_cols + at);
      s2 += __ldcg(q + 2 * n_cols + at);
      s3 += __ldcg(q + 3 * n_cols + at);
    }
    dwb[cl.o] = s0;
    dwb[width + cl.o] = s1;
    dwb[2 * width + cl.o] = s2;
    dwb[3 * width + cl.o] = s3;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0u;
}

inline dim3 grid(int batch, int width) {
  return dim3((width + kThreads - 1) / kThreads, batch);
}

template <int K, int ACT>
struct Fwd {
  template <typename... A>
  static void run(int batch, int width, cudaStream_t s, A... a) {
    sru_fwd_kernel<K, ACT><<<grid(batch, width), kThreads, 0, s>>>(a...);
  }
};

template <int K, int ACT>
struct Bwd {
  template <typename... A>
  static void run(int batch, int width, cudaStream_t s, A... a) {
    sru_bwd_kernel<K, ACT><<<grid(batch, width), kThreads, 0, s>>>(a...);
  }
};

// the (k, activation) instance; false for a pair the kernels do not take
template <template <int, int> class F, typename... A>
bool dispatch(int k, int activation, A... args) {
  switch (k * 4 + activation) {
    case 12: F<3, 0>::run(args...); return true;
    case 13: F<3, 1>::run(args...); return true;
    case 14: F<3, 2>::run(args...); return true;
    case 16: F<4, 0>::run(args...); return true;
    case 17: F<4, 1>::run(args...); return true;
    case 18: F<4, 2>::run(args...); return true;
    default: return false;
  }
}

}  // namespace

// Pointers may be null for c0 (zeros), mask_c (ones) and mask_pad (no
// padding); x may be null unless k = 3 with the skip term.  Returns a
// cudaError_t (cudaErrorInvalidValue for k or activation out of range, or a
// batch beyond the grid's 65535 rows).
extern "C" int tpuseg_sru_fwd(const void* u, const void* x,
                              const void* weight_c, const void* bias,
                              const void* c0, const void* mask_c,
                              const void* mask_pad, void* h, void* c_all,
                              void* c_final, int length, int batch, int d,
                              int k, int ndir, int activation, int has_skip,
                              float scale_x, void* stream) {
  if (batch > 65535) return cudaErrorInvalidValue;
  const bool ok = dispatch<Fwd>(
      k, activation, batch, ndir * d, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(u), static_cast<const float*>(x),
      static_cast<const float*>(weight_c), static_cast<const float*>(bias),
      static_cast<const float*>(c0), static_cast<const float*>(mask_c),
      static_cast<const float*>(mask_pad), static_cast<float*>(h),
      static_cast<float*>(c_all), static_cast<float*>(c_final), length,
      batch, d, ndir, has_skip, scale_x);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// One launch: the reverse-time scan, writing du (L, B, ndir, d, k), dx
// (L, B, ndir*d; k = 3 with the skip term, else pass null), dc0 (B, ndir*d),
// the partials (4 * B*ndir*d floats of scratch) and their batch sum dwb
// (4 * ndir*d): d weight_c, then d bias.  `counters`: at least ndir*d
// zeroed uint32, left zeroed; calls that share them must be stream-ordered.
extern "C" int tpuseg_sru_bwd(const void* u, const void* x,
                              const void* weight_c, const void* bias,
                              const void* c0, const void* mask_c,
                              const void* mask_pad, const void* c_all,
                              const void* gh, const void* gc_final, void* gu,
                              void* gx, void* part, void* gc0, void* dwb,
                              void* counters, int length, int batch, int d,
                              int k, int ndir, int activation, int has_skip,
                              float scale_x, void* stream) {
  if (batch > 65535) return cudaErrorInvalidValue;
  const bool ok = dispatch<Bwd>(
      k, activation, batch, ndir * d, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(u), static_cast<const float*>(x),
      static_cast<const float*>(weight_c), static_cast<const float*>(bias),
      static_cast<const float*>(c0), static_cast<const float*>(mask_c),
      static_cast<const float*>(mask_pad), static_cast<const float*>(c_all),
      static_cast<const float*>(gh), static_cast<const float*>(gc_final),
      static_cast<float*>(gu), static_cast<float*>(gx),
      static_cast<float*>(part), static_cast<float*>(gc0),
      static_cast<float*>(dwb), static_cast<unsigned*>(counters), length,
      batch, d, ndir, has_skip, scale_x);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
