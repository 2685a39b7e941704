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
// A column is one (batch, direction, hidden) index, col = (b*ndir + dir)*d
// + j; at step t its element sits at t*N + col (N = B*ndir*d) in every
// (L, B, ...) tensor, and at (t*N + col)*k in u.  Direction 1 scans time
// reversed.
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
// one 16-byte vector.  The forward writes every c_t, so the backward reads
// c_{t-1} back instead of recomputing it, and recomputes the gates from it.
// The backward walks time the other way, carrying dc and four per-column
// partial sums (d weight_c, d bias); a second launch sums them over the batch
// in a fixed order: no atomics, so the weight gradients are bit-equal from
// run to run.  Later work: prefetch several steps of u into registers, so
// that enough bytes are in flight with ~7 warps per SM at B*d = 29120.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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
  int col, b, dir, j;
  float fw, rw, fb, rb, mc;
};

__device__ __forceinline__ bool column(Column& c, const float* weight_c,
                                       const float* bias, const float* mask_c,
                                       int n_cols, int d, int ndir) {
  c.col = blockIdx.x * blockDim.x + threadIdx.x;
  if (c.col >= n_cols) return false;
  c.j = c.col % d;
  c.dir = (c.col / d) % ndir;
  c.b = c.col / (ndir * d);
  const int f = c.dir * d + c.j, r = (ndir + c.dir) * d + c.j;
  c.fw = weight_c[f];
  c.rw = weight_c[r];
  c.fb = bias[f];
  c.rb = bias[r];
  c.mc = mask_c ? mask_c[c.col] : 1.f;
  return true;
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
  const int n_cols = batch * ndir * d;
  Column cl;
  if (!column(cl, weight_c, bias, mask_c, n_cols, d, ndir)) return;
  const bool rev = cl.dir == 1;
  float c = c0 ? c0[cl.col] : 0.f;
  for (int s = 0; s < length; ++s) {
    const int t = rev ? length - 1 - s : s;
    const size_t i = static_cast<size_t>(t) * n_cols + cl.col;
    const float4 ut = load_u<K>(u, i);
    const float f = sigmoid(ut.y + cl.fb + c * cl.fw);
    const float r = sigmoid(ut.z + cl.rb + c * cl.rw);
    float ct = ut.x + (c - ut.x) * f;
    float keep = 1.f;
    if (mask_pad) {
      const float p = mask_pad[static_cast<size_t>(t) * batch + cl.b];
      keep = 1.f - p;
      ct = ct * keep + c * p;
    }
    const float g = act<ACT>(ct) * cl.mc;
    float ht;
    if (has_skip) {
      const float xp = K == 4 ? ut.w : __ldg(x + i) * scale_x;
      ht = xp + (g - xp) * r;
    } else {
      ht = g * r;
    }
    if (mask_pad) ht *= keep;
    h[i] = ht;
    c_all[i] = ct;
    c = ct;
  }
  c_final[cl.col] = c;
}

// part: (4, N) per-column partials of d fw, d rw, d fb, d rb.
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
               float* __restrict__ gc0, int length, int batch, int d,
               int ndir, int has_skip, float scale_x) {
  const int n_cols = batch * ndir * d;
  Column cl;
  if (!column(cl, weight_c, bias, mask_c, n_cols, d, ndir)) return;
  const bool rev = cl.dir == 1;
  const float c0v = c0 ? c0[cl.col] : 0.f;
  float gc = gc_final[cl.col];
  float afw = 0.f, arw = 0.f, afb = 0.f, arb = 0.f;
  // the forward's steps in reverse: direction 0 from t = L-1 down to 0,
  // direction 1 from t = 0 up; c_{t-1} is the state the forward held
  // before step t (c0 before its first step)
  float c = c_all[static_cast<size_t>(rev ? 0 : length - 1) * n_cols +
                  cl.col];
  for (int s = 0; s < length; ++s) {
    const int t = rev ? s : length - 1 - s;
    const size_t i = static_cast<size_t>(t) * n_cols + cl.col;
    const bool first = rev ? t == length - 1 : t == 0;
    const float cp =
        first ? c0v
              : c_all[static_cast<size_t>(rev ? t + 1 : t - 1) * n_cols +
                      cl.col];
    const float4 ut = load_u<K>(u, i);
    const float f = sigmoid(ut.y + cl.fb + cp * cl.fw);
    const float r = sigmoid(ut.z + cl.rb + cp * cl.rw);
    float p = 0.f, ght = gh[i];
    if (mask_pad) {
      p = mask_pad[static_cast<size_t>(t) * batch + cl.b];
      ght *= 1.f - p;
    }
    const float gv = act<ACT>(c);
    const float g = gv * cl.mc;
    float dr, gxp = 0.f;
    if (has_skip) {
      const float xp = K == 4 ? ut.w : __ldg(x + i) * scale_x;
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
      float* q = gu + i * 3;
      q[0] = du0;
      q[1] = du1;
      q[2] = du2;
      if (gx) gx[i] = gxp * scale_x;
    }
    c = cp;
  }
  gc0[cl.col] = gc;
  part[cl.col] = afw;
  part[n_cols + cl.col] = arw;
  part[2 * n_cols + cl.col] = afb;
  part[3 * n_cols + cl.col] = arb;
}

// out (4, ndir, d) = part (4, B, ndir, d) summed over the batch, b = 0..B-1
// in order: out[0:2] is d weight_c, out[2:4] d bias.
__global__ void __launch_bounds__(kThreads)
sru_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int batch, int width) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= 4 * width) return;
  const int which = o / width, rem = o % width;
  const float* p = part + static_cast<size_t>(which) * batch * width + rem;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += p[static_cast<size_t>(b) * width];
  out[o] = acc;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int K, int ACT>
void launch_fwd(const float* u, const float* x, const float* wc,
                const float* bias, const float* c0, const float* mc,
                const float* mp, float* h, float* c_all, float* cf, int length,
                int batch, int d, int ndir, int has_skip, float scale_x,
                cudaStream_t s) {
  sru_fwd_kernel<K, ACT><<<blocks(batch * ndir * d), kThreads, 0, s>>>(
      u, x, wc, bias, c0, mc, mp, h, c_all, cf, length, batch, d, ndir,
      has_skip, scale_x);
}

template <int K, int ACT>
void launch_bwd(const float* u, const float* x, const float* wc,
                const float* bias, const float* c0, const float* mc,
                const float* mp, const float* c_all, const float* gh,
                const float* gcf, float* gu, float* gx, float* part,
                float* gc0, int length, int batch, int d, int ndir,
                int has_skip, float scale_x, cudaStream_t s) {
  sru_bwd_kernel<K, ACT><<<blocks(batch * ndir * d), kThreads, 0, s>>>(
      u, x, wc, bias, c0, mc, mp, c_all, gh, gcf, gu, gx, part, gc0, length,
      batch, d, ndir, has_skip, scale_x);
}

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

template <int K, int ACT>
struct Fwd {
  template <typename... A>
  static void run(A... a) { launch_fwd<K, ACT>(a...); }
};

template <int K, int ACT>
struct Bwd {
  template <typename... A>
  static void run(A... a) { launch_bwd<K, ACT>(a...); }
};

}  // namespace

// Pointers may be null for c0 (zeros), mask_c (ones) and mask_pad (no
// padding); x may be null unless k = 3 with the skip term.  Returns a
// cudaError_t (cudaErrorInvalidValue for k or activation out of range).
extern "C" int tpuseg_sru_fwd(const void* u, const void* x,
                              const void* weight_c, const void* bias,
                              const void* c0, const void* mask_c,
                              const void* mask_pad, void* h, void* c_all,
                              void* c_final, int length, int batch, int d,
                              int k, int ndir, int activation, int has_skip,
                              float scale_x, void* stream) {
  const bool ok = dispatch<Fwd>(
      k, activation, static_cast<const float*>(u),
      static_cast<const float*>(x), static_cast<const float*>(weight_c),
      static_cast<const float*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(mask_c), static_cast<const float*>(mask_pad),
      static_cast<float*>(h), static_cast<float*>(c_all),
      static_cast<float*>(c_final), length, batch, d, ndir, has_skip, scale_x,
      static_cast<cudaStream_t>(stream));
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Two launches: the reverse-time scan, writing du (L, B, ndir, d, k), dx
// (L, B, ndir*d; k = 3 with the skip term, else pass null), dc0 (B, ndir*d)
// and the partials (4 * B*ndir*d floats of scratch); then the batch sum
// into dwb (4 * ndir*d): d weight_c, then d bias.
extern "C" int tpuseg_sru_bwd(const void* u, const void* x,
                              const void* weight_c, const void* bias,
                              const void* c0, const void* mask_c,
                              const void* mask_pad, const void* c_all,
                              const void* gh, const void* gc_final, void* gu,
                              void* gx, void* part, void* gc0, void* dwb,
                              int length, int batch, int d, int k, int ndir,
                              int activation, int has_skip, float scale_x,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch<Bwd>(
      k, activation, static_cast<const float*>(u),
      static_cast<const float*>(x), static_cast<const float*>(weight_c),
      static_cast<const float*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(mask_c), static_cast<const float*>(mask_pad),
      static_cast<const float*>(c_all), static_cast<const float*>(gh),
      static_cast<const float*>(gc_final), static_cast<float*>(gu),
      static_cast<float*>(gx), static_cast<float*>(part),
      static_cast<float*>(gc0), length, batch, d, ndir, has_skip, scale_x, s);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = ndir * d;
  sru_reduce_kernel<<<blocks(4 * width), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dwb), batch, width);
  return cudaGetLastError();
}
