// Fused inverted-residual block for the pyramid decoder's IR chain (Hopper).
//
// Replaces the TPU kernel tpuseg/kernels/ir_chain.py::ir_chain (Pallas body
// _kernel).  The chain is y = IR4(IR3(IR2(IR1(x)) + x1u)) with
//   IR(v) = v + pw2(relu6(dw3x3(relu6(pw1 v + b1)) + b2)) + b3,
// BatchNorm folded into the weights (fold_ir_params).  This file computes ONE
// block per launch; the Python wrapper launches it four times per chain and
// hands the mid-chain skip x1u to block 3, which adds it while loading.
//
// Bound on the card: per pixel a block does 8 C^2 FLOPs of pointwise products
// and ~50 C float32 operations of depthwise taps, bias, relu6 and residual.
// For the whole chain at the main path's shapes (N = 128 glimpses,
// C = 32..256; input read once, output written once) the bound is
// operations: in bf16 the float32 work on the CUDA cores (67 TFLOP/s) outlasts
// both the tensor-core products (989 TFLOP/s) and memory (3.35 TB/s); in f32
// everything shares the CUDA cores.  One launch per block moves each
// intermediate through device memory, 4x a fused chain's activation bytes.
//
// Design: the 2C hidden never reaches device memory.  A thread block owns a
// TH x TW output tile and keeps the input tile plus a one-pixel halo in
// shared memory.  It walks the hidden channels in chunks of KC:
//   1. h = relu6(x . W1[:, chunk] + b1) on the halo tile, zero outside the
//      image (the depthwise conv's SAME padding pads the hidden with zeros);
//   2. d = relu6(dw3x3(h) + b2) on the output tile;
//   3. acc += d . W2[chunk, :], acc in registers.
// then writes y = v + acc + b3 (v includes x1u).  Shared memory, not
// registers, is what limits the tile: at C = 256, W1 alone is 512 KB in f32,
// so the weights stream through in chunks.
//
// Two paths.  float32 (ir_block_kernel): both products as f32 FMAs on the
// CUDA cores, 8 pixels x 8 channels of accumulator per thread.  bfloat16
// (ir_block_tc_kernel): both products on the tensor cores
// (mma.sync through WMMA, 16x16x16 bf16 tiles, f32 accumulation); the block
// input (x + x1u) and the depthwise output are rounded to bf16 as the
// products' operands, as the TPU kernel rounds its operands to the storage
// type.  The depthwise and the epilogue stay f32.  Later work: one launch for
// the whole chain with row halos, and wgmma/TMA for the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float relu6f(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

template <int C, int TH, int TW, int KC>
struct Tile {
  static constexpr int kHid = 2 * C;
  static constexpr int kHW = TW + 2;             // halo tile width
  static constexpr int kHP = (TH + 2) * kHW;     // halo tile pixels
  static constexpr int kTP = TH * TW;            // output tile pixels
  static constexpr int kXS = C + 1;              // padded rows: odd strides
  static constexpr int kKP = KC + 1;             //   spread smem banks
  // projection register tile: kRP pixels x kRC channels per thread
  static constexpr int kRC = 8;
  static constexpr int kCG = C / kRC;            // channel groups
  static constexpr int kPG = kThreads / kCG;     // pixel groups
  static constexpr int kRP = kTP / kPG;
  // expansion register tile: 4 halo pixels x 4 hidden channels per thread
  static constexpr int kQ4 = kHP / 4;
  static constexpr int kJ4 = KC / 4;
  // shared memory carve-up, in floats
  static constexpr int kOffW1 = kHP * kXS;
  static constexpr int kOffH = kOffW1 + C * KC;
  static constexpr int kOffD = kOffH + kHP * kKP;
  static constexpr int kOffW2 = kOffD + kTP * kKP;
  static constexpr int kOffB1 = kOffW2 + KC * C;
  static constexpr int kOffB2 = kOffB1 + KC;
  static constexpr int kOffWD = kOffB2 + KC;
  static constexpr int kFloats = kOffWD + 9 * KC;
  static constexpr size_t kBytes = sizeof(float) * kFloats;

  static_assert(C % kRC == 0 && kThreads % kCG == 0, "channel split");
  static_assert(kTP % kPG == 0 && kRP >= 1, "pixel split");
  static_assert(kHP % 4 == 0 && KC % 4 == 0 && kHid % KC == 0,
                "expansion split");
  static_assert(kBytes <= 232448, "shared memory per block");
};

template <int C, int TH, int TW, int KC>
__global__ void __launch_bounds__(kThreads, 1)
ir_block_kernel(const float* __restrict__ x, const float* __restrict__ x1u,
                float* __restrict__ y, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ wd,
                const float* __restrict__ b2, const float* __restrict__ w2,
                const float* __restrict__ b3, int H, int W, int tiles_w) {
  using L = Tile<C, TH, TW, KC>;
  extern __shared__ float smem[];
  float* xs = smem;
  float* w1s = smem + L::kOffW1;
  float* hs = smem + L::kOffH;
  float* ds = smem + L::kOffD;
  float* w2s = smem + L::kOffW2;
  float* b1s = smem + L::kOffB1;
  float* b2s = smem + L::kOffB2;
  float* wds = smem + L::kOffWD;

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)blockIdx.y * H * W * C;

  // the block input on the halo tile, zero outside the image; block 3 of
  // the chain adds the mid-chain skip here
  for (int i = tid; i < L::kHP * C; i += kThreads) {
    const int q = i / C, c = i - q * C;
    const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t off = img + ((size_t)gy * W + gx) * C + c;
      v = x[off];
      if (x1u != nullptr) v += x1u[off];
    }
    xs[q * L::kXS + c] = v;
  }

  const int cg = tid % L::kCG, pg = tid / L::kCG;
  float acc[L::kRP][L::kRC];
#pragma unroll
  for (int i = 0; i < L::kRP; ++i)
#pragma unroll
    for (int r = 0; r < L::kRC; ++r) acc[i][r] = 0.f;

  for (int c0 = 0; c0 < L::kHid; c0 += KC) {
    // this hidden chunk's weights: W1 (C, 2C) columns, W2 (2C, C) rows
    for (int i = tid; i < C * KC; i += kThreads) {
      const int k = i / KC, j = i - k * KC;
      w1s[i] = w1[(size_t)k * L::kHid + c0 + j];
      w2s[i] = w2[(size_t)c0 * C + i];
    }
    for (int i = tid; i < KC; i += kThreads) {
      b1s[i] = b1[c0 + i];
      b2s[i] = b2[c0 + i];
    }
    for (int i = tid; i < 9 * KC; i += kThreads) {
      const int t = i / KC, j = i - t * KC;
      wds[i] = wd[t * L::kHid + c0 + j];
    }
    __syncthreads();

    // 1. expansion on the halo tile
    for (int it = tid; it < L::kQ4 * L::kJ4; it += kThreads) {
      const int qg = it / L::kJ4, jg = it - qg * L::kJ4;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) a[i][m] = b1s[jg + m * L::kJ4];
      const float* xr = xs + qg * L::kXS;
#pragma unroll 4
      for (int k = 0; k < C; ++k) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xr[i * L::kQ4 * L::kXS + k];
#pragma unroll
        for (int m = 0; m < 4; ++m) wv[m] = w1s[k * KC + jg + m * L::kJ4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) a[i][m] = fmaf(xv[i], wv[m], a[i][m]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qg + i * L::kQ4;
        const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          hs[q * L::kKP + jg + m * L::kJ4] = inside ? relu6f(a[i][m]) : 0.f;
      }
    }
    __syncthreads();

    // 2. depthwise 3x3 on the output tile
    for (int i = tid; i < L::kTP * KC; i += kThreads) {
      const int p = i / KC, j = i - p * KC;
      const int py = p / TW, px = p - py * TW;
      float s = b2s[j];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          s = fmaf(hs[((py + dy) * L::kHW + px + dx) * L::kKP + j],
                   wds[(dy * 3 + dx) * KC + j], s);
      ds[p * L::kKP + j] = relu6f(s);
    }
    __syncthreads();

    // 3. projection of this chunk into the register accumulators
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float dv[L::kRP], wv[L::kRC];
#pragma unroll
      for (int i = 0; i < L::kRP; ++i) dv[i] = ds[(pg + i * L::kPG) * L::kKP + k];
#pragma unroll
      for (int r = 0; r < L::kRC; ++r) wv[r] = w2s[k * C + cg + r * L::kCG];
#pragma unroll
      for (int i = 0; i < L::kRP; ++i)
#pragma unroll
        for (int r = 0; r < L::kRC; ++r) acc[i][r] = fmaf(dv[i], wv[r], acc[i][r]);
    }
    __syncthreads();
  }

  // residual + b3, store the tile's in-image pixels
#pragma unroll
  for (int i = 0; i < L::kRP; ++i) {
    const int p = pg + i * L::kPG;
    const int py = p / TW, px = p - py * TW;
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= H || gx >= W) continue;
    const float* vr = xs + ((py + 1) * L::kHW + px + 1) * L::kXS;
    float* yr = y + img + ((size_t)gy * W + gx) * C;
#pragma unroll
    for (int r = 0; r < L::kRC; ++r) {
      const int c = cg + r * L::kCG;
      yr[c] = vr[c] + acc[i][r] + b3[c];
    }
  }
}

template <int C, int TH, int TW, int KC>
cudaError_t launch(const void* x, const void* x1u, void* y, const void* w1,
                   const void* b1, const void* wd, const void* b2,
                   const void* w2, const void* b3, int n, int h, int w,
                   cudaStream_t stream) {
  using L = Tile<C, TH, TW, KC>;
  auto kern = ir_block_kernel<C, TH, TW, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, n);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(x1u),
      static_cast<float*>(y), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(b2), static_cast<const float*>(w2),
      static_cast<const float*>(b3), h, w, tiles_w);
  return cudaGetLastError();
}

cudaError_t dispatch(int c, const void* x, const void* x1u, void* y,
                     const void* w1, const void* b1, const void* wd,
                     const void* b2, const void* w2, const void* b3, int n,
                     int h, int w, cudaStream_t s) {
  switch (c) {
    case 256: return launch<256, 8, 8, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 128: return launch<128, 8, 16, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 64: return launch<64, 16, 16, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 32: return launch<32, 16, 32, 16>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path: the two pointwise products on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

template <int C, int TH, int TW, int KC>
struct TcTile {
  static constexpr int kHid = 2 * C;
  static constexpr int kHW = TW + 2;
  static constexpr int kHP = (TH + 2) * kHW;
  static constexpr int kHPp = (kHP + 15) / 16 * 16;  // WMMA row tiles
  static constexpr int kTP = TH * TW;
  static constexpr int kWarps = kThreads / 32;
  // row strides (elements): WMMA wants multiples of 8 (bf16) / 4 (f32);
  // the extra 8 / 4 spread the rows over the shared-memory banks
  static constexpr int kLX = C + 8;    // x tile, bf16
  static constexpr int kLW1 = KC + 8;  // W1 chunk, bf16
  static constexpr int kLH = KC + 4;   // expansion output, f32
  static constexpr int kLD = KC + 8;   // depthwise output, bf16
  static constexpr int kLW2 = C + 8;   // W2 chunk, bf16
  static constexpr int kNT1 = KC / 16;
  static constexpr int kTiles1 = kHPp / 16 * kNT1;   // expansion tiles
  static constexpr int kNT3 = C / 16;
  static constexpr int kTiles3 = kTP / 16 * kNT3;    // accumulator tiles
  static constexpr int kAcc = kTiles3 / kWarps;      // ... per warp
  // shared memory carve-up, in bytes (128-aligned regions)
  static constexpr size_t kOffW1 = align128(2ull * kHPp * kLX);
  static constexpr size_t kOffH = kOffW1 + align128(2ull * C * kLW1);
  static constexpr size_t kOffD = kOffH + align128(4ull * kHPp * kLH);
  static constexpr size_t kOffW2 = kOffD + align128(2ull * kTP * kLD);
  static constexpr size_t kOffS = kOffW2 + align128(2ull * KC * kLW2);
  static constexpr size_t kOffB = kOffS + align128(4ull * kWarps * 256);
  static constexpr size_t kBytes = kOffB + 4ull * 11 * KC;

  static_assert(C % 16 == 0 && KC % 16 == 0 && kHid % KC == 0, "WMMA tiles");
  static_assert(kTP % 16 == 0 && kTiles3 % kWarps == 0, "accumulator split");
  // two blocks per SM (228 KB of shared memory, 1 KB reserved per block)
  static_assert(kBytes <= 113 * 1024, "shared memory for two blocks per SM");
};

template <int C, int TH, int TW, int KC>
__global__ void __launch_bounds__(kThreads, 2)
ir_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ x1u,
                   bf16* __restrict__ y, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ wd,
                   const float* __restrict__ b2, const bf16* __restrict__ w2,
                   const float* __restrict__ b3, int H, int W, int tiles_w) {
  namespace wmma = nvcuda::wmma;
  using L = TcTile<C, TH, TW, KC>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw + L::kOffW1);
  float* hs = reinterpret_cast<float*>(smem_raw + L::kOffH);
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + L::kOffD);
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw + L::kOffW2);
  float* scratch = reinterpret_cast<float*>(smem_raw + L::kOffS);
  float* b1s = reinterpret_cast<float*>(smem_raw + L::kOffB);
  float* b2s = b1s + KC;
  float* wds = b2s + KC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)blockIdx.y * H * W * C;

  // block input (x + x1u, rounded to bf16 once) on the halo tile; zero
  // outside the image and in the padding rows.  16-byte vectors: 8 channels
  constexpr int kCV = C / 8;
  for (int i = tid; i < L::kHPp * kCV; i += kThreads) {
    const int q = i / kCV, c = (i - q * kCV) * 8;
    const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < L::kHP && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t off = img + ((size_t)gy * W + gx) * C + c;
      v = *reinterpret_cast<const uint4*>(x + off);
      if (x1u != nullptr) {
        const uint4 u = *reinterpret_cast<const uint4*>(x1u + off);
        __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&v);
        const __nv_bfloat162* up = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a = __bfloat1622float2(vp[k]);
          const float2 b = __bfloat1622float2(up[k]);
          vp[k] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
        }
      }
    }
    *reinterpret_cast<uint4*>(xs + q * L::kLX + c) = v;
  }

  FragC acc[L::kAcc];
#pragma unroll
  for (int t = 0; t < L::kAcc; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int c0 = 0; c0 < L::kHid; c0 += KC) {
    for (int i = tid; i < C * KC; i += kThreads) {
      const int k = i / KC, j = i - k * KC;
      w1s[k * L::kLW1 + j] = w1[(size_t)k * L::kHid + c0 + j];
      const int jj = i / C, c = i - jj * C;
      w2s[jj * L::kLW2 + c] = w2[(size_t)(c0 + jj) * C + c];
    }
    for (int i = tid; i < KC; i += kThreads) {
      b1s[i] = b1[c0 + i];
      b2s[i] = b2[c0 + i];
    }
    for (int i = tid; i < 9 * KC; i += kThreads) {
      const int t = i / KC, j = i - t * KC;
      wds[i] = wd[t * L::kHid + c0 + j];
    }
    __syncthreads();

    // 1. expansion on the tensor cores: hs = xs . w1s
    for (int t = warp; t < L::kTiles1; t += L::kWarps) {
      const int mt = t / L::kNT1, nt = t - mt * L::kNT1;
      FragC h;
      wmma::fill_fragment(h, 0.f);
#pragma unroll 4
      for (int k = 0; k < C; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, xs + mt * 16 * L::kLX + k, L::kLX);
        wmma::load_matrix_sync(b, w1s + k * L::kLW1 + nt * 16, L::kLW1);
        wmma::mma_sync(h, a, b, h);
      }
      wmma::store_matrix_sync(hs + mt * 16 * L::kLH + nt * 16, h, L::kLH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // + b1, relu6; zero outside the image
    for (int i = tid; i < L::kHP * KC; i += kThreads) {
      const int q = i / KC, j = i - q * KC;
      const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* hp = hs + q * L::kLH + j;
      *hp = inside ? relu6f(*hp + b1s[j]) : 0.f;
    }
    __syncthreads();

    // 2. depthwise 3x3 (f32) -> bf16 operand of the projection.  A thread
    //    walks one output row of one channel, sliding the 3x3 window
    for (int it = tid; it < TH * KC; it += kThreads) {
      const int r = it / KC, j = it - r * KC;
      float w[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = wds[t * KC + j];
      const float bias = b2s[j];
      const float* h0 = hs + r * L::kHW * L::kLH + j;
      const float* h1 = h0 + L::kHW * L::kLH;
      const float* h2 = h1 + L::kHW * L::kLH;
      float a0 = h0[0], a1 = h1[0], a2 = h2[0];
      float m0 = h0[L::kLH], m1 = h1[L::kLH], m2 = h2[L::kLH];
      bf16* dr = ds + r * TW * L::kLD + j;
#pragma unroll 4
      for (int px = 0; px < TW; ++px) {
        const int o = (px + 2) * L::kLH;
        const float c0 = h0[o], c1 = h1[o], c2 = h2[o];
        float s = bias;
        s = fmaf(a0, w[0], s); s = fmaf(m0, w[1], s); s = fmaf(c0, w[2], s);
        s = fmaf(a1, w[3], s); s = fmaf(m1, w[4], s); s = fmaf(c1, w[5], s);
        s = fmaf(a2, w[6], s); s = fmaf(m2, w[7], s); s = fmaf(c2, w[8], s);
        dr[px * L::kLD] = __float2bfloat16(relu6f(s));
        a0 = m0; a1 = m1; a2 = m2;
        m0 = c0; m1 = c1; m2 = c2;
      }
    }
    __syncthreads();

    // 3. projection on the tensor cores: acc += ds . w2s
#pragma unroll
    for (int t = 0; t < L::kAcc; ++t) {
      const int tile = warp + t * L::kWarps;
      const int mt = tile / L::kNT3, nt = tile - mt * L::kNT3;
#pragma unroll
      for (int k = 0; k < KC; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, ds + mt * 16 * L::kLD + k, L::kLD);
        wmma::load_matrix_sync(b, w2s + k * L::kLW2 + nt * 16, L::kLW2);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();
  }

  // residual (the bf16 block input) + b3, through each warp's scratch tile
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int t = 0; t < L::kAcc; ++t) {
    const int tile = warp + t * L::kWarps;
    const int mt = tile / L::kNT3, nt = tile - mt * L::kNT3;
    wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int p = mt * 16 + e / 16, c = nt * 16 + e % 16;
      const int py = p / TW, px = p - py * TW;
      const int gy = y0 + py, gx = x0 + px;
      if (gy < H && gx < W) {
        const float v = __bfloat162float(
            xs[((py + 1) * L::kHW + px + 1) * L::kLX + c]);
        y[img + ((size_t)gy * W + gx) * C + c] =
            __float2bfloat16(v + sc[e] + b3[c]);
      }
    }
    __syncwarp();
  }
}

template <int C, int TH, int TW, int KC>
cudaError_t launch_tc(const void* x, const void* x1u, void* y, const void* w1,
                      const void* b1, const void* wd, const void* b2,
                      const void* w2, const void* b3, int n, int h, int w,
                      cudaStream_t stream) {
  using L = TcTile<C, TH, TW, KC>;
  auto kern = ir_block_tc_kernel<C, TH, TW, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, n);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(x1u),
      static_cast<bf16*>(y), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(b2), static_cast<const bf16*>(w2),
      static_cast<const float*>(b3), h, w, tiles_w);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int c, const void* x, const void* x1u, void* y,
                        const void* w1, const void* b1, const void* wd,
                        const void* b2, const void* w2, const void* b3, int n,
                        int h, int w, cudaStream_t s) {
  switch (c) {
    case 256: return launch_tc<256, 4, 8, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 128: return launch_tc<128, 8, 8, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 64: return launch_tc<64, 8, 16, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 32: return launch_tc<32, 16, 16, 32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One folded inverted-residual block.  dtype 0 = float32, 1 = bfloat16 (the
// storage type of x, x1u, y, w1, w2); b1, wd, b2, b3 are float32.  x, x1u and
// y are contiguous NHWC (n, h, w, c) with c in {32, 64, 128, 256}, the
// decoder's level widths; x1u may be null; y must not alias either input.
// Returns the cudaError_t of the launch.
extern "C" int tpuseg_ir_block(int dtype, const void* x, const void* x1u,
                               void* y, const void* w1, const void* b1,
                               const void* wd, const void* b2, const void* w2,
                               const void* b3, int n, int h, int w, int c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(c, x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
  if (dtype == 1)
    return dispatch_tc(c, x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
  return cudaErrorInvalidValue;
}
