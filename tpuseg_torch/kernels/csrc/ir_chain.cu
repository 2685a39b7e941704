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
// then writes y = v + acc + b3 (v includes x1u).
//
// float32 (ir_block_kernel): both products as f32 FMAs on the CUDA cores,
// 8 pixels x 8 channels of accumulator per thread, weights loaded per chunk.
//
// bfloat16 (ir_block_tc_kernel), the main path's type:
// - both products on mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands
//   from shared memory by ldmatrix (.trans for the row-major W1 / W2).  The
//   accumulator layout is the PTX ISA's, so both epilogues run in
//   registers: the expansion adds b1, applies relu6 and the in-image mask
//   and stores h as bf16 (the TPU kernel's rounding point); the projection
//   adds b3 and the residual and writes y over the input tile in shared
//   memory, which leaves the block in 16-byte stores;
// - the depthwise reads bf16 h two channels at a time, sums in f32 over a
//   3x3 window that slides along one row, or along two rows at once where
//   the accumulators leave the registers (C <= 64: four row loads serve
//   two output rows), and stores its bf16 output;
// - weights arrive by cp.async, 16 bytes a copy.  Streamed (kMode 0): two
//   stages, chunk k + 1 lands while chunk k computes.  Kept (kMode 1, 2; C
//   <= 64, where a block's W1 + W2 + taps take 13-45 KB): all chunks are
//   loaded once, and a persistent grid of the blocks the card holds at once
//   walks the tiles; kMode 2 also lands the next tile's input while this
//   one computes.  The input tile comes by cp.async too (zero-filled
//   outside the image); x1u is added in shared memory after the wait.
//
// Tiles (C: TH x TW, KC, mode, blocks per SM x threads; dispatch_tc):
//   256: 8 x 16, KC 32, streamed, 1 x 512  (a block pulls all of W1 + W2
//        from L2 per tile, so a 128-pixel tile halves the weight bytes per
//        output pixel against 8 x 8, and halo 180 / 128 against 100 / 64)
//   128: 16 x 16, KC 32, streamed, 1 x 512  (halo 324 / 256)
//    64: 8 x 16, KC 32, kept, 2 x 256
//    32: 16 x 16, KC 32, kept + next input prefetched, 2 x 256
// 64 accumulator floats a thread at most (TP x C / threads), 126-128
// registers, no spills (-Xptxas -v).  Per launch on an H100 (700 W) the
// five main-path levels take 0.14-0.84 ms, 10-13% of the operations bound:
// the f32 CUDA-core work (depthwise, epilogues, conversions) and the
// barriers between the three phases of a chunk are what is left (PERF.md).
//
// Tried and dropped (tpuseg_torch/tools/bench_ir_chain.py, each against
// the others in one call; PERF.md has the times): the first version's
// tiles (4 x 8, 8 x 8, 8 x 16, 16 x 16) streamed; 8 x 8 / 8 x 16 at KC 16
// with two blocks of 256 threads at C >= 128 (kept until 512-thread blocks
// beat them by 13-20%); KC 16 with 512 threads; larger tiles and 512
// threads at C <= 64; three blocks per SM at C <= 64; the next input
// prefetched at C = 64 (needs the 8 x 8 tile); k-split expansion
// accumulators; a per-warp depthwise feeding the warp's own projection
// rows without a block barrier.  Later work (ROADMAP): the depthwise in
// packed bf16x2, one launch for the whole chain, wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
// bfloat16 path: mma.sync products, register epilogues, cp.async pipeline
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }
constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// warps along the pixel rows of the projection: the split of the block's
// warps over the tile's (m16 x n8) accumulator tiles that loads the fewest
// fragments per k step; 0 if none divides evenly
constexpr int warps_m(int mt, int nt, int warps) {
  int best = 0, cost = 1 << 30;
  for (int wm = 1; wm <= warps; wm *= 2) {
    const int wn = warps / wm;
    if (mt % wm || nt % (2 * wn)) continue;
    const int c = mt / wm + nt / wn / 2;
    if (c < cost) {
      cost = c;
      best = wm;
    }
  }
  return best;
}

// C channels, a TH x TW output tile, the 2C hidden in chunks of KC.
// kMode 0: one tile per block, each chunk's weights streamed through two
// stages; 1: every chunk's weights kept in shared memory, a persistent
// grid walks the tiles; 2: as 1, and the next tile's input lands while
// this one computes.  kBlocks: blocks per SM the tile is sized for, of
// kT threads each
template <int C, int TH, int TW, int KC, int kMode, int kBlocks, int kT>
struct TcTile {
  static constexpr bool kKeep = kMode >= 1;
  static constexpr int kXBufs = kMode == 2 ? 2 : 1;
  static constexpr int kHid = 2 * C;
  static constexpr int kChunks = kHid / KC;
  static constexpr int kStages = kKeep ? kChunks : 2;
  static constexpr int kHW = TW + 2;
  static constexpr int kHP = (TH + 2) * kHW;         // halo tile pixels
  static constexpr int kHPp = round16(kHP);          // ... in m16 tiles
  static constexpr int kTP = TH * TW;
  static constexpr int kWarps = kT / 32;
  // row strides (elements): 16 bytes past a multiple of 32 bytes, so the
  // eight row addresses of an ldmatrix hit distinct bank groups
  static constexpr int kLX = C + 8;    // block input, bf16
  static constexpr int kLW1 = KC + 8;  // W1 chunk, bf16
  static constexpr int kLH = KC + 8;   // hidden, bf16
  static constexpr int kLD = KC + 8;   // depthwise output, bf16
  static constexpr int kLW2 = C + 8;   // W2 chunk, bf16
  // expansion: one warp item is 16 halo pixels x the chunk's KC channels
  static constexpr int kMT1 = kHPp / 16;
  static constexpr int kNF1 = KC / 8;
  // projection: kWM x kWN warps, each kFM x kFN (m16 x n8) accumulators
  static constexpr int kMT3 = kTP / 16, kNT3 = C / 8;
  static constexpr int kWM = warps_m(kMT3, kNT3, kWarps);
  static constexpr int kWN = kWarps / (kWM ? kWM : 1);
  static constexpr int kFM = kMT3 / (kWM ? kWM : 1), kFN = kNT3 / kWN;
  // depthwise: a thread slides the 3x3 window over kSW pixels of kR rows
  // for a pair of channels; two rows share two of their four row loads
  // where that still fills the block and the accumulators (kTP * C / kT
  // floats a thread) leave the registers; kSeg segments per row
  static constexpr int kJ2 = KC / 2;
  static constexpr int kR = TH % 2 == 0 && TW % 4 == 0 &&
                                    2 * TH * kJ2 >= kT && kTP * C <= 32 * kT
                                ? 2
                                : 1;
  static constexpr int kItems = TH / kR * kJ2;
  static constexpr int kSeg =
      (kItems >= kT || TW % 2) ? 1
      : (2 * kItems >= kT || TW % 4) ? 2 : 4;
  static constexpr int kSW = TW / kSeg;
  // per chunk, float32: b1 (KC), b2 (KC), the 9 depthwise taps (9 x KC)
  static constexpr int kVec = 11 * KC;
  // shared memory carve-up, in bytes (128-aligned regions)
  static constexpr size_t kXBytes = align128(2ull * kHPp * kLX);
  static constexpr size_t kOffW1 = kXBufs * kXBytes;
  static constexpr size_t kOffW2 = kOffW1 + align128(2ull * kStages * C * kLW1);
  static constexpr size_t kOffH = kOffW2 + align128(2ull * kStages * KC * kLW2);
  static constexpr size_t kOffD = kOffH + align128(2ull * kHPp * kLH);
  static constexpr size_t kOffV = kOffD + align128(2ull * kTP * kLD);
  static constexpr size_t kOffB3 = kOffV + align128(4ull * kStages * kVec);
  static constexpr size_t kBytes = kOffB3 + 4ull * C;

  static_assert(C % 16 == 0 && KC % 16 == 0 && kHid % KC == 0, "mma tiles");
  static_assert(kTP % 16 == 0 && kWM > 0, "accumulator split");
  // an SM has 228 KB of shared memory; each block leaves 1 KB reserved
  static_assert(kBytes <= 232448 && kBlocks * (kBytes + 1024) <= 233472,
                "shared memory for kBlocks blocks per SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses the registers; bytes = 0
// fills the 16 bytes with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.  Lane l
// holds d[0..1] at row l/4, columns 2(l%4) + {0,1}, and d[2..3] 8 rows
// below (PTX ISA, mma.m16n8k16 fragment layout)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int C, int TH, int TW, int KC, int kMode, int kBlocks, int kT>
__global__ void __launch_bounds__(kT, kBlocks)
ir_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ x1u,
                   bf16* __restrict__ y, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ wd,
                   const float* __restrict__ b2, const bf16* __restrict__ w2,
                   const float* __restrict__ b3, int H, int W, int tiles_w,
                   int tiles_img, int n_tiles) {
  using L = TcTile<C, TH, TW, KC, kMode, kBlocks, kT>;
  constexpr bool kKeep = L::kKeep;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw + L::kOffW1);
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw + L::kOffW2);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + L::kOffH);
  bf16* ds = reinterpret_cast<bf16*>(smem_raw + L::kOffD);
  float* vs = reinterpret_cast<float*>(smem_raw + L::kOffV);
  float* b3s = reinterpret_cast<float*>(smem_raw + L::kOffB3);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % L::kWM, wn = warp / L::kWM;

  // hidden chunk k into stage s: W1 columns, W2 rows, b1, b2, taps
  auto load_chunk = [&](int k, int s) {
    const int c0 = k * KC;
    bf16* w1d = w1s + s * C * L::kLW1;
    constexpr int kV1 = KC / 8;
    for (int i = tid; i < C * kV1; i += kT) {
      const int r = i / kV1, v = i - r * kV1;
      cp16(w1d + r * L::kLW1 + v * 8, w1 + (size_t)r * L::kHid + c0 + v * 8);
    }
    bf16* w2d = w2s + s * KC * L::kLW2;
    constexpr int kV2 = C / 8;
    for (int i = tid; i < KC * kV2; i += kT) {
      const int r = i / kV2, v = i - r * kV2;
      cp16(w2d + r * L::kLW2 + v * 8, w2 + (size_t)(c0 + r) * C + v * 8);
    }
    float* vd = vs + s * L::kVec;
    constexpr int kV4 = KC / 4;
    for (int i = tid; i < 11 * kV4; i += kT) {
      const int r = i / kV4, v = i - r * kV4;
      const float* src = r == 0   ? b1 + c0
                         : r == 1 ? b2 + c0
                                  : wd + (r - 2) * L::kHid + c0;
      cp16(vd + r * KC + v * 4, src + v * 4);
    }
  };

  constexpr int kCV = C / 8;  // 16-byte vectors per pixel
  constexpr int kXE = L::kXBytes / 2;  // elements per input buffer
  // the block input on the tile's halo into xt; zero outside the image and
  // in the padding rows
  auto load_input = [&](int tile, bf16* xt) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int y0 = (rem / tiles_w) * TH, x0 = (rem % tiles_w) * TW;
    const size_t img = (size_t)n * H * W * C;
    for (int i = tid; i < L::kHPp * kCV; i += kT) {
      const int q = i / kCV, c = (i - q * kCV) * 8;
      const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
      const bool ok = q < L::kHP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp16(xt + q * L::kLX + c,
           ok ? x + img + ((size_t)gy * W + gx) * C + c : x, ok ? 16 : 0);
    }
  };

  for (int i = tid; i < C / 4; i += kT) cp16(b3s + i * 4, b3 + i * 4);
  if constexpr (kKeep) {
    for (int k = 0; k < L::kChunks; ++k) load_chunk(k, k);
  } else {
    load_chunk(0, 0);
  }
  if constexpr (L::kXBufs == 2) {
    if ((int)blockIdx.x < n_tiles) load_input(blockIdx.x, xs);
  }
  cp_commit();

  int seq = 0;  // chunks computed: a streamed chunk's stage
  int buf = 0;  // input buffer of this tile
  for (int tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, buf ^= L::kXBufs - 1) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int y0 = (rem / tiles_w) * TH, x0 = (rem % tiles_w) * TW;
    const size_t img = (size_t)n * H * W * C;
    bf16* xt = xs + buf * kXE;
    if constexpr (L::kXBufs == 1) {
      load_input(tile, xt);
      cp_commit();
    }
    cp_wait_all();
    // block 3 of the chain adds the mid-chain skip, rounded to bf16 once,
    // on the elements each thread copied itself
    if (x1u != nullptr) {
      for (int i = tid; i < L::kHPp * kCV; i += kT) {
        const int q = i / kCV, c = (i - q * kCV) * 8;
        const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
        if (!(q < L::kHP && gy >= 0 && gy < H && gx >= 0 && gx < W)) continue;
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            x1u + img + ((size_t)gy * W + gx) * C + c));
        uint4* vp = reinterpret_cast<uint4*>(xt + q * L::kLX + c);
        uint4 v = *vp;
        __nv_bfloat162* va = reinterpret_cast<__nv_bfloat162*>(&v);
        const __nv_bfloat162* ua = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a = __bfloat1622float2(va[k]);
          const float2 b = __bfloat1622float2(ua[k]);
          va[k] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
        }
        *vp = v;
      }
    }
    // the next tile's input lands while this one computes
    if constexpr (L::kXBufs == 2) {
      if (tile + (int)gridDim.x < n_tiles) {
        load_input(tile + gridDim.x, xs + (buf ^ 1) * kXE);
        cp_commit();
      }
    }

    float acc[L::kFM][L::kFN][4];
#pragma unroll
    for (int i = 0; i < L::kFM; ++i)
#pragma unroll
      for (int j = 0; j < L::kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int k = 0; k < L::kChunks; ++k, ++seq) {
      const int s = kKeep ? k : (seq & 1);
      const bf16* w1c = w1s + s * C * L::kLW1;
      const bf16* w2c = w2s + s * KC * L::kLW2;
      const float* b1c = vs + s * L::kVec;
      const float* b2c = b1c + KC;
      const float* wdc = b2c + KC;
      if constexpr (!kKeep) cp_wait_all();  // this chunk's weights
      __syncthreads();
      // the next chunk's weights land while this one computes: stage s ^ 1
      // was last read by the chunk before, which every thread has finished
      if constexpr (!kKeep) {
        if (k + 1 < L::kChunks)
          load_chunk(k + 1, s ^ 1);
        else if (tile + (int)gridDim.x < n_tiles)
          load_chunk(0, s ^ 1);
        cp_commit();
      }

      // 1. expansion h = relu6(xs . W1 + b1), zero outside the image,
      //    stored as bf16 straight from the accumulator registers
      for (int mt = warp; mt < L::kMT1; mt += L::kWarps) {
        float h[L::kNF1][4];
#pragma unroll
        for (int j = 0; j < L::kNF1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
        const bf16* ap = xt + (mt * 16 + (lane & 15)) * L::kLX + (lane >> 4) * 8;
        const bf16* bp = w1c + (lane & 15) * L::kLW1 + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < C; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, ap + kk);
#pragma unroll
          for (int j = 0; j < L::kNF1; j += 2) {
            uint32_t b[4];
            ldsm_x4_t(b, bp + kk * L::kLW1 + j * 8);
            mma16816(h[j], a, b[0], b[1]);
            mma16816(h[j + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = mt * 16 + g + half * 8;
          if (q >= L::kHP) continue;
          const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < L::kNF1; ++j) {
            const int ch = j * 8 + 2 * t4;
            const float2 bb = *reinterpret_cast<const float2*>(b1c + ch);
            *reinterpret_cast<uint32_t*>(hs + q * L::kLH + ch) =
                inside ? pack_bf16(relu6f(h[j][2 * half] + bb.x),
                                   relu6f(h[j][2 * half + 1] + bb.y))
                       : 0u;
          }
        }
      }
      __syncthreads();

      // 2. depthwise 3x3 on bf16 h, f32 sums -> bf16 operand of the
      //    projection; two channels per thread, a window sliding along kR
      //    rows at once
      for (int it = tid; it < L::kItems * L::kSeg; it += kT) {
        constexpr int kRows = L::kR + 2, kRS = L::kHW * L::kLH;
        const int ch = (it % L::kJ2) * 2, rs = it / L::kJ2;
        const int r0 = rs / L::kSeg * L::kR, cx = (rs % L::kSeg) * L::kSW;
        float2 wt[9];
#pragma unroll
        for (int t = 0; t < 9; ++t)
          wt[t] = *reinterpret_cast<const float2*>(wdc + t * KC + ch);
        const float2 bias = *reinterpret_cast<const float2*>(b2c + ch);
        const bf16* h0 = hs + (r0 * L::kHW + cx) * L::kLH + ch;
        float2 a[kRows], m[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          a[i] = ld_bf16x2(h0 + i * kRS);
          m[i] = ld_bf16x2(h0 + i * kRS + L::kLH);
        }
        bf16* dr = ds + (r0 * TW + cx) * L::kLD + ch;
#pragma unroll
        for (int px = 0; px < L::kSW; ++px) {
          float2 e[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            e[i] = ld_bf16x2(h0 + i * kRS + (px + 2) * L::kLH);
#pragma unroll
          for (int rr = 0; rr < L::kR; ++rr) {
            float sx = bias.x, sy = bias.y;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const float2 u = a[rr + dy], v = m[rr + dy], w = e[rr + dy];
              const float2 p = wt[3 * dy], q = wt[3 * dy + 1], t = wt[3 * dy + 2];
              sx = fmaf(u.x, p.x, sx); sy = fmaf(u.y, p.y, sy);
              sx = fmaf(v.x, q.x, sx); sy = fmaf(v.y, q.y, sy);
              sx = fmaf(w.x, t.x, sx); sy = fmaf(w.y, t.y, sy);
            }
            *reinterpret_cast<uint32_t*>(dr + (rr * TW + px) * L::kLD) =
                pack_bf16(relu6f(sx), relu6f(sy));
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            a[i] = m[i];
            m[i] = e[i];
          }
        }
      }
      __syncthreads();

      // 3. projection acc += ds . W2 (this chunk's rows)
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[L::kFM][4];
#pragma unroll
        for (int i = 0; i < L::kFM; ++i)
          ldsm_x4(a[i], ds + ((wm * L::kFM + i) * 16 + (lane & 15)) * L::kLD +
                            kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < L::kFN; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, w2c + (kk + (lane & 15)) * L::kLW2 +
                           (wn * L::kFN + j) * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < L::kFM; ++i) {
            mma16816(acc[i][j], a[i], b[0], b[1]);
            mma16816(acc[i][j + 1], a[i], b[2], b[3]);
          }
        }
      }
    }

    // y = v + acc + b3 from the registers, written over v in xs (each
    // element read and written by its owner), then 16-byte stores
#pragma unroll
    for (int i = 0; i < L::kFM; ++i)
#pragma unroll
      for (int j = 0; j < L::kFN; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (wm * L::kFM + i) * 16 + g + half * 8;
          const int c = (wn * L::kFN + j) * 8 + 2 * t4;
          const int py = p / TW, px = p - py * TW;
          bf16* vp = xt + ((py + 1) * L::kHW + px + 1) * L::kLX + c;
          const float2 v = ld_bf16x2(vp);
          const float2 bb = *reinterpret_cast<const float2*>(b3s + c);
          *reinterpret_cast<uint32_t*>(vp) =
              pack_bf16(v.x + acc[i][j][2 * half] + bb.x,
                        v.y + acc[i][j][2 * half + 1] + bb.y);
        }
    __syncthreads();
    for (int i = tid; i < L::kTP * kCV; i += kT) {
      const int p = i / kCV, c = (i - p * kCV) * 8;
      const int py = p / TW, px = p - py * TW;
      const int gy = y0 + py, gx = x0 + px;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(y + img + ((size_t)gy * W + gx) * C + c) =
            *reinterpret_cast<const uint4*>(
                xt + ((py + 1) * L::kHW + px + 1) * L::kLX + c);
    }
    __syncthreads();  // xt takes a later tile
  }
}

template <int C, int TH, int TW, int KC, int kMode, int kBlocks,
          int kT = kThreads>
cudaError_t launch_tc(const void* x, const void* x1u, void* y, const void* w1,
                      const void* b1, const void* wd, const void* b2,
                      const void* w2, const void* b3, int n, int h, int w,
                      cudaStream_t stream) {
  using L = TcTile<C, TH, TW, KC, kMode, kBlocks, kT>;
  auto kern = ir_block_tc_kernel<C, TH, TW, KC, kMode, kBlocks, kT>;
  static int resident = 0;  // blocks the card holds at once (kKeep)
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + TW - 1) / TW, tiles_h = (h + TH - 1) / TH;
  const int tiles_img = tiles_w * tiles_h, n_tiles = n * tiles_img;
  int grid = n_tiles;
  if (L::kKeep) {
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
      if ((err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kern, kT, L::kBytes)) != cudaSuccess)
        return err;
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    grid = n_tiles < resident ? n_tiles : resident;
  }
  if (grid == 0) return cudaSuccess;
  kern<<<grid, kT, L::kBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(x1u),
      static_cast<bf16*>(y), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(b2), static_cast<const bf16*>(w2),
      static_cast<const float*>(b3), h, w, tiles_w, tiles_img, n_tiles);
  return cudaGetLastError();
}

// Tiles of each width, <C, TH, TW, KC, kMode, kBlocks[, threads]>: the
// header says why, PERF.md holds the sets timed against them
cudaError_t dispatch_tc(int c, const void* x, const void* x1u, void* y,
                        const void* w1, const void* b1, const void* wd,
                        const void* b2, const void* w2, const void* b3, int n,
                        int h, int w, cudaStream_t s) {
  switch (c) {
    case 256: return launch_tc<256, 8, 16, 32, 0, 1, 512>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 128: return launch_tc<128, 16, 16, 32, 0, 1, 512>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 64: return launch_tc<64, 8, 16, 32, 1, 2>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 32: return launch_tc<32, 16, 16, 32, 2, 2>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
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
