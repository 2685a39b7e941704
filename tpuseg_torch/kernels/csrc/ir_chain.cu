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
// the products as 3xTF32 on the tensor cores (494.7 / 3 TFLOP/s) outlast
// the CUDA-core work.  One launch per block moves each intermediate through
// device memory, 4x a fused chain's activation bytes.
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
// float32 (ir_block_kernel; f32 inference and the card-vs-CPU runs):
// - both products on mma.sync.m16n8k8 as 3xTF32: each operand is split as
//   its fragment is loaded into hi (rounded to TF32) and lo = v - hi, and
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi go into one f32 accumulator, each
//   term issued across a warp's tiles so that no product waits on the one
//   before.  Within 1.3e-5 of max|y| of the f32 plain chain at the main
//   path's shapes, against 1e-4 allowed; single-pass TF32 misses that
//   (4-6e-4, PERF.md);
// - both epilogues on the accumulator registers, as in the bf16 path: the
//   expansion adds b1, relu6 and the in-image mask and stores h in f32,
//   the projection adds b3 and the residual and stores y, 8 bytes a lane;
// - the depthwise slides a 3x3 window along one row, 4 channels a thread
//   from 16-byte loads, the taps in registers;
// - weights and the input tile arrive by cp.async as in the bf16 path:
//   streamed through two stages at C >= 64, kept with a persistent grid
//   at C = 32.
// f32 doubles every byte of the bf16 tiles, so the tiles are smaller (C:
// TH x TW, KC, mode, blocks per SM x threads, n8 tiles per expansion item;
// dispatch): 256: 8 x 8, 16, streamed, 1 x 512, 2 (the halo input alone
// takes 116 KB); 128: 8 x 16, 32, streamed, 1 x 512, 4; 64: 16 x 16, 32,
// streamed, 1 x 512, 4; 32: 8 x 16, 32, kept, 2 x 256, 4.  At most 128
// registers; C = 256 spills 8 bytes, the others none.  Per launch on an
// H100 (700 W) the five main-path levels take 0.46-1.82 ms, 13-20% of the
// 3xTF32 operations bound (37-52% of the bound with every product on the
// CUDA cores); the operand splits, the depthwise and the cross products
// cost 12%, 15% and 24% of a round (timed variants, PERF.md).
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
// the others in one call; PERF.md has the times).  float32: the products
// as FFMA register tiles on the CUDA cores (4-6 halo pixels x 4 channels
// from 16-byte loads along k, the sum split over 2-4 lanes at C >= 128;
// 4 pixels x 4-8 channels in the projection), bit-equal to the first
// version where a sum stays on one lane, 1.3-2.2x faster than it but
// 13-29% slower than 3xTF32 at every width; 3xTF32 with each tile's three
// products issued back to back (asm volatile) and cvt.rna.tf32
// conversions (no faster than FFMA); weights kept at C = 64 (8 x 8 or
// 8 x 16 tiles: 16 x 16 does not fit beside them); 3 blocks per SM or the
// next input prefetched at C = 32 (8 x 8 tiles); 1 or 2 n8 tiles per
// expansion item at C <= 128; 256 threads at C = 256.  bfloat16: the
// first version's tiles (4 x 8, 8 x 8, 8 x 16, 16 x 16) streamed; 8 x 8 /
// 8 x 16 at KC 16
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

// ---------------------------------------------------------------------------
// float32 path: both products on mma.sync as 3xTF32, register epilogues,
// cp.async pipeline
// ---------------------------------------------------------------------------

// the depthwise's segments per tile row: as many as keep the items (rows x
// segments x channel quads) within the block
constexpr int dw_segments(int th, int tw, int quads, int threads) {
  int seg = 1;
  while (tw % (2 * seg) == 0 && th * quads * 2 * seg <= threads) seg *= 2;
  return seg;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ float4 relu6f4(float4 v) {
  return make_float4(relu6f(v.x), relu6f(v.y), relu6f(v.z), relu6f(v.w));
}
// s = fma(h, t, s) lane by lane
__device__ __forceinline__ void fma4(float4& s, const float4& h,
                                     const float4& t) {
  s.x = fmaf(h.x, t.x, s.x);
  s.y = fmaf(h.y, t.y, s.y);
  s.z = fmaf(h.z, t.z, s.z);
  s.w = fmaf(h.w, t.w, s.w);
}

// hidden chunk k into stage s: W1 columns, W2 rows, b1, b2, taps
template <class L>
__device__ __forceinline__ void load_chunk(float* w1s, float* w2s, float* vs,
                                           const float* w1, const float* b1,
                                           const float* wd, const float* b2,
                                           const float* w2, int k, int s) {
  constexpr int C = L::C, KC = L::KC, kV1 = KC / 4, kV2 = C / 4;
  const int c0 = k * KC;
  float* w1d = w1s + s * C * L::kLW1;
  for (int i = threadIdx.x; i < C * kV1; i += L::kT) {
    const int r = i / kV1, v = i - r * kV1;
    cp16(w1d + r * L::kLW1 + v * 4, w1 + (size_t)r * L::kHid + c0 + v * 4);
  }
  float* w2d = w2s + s * KC * L::kLW2;
  for (int i = threadIdx.x; i < KC * kV2; i += L::kT) {
    const int r = i / kV2, v = i - r * kV2;
    cp16(w2d + r * L::kLW2 + v * 4, w2 + (size_t)(c0 + r) * C + v * 4);
  }
  float* vd = vs + s * L::kVec;
  for (int i = threadIdx.x; i < 11 * kV1; i += L::kT) {
    const int r = i / kV1, v = i - r * kV1;
    const float* src = r == 0   ? b1 + c0
                       : r == 1 ? b2 + c0
                                : wd + (r - 2) * L::kHid + c0;
    cp16(vd + r * KC + v * 4, src + v * 4);
  }
}

// the block input on the halo of the tile at (y0, x0) of image n into xt;
// zero outside the image and in the padding rows
template <class L>
__device__ __forceinline__ void load_input(float* xt, const float* x, int n,
                                           int y0, int x0, int H, int W) {
  constexpr int kCV = L::C / 4;  // 16-byte vectors per pixel
  const size_t img = (size_t)n * H * W * L::C;
  for (int i = threadIdx.x; i < L::kHPp * kCV; i += L::kT) {
    const int q = i / kCV, c = (i - q * kCV) * 4;
    const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
    const bool ok = q < L::kHP && gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp16(xt + q * L::kLX + c,
         ok ? x + img + ((size_t)gy * W + gx) * L::C + c : x, ok ? 16 : 0);
  }
}

// block 3 of the chain adds the mid-chain skip, on the elements each thread
// copied itself (load_input's split of the tile)
template <class L>
__device__ __forceinline__ void add_skip(float* xt, const float* x1u,
                                         size_t img, int y0, int x0, int H,
                                         int W) {
  constexpr int kCV = L::C / 4;
  for (int i = threadIdx.x; i < L::kHPp * kCV; i += L::kT) {
    const int q = i / kCV, c = (i - q * kCV) * 4;
    const int gy = y0 - 1 + q / L::kHW, gx = x0 - 1 + q % L::kHW;
    if (!(q < L::kHP && gy >= 0 && gy < H && gx >= 0 && gx < W)) continue;
    const float4 u = __ldg(reinterpret_cast<const float4*>(
        x1u + img + ((size_t)gy * W + gx) * L::C + c));
    float4 v = ld4(xt + q * L::kLX + c);
    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    st4(xt + q * L::kLX + c, v);
  }
}

// d = relu6(dw3x3(h) + b2): s = b2, then the taps row by row, a window of
// 3 columns sliding along kSW pixels of one row, 4 channels a thread
template <class L>
__device__ __forceinline__ void depthwise(const float* hs, float* ds,
                                          const float* b2c,
                                          const float* wdc) {
  constexpr int KC = L::KC, kRS = L::kHW * L::kLH;
  for (int it = threadIdx.x; it < L::TH * L::kSeg * L::kJ4; it += L::kT) {
    const int jg = it % L::kJ4, rs = it / L::kJ4;
    const int row = rs / L::kSeg, cx = (rs % L::kSeg) * L::kSW;
    float4 wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = ld4(wdc + t * KC + jg * 4);
    const float4 bias = ld4(b2c + jg * 4);
    const float* h0 = hs + (row * L::kHW + cx) * L::kLH + jg * 4;
    float4 a[3], m[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      a[dy] = ld4(h0 + dy * kRS);
      m[dy] = ld4(h0 + dy * kRS + L::kLH);
    }
    float* dr = ds + (row * L::TW + cx) * L::kLD + jg * 4;
#pragma unroll
    for (int px = 0; px < L::kSW; ++px) {
      float4 e[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        e[dy] = ld4(h0 + dy * kRS + (px + 2) * L::kLH);
      float4 sum = bias;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        fma4(sum, a[dy], wt[3 * dy]);
        fma4(sum, m[dy], wt[3 * dy + 1]);
        fma4(sum, e[dy], wt[3 * dy + 2]);
      }
      st4(dr + px * L::kLD, relu6f4(sum));
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        a[dy] = m[dy];
        m[dy] = e[dy];
      }
    }
  }
}

// v ~ hi + lo for 3xTF32: hi is v rounded to TF32 (10 mantissa bits, the
// magnitude rounded half away from zero, as cvt.rna.tf32.f32 does, in two
// integer operations in place of a conversion); lo = v - hi, whose low 13
// bits the tensor core drops
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulate.  Lane l
// holds a[0] at row l/4, column l%4, a[1] 8 rows below, a[2..3] 4 columns
// right of a[0..1]; b0 at row l%4, column l/4, b1 4 rows below; d as for
// mma16816 (PTX ISA, mma.m16n8k8 .tf32 fragment layout).  Not volatile:
// the compiler may interleave independent tiles' products
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C channels, a TH x TW output tile, the 2C hidden in chunks of KC.  kMode
// 0: one tile per block, each chunk's weights streamed through two stages;
// 1: every chunk's weights kept in shared memory, a persistent grid walks
// the tiles.  kBlocks: blocks per SM the tile is sized for, of kT threads
// each.  Both products on the tensor cores as
// 3xTF32, each operand split into two TF32 parts as its fragment is loaded.
// The expansion gives a warp 16 halo pixels x NG n8 tiles of the chunk; the
// projection's accumulators are kFM x kFN (m16 x n8) tiles a warp, kWM x kWN
// warps, as in TcTile.  Both epilogues run on the accumulator registers.
template <int C_, int TH_, int TW_, int KC_, int kMode, int kBlocks_, int kT_,
          int NG>
struct Tile {
  static constexpr int C = C_, TH = TH_, TW = TW_, KC = KC_;
  static constexpr int kBlocks = kBlocks_, kT = kT_;
  static constexpr bool kKeep = kMode == 1;
  static constexpr int kHid = 2 * C;
  static constexpr int kChunks = kHid / KC;
  static constexpr int kStages = kKeep ? kChunks : 2;
  static constexpr int kHW = TW + 2;
  static constexpr int kHP = (TH + 2) * kHW;   // halo tile pixels
  static constexpr int kHPp = round16(kHP);    // ... in m16 tiles
  static constexpr int kTP = TH * TW;
  // row strides (floats).  The input and the depthwise output, read as A
  // fragments (row l/4, column l%4): 16 bytes past a multiple of 128.  W1,
  // W2, read as B fragments (row l%4, column l/4), and the hidden, stored
  // 8 bytes a lane from the accumulators: 32 bytes past.  Either way a
  // warp's accesses fall in distinct banks
  static constexpr int kLX = C + 4;
  static constexpr int kLD = KC + 4;
  static constexpr int kLW1 = KC + 8, kLW2 = C + 8, kLH = KC + 8;
  // depthwise: a thread slides the 3x3 window over kSW pixels of one row
  // for one channel quad
  static constexpr int kJ4 = KC / 4;
  static constexpr int kSeg = dw_segments(TH, TW, kJ4, kT);
  static constexpr int kSW = TW / kSeg;
  // per chunk: b1 (KC), b2 (KC), the 9 depthwise taps (9 x KC)
  static constexpr int kVec = 11 * KC;
  // shared memory carve-up, in bytes (128-aligned regions)
  static constexpr size_t kXBytes = align128(4ull * kHPp * kLX);
  static constexpr size_t kOffW1 = kXBytes;
  static constexpr size_t kOffW2 = kOffW1 + align128(4ull * kStages * C * kLW1);
  static constexpr size_t kOffH = kOffW2 + align128(4ull * kStages * KC * kLW2);
  static constexpr size_t kOffD = kOffH + align128(4ull * kHP * kLH);
  static constexpr size_t kOffV = kOffD + align128(4ull * kTP * kLD);
  static constexpr size_t kOffB3 = kOffV + align128(4ull * kStages * kVec);
  static constexpr size_t kBytes = kOffB3 + 4ull * C;

  static_assert(C % 32 == 0 && KC % 8 == 0 && kHid % KC == 0, "chunks");
  static_assert((kMode == 0 || kMode == 1) && kT % 32 == 0, "mode, warps");
  // an SM has 228 KB of shared memory; each block leaves 1 KB reserved
  static_assert(kBytes <= 232448 && kBlocks * (kBytes + 1024) <= 233472,
                "shared memory for kBlocks blocks per SM");

  static constexpr int kWarps = kT / 32;
  static constexpr int kMT1 = kHPp / 16, kNT1 = KC / 8;
  static constexpr int kItems = kMT1 * (kNT1 / NG);
  static constexpr int kMT3 = kTP / 16, kNT3 = C / 8;
  static constexpr int kWM = warps_m(kMT3, kNT3, kWarps);
  static constexpr int kWN = kWarps / (kWM ? kWM : 1);
  static constexpr int kFM = kMT3 / (kWM ? kWM : 1), kFN = kNT3 / kWN;
  static_assert(kNT1 % NG == 0, "expansion tiles");
  static_assert(kTP % 16 == 0 && kWM > 0, "accumulator split");

  struct Acc {
    float v[kFM][kFN][4];
  };

  static __device__ __forceinline__ void clear(Acc& acc) {
#pragma unroll
    for (int i = 0; i < kFM; ++i)
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
  }

  // a's fragment at p (row l/4, column l%4 of a row-major tile, row
  // stride ld), split
  static __device__ __forceinline__ void load_a(uint32_t (&ah)[4],
                                                uint32_t (&al)[4],
                                                const float* p, int ld) {
    split_tf32(p[0], ah[0], al[0]);
    split_tf32(p[8 * ld], ah[1], al[1]);
    split_tf32(p[4], ah[2], al[2]);
    split_tf32(p[8 * ld + 4], ah[3], al[3]);
  }
  // b's fragment at p (row l%4, column l/4 of a row-major k x n tile)
  static __device__ __forceinline__ void load_b(uint32_t (&bh)[2],
                                                uint32_t (&bl)[2],
                                                const float* p, int ld) {
    split_tf32(p[0], bh[0], bl[0]);
    split_tf32(p[4 * ld], bh[1], bl[1]);
  }

  // h = relu6(xs . W1 + b1) on the halo tile, zero outside the image,
  // stored from the accumulator registers
  static __device__ __forceinline__ void expand(const float* xt,
                                                const float* w1c,
                                                const float* b1c, float* hs,
                                                int y0, int x0, int H, int W) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    for (int it = warp; it < kItems; it += kWarps) {
      const int mt = it % kMT1, n0 = (it / kMT1) * NG * 8;
      float h[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
      const float* ap = xt + (mt * 16 + g) * kLX + t4;
      const float* bp = w1c + t4 * kLW1 + n0 + g;
#pragma unroll 2
      for (int k = 0; k < C; k += 8) {
        uint32_t ah[4], al[4], bh[NG][2], bl[NG][2];
        load_a(ah, al, ap + k, kLX);
#pragma unroll
        for (int j = 0; j < NG; ++j)
          load_b(bh[j], bl[j], bp + k * kLW1 + j * 8, kLW1);
        // 3xTF32: the two cross terms, then hi . hi, each across the tiles
#pragma unroll
        for (int j = 0; j < NG; ++j) mma1688(h[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) mma1688(h[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) mma1688(h[j], ah, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = mt * 16 + g + half * 8;
        if (q >= kHP) continue;
        const int gy = y0 - 1 + q / kHW, gx = x0 - 1 + q % kHW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int ch = n0 + j * 8 + 2 * t4;
          const float2 bb = ld2(b1c + ch);
          st2(hs + q * kLH + ch,
              inside ? make_float2(relu6f(h[j][2 * half] + bb.x),
                                   relu6f(h[j][2 * half + 1] + bb.y))
                     : make_float2(0.f, 0.f));
        }
      }
    }
  }

  // acc += ds . W2 (this chunk's rows)
  static __device__ __forceinline__ void project(const float* ds,
                                                 const float* w2c, Acc& acc) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wm = warp % kWM, wn = warp / kWM;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ah[kFM][4], al[kFM][4];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        load_a(ah[i], al[i],
               ds + ((wm * kFM + i) * 16 + g) * kLD + kk + t4, kLD);
      uint32_t bh[kFN][2], bl[kFN][2];
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        load_b(bh[j], bl[j],
               w2c + (kk + t4) * kLW2 + (wn * kFN + j) * 8 + g, kLW2);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          mma1688(acc.v[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          mma1688(acc.v[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          mma1688(acc.v[i][j], ah[i], bh[j][0], bh[j][1]);
    }
  }

  // y = v + acc + b3 from the accumulator registers, 8-byte stores
  static __device__ __forceinline__ void store(const Acc& acc,
                                               const float* xt,
                                               const float* b3s, float* y,
                                               int y0, int x0, int H, int W) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wm = warp % kWM, wn = warp / kWM;
#pragma unroll
    for (int i = 0; i < kFM; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wm * kFM + i) * 16 + g + half * 8;
        const int py = p / TW, px = p - py * TW;
        const int gy = y0 + py, gx = x0 + px;
        if (gy >= H || gx >= W) continue;
        const float* vr = xt + ((py + 1) * kHW + px + 1) * kLX;
        float* yr = y + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < kFN; ++j) {
          const int c = (wn * kFN + j) * 8 + 2 * t4;
          const float2 v = ld2(vr + c), b = ld2(b3s + c);
          st2(yr + c, make_float2(v.x + acc.v[i][j][2 * half] + b.x,
                                  v.y + acc.v[i][j][2 * half + 1] + b.y));
        }
      }
  }
};


template <class L>
__global__ void __launch_bounds__(L::kT, L::kBlocks)
ir_block_kernel(const float* __restrict__ x, const float* __restrict__ x1u,
                float* __restrict__ y, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ wd,
                const float* __restrict__ b2, const float* __restrict__ w2,
                const float* __restrict__ b3, int H, int W, int tiles_w,
                int tiles_img, int n_tiles) {
  constexpr bool kKeep = L::kKeep;
  constexpr int C = L::C, KC = L::KC, TH = L::TH, TW = L::TW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* w1s = reinterpret_cast<float*>(smem_raw + L::kOffW1);
  float* w2s = reinterpret_cast<float*>(smem_raw + L::kOffW2);
  float* hs = reinterpret_cast<float*>(smem_raw + L::kOffH);
  float* ds = reinterpret_cast<float*>(smem_raw + L::kOffD);
  float* vs = reinterpret_cast<float*>(smem_raw + L::kOffV);
  float* b3s = reinterpret_cast<float*>(smem_raw + L::kOffB3);
  for (int i = threadIdx.x; i < C / 4; i += L::kT)
    cp16(b3s + i * 4, b3 + i * 4);
  if constexpr (kKeep) {
    for (int k = 0; k < L::kChunks; ++k)
      load_chunk<L>(w1s, w2s, vs, w1, b1, wd, b2, w2, k, k);
  } else {
    load_chunk<L>(w1s, w2s, vs, w1, b1, wd, b2, w2, 0, 0);
  }
  cp_commit();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int y0 = (rem / tiles_w) * TH, x0 = (rem % tiles_w) * TW;
    const size_t img = (size_t)n * H * W * C;
    load_input<L>(xs, x, n, y0, x0, H, W);
    cp_commit();
    cp_wait_all();
    if (x1u != nullptr) add_skip<L>(xs, x1u, img, y0, x0, H, W);

    typename L::Acc acc;
    L::clear(acc);
    for (int k = 0; k < L::kChunks; ++k) {
      const int s = kKeep ? k : (k & 1);
      const float* w1c = w1s + s * C * L::kLW1;
      const float* w2c = w2s + s * KC * L::kLW2;
      const float* b1c = vs + s * L::kVec;
      const float* b2c = b1c + KC;
      const float* wdc = b2c + KC;
      if constexpr (!kKeep) cp_wait_all();  // this chunk's weights
      // kept weights: the chunks' phases are ordered by the two barriers
      // below; only the tile's input needs one here
      if (!kKeep || k == 0) __syncthreads();
      // the next chunk's weights land while this one computes: stage s ^ 1
      // was last read by the chunk before, which every thread has finished
      if (!kKeep && k + 1 < L::kChunks) {
        load_chunk<L>(w1s, w2s, vs, w1, b1, wd, b2, w2, k + 1, s ^ 1);
        cp_commit();
      }
      // 1. expansion on the halo tile, 2. depthwise 3x3 on the output tile,
      // 3. projection of this chunk into the register accumulators
      L::expand(xs, w1c, b1c, hs, y0, x0, H, W);
      __syncthreads();
      depthwise<L>(hs, ds, b2c, wdc);
      __syncthreads();
      L::project(ds, w2c, acc);
    }
    L::store(acc, xs, b3s, y + img, y0, x0, H, W);
    __syncthreads();  // xs takes a later tile
  }
}

template <class L>
cudaError_t launch(const void* x, const void* x1u, void* y, const void* w1,
                   const void* b1, const void* wd, const void* b2,
                   const void* w2, const void* b3, int n, int h, int w,
                   cudaStream_t stream) {
  auto kern = ir_block_kernel<L>;
  static int resident = 0;  // blocks the card holds at once (kKeep)
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + L::TW - 1) / L::TW;
  const int tiles_h = (h + L::TH - 1) / L::TH;
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
               &per_sm, kern, L::kT, L::kBytes)) != cudaSuccess)
        return err;
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    grid = n_tiles < resident ? n_tiles : resident;
  }
  if (grid == 0) return cudaSuccess;
  kern<<<grid, L::kT, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(x1u),
      static_cast<float*>(y), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wd),
      static_cast<const float*>(b2), static_cast<const float*>(w2),
      static_cast<const float*>(b3), h, w, tiles_w, tiles_img, n_tiles);
  return cudaGetLastError();
}

// Tiles of each width, <C, TH, TW, KC, kMode, kBlocks, threads, NG>:
// the header says why, PERF.md holds the sets timed against them.  A build
// may set IR_F32_<C> to time another.
#ifndef IR_F32_256
#define IR_F32_256 Tile<256, 8, 8, 16, 0, 1, 512, 2>
#endif
#ifndef IR_F32_128
#define IR_F32_128 Tile<128, 8, 16, 32, 0, 1, 512, 4>
#endif
#ifndef IR_F32_64
#define IR_F32_64 Tile<64, 16, 16, 32, 0, 1, 512, 4>
#endif
#ifndef IR_F32_32
#define IR_F32_32 Tile<32, 8, 16, 32, 1, 2, 256, 4>
#endif

cudaError_t dispatch(int c, const void* x, const void* x1u, void* y,
                     const void* w1, const void* b1, const void* wd,
                     const void* b2, const void* w2, const void* b3, int n,
                     int h, int w, cudaStream_t s) {
  switch (c) {
    case 256: return launch<IR_F32_256>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 128: return launch<IR_F32_128>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 64: return launch<IR_F32_64>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
    case 32: return launch<IR_F32_32>(x, x1u, y, w1, b1, wd, b2, w2, b3, n, h, w, s);
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
