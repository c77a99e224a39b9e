// K4: a 3x3 or 1x1 SAME convolution with a per-output-channel affine
// epilogue, on channels-second activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdformerflow_tpu/ops/pallas_embed.py:
// _conv_cs_kernel (:112), reached through conv3x3_affine_cs (pallas_call at
// :202). The TPU kernel computes, per time step t of x [T, Cin, H, W] and
// kernel HWIO [k, k, Cin, Cout],
//
//   out[t, co, y, x] = a[co] * sum_{ci, dy, dx} K[dy, dx, ci, co]
//                              * x[t, ci, y + dy - k/2, x + dx - k/2] + b[co]
//
// (zero outside the frame), a and b float32: the folded eval BatchNorm, or
// a conv bias. Channels-second [T, Cin, H, W] is PyTorch's NCHW with time
// as the batch, so here x is [N, Cin, H, W] with N = T * B and the weight is
// PyTorch's OIHW [Cout, Cin, k, k]. The kernel also takes an output stride
// of 2 and computes only the outputs it keeps: the JAX composition runs the
// two stride-2 convolutions of the embed at full resolution and keeps
// [::2, ::2], four times the work for the same function.
//
// What bounds it on H100: operations. At the en4 embed's shapes a launch
// does 2-92 GFLOP on at most ~0.5 GB, hundreds of operations a byte, so the
// bound is the bf16 tensor cores (989 TFLOP/s). Two instantiations share
// the one entry and the one launch counter, dispatched by dtype:
//
// bfloat16: an implicit GEMM on the tensor cores (wgmma, sm90_mma.cuh).
//   M is 64 output pixels of one output row, N is Cout (48 or 96 a block,
//   the padded weight columns masked), K is Cin x taps in steps of 16. A
//   block is two warpgroups and owns 4 output rows x 64 columns x N of one
//   image; each warpgroup holds two m64 accumulators in float32 registers.
//   - NCHW makes the A operand MN-major (pixels contiguous per channel), and
//     a tap's shift of one pixel (two at stride 2) breaks the 16-byte
//     alignment a shared-memory descriptor needs. So A is built in
//     registers: the input tile is staged NCHW in shared memory (rows of
//     the tile with their halo, zero outside the frame), and each thread
//     reads its fragment (2 pixels x 4 channels a k16 step) with 16-bit
//     loads, strided by the output stride. Stride 2 thus stages the full-
//     resolution rows and reads every other pixel; only kept outputs are
//     computed. A channel's plane is padded to 16 mod 64 bytes, which makes
//     the fragment loads free of bank conflicts.
//   - B (the weight) comes from shared memory by descriptor, K-major, no
//     swizzle. The wrapper re-lays the OIHW weight once per call into the
//     exact shared-memory image of each stage (hopper_embed.py:
//     pack_conv_weight), so a stage is one contiguous cp.async copy.
//   - A stage is 16 input channels: the input tile and the weights of all
//     taps for them. Two stages form a ring: the cp.async copy of chunk
//     i + 1 overlaps the products of chunk i. Per tap, the warpgroup loads
//     its fragments into a ring of three, issues two wgmma (one per output
//     row) and waits only for the tap two back, so fragment loads overlap
//     the tensor cores (a ring of two, waiting for the tap before, measured
//     slower on the card).
//   - The head (Cin = 2 at en4) folds its taps into K: Cin x 9 values, padded
//     to 64 (4 k16 steps, issued unconditionally), instead of 9 taps x 16
//     channels (2.25x the work). Any Cin x 9 <= 64 at stride 1 takes this
//     path.
//   - The epilogue applies the affine to the accumulators, rounds to bf16
//     into a shared-memory tile [Cout][4 x 64], and stores it as 16-byte
//     rows of pixels, so the NCHW stores are coalesced.
// float32: the first, CUDA-core kernel (float32 FMAs, no TF32): the tensor
//   cores would round float32 operands to TF32, which the float32 twin does
//   not. A block owns 8 output rows x 32 columns x 32 output channels, walks
//   Cin in chunks of 8 staged in shared memory with their halo, and each
//   thread keeps 4 columns x 8 output channels of accumulators.
//
// What the TPU kernel needed and neither needs: the 128-lane padding of W,
// the 8-aligned DMA row windows, the block_h picker, the im2col scratch and
// the revolving DMA buffer (pallas_embed.py:175-192).
//
// Rounding: each output is one float32 sum, then a[co] times it, then plus
// b[co], each rounded once, as the plain twin applies the affine after its
// convolution; bfloat16 rounds that once more. On inputs whose every
// partial sum is exact (dyadic values) both paths agree with the twin bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

// ------------------------------------------------- float32, CUDA cores

namespace simt {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int kTileH = 8;            // output rows per block
constexpr int kTileW = 32;           // output columns per block
constexpr int kCols = 4;             // output columns per thread
constexpr int kCo = 8;               // output channels per thread
constexpr int kColThreads = kTileW / kCols;               // 8
constexpr int kSpatialThreads = kColThreads * kTileH;     // 64
constexpr int kCoGroups = kThreads / kSpatialThreads;     // 4
constexpr int kCoBlock = kCoGroups * kCo;                 // 32
constexpr int kCinChunk = 8;

template <int K, int S, typename T>
__global__ void __launch_bounds__(kThreads)
conv_cs_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ a, const float* __restrict__ b,
               T* __restrict__ out, int cin, int cout, int h, int wd,
               int ho, int wo, int co_blocks) {
  constexpr int kInH = (kTileH - 1) * S + K;   // input rows of a tile
  constexpr int kInW = (kTileW - 1) * S + K;   // input columns of a tile
  constexpr int kRow = (kCols - 1) * S + K;    // inputs a thread reads a row
  __shared__ float sx[kCinChunk][kInH][kInW];
  __shared__ __align__(16) float sw[kCinChunk][K * K][kCoBlock];

  const int img = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kCoBlock;
  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;
  const int iy0 = oy0 * S - K / 2;
  const int ix0 = ox0 * S - K / 2;
  const int tid = threadIdx.x;
  const int group = tid / kSpatialThreads;
  const int ty = (tid % kSpatialThreads) / kColThreads;
  const int tx = tid % kColThreads;

  const int64_t plane = static_cast<int64_t>(h) * wd;
  const T* xi = x + static_cast<int64_t>(img) * cin * plane;

  float acc[kCo][kCols];
#pragma unroll
  for (int o = 0; o < kCo; ++o)
#pragma unroll
    for (int p = 0; p < kCols; ++p) acc[o][p] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += kCinChunk) {
    const int nc = min(kCinChunk, cin - c0);
    for (int i = tid; i < nc * kInH * kInW; i += kThreads) {
      const int c = i / (kInH * kInW);
      const int r = (i / kInW) % kInH;
      const int q = i % kInW;
      const int iy = iy0 + r;
      const int ix = ix0 + q;
      float v = 0.0f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
        v = load_f(xi + (c0 + c) * plane + static_cast<int64_t>(iy) * wd + ix);
      sx[c][r][q] = v;
    }
    for (int i = tid; i < nc * K * K * kCoBlock; i += kThreads) {
      const int co = i % kCoBlock;
      const int tap = (i / kCoBlock) % (K * K);
      const int c = i / (kCoBlock * K * K);
      float v = 0.0f;
      if (co0 + co < cout)
        v = load_f(w + (static_cast<int64_t>(co0 + co) * cin + c0 + c)
                           * (K * K) + tap);
      sw[c][tap][co] = v;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        float v[kRow];
#pragma unroll
        for (int j = 0; j < kRow; ++j)
          v[j] = sx[c][ty * S + dy][tx * kCols * S + j];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(
              &sw[c][dy * K + dx][group * kCo]);
          const float4 w0 = wp[0];
          const float4 w1 = wp[1];
          const float wv[kCo] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int o = 0; o < kCo; ++o)
#pragma unroll
            for (int p = 0; p < kCols; ++p)
              acc[o][p] = __fmaf_rn(wv[o], v[p * S + dx], acc[o][p]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  if (oy >= ho) return;
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
    const int co = co0 + group * kCo + o;
    if (co >= cout) break;
    const float ao = a == nullptr ? 1.0f : a[co];
    const float bo = b == nullptr ? 0.0f : b[co];
    T* row = out + ((static_cast<int64_t>(img) * cout + co) * ho + oy) * wo;
#pragma unroll
    for (int p = 0; p < kCols; ++p) {
      const int ox = ox0 + tx * kCols + p;
      if (ox < wo) store_f(row + ox, __fadd_rn(__fmul_rn(acc[o][p], ao), bo));
    }
  }
}

template <int K, int S, typename T>
int launch(const void* x, const void* w, const float* a, const float* b,
           void* out, int n, int cin, int cout, int h, int wd, int ho, int wo,
           cudaStream_t stream) {
  const int co_blocks = (cout + kCoBlock - 1) / kCoBlock;
  const int64_t z = static_cast<int64_t>(n) * co_blocks;
  const int gy = (ho + kTileH - 1) / kTileH;
  if (z > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((wo + kTileW - 1) / kTileW, gy, static_cast<unsigned>(z));
  conv_cs_kernel<K, S, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), a, b,
      static_cast<T*>(out), cin, cout, h, wd, ho, wo, co_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------ bfloat16, tensor cores (wgmma)

namespace tc {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileW = 64;                  // output columns: one wgmma M
constexpr int kRowsPerWg = 2;               // M tiles (rows) a warpgroup
constexpr int kTileH = kWarpgroups * kRowsPerWg;   // output rows a block
constexpr int kChunk = 16;                  // input channels a stage
constexpr int kFoldSteps = 4;               // k16 steps of a folded K at most
// output tile row (bf16): 16-byte rows, conflict-free accumulator stores
constexpr int kOutStride = kTileH * kTileW + 8;

// The staged input tile of one block: kRows input rows x kSpan columns per
// channel. Row i is input row oy0 * S - pad + i * kRowStep; column j is input
// column ox0 * S - kLPad + j (kLPad keeps the 16-byte copies aligned).
template <int K, int S>
struct Tile {
  static constexpr int kPad = K / 2;
  static constexpr int kLPad = kPad ? 8 : 0;
  static constexpr int kRows = K == 1 ? kTileH : (kTileH - 1) * S + K;
  static constexpr int kRowStep = K == 1 ? S : 1;
  static constexpr int kSpan = kLPad + kTileW * S + (kPad ? 8 : 0);
  static constexpr int kPlaneRaw = kRows * kSpan;
  // elements a channel, = 8 mod 32 (16 mod 64 bytes): no bank conflicts
  static constexpr int kPlane = kPlaneRaw + (40 - kPlaneRaw % 32) % 32;
};

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Stage input channels [c0, c0 + nch) of the block's tile (zero outside the
// frame and at c >= cin) and `wbytes` bytes of packed weights.
template <int K, int S>
__device__ __forceinline__ void load_stage(
    uint16_t* sx, uint8_t* sw, const uint16_t* __restrict__ x_img,
    const uint8_t* __restrict__ w_src, int wbytes, int c0, int nch, int cin,
    int h, int wd, int iy0, int ix0, bool vec, int tid) {
  using G = Tile<K, S>;
  const int64_t plane = static_cast<int64_t>(h) * wd;
  if (vec) {
    constexpr int kSegs = G::kSpan / 8;
    for (int i = tid; i < nch * G::kRows * kSegs; i += kThreads) {
      const int c = i / (G::kRows * kSegs);
      const int r = (i / kSegs) % G::kRows;
      const int s = i % kSegs;
      const int iy = iy0 + r * G::kRowStep;
      const int ix = ix0 + 8 * s;
      const bool in = c0 + c < cin && iy >= 0 && iy < h && ix >= 0 &&
                      ix < wd;
      const uint16_t* src =
          in ? x_img + (c0 + c) * plane + static_cast<int64_t>(iy) * wd + ix
             : x_img;
      sm90::cp_async16(sx + c * G::kPlane + r * G::kSpan + 8 * s, src,
                       in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < nch * G::kRows * G::kSpan; i += kThreads) {
      const int c = i / (G::kRows * G::kSpan);
      const int r = (i / G::kSpan) % G::kRows;
      const int j = i % G::kSpan;
      const int iy = iy0 + r * G::kRowStep;
      const int ix = ix0 + j;
      uint16_t v = 0;
      if (c0 + c < cin && iy >= 0 && iy < h && ix >= 0 && ix < wd)
        v = x_img[(c0 + c) * plane + static_cast<int64_t>(iy) * wd + ix];
      sx[c * G::kPlane + r * G::kSpan + j] = v;
    }
  }
  for (int i = 16 * tid; i < wbytes; i += 16 * kThreads)
    sm90::cp_async16(sw + i, w_src + i, 16);
}

// Epilogue: affine, bf16 rounding, the [NT][4 x 64] tile in shared memory,
// then 16-byte coalesced NCHW stores.
template <int NT>
__device__ __forceinline__ void store_tile(
    float (&acc)[kRowsPerWg][NT / 2], uint16_t* so,
    const float* __restrict__ a, const float* __restrict__ b,
    __nv_bfloat16* __restrict__ out, int img, int n0, int cout, int ho,
    int wo, int oy0, int ox0, bool vec, int tid) {
  const int wg = tid / 128;
  const int m0 = 16 * ((tid % 128) / 32) + (tid % 32) / 4;
  const int q = tid % 4;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * q + e;
      const int co = n0 + col;
      const float av = (a == nullptr || co >= cout) ? 1.0f : a[co];
      const float bv = (b == nullptr || co >= cout) ? 0.0f : b[co];
#pragma unroll
      for (int mt = 0; mt < kRowsPerWg; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v = __fadd_rn(__fmul_rn(acc[mt][4 * j + 2 * hh + e], av),
                                    bv);
          const __nv_bfloat16 r = __float2bfloat16_rn(v);
          const int px = (wg * kRowsPerWg + mt) * kTileW + m0 + 8 * hh;
          so[col * kOutStride + px] = *reinterpret_cast<const uint16_t*>(&r);
        }
    }
  }
  __syncthreads();
  uint16_t* o = reinterpret_cast<uint16_t*>(out);
  const int ncol = min(NT, cout - n0);
  if (vec) {
    constexpr int kSegs = kTileW / 8;
    for (int i = tid; i < ncol * kTileH * kSegs; i += kThreads) {
      const int col = i / (kTileH * kSegs);
      const int rr = (i / kSegs) % kTileH;
      const int s = i % kSegs;
      const int oy = oy0 + rr;
      const int ox = ox0 + 8 * s;
      if (oy >= ho || ox >= wo) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          so + col * kOutStride + rr * kTileW + 8 * s);
      *reinterpret_cast<uint4*>(
          o + ((static_cast<int64_t>(img) * cout + n0 + col) * ho + oy) * wo
          + ox) = v;
    }
  } else {
    for (int i = tid; i < ncol * kTileH * kTileW; i += kThreads) {
      const int col = i / (kTileH * kTileW);
      const int rr = (i / kTileW) % kTileH;
      const int px = i % kTileW;
      const int oy = oy0 + rr;
      const int ox = ox0 + px;
      if (oy >= ho || ox >= wo) continue;
      o[((static_cast<int64_t>(img) * cout + n0 + col) * ho + oy) * wo + ox] =
          so[col * kOutStride + rr * kTileW + px];
    }
  }
}

// Shared memory of one block: the stages, then (reusing them) the output tile.
template <int K, int S, int NT, bool FOLD>
struct Smem {
  using G = Tile<K, S>;
  static constexpr int kChannels = FOLD ? 8 : kChunk;
  static constexpr int kIn = kChannels * G::kPlane * 2;
  static constexpr int kW = (FOLD ? kFoldSteps : K * K) * NT * 32;
  static constexpr int kStage = kIn + kW;
  static constexpr int kStages = FOLD ? 1 : 2;
  static constexpr int kOut = NT * kOutStride * 2;
  static constexpr int kBytes =
      kStages * kStage > kOut ? kStages * kStage : kOut;
};

// FOLD: K is ci * K * K + tap (the OIHW order), zero-padded to kFoldSteps
// k16 steps, all in one stage. Otherwise K runs over 16-channel stages, a
// k16 step a tap.
template <int K, int S, int NT, bool FOLD>
__global__ void __launch_bounds__(kThreads)
conv_wgmma_kernel(const uint16_t* __restrict__ x,
                  const uint8_t* __restrict__ wpk,
                  const float* __restrict__ a, const float* __restrict__ b,
                  __nv_bfloat16* __restrict__ out, int cin, int cout, int h,
                  int wd, int ho, int wo, int co_chunks, int vec_in,
                  int vec_out) {
  using G = Tile<K, S>;
  using SM = Smem<K, S, NT, FOLD>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int img = blockIdx.z / co_chunks;
  const int nchunk = blockIdx.z % co_chunks;
  const int n0 = nchunk * NT;
  const int oy0 = blockIdx.y * kTileH;
  const int ox0 = blockIdx.x * kTileW;
  const int iy0 = oy0 * S - G::kPad;
  const int ix0 = ox0 * S - G::kLPad;
  const uint16_t* x_img = x + static_cast<int64_t>(img) * cin * h * wd;

  // this thread's fragment coordinates
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int pix0 = (16 * ((tid % 128) / 32) + g) * S - G::kPad + G::kLPad;
  const int pix1 = pix0 + 8 * S;

  float acc[kRowsPerWg][NT / 2];
#pragma unroll
  for (int mt = 0; mt < kRowsPerWg; ++mt)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[mt][i] = 0.0f;

  if constexpr (FOLD) {
    uint16_t* sx = reinterpret_cast<uint16_t*>(smem);
    uint8_t* sw = smem + SM::kIn;
    constexpr int kWBytes = kFoldSteps * NT * 32;
    load_stage<K, S>(sx, sw, x_img,
                     wpk + static_cast<int64_t>(nchunk) * kWBytes, kWBytes, 0,
                     cin, cin, h, wd, iy0, ix0, vec_in, tid);
    sm90::cp_async_commit();
    // the offsets of this thread's 4 k values of each k16 step
    int off[kFoldSteps][4];
    bool ok[kFoldSteps][4];
#pragma unroll
    for (int s = 0; s < kFoldSteps; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * s + 2 * q + (i & 1) + 8 * (i >> 1);
        const int ci = k / (K * K), tap = k % (K * K);
        ok[s][i] = k < cin * K * K;
        off[s][i] = ok[s][i] ? ci * G::kPlane + (tap / K) * G::kSpan + tap % K
                             : 0;
      }
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();
    const uint32_t sw_addr = sm90::smem_addr(sw);
    // every k16 step, past Cin x K x K too (zero inputs and weights
    // there): a wgmma under a runtime condition leaves its accumulators
    // merged at the branch's join while it may still be writing them
#pragma unroll
    for (int s = 0; s < kFoldSteps; ++s) {
      uint32_t af[kRowsPerWg][4];
#pragma unroll
      for (int mt = 0; mt < kRowsPerWg; ++mt) {
        const int rb = (wg * kRowsPerWg + mt) * S * G::kSpan;
        uint16_t v[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i][0] = ok[s][i] ? sx[off[s][i] + rb + pix0] : 0;
          v[i][1] = ok[s][i] ? sx[off[s][i] + rb + pix1] : 0;
        }
        af[mt][0] = pack2(v[0][0], v[1][0]);
        af[mt][1] = pack2(v[0][1], v[1][1]);
        af[mt][2] = pack2(v[2][0], v[3][0]);
        af[mt][3] = pack2(v[2][1], v[3][1]);
      }
      sm90::wgmma_fence();
      const uint64_t db = sm90::desc(sw_addr + s * NT * 32, NT * 16, 128);
#pragma unroll
      for (int mt = 0; mt < kRowsPerWg; ++mt)
        sm90::WgmmaRS<NT>::mma(acc[mt], af[mt], db);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
  } else {
    const int nstages = (cin + kChunk - 1) / kChunk;
    constexpr int kWStage = K * K * NT * 32;
    int cb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cb[i] = (2 * q + (i & 1) + 8 * (i >> 1)) * G::kPlane;
    auto stage_x = [&](int st) {
      return reinterpret_cast<uint16_t*>(smem + st * SM::kStage);
    };
    auto stage_w = [&](int st) { return smem + st * SM::kStage + SM::kIn; };
    const uint8_t* w_chunk =
        wpk + static_cast<int64_t>(nchunk) * nstages * kWStage;
    load_stage<K, S>(stage_x(0), stage_w(0), x_img, w_chunk, kWStage, 0,
                     kChunk, cin, h, wd, iy0, ix0, vec_in, tid);
    sm90::cp_async_commit();
    for (int c = 0; c < nstages; ++c) {
      if (c + 1 < nstages)
        load_stage<K, S>(stage_x((c + 1) & 1), stage_w((c + 1) & 1), x_img,
                         w_chunk + static_cast<int64_t>(c + 1) * kWStage,
                         kWStage, (c + 1) * kChunk, kChunk, cin, h, wd, iy0,
                         ix0, vec_in, tid);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
      sm90::fence_proxy_async();
      __syncthreads();
      const uint16_t* sx = stage_x(c & 1);
      const uint32_t sw_addr = sm90::smem_addr(stage_w(c & 1));
      uint32_t af[3][kRowsPerWg][4];   // a ring of 3 taps' fragments
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const int dy = tap / K, dx = tap % K;
        const int buf = tap % 3;
#pragma unroll
        for (int mt = 0; mt < kRowsPerWg; ++mt) {
          const int rr = wg * kRowsPerWg + mt;
          const int base = (K == 1 ? rr : rr * S + dy) * G::kSpan + dx;
          const uint16_t* s0 = sx + base + pix0;
          const uint16_t* s1 = sx + base + pix1;
          af[buf][mt][0] = pack2(s0[cb[0]], s0[cb[1]]);
          af[buf][mt][1] = pack2(s1[cb[0]], s1[cb[1]]);
          af[buf][mt][2] = pack2(s0[cb[2]], s0[cb[3]]);
          af[buf][mt][3] = pack2(s1[cb[2]], s1[cb[3]]);
        }
        sm90::wgmma_fence();
        const uint64_t db = sm90::desc(sw_addr + tap * NT * 32, NT * 16, 128);
#pragma unroll
        for (int mt = 0; mt < kRowsPerWg; ++mt)
          sm90::WgmmaRS<NT>::mma(acc[mt], af[buf][mt], db);
        sm90::wgmma_commit();
        // the products of tap - 2 are done before its buffer is refilled
        sm90::wgmma_wait<2>();
      }
      sm90::wgmma_wait<0>();
      __syncthreads();
    }
  }
#pragma unroll
  for (int mt = 0; mt < kRowsPerWg; ++mt)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sm90::fence_operand(acc[mt][i]);
  __syncthreads();  // every warpgroup is done with the stages
  store_tile<NT>(acc, reinterpret_cast<uint16_t*>(smem), a, b, out, img, n0,
                 cout, ho, wo, oy0, ox0, vec_out, tid);
}

template <int K, int S, int NT, bool FOLD>
int launch(const void* x, const void* wpk, const float* a, const float* b,
           void* out, int n, int cin, int cout, int h, int wd, int ho, int wo,
           cudaStream_t stream) {
  using SM = Smem<K, S, NT, FOLD>;
  auto kernel = conv_wgmma_kernel<K, S, NT, FOLD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int co_chunks = (cout + NT - 1) / NT;
  const int64_t z = static_cast<int64_t>(n) * co_chunks;
  const int gy = (ho + kTileH - 1) / kTileH;
  if (z > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (FOLD && cin * K * K > 16 * kFoldSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = wd % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      wo % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((wo + kTileW - 1) / kTileW, gy, static_cast<unsigned>(z));
  kernel<<<grid, kThreads, SM::kBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(wpk), a, b,
      static_cast<__nv_bfloat16*>(out), cin, cout, h, wd, ho, wo, co_chunks,
      vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch(int ksize, int stride, bool fold, const void* x, const void* wpk,
             const float* a, const float* b, void* out, int n, int cin,
             int cout, int h, int wd, int ho, int wo, cudaStream_t s) {
  if (fold) {
    if (ksize == 3 && stride == 1)
      return launch<3, 1, NT, true>(x, wpk, a, b, out, n, cin, cout, h, wd,
                                    ho, wo, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ksize == 3 && stride == 1)
    return launch<3, 1, NT, false>(x, wpk, a, b, out, n, cin, cout, h, wd, ho,
                                   wo, s);
  if (ksize == 3 && stride == 2)
    return launch<3, 2, NT, false>(x, wpk, a, b, out, n, cin, cout, h, wd, ho,
                                   wo, s);
  if (ksize == 1 && stride == 1)
    return launch<1, 1, NT, false>(x, wpk, a, b, out, n, cin, cout, h, wd, ho,
                                   wo, s);
  if (ksize == 1 && stride == 2)
    return launch<1, 2, NT, false>(x, wpk, a, b, out, n, cin, cout, h, wd, ho,
                                   wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

template <typename T>
int dispatch_simt(int ksize, int stride, const void* x, const void* w,
                  const float* a, const float* b, void* out, int n, int cin,
                  int cout, int h, int wd, int ho, int wo, cudaStream_t s) {
  if (ksize == 3 && stride == 1)
    return simt::launch<3, 1, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo,
                                 s);
  if (ksize == 3 && stride == 2)
    return simt::launch<3, 2, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo,
                                 s);
  if (ksize == 1 && stride == 1)
    return simt::launch<1, 1, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo,
                                 s);
  if (ksize == 1 && stride == 2)
    return simt::launch<1, 2, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One K4 launch: x [n, cin, h, wd] contiguous, a and b float32 [cout] (null
// for 1 and 0), out [n, cout, ho, wo] contiguous in x's type with
// ho = (h - 1) / stride + 1 and wo = (wd - 1) / stride + 1. ksize 1 or 3
// (SAME padding), stride 1 or 2.
// dtype 0 (float32): w is the OIHW weight [cout, cin, ksize, ksize].
// dtype 1 (bfloat16): wpk is the weight packed by hopper_embed.py:
// pack_conv_weight for block width nt (48 or 96) and fold (0 or 1) (tensor
// cores).
// dtype 2 (bfloat16 on the CUDA-core kernel, the first version of K4, kept
// as the yardstick of the tensor-core one): w as for dtype 0, in bf16.
// Returns the cudaError_t of the launch.
extern "C" int conv_cs(const void* x, const void* w, const void* wpk,
                       const float* a, const float* b, void* out, int n,
                       int cin, int cout, int h, int wd, int ksize,
                       int stride, int dtype, int nt, int fold,
                       void* stream) {
  if (n < 0 || cin < 1 || cout < 1 || h < 1 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (stride != 1 && stride != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_simt<float>(ksize, stride, x, w, a, b, out, n, cin, cout,
                                h, wd, ho, wo, s);
  if (dtype == 2)
    return dispatch_simt<__nv_bfloat16>(ksize, stride, x, w, a, b, out, n,
                                        cin, cout, h, wd, ho, wo, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nt == 48)
    return tc::dispatch<48>(ksize, stride, fold != 0, x, wpk, a, b, out, n,
                            cin, cout, h, wd, ho, wo, s);
  if (nt == 96)
    return tc::dispatch<96>(ksize, stride, fold != 0, x, wpk, a, b, out, n,
                            cin, cout, h, wd, ho, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
