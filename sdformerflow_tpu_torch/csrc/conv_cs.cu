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
// Types: float32 in and out, float32 multiply-adds (no TF32); or bfloat16
// in and out, the products accumulated in float32.
//
// What bounds it on H100: operations. At the en4 embed's shapes a launch
// does 2-92 GFLOP on at most ~0.5 GB of bytes, hundreds of operations a
// byte. The card's bound is its bf16 tensor cores; this first kernel runs on
// the CUDA cores (67 TFLOP/s of float32 FMAs at best), so it stays an order
// of magnitude above that bound; a wgmma implicit GEMM is the later step.
// The design: a block owns a tile of 8 output rows x 32 output columns x 32
// output channels of one image. It walks Cin in chunks of 8: the chunk's
// input tile with its halo (zero where it leaves the frame) and the chunk's
// weights, laid out [ci][tap][co], are staged in shared memory; each thread
// then keeps 4 neighbouring columns x 8 output channels of accumulators in
// registers, reads a row of 4 * stride + k - stride inputs once per (ci, dy)
// and the weights as two 16-byte broadcasts per tap: at k = 3, stride 1 a
// thread does 96 FMAs for 12 shared-memory loads. What the TPU kernel
// needed and this one does not: the 128-lane padding of W, the 8-aligned
// DMA row windows, the block_h picker, the im2col scratch and the revolving
// DMA buffer (pallas_embed.py:175-192).
//
// Rounding: each output is one float32 sum in the order ci, dy, dx with
// fused multiply-adds, then a[co] times it, then plus b[co], each rounded
// once, as the plain twin applies the affine after its convolution. On
// inputs whose every partial sum is exact (dyadic values) the kernel and
// the twin agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
int dispatch(int ksize, int stride, const void* x, const void* w,
             const float* a, const float* b, void* out, int n, int cin,
             int cout, int h, int wd, int ho, int wo, cudaStream_t s) {
  if (ksize == 3 && stride == 1)
    return launch<3, 1, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo, s);
  if (ksize == 3 && stride == 2)
    return launch<3, 2, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo, s);
  if (ksize == 1 && stride == 1)
    return launch<1, 1, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo, s);
  if (ksize == 1 && stride == 2)
    return launch<1, 2, T>(x, w, a, b, out, n, cin, cout, h, wd, ho, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One K4 launch: x [n, cin, h, wd] contiguous, w [cout, cin, ksize, ksize]
// contiguous in x's type, a and b float32 [cout] (null for 1 and 0), out
// [n, cout, ho, wo] contiguous in x's type with ho = (h - 1) / stride + 1
// and wo = (wd - 1) / stride + 1. ksize 1 or 3 (SAME padding), stride 1 or
// 2. dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int conv_cs(const void* x, const void* w, const float* a,
                       const float* b, void* out, int n, int cin, int cout,
                       int h, int wd, int ksize, int stride, int dtype,
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
    return dispatch<float>(ksize, stride, x, w, a, b, out, n, cin, cout, h,
                           wd, ho, wo, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ksize, stride, x, w, a, b, out, n, cin,
                                   cout, h, wd, ho, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
