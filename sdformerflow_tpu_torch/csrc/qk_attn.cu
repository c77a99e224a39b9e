// K1: eval-mode spiking-QK window-attention interior for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdformerflow_tpu/ops/pallas_attn.py:_kernel
// (entry fused_qk_attention). For every row r of the [M*ns] window-token axis
// it computes, over both time halves t in {0, 1}:
//
//   xs_t  = PSN2_in(x_0[r], x_1[r])                      input spikes
//   q_t   = PSN2_q(aq * (xs_t @ Wq) + cq)                 q spikes
//   k_t   = PSN2_k(ak * (xs_t @ Wk) + ck + pe[t][r % ns])  k spikes
//   tok_t = PSN2_t(sum of q_t over each head's hd channels)
//   out_t[r, c] = k_t[r, c] * tok_t[r, c / hd]
//
// where PSN2(a0, a1) = (H(w00 a0 + w01 a1 + b0), H(w10 a0 + w11 a1 + b1)).
// The pair-regroup, proj matmul and BN affine that follow stay in torch
// (sdformerflow_tpu_torch/ops/hopper_attn.py), as they stayed in XLA.
//
// What bounds it on H100: the two C x C products per row (4 * C^2 FMAs per
// row for both halves of q and k) done here on the CUDA cores in f32. At the
// en4 288x384 sites (M*ns rows, C) that is 2.63 GFLOP at (35640, 96), 2.87
// at (9720, 192) and (2430, 384), and 3.82 at (810, 768). Not the memory
// traffic: x is read once, the 0/1 output written once.
// The design keeps every intermediate on chip: one block owns a tile of rows of BOTH time halves (the PSN pairs x_0[r] with
// x_1[r]), writes the input spikes to shared memory once, and each thread
// accumulates kRows rows of q and k at one output channel, so every weight
// element loaded from L1/L2 feeds 4 * kRows FMAs and every spike read from
// shared memory is a warp broadcast. q spikes are counted per (row, head)
// with shared-memory integer atomics (exact, order-free), k spikes wait in
// shared memory as bytes, and a last pass writes k * tok coalesced.
// This is the simple first version: no tensor cores (wgmma), no TMA.
//
// Rounding: the affine, positional-encoding and PSN steps round each
// product and sum separately (no FMA contraction), in the order of the
// plain PyTorch version; only the dot products' summation order differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;          // rows of the tile each thread accumulates
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// (w0 * a + w1 * b) + bias, each step rounded, >= 0 -> spike
__device__ __forceinline__ bool psn_fire(float w0, float a, float w1, float b,
                                         float bias) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)), bias) >= 0.f;
}

// psn layout: 4 neurons x (w00, w01, w10, w11, b0, b1): in, q, k, tok
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) qk_attn_kernel(
    const T* __restrict__ x,           // [2, R, C]
    const T* __restrict__ wq,          // [C, C] input-major
    const T* __restrict__ wk,          // [C, C] input-major
    const T* __restrict__ pe,          // [2, ns, C]
    const float* __restrict__ affine,  // [4, C]: aq, cq, ak, ck
    const float* __restrict__ psn,     // [4, 6]
    T* __restrict__ out,               // [2, R, C]
    int R, int C, int nh, int ns, int tile_rows) {
  extern __shared__ float smem[];
  __shared__ float p[24];
  const int tile = tile_rows * C;
  float* xs = smem;                                   // [2][tile_rows][C]
  int* tok = reinterpret_cast<int*>(xs + 2 * tile);   // [2][tile_rows][nh]
  uint8_t* ks = reinterpret_cast<uint8_t*>(tok + 2 * tile_rows * nh);
                                                      // [2][tile_rows][C]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tile_rows;
  const int n_rows = min(tile_rows, R - row0);
  const size_t half = static_cast<size_t>(R) * C;
  const size_t base = static_cast<size_t>(row0) * C;
  const int hd = C / nh;

  if (tid < 24) p[tid] = psn[tid];
  for (int i = tid; i < 2 * tile_rows * nh; i += blockDim.x) tok[i] = 0;
  __syncthreads();

  // 1. input spikes of both halves; rows past R are zero
  for (int i = tid; i < tile; i += blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
    if (i < n_rows * C) {
      const float x0 = to_f32(x[base + i]);
      const float x1 = to_f32(x[half + base + i]);
      s0 = psn_fire(p[0], x0, p[1], x1, p[4]) ? 1.f : 0.f;
      s1 = psn_fire(p[2], x0, p[3], x1, p[5]) ? 1.f : 0.f;
    }
    xs[i] = s0;
    xs[tile + i] = s1;
  }
  __syncthreads();

  // 2. q and k for kRows rows at one output channel per work item
  const int row_groups = tile_rows / kRows;
  for (int o = tid; o < row_groups * C; o += blockDim.x) {
    const int co = o % C;
    const int rb = (o / C) * kRows;
    float q0[kRows], q1[kRows], k0[kRows], k1[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) q0[j] = q1[j] = k0[j] = k1[j] = 0.f;
    const float* xs0 = xs + rb * C;
    const float* xs1 = xs + tile + rb * C;
    for (int ci = 0; ci < C; ++ci) {
      const float wqv = to_f32(wq[static_cast<size_t>(ci) * C + co]);
      const float wkv = to_f32(wk[static_cast<size_t>(ci) * C + co]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float a0 = xs0[j * C + ci];
        const float a1 = xs1[j * C + ci];
        q0[j] = fmaf(a0, wqv, q0[j]);
        q1[j] = fmaf(a1, wqv, q1[j]);
        k0[j] = fmaf(a0, wkv, k0[j]);
        k1[j] = fmaf(a1, wkv, k1[j]);
      }
    }
    const float aq = affine[co], cq = affine[C + co];
    const float ak = affine[2 * C + co], ck = affine[3 * C + co];
    const int h = co / hd;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = rb + j;
      if (r >= n_rows) break;
      const int tokpos = (row0 + r) % ns;
      const float yq0 = __fadd_rn(__fmul_rn(aq, q0[j]), cq);
      const float yq1 = __fadd_rn(__fmul_rn(aq, q1[j]), cq);
      const float yk0 = __fadd_rn(__fadd_rn(__fmul_rn(ak, k0[j]), ck),
                                  to_f32(pe[tokpos * C + co]));
      const float yk1 = __fadd_rn(__fadd_rn(__fmul_rn(ak, k1[j]), ck),
                                  to_f32(pe[(ns + tokpos) * C + co]));
      if (psn_fire(p[6], yq0, p[7], yq1, p[10])) atomicAdd(&tok[r * nh + h], 1);
      if (psn_fire(p[8], yq0, p[9], yq1, p[11]))
        atomicAdd(&tok[(tile_rows + r) * nh + h], 1);
      ks[r * C + co] = psn_fire(p[12], yk0, p[13], yk1, p[16]);
      ks[tile + r * C + co] = psn_fire(p[14], yk0, p[15], yk1, p[17]);
    }
  }
  __syncthreads();

  // 3. head tokens and the slab-local product k * tok, written coalesced
  for (int i = tid; i < n_rows * C; i += blockDim.x) {
    const int r = i / C;
    const int h = (i % C) / hd;
    const float s0 = static_cast<float>(tok[r * nh + h]);
    const float s1 = static_cast<float>(tok[(tile_rows + r) * nh + h]);
    const bool t0 = psn_fire(p[18], s0, p[19], s1, p[22]);
    const bool t1 = psn_fire(p[20], s0, p[21], s1, p[23]);
    out[base + i] = from_f32<T>(ks[i] && t0 ? 1.f : 0.f);
    out[half + base + i] = from_f32<T>(ks[tile + i] && t1 ? 1.f : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wq, const void* wk,
                   const void* pe, const float* affine, const float* psn,
                   void* out, int R, int C, int nh, int ns,
                   cudaStream_t stream) {
  // enough row groups that one block has ~512 work items in step 2
  const int row_groups = C >= 512 ? 1 : 512 / C;
  const int tile_rows = row_groups * kRows;
  int threads = ((row_groups * C + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * C * sizeof(float)
                      + 2 * static_cast<size_t>(tile_rows) * nh * sizeof(int)
                      + 2 * static_cast<size_t>(tile_rows) * C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qk_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (R + tile_rows - 1) / tile_rows;
  qk_attn_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(pe), affine, psn,
      static_cast<T*>(out), R, C, nh, ns, tile_rows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int qk_attn_forward(const void* x, const void* wq, const void* wk,
                               const void* pe, const float* affine,
                               const float* psn, void* out, int R, int C,
                               int nh, int ns, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wq, wk, pe, affine, psn, out, R, C, nh, ns, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, wk, pe, affine, psn, out, R, C, nh,
                                 ns, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
