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
// What bounds it on H100: the two C x C products per row (8 C^2 operations
// a row for q and k over both halves): 2.63 GFLOP at the en4 288x384 site
// (35640 rows, C 96), 2.87 at (9720, 192) and (2430, 384), 3.82 at
// (810, 768). The spikes are 0/1 and the weights bf16, so the products are
// exact on the bf16 tensor cores (989 TFLOP/s) with float32 sums; x is read
// once and the 0/1 output written once, about as many bytes as operations
// take at that rate. Two instantiations share the one entry and the one
// launch counter, dispatched by dtype:
//
// bfloat16: the products on the tensor cores (wgmma, sm90_mma.cuh). A block
//   is one warpgroup and owns 64 rows (one wgmma M) of both halves and 32
//   output channels: N = 64 columns [q | k] of the same 32 channels.
//   - The input spikes are computed from x (both halves of a row in one
//     thread) and stored as exact bf16 0/1 in shared memory; rows are
//     channel-contiguous, so that is the K-major A operand (no swizzle).
//     The weights arrive input-major [C, C] (MN-major B); the wrapper
//     re-lays [Wq | Wk] per 32-channel group and 64-channel K chunk into
//     the K-major shared-memory image of a stage (hopper_attn.py:
//     pack_qk_weight), copied by cp.async.
//   - K runs in chunks of 64 channels (the last zero-padded: every wgmma is
//     issued unconditionally) through a ring of two stages: while
//     the tensor cores multiply chunk i, the warpgroup computes chunk i + 1's
//     spikes from x and its weights are copied. So at C = 768 the A tile
//     never has to hold a whole row (196 KB for both halves), and 48 KB of
//     shared memory serve every C.
//   - One wgmma per half against the same weight chunk: a thread holds
//     (r, c) of half 0 and half 1 in the same registers, so every PSN2 over
//     the halves stays in the thread.
//   - Splitting N by 32 channels gives ceil(R / 64) x C / 32 blocks: 312 at
//     the smallest en4 site (810 rows), enough for the 132 SMs.
//   - A head of hd channels that divides 32 (hd = 32 at every en4 stage)
//     lies inside one block: a thread's own q columns plus shuffles within
//     its quad (fewer for narrower heads) give the head's count, and
//     tok and k * tok follow in registers. The 0/1 result goes through
//     shared memory and out as 16-byte rows. Any other head width (a head
//     straddling 32-channel groups) takes one block per 64 rows that walks
//     every group, counts q spikes per (row, head) with shared-memory
//     integer atomics (exact, order-free) and keeps k spikes as bytes in
//     shared memory until the last group.
// float32: the first, CUDA-core kernel (f32 FMAs): the tensor cores would
//   round float32 weights to TF32. A block owns a tile of rows of both
//   halves, writes the input spikes to shared memory once, and each thread
//   accumulates kRows rows of q and k at one output channel; q spikes are
//   counted per (row, head) with shared-memory integer atomics, k spikes wait
//   in shared memory as bytes, and a last pass writes k * tok coalesced.
//
// Rounding: the affine, positional-encoding and PSN steps round each
// product and sum separately (no FMA contraction), in the order of the
// plain PyTorch version; only the dot products' summation order differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_mma.cuh"

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

// ------------------------------------------ bfloat16, tensor cores (wgmma)

namespace tc {

constexpr int kThreads = 128;                 // one warpgroup
constexpr int kTileRows = 64;                 // wgmma M
constexpr int kQN = 32;                       // output channels a block
constexpr int kN = 2 * kQN;                   // wgmma N: [q | k]
constexpr int kKC = 64;                       // input channels a stage
constexpr int kHalfBytes = kTileRows * kKC * 2;       // A of one half, 8 KB
constexpr int kABytes = 2 * kHalfBytes;
constexpr int kBBytes = kKC * kN * 2;                 // 8 KB
constexpr int kStage = kABytes + kBBytes;             // 24 KB
constexpr int kOutStride = kQN + 8;           // bf16: 80-byte rows
constexpr int kSmemMax = 232448;

__device__ __forceinline__ uint16_t spike_bits(bool s) {
  return s ? 0x3F80 : 0;  // bf16 1.0 or 0.0
}

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Stage chunk kc: the packed weight chunk by cp.async, and the input spikes
// of both halves of the block's 64 rows at channels [64 kc, 64 kc + 64) as
// K-major core matrices ([kg][row][8]; zero past R and C).
__device__ __forceinline__ void produce(
    uint8_t* st, const uint16_t* __restrict__ x,
    const uint8_t* __restrict__ w_src, const float* p, int R, int C,
    int row0, int kc, bool vec, int tid) {
  uint8_t* sb = st + kABytes;
#pragma unroll
  for (int i = 0; i < kBBytes / (16 * kThreads); ++i) {
    const int off = 16 * (tid + i * kThreads);
    sm90::cp_async16(sb + off, w_src + off, 16);
  }
  const int lane = tid % 32;
  const size_t half = static_cast<size_t>(R) * C;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int combo = (tid / 32) * 4 + it;
    const int r = (combo & 7) * 8 + (lane & 7);
    const int kg = (combo >> 3) * 4 + (lane >> 3);
    const int row = row0 + r;
    const int c0 = kc * kKC + kg * 8;
    uint16_t x0[8], x1[8];
    if (row < R && vec && c0 + 8 <= C) {
      const uint4 v0 = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(row) * C + c0);
      const uint4 v1 = *reinterpret_cast<const uint4*>(
          x + half + static_cast<size_t>(row) * C + c0);
      const uint16_t* a0 = reinterpret_cast<const uint16_t*>(&v0);
      const uint16_t* a1 = reinterpret_cast<const uint16_t*>(&v1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x0[e] = a0[e];
        x1[e] = a1[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = row < R && c0 + e < C;
        x0[e] = in ? x[static_cast<size_t>(row) * C + c0 + e] : 0;
        x1[e] = in ? x[half + static_cast<size_t>(row) * C + c0 + e] : 0;
      }
    }
    uint16_t s0[8], s1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = row < R && c0 + e < C;
      const float f0 = bf16_bits_to_f32(x0[e]);
      const float f1 = bf16_bits_to_f32(x1[e]);
      s0[e] = spike_bits(in && psn_fire(p[0], f0, p[1], f1, p[4]));
      s1[e] = spike_bits(in && psn_fire(p[2], f0, p[3], f1, p[5]));
    }
    uint8_t* dst = st + (kg * kTileRows + r) * 16;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s0);
    *reinterpret_cast<uint4*>(dst + kHalfBytes) =
        *reinterpret_cast<const uint4*>(s1);
  }
}

// q and k of 32 output channels for the block's 64 rows, both halves:
// acc_t[4 j + 2 h + e] is (row 16 w + g + 8 h, column 8 j + 2 q + e), q
// at j < 4, k at j >= 4.
__device__ __forceinline__ void products(
    float (&acc0)[kN / 2], float (&acc1)[kN / 2], uint8_t* stages,
    const uint16_t* __restrict__ x, const uint8_t* __restrict__ w_group,
    const float* p, int R, int C, int row0, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc0[i] = acc1[i] = 0.0f;
  const int nk = (C + kKC - 1) / kKC;
  produce(stages, x, w_group, p, R, C, row0, 0, vec, tid);
  sm90::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();
    uint8_t* st = stages + (kc & 1) * kStage;
    const uint32_t a_addr = sm90::smem_addr(st);
    const uint32_t b_addr = a_addr + kABytes;
    // every k16 step of the chunk, past C too (zero spikes and weights
    // there): a wgmma under a runtime condition leaves its accumulators
    // merged at the branch's join while it may still be writing them
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kKC / 16; ++s) {
      const uint64_t db = sm90::desc(b_addr + s * 2048, kQN * 2 * 16, 128);
      sm90::WgmmaSS<kN>::mma(
          acc0, sm90::desc(a_addr + s * 2048, kTileRows * 16, 128), db);
      sm90::WgmmaSS<kN>::mma(
          acc1,
          sm90::desc(a_addr + kHalfBytes + s * 2048, kTileRows * 16, 128),
          db);
    }
    sm90::wgmma_commit();
    if (kc + 1 < nk) {
      produce(stages + ((kc + 1) & 1) * kStage, x,
              w_group + static_cast<size_t>(kc + 1) * kBBytes, p, R, C, row0,
              kc + 1, vec, tid);
      sm90::cp_async_commit();
    }
    sm90::wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    sm90::fence_operand(acc0[i]);
    sm90::fence_operand(acc1[i]);
  }
  __syncthreads();  // the stages are free
}

// The per-head q count of the thread's columns (8 j + 2 q + e of its
// group) from their spikes sq[j][e], for a head width hd dividing 32: the
// thread's own columns, then partners in its quad (all lanes take part).
__device__ __forceinline__ void head_counts(const bool (&sq)[4][2], int hd,
                                            float (&cnt)[4][2]) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = static_cast<float>(sq[j][0]) + static_cast<float>(sq[j][1]);
  if (hd >= 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], 1);
  }
  if (hd >= 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], 2);
  }
  if (hd == 16) {
    const float a = v[0] + v[1], b = v[2] + v[3];
    v[0] = v[1] = a;
    v[2] = v[3] = b;
  } else if (hd == 32) {
    const float a = (v[0] + v[1]) + (v[2] + v[3]);
    v[0] = v[1] = v[2] = v[3] = a;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cnt[j][e] = hd == 1 ? static_cast<float>(sq[j][e]) : v[j];
}

// WHOLE: a head lies inside the block's 32 channels (hd divides 32).
// Four blocks an SM (at most 128 registers a thread, a few spilled): the
// products are short and each block waits on its loads, so occupancy is
// what hides the latency (two or three blocks an SM measured slower).
template <bool WHOLE>
__global__ void __launch_bounds__(kThreads, 4) qk_attn_wgmma_kernel(
    const uint16_t* __restrict__ x,       // [2, R, C] bf16
    const uint8_t* __restrict__ wpk,      // packed [Wq | Wk]
    const uint16_t* __restrict__ pe,      // [2, ns, C] bf16
    const float* __restrict__ affine,     // [4, C]: aq, cq, ak, ck
    const float* __restrict__ psn,        // [4, 6]
    uint16_t* __restrict__ out,           // [2, R, C] bf16
    int R, int C, int nh, int ns) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float p[24];
  __shared__ float aff[4][kQN];           // the group's aq, cq, ak, ck
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTileRows;
  const int hd = C / nh;
  const int nk = (C + kKC - 1) / kKC;
  const bool vec = C % 8 == 0;
  const size_t half = static_cast<size_t>(R) * C;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int rbase = 16 * (tid / 32) + g;
  if (tid < 24) p[tid] = psn[tid];

  // the generic path's per-(row, head) q counts and k spikes
  int* cnt = reinterpret_cast<int*>(smem + 2 * kStage);       // [2][64][nh]
  uint8_t* kbuf = reinterpret_cast<uint8_t*>(cnt + 2 * kTileRows * nh);
  if (!WHOLE) {
    for (int i = tid; i < 2 * kTileRows * nh; i += kThreads) cnt[i] = 0;
  }
  __syncthreads();

  const int g_begin = WHOLE ? blockIdx.y : 0;
  const int g_end = WHOLE ? blockIdx.y + 1 : (C + kQN - 1) / kQN;
  for (int grp = g_begin; grp < g_end; ++grp) {
    const int n0 = grp * kQN;
    {
      const int c = n0 + tid % kQN;
      aff[tid / kQN][tid % kQN] = c < C ? affine[(tid / kQN) * C + c] : 0.f;
    }
    float acc0[kN / 2], acc1[kN / 2];
    products(acc0, acc1, smem, x,
             wpk + static_cast<size_t>(grp) * nk * kBBytes, p, R, C, row0,
             vec, tid);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rbase + 8 * hh;
      // pe of the row's token at the thread's column pairs, both halves
      const int tok = (row0 + r < R ? row0 + r : 0) % ns;
      uint32_t pev[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 8 * j + 2 * q;
          const uint16_t* src = pe + static_cast<size_t>(t * ns + tok) * C;
          const uint32_t lo = c < C ? src[c] : 0;
          const uint32_t hi = c + 1 < C ? src[c + 1] : 0;
          pev[t][j] = lo | (hi << 16);
        }
      // q and k spikes of the thread's columns in this row, both halves
      bool sq[2][4][2], sk[2][4][2];  // [half][j][e]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j + 2 * q + e;
          const bool in = n0 + cl < C;
          const int iq = 4 * j + 2 * hh + e, ik = iq + 16;
          const float yq0 = __fadd_rn(__fmul_rn(aff[0][cl], acc0[iq]),
                                      aff[1][cl]);
          const float yq1 = __fadd_rn(__fmul_rn(aff[0][cl], acc1[iq]),
                                      aff[1][cl]);
          const float yk0 = __fadd_rn(
              __fadd_rn(__fmul_rn(aff[2][cl], acc0[ik]), aff[3][cl]),
              bf16_bits_to_f32(static_cast<uint16_t>(pev[0][j] >> (16 * e))));
          const float yk1 = __fadd_rn(
              __fadd_rn(__fmul_rn(aff[2][cl], acc1[ik]), aff[3][cl]),
              bf16_bits_to_f32(static_cast<uint16_t>(pev[1][j] >> (16 * e))));
          sq[0][j][e] = in && psn_fire(p[6], yq0, p[7], yq1, p[10]);
          sq[1][j][e] = in && psn_fire(p[8], yq0, p[9], yq1, p[11]);
          sk[0][j][e] = in && psn_fire(p[12], yk0, p[13], yk1, p[16]);
          sk[1][j][e] = in && psn_fire(p[14], yk0, p[15], yk1, p[17]);
        }
      if (WHOLE) {
        // tok and k * tok in registers, the 0/1 tile into shared memory
        uint32_t* so = reinterpret_cast<uint32_t*>(smem);  // [2][64][40]
        float c0[4][2], c1[4][2];
        head_counts(sq[0], hd, c0);
        head_counts(sq[1], hd, c1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word0 = 0, word1 = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool t0 = psn_fire(p[18], c0[j][e], p[19], c1[j][e], p[22]);
            const bool t1 = psn_fire(p[20], c0[j][e], p[21], c1[j][e], p[23]);
            word0 |= static_cast<uint32_t>(spike_bits(sk[0][j][e] && t0))
                     << (16 * e);
            word1 |= static_cast<uint32_t>(spike_bits(sk[1][j][e] && t1))
                     << (16 * e);
          }
          so[(r * kOutStride + 8 * j + 2 * q) / 2] = word0;
          so[((kTileRows + r) * kOutStride + 8 * j + 2 * q) / 2] = word1;
        }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n0 + 8 * j + 2 * q + e;
              if (c >= C) continue;
              if (sq[t][j][e])
                atomicAdd(&cnt[(t * kTileRows + r) * nh + c / hd], 1);
              kbuf[(t * kTileRows + r) * C + c] = sk[t][j][e];
            }
      }
    }
    if (WHOLE) {
      __syncthreads();
      // 2 halves x 64 rows x 32 channels, 16 bytes a thread a step
      const uint16_t* sos = reinterpret_cast<const uint16_t*>(smem);
      for (int i = tid; i < 2 * kTileRows * (kQN / 8); i += kThreads) {
        const int t = i / (kTileRows * (kQN / 8));
        const int r = (i / (kQN / 8)) % kTileRows;
        const int s = i % (kQN / 8);
        const int row = row0 + r;
        const int c = n0 + 8 * s;
        if (row >= R || c >= C) continue;
        const uint16_t* src = sos + (t * kTileRows + r) * kOutStride + 8 * s;
        uint16_t* dst = out + t * half + static_cast<size_t>(row) * C + c;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && c + e < C; ++e) dst[e] = src[e];
        }
      }
    }
    __syncthreads();  // aff and the stages are reused by the next group
  }
  if (!WHOLE) {
    for (int i = tid; i < kTileRows * C; i += kThreads) {
      const int r = i / C;
      const int c = i % C;
      const int row = row0 + r;
      if (row >= R) break;
      const int h = c / hd;
      const float s0 = static_cast<float>(cnt[r * nh + h]);
      const float s1 = static_cast<float>(cnt[(kTileRows + r) * nh + h]);
      const bool t0 = psn_fire(p[18], s0, p[19], s1, p[22]);
      const bool t1 = psn_fire(p[20], s0, p[21], s1, p[23]);
      out[static_cast<size_t>(row) * C + c] = spike_bits(kbuf[i] && t0);
      out[half + static_cast<size_t>(row) * C + c] =
          spike_bits(kbuf[kTileRows * C + i] && t1);
    }
  }
}

template <bool WHOLE>
cudaError_t launch(const void* x, const void* wpk, const void* pe,
                   const float* affine, const float* psn, void* out, int R,
                   int C, int nh, int ns, cudaStream_t stream) {
  auto kernel = qk_attn_wgmma_kernel<WHOLE>;
  const size_t smem = WHOLE
      ? 2 * kStage
      : 2 * kStage + 2 * static_cast<size_t>(kTileRows) * nh * sizeof(int)
            + 2 * static_cast<size_t>(kTileRows) * C;
  // beside the static p[24] and aff[4][32]
  if (smem + (24 + 4 * kQN) * sizeof(float) > kSmemMax)
    return cudaErrorInvalidValue;
  static size_t configured = 0;  // the dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const int groups = (C + kQN - 1) / kQN;
  const dim3 grid((R + kTileRows - 1) / kTileRows, WHOLE ? groups : 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(wpk),
      static_cast<const uint16_t*>(pe), affine, psn,
      static_cast<uint16_t*>(out), R, C, nh, ns);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// One K1 launch on x [2, R, C] (R = M * ns rows), pe [2, ns, C] and out
// [2, R, C] in x's type, affine float32 [4, C] (aq, cq, ak, ck), psn float32
// [4, 6] (input, q, k, token: w00, w01, w10, w11, b0, b1).
// dtype 0 (float32): wq, wk are the input-major [C, C] weights.
// dtype 1 (bfloat16): wpk is [Wq | Wk] packed by hopper_attn.py:
// pack_qk_weight (tensor cores).
// dtype 2 (bfloat16 on the CUDA-core kernel, the first version of K1, kept
// as the yardstick of the tensor-core one): wq, wk as for dtype 0.
// Returns the cudaError_t of the launch.
extern "C" int qk_attn_forward(const void* x, const void* wq, const void* wk,
                               const void* wpk, const void* pe,
                               const float* affine, const float* psn,
                               void* out, int R, int C, int nh, int ns,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 0 || C < 1 || nh < 1 || C % nh || ns < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0)
    return launch<float>(x, wq, wk, pe, affine, psn, out, R, C, nh, ns, s);
  if (dtype == 2)
    return launch<__nv_bfloat16>(x, wq, wk, pe, affine, psn, out, R, C, nh,
                                 ns, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (32 % (C / nh) == 0)
    return tc::launch<true>(x, wpk, pe, affine, psn, out, R, C, nh, ns, s);
  return tc::launch<false>(x, wpk, pe, affine, psn, out, R, C, nh, ns, s);
}
