// K2 and K2b: the fused PSN site, forward and surrogate backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sdformerflow_tpu/ops/pallas_psn.py:
// _fwd_kernel (:30, pallas_call at :80, fused_affine_psn) and _bwd_kernel
// (:41, pallas_call at :115, _fused_bwd) with the parameter reductions that
// _fused_bwd leaves to XLA (:139-145). For one PSN site x is the input viewed
// as [T, N] (N = everything after the time axis, channels-last, so column n
// has channel n % C), and per column:
//
//   xa[s] = x[s] * scale[c] + shift[c]          (or x[s] with no affine)
//   h[t]  = b[t] + sum_s W[t, s] xa[s]          (potential(), both kernels)
//   out[t] = h[t] >= 0                          (K2: 0/1 spikes)
//   hout[t] = h[t]          (K2, only when asked: the membrane telemetry)
//   gh[t] = g[t] * alpha/2 / (1 + (pi/2 alpha h[t])^2)           (K2b)
//   dxa[s] = sum_t W[t, s] gh[t];  dx[s] = scale[c] dxa[s]
//   dW[t, s] += gh[t] xa[s];  db[t] += gh[t]
//   dscale[c] += sum_s dxa[s] x[s];  dshift[c] += sum_s dxa[s]
//
// What bounds it on H100: memory. K2 reads T values of a column and writes T
// spikes with T^2 multiply-adds between (~5 per byte in bfloat16); K2b reads x
// and g and writes dx with ~4 T^2 multiply-adds a column (~10 a byte in
// bfloat16, ~5 in float32), against the card's ~20 float32 operations a byte.
// The design, shared by both kernels:
//
// - Columns. A thread owns a group of V contiguous columns, one 16-byte load
//   per row (V = 4 in float32, 8 in bfloat16), and starts the T row loads of
//   a group before any arithmetic, so T x 16 bytes a tensor are in flight per
//   thread. Groups are laid out over [rows, C] (the affine sites: one row is
//   one token's C channels) or over rows of 128 V columns (no affine). A
//   block is 128 threads in a (bx, by) layout over (channel groups, rows) and
//   walks rows with a stride of the grid, so a thread's channels never
//   change: the affine is read once per thread, and dscale and dshift sum in
//   registers. A group that is ragged (C or N not a multiple of V) or
//   misaligned is loaded and stored element by element; nothing falls back.
// - Weights. W (and, for K2b, its transpose) and b are staged once per
//   block in shared memory, converted from the dtype the model holds them in
//   (float32 or bfloat16), and read a row at a time by 16-byte loads into
//   registers (load_row); a row serves all V columns of a group in K2 and
//   kBwdColumns of them in K2b.
// - Grid. One wave, sized from the SM count and the kernel's occupancy.
// - K2b's reductions, deterministic. db, dscale and dshift sum in registers.
//   dW needs T^2 sums a column: each column's gh and xa go through a warp's
//   shared-memory stage, and each lane owns a BT x BT block of (t, s) pairs
//   (and, for small T, a share of the 32 columns), so a lane reads 2 BT
//   floats for BT^2 multiply-adds. At the end of a block the sums combine in
//   a fixed order (warp shuffles, then warps, then rows of threads) into a
//   float32 workspace of per-block partials, and psn_reduce_kernel sums those
//   in a fixed order. No float atomics: a launch's bits do not depend on the
//   order in which blocks run.
//
// Rounding: the potential is one function, potential(), in one order of
// fused multiply-adds, for the forward and for the backward's recomputation,
// so the surrogate sees the potential whose sign made the spike. The
// surrogate is rounded step by step in the order of the plain form
// (ops/surrogate.py:atan_grad: u = k h, 1 + u u, a reciprocal times alpha/2,
// times g). The plain twins compute h and W^T gh as matrix products, so the
// two agree to float32 rounding of those sums, and bit for bit where every
// sum is exact (dyadic inputs).
//
// What the TPU kernel needed and this one does not: the BLOCK_N padding of N
// (pallas_psn.py:54-59), the scale/shift broadcast to [T, N], the VMEM block
// specs, and the float32 gh written to memory for the reductions outside.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSteps = 16;
constexpr unsigned kFull = 0xffffffffu;
// K2b's columns per pass over the rows of W: each 16-byte row read serves
// this many columns (more columns, more registers)
constexpr int kBwdColumns = 2;

// V consecutive elements of In (float or __nv_bfloat16) as raw 32-bit words:
// one 16-byte vector in registers
template <typename In>
struct Group {
  static constexpr int V = 16 / sizeof(In);
  uint32_t w[4];

  __device__ __forceinline__ float at(int j) const {
    if constexpr (sizeof(In) == 4) {
      return __uint_as_float(w[j]);
    } else {
      const uint32_t v = w[j >> 1];
      return __uint_as_float((j & 1) ? (v & 0xffff0000u) : (v << 16));
    }
  }
  __device__ __forceinline__ void set(int j, float v) {
    if constexpr (sizeof(In) == 4) {
      w[j] = __float_as_uint(v);
    } else {
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      const uint32_t old = w[j >> 1];
      w[j >> 1] = (j & 1) ? ((old & 0xffffu) | (b << 16))
                          : ((old & 0xffff0000u) | b);
    }
  }
};

template <typename E>
using Bits = std::conditional_t<sizeof(E) == 4, uint32_t, uint16_t>;

// the n (<= V) elements at p: one 16-byte load when vec and the group is
// whole, else element by element; missing elements are 0
template <typename In>
__device__ __forceinline__ Group<In> load_group(const In* p, int n, bool vec) {
  constexpr int V = Group<In>::V;
  Group<In> g;
  if (vec && n == V) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    g.w[0] = r.x; g.w[1] = r.y; g.w[2] = r.z; g.w[3] = r.w;
    return g;
  }
  const Bits<In>* q = reinterpret_cast<const Bits<In>*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) g.w[i] = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      const uint32_t b = q[j];
      if constexpr (sizeof(In) == 4) g.w[j] = b;
      else g.w[j >> 1] |= b << (16 * (j & 1));
    }
  }
  return g;
}

template <typename In>
__device__ __forceinline__ void store_group(In* p, const Group<In>& g, int n,
                                            bool vec) {
  constexpr int V = Group<In>::V;
  if (vec && n == V) {
    *reinterpret_cast<uint4*>(p) = make_uint4(g.w[0], g.w[1], g.w[2], g.w[3]);
    return;
  }
  Bits<In>* q = reinterpret_cast<Bits<In>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      if constexpr (sizeof(In) == 4) q[j] = g.w[j];
      else q[j] = static_cast<uint16_t>(g.w[j >> 1] >> (16 * (j & 1)));
    }
  }
}

// V spikes (bit j of `fire`) as 0/1 of the output dtype (0 float32, 1
// bfloat16) at p; V = 4 or 8
template <int V>
__device__ __forceinline__ void store_spikes(void* out, int odt, int64_t idx,
                                             unsigned fire, int n, bool vec) {
  if (odt == 0) {
    Group<float> a, b;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.w[j] = ((fire >> j) & 1u) ? 0x3f800000u : 0u;
      b.w[j] = ((fire >> (j + 4)) & 1u) ? 0x3f800000u : 0u;
    }
    float* o = static_cast<float*>(out) + idx;
    store_group(o, a, n < 4 ? n : 4, vec);
    if (V == 8 && n > 4) store_group(o + 4, b, n - 4, vec);
  } else {
    Group<__nv_bfloat16> a;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a.w[i] = (((fire >> (2 * i)) & 1u) ? 0x3f80u : 0u)
               | (((fire >> (2 * i + 1)) & 1u) ? 0x3f800000u : 0u);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
    if (V == 8 || !vec || n != V) {
      store_group(o, a, n, vec && V == 8);
    } else {   // 4 bfloat16 spikes: one 8-byte store
      *reinterpret_cast<uint2*>(o) = make_uint2(a.w[0], a.w[1]);
    }
  }
}

// A row of W (or of W^T) from shared memory into registers: 16-byte loads
// of a row padded to a multiple of 4, by volatile asm, so the compiler
// neither hoists the T^2 weights out of the column loop (hoisted, they took
// ~155 registers a thread at T = 10) nor keeps them across rows.
template <int T>
__device__ __forceinline__ void load_row(const float* row, float (&wr)[T]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
#pragma unroll
  for (int i = 0; i < T; i += 4) {
    float v0, v1, v2, v3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v0), "=f"(v1), "=f"(v2), "=f"(v3)
                 : "r"(a + 4 * i));
    wr[i] = v0;
    if (i + 1 < T) wr[i + 1] = v1;
    if (i + 2 < T) wr[i + 2] = v2;
    if (i + 3 < T) wr[i + 3] = v3;
  }
}

// The potential of row t: b[t] + sum_s W[t, s] xa[s], one fused multiply-add
// per s in increasing order. K2 and K2b both call it.
template <int T>
__device__ __forceinline__ float potential(const float (&w_row)[T], float b_t,
                                           const float (&xa)[T]) {
  float h = b_t;
#pragma unroll
  for (int s = 0; s < T; ++s) h = __fmaf_rn(w_row[s], xa[s], h);
  return h;
}

// rows of W in shared memory are padded to a multiple of 4 floats
template <int T>
struct Padded {
  static constexpr int TP = (T + 3) / 4 * 4;
};

// W [T, T] and b [T] (float32 when wdt is 0, bfloat16 when 1) into shared
// memory as float32: W row-major in sw, its transpose in swt (if given)
template <int T>
__device__ __forceinline__ void stage_params(
    const void* w, const void* b, int wdt, float (*sw)[Padded<T>::TP],
    float (*swt)[Padded<T>::TP], float* sb) {
  for (int i = threadIdx.x; i < T * T + T; i += blockDim.x) {
    const void* src = i < T * T ? w : b;
    const int k = i < T * T ? i : i - T * T;
    const float v = wdt == 0
        ? static_cast<const float*>(src)[k]
        : __bfloat162float(static_cast<const __nv_bfloat16*>(src)[k]);
    if (i < T * T) {
      sw[i / T][i % T] = v;
      if (swt != nullptr) swt[i % T][i / T] = v;
    } else {
      sb[k] = v;
    }
  }
}

// How groups of V columns map onto a grid of (bx, by) thread blocks: rows of
// row_len columns (C with an affine, 128 V without), `groups` groups a row;
// grid.x tiles a row's groups, grid.y strides over the rows.
struct Map {
  int64_t n;         // columns
  int64_t row_len;
  int64_t rows;
  int groups;
  int bx, by;
};

struct Lane {
  int64_t row0, row_step, iters;
  int cv;            // the thread's group within a row (-1: none)
};

__device__ __forceinline__ Lane lane_of(const Map& m) {
  Lane l;
  const int tx = threadIdx.x % m.bx, ty = threadIdx.x / m.bx;
  const int cv = blockIdx.x * m.bx + tx;
  l.cv = (ty < m.by && cv < m.groups) ? cv : -1;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * m.by;
  l.row_step = static_cast<int64_t>(gridDim.y) * m.by;
  // the same count for every thread of the block (K2b's warps stage and
  // shuffle together)
  l.iters = first < m.rows ? (m.rows - first + l.row_step - 1) / l.row_step
                           : 0;
  l.row0 = first + ty;
  return l;
}

// (first column, columns) of the thread's group in iteration it; 0 columns
// for a thread with no group there
template <int V>
__device__ __forceinline__ int group_at(const Map& m, const Lane& l,
                                        int64_t it, int64_t* col0) {
  const int64_t row = l.row0 + it * l.row_step;
  if (l.cv < 0 || row >= m.rows) return 0;
  const int64_t c = static_cast<int64_t>(l.cv) * V;
  *col0 = row * m.row_len + c;
  int64_t n = m.row_len - c;
  if (m.n - *col0 < n) n = m.n - *col0;
  return n <= 0 ? 0 : (n < V ? static_cast<int>(n) : V);
}

// V float32 potentials at p (8 as two 16-byte stores when vec)
template <int V>
__device__ __forceinline__ void store_potentials(float* p, const float (&h)[V],
                                                 int n, bool vec) {
  Group<float> a, b;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a.w[j] = __float_as_uint(h[j]);
    b.w[j] = __float_as_uint(h[V == 8 ? j + 4 : j]);
  }
  store_group(p, a, n < 4 ? n : 4, vec);
  if (V == 8 && n > 4) store_group(p + 4, b, n - 4, vec);
}

// ------------------------------------------------------------------- K2

// kH: also write the float32 potential h [T, n] to hout (the membrane of the
// telemetry), from the registers that hold it for the threshold; the default
// launch (kH false) is the kernel without it
template <int T, typename In, bool kH>
__global__ void __launch_bounds__(kThreads)
psn_fwd_kernel(const In* __restrict__ x, const void* __restrict__ w,
               const void* __restrict__ b, int wdt,
               const float* __restrict__ scale,
               const float* __restrict__ shift, void* __restrict__ out,
               float* __restrict__ hout, int odt, Map m, bool vec) {
  constexpr int V = Group<In>::V;
  __shared__ __align__(16) float sw[T][Padded<T>::TP];
  __shared__ float sb[T];
  stage_params<T>(w, b, wdt, sw, nullptr, sb);
  __syncthreads();
  const Lane l = lane_of(m);
  const bool affine = scale != nullptr;
  float sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int64_t c = static_cast<int64_t>(l.cv) * V + j;
    const bool ok = affine && l.cv >= 0 && c < m.row_len;
    sc[j] = ok ? scale[c] : 1.0f;
    sh[j] = ok ? shift[c] : 0.0f;
  }
  for (int64_t it = 0; it < l.iters; ++it) {
    int64_t col0 = 0;
    const int n = group_at<V>(m, l, it, &col0);
    if (n == 0) continue;
    Group<In> raw[T];
#pragma unroll
    for (int s = 0; s < T; ++s)
      raw[s] = load_group(x + s * m.n + col0, n, vec);
    float xa[V][T];
#pragma unroll
    for (int s = 0; s < T; ++s) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = raw[s].at(j);
        xa[j][s] = affine ? __fmaf_rn(v, sc[j], sh[j]) : v;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float wr[T];
      load_row<T>(sw[t], wr);
      unsigned fire = 0u;
      float h[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        h[j] = potential<T>(wr, sb[t], xa[j]);
        fire |= (h[j] >= 0.0f ? 1u : 0u) << j;
      }
      store_spikes<V>(out, odt, t * m.n + col0, fire, n, vec);
      if constexpr (kH) store_potentials<V>(hout + t * m.n + col0, h, n, vec);
    }
  }
}

// ------------------------------------------------------------------ K2b

// a lane's block of dW pairs is BT x BT; NT blocks along t (and s), NB in
// all; NC column groups share the warp's 32 staged columns
template <int T>
struct PairTiles {
  static constexpr int BT = (T + 4) / 5;
  static constexpr int NT = (T + BT - 1) / BT;
  static constexpr int NB = NT * NT;
  static constexpr int NC = NB <= 1 ? 32 : NB <= 2 ? 16 : NB <= 4 ? 8
                            : NB <= 8 ? 4 : NB <= 16 ? 2 : 1;
};

template <int T, typename In>
__global__ void __launch_bounds__(kThreads)
psn_bwd_kernel(const In* __restrict__ x, const In* __restrict__ g,
               const void* __restrict__ w, const void* __restrict__ b,
               int wdt, const float* __restrict__ scale,
               const float* __restrict__ shift, In* __restrict__ dx,
               float* __restrict__ ws, Map m, bool vec, float half_alpha,
               float k) {
  constexpr int V = Group<In>::V;
  constexpr int J = kBwdColumns;
  using P = PairTiles<T>;
  constexpr int BT = P::BT, NT = P::NT, NB = P::NB, NC = P::NC;
  __shared__ __align__(16) float sw[T][Padded<T>::TP];
  __shared__ __align__(16) float swt[T][Padded<T>::TP];
  __shared__ float sb[T];
  // a warp's stage: gh and xa of one column for each of its 32 lanes
  __shared__ float stage[kWarps][2][T][33];
  __shared__ float red_w[kWarps][T * T + T];
  __shared__ float red_c[2][kThreads * V];
  stage_params<T>(w, b, wdt, sw, swt, sb);
  __syncthreads();
  const Lane l = lane_of(m);
  const bool affine = scale != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pb = lane % NB, cg = lane / NB;
  const bool pair_lane = lane < NB * NC;
  const int t0 = (pb / NT) * BT, s0 = (pb % NT) * BT;

  float sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int64_t c = static_cast<int64_t>(l.cv) * V + j;
    const bool ok = affine && l.cv >= 0 && c < m.row_len;
    sc[j] = ok ? scale[c] : 1.0f;
    sh[j] = ok ? shift[c] : 0.0f;
  }
  float acc[BT][BT];
#pragma unroll
  for (int i = 0; i < BT; ++i)
#pragma unroll
    for (int q = 0; q < BT; ++q) acc[i][q] = 0.0f;
  float db[T];
#pragma unroll
  for (int t = 0; t < T; ++t) db[t] = 0.0f;
  float dsc[V], dsh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) dsc[j] = dsh[j] = 0.0f;

  for (int64_t it = 0; it < l.iters; ++it) {
    int64_t col0 = 0;
    const int n = group_at<V>(m, l, it, &col0);
    Group<In> xr[T], gr[T];
#pragma unroll
    for (int s = 0; s < T; ++s) {
      xr[s] = load_group(x + s * m.n + col0, n, vec);
      gr[s] = load_group(g + s * m.n + col0, n, vec);
    }
    Group<In> dr[T];
#pragma unroll
    for (int s = 0; s < T; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[s].w[i] = 0u;
    // J columns at a time: each row of W (and of W^T) read from shared
    // memory serves J columns
#pragma unroll
    for (int j0 = 0; j0 < V; j0 += J) {
      float xa[J][T], gh[J][T];
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int s = 0; s < T; ++s) {
          const float v = xr[s].at(j0 + jj);
          xa[jj][s] = affine ? __fmaf_rn(v, sc[j0 + jj], sh[j0 + jj]) : v;
        }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float wr[T];
        load_row<T>(sw[t], wr);
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float h = potential<T>(wr, sb[t], xa[jj]);
          const float u = __fmul_rn(k, h);
          const float sg = __fmul_rn(
              __frcp_rn(__fadd_rn(1.0f, __fmul_rn(u, u))), half_alpha);
          // 0 where the group has no column (g loaded as 0 there)
          gh[jj][t] = __fmul_rn(gr[t].at(j0 + jj), sg);
          db[t] = __fadd_rn(db[t], gh[jj][t]);
        }
      }
      float su[J], sv[J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) su[jj] = sv[jj] = 0.0f;
#pragma unroll
      for (int s = 0; s < T; ++s) {
        float wc[T];
        load_row<T>(swt[s], wc);
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          float d = 0.0f;
#pragma unroll
          for (int t = 0; t < T; ++t) d = __fmaf_rn(wc[t], gh[jj][t], d);
          dr[s].set(j0 + jj, affine ? __fmul_rn(d, sc[j0 + jj]) : d);
          su[jj] = __fadd_rn(su[jj], d);
          sv[jj] = __fmaf_rn(d, xr[s].at(j0 + jj), sv[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        dsh[j0 + jj] = __fadd_rn(dsh[j0 + jj], su[jj]);
        dsc[j0 + jj] = __fadd_rn(dsc[j0 + jj], sv[jj]);
        // dW through the warp's stage, one column a lane
#pragma unroll
        for (int t = 0; t < T; ++t) {
          stage[warp][0][t][lane] = gh[jj][t];
          stage[warp][1][t][lane] = xa[jj][t];
        }
        __syncwarp();
        if (pair_lane) {
          for (int c = cg; c < 32; c += NC) {
#pragma unroll
            for (int i = 0; i < BT; ++i) {
              if (t0 + i >= T) break;
              const float a = stage[warp][0][t0 + i][c];
#pragma unroll
              for (int q = 0; q < BT; ++q) {
                if (s0 + q < T)
                  acc[i][q] = __fmaf_rn(a, stage[warp][1][s0 + q][c],
                                        acc[i][q]);
              }
            }
          }
        }
        __syncwarp();
      }
    }
    if (n > 0) {
#pragma unroll
      for (int s = 0; s < T; ++s)
        store_group(dx + s * m.n + col0, dr[s], n, vec);
    }
  }

  // the block's partial sums, combined in a fixed order. dW: the column
  // groups of a warp (a shuffle tree), then the warps
#pragma unroll
  for (int off = NC / 2; off >= 1; off /= 2) {
#pragma unroll
    for (int i = 0; i < BT; ++i)
#pragma unroll
      for (int q = 0; q < BT; ++q)
        acc[i][q] = __fadd_rn(acc[i][q],
                              __shfl_down_sync(kFull, acc[i][q], off * NB));
  }
  if (lane < NB) {
#pragma unroll
    for (int i = 0; i < BT; ++i)
#pragma unroll
      for (int q = 0; q < BT; ++q)
        if (t0 + i < T && s0 + q < T)
          red_w[warp][(t0 + i) * T + s0 + q] = acc[i][q];
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float v = db[t];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
    if (lane == 0) red_w[warp][T * T + t] = v;
  }
  if (affine) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red_c[0][threadIdx.x * V + j] = dsc[j];
      red_c[1][threadIdx.x * V + j] = dsh[j];
    }
  }
  __syncthreads();
  const int64_t blk = static_cast<int64_t>(blockIdx.y) * gridDim.x
                      + blockIdx.x;
  for (int i = threadIdx.x; i < T * T + T; i += kThreads) {
    float v = red_w[0][i];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) v = __fadd_rn(v, red_w[u][i]);
    ws[blk * (T * T + T) + i] = v;
  }
  // dscale, dshift: each thread of the first row sums its channels down the
  // block's rows of threads
  if (affine && static_cast<int>(threadIdx.x) < m.bx) {
    const int cv = blockIdx.x * m.bx + threadIdx.x;
    if (cv < m.groups) {
      const int64_t nblk = static_cast<int64_t>(gridDim.x) * gridDim.y;
      float* wc = ws + nblk * (T * T + T)
                  + static_cast<int64_t>(blockIdx.y) * 2 * m.row_len;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t c = static_cast<int64_t>(cv) * V + j;
        if (c >= m.row_len) break;
        float a = 0.0f, z = 0.0f;
        for (int ty = 0; ty < m.by; ++ty) {
          const int src = (ty * m.bx + threadIdx.x) * V + j;
          a = __fadd_rn(a, red_c[0][src]);
          z = __fadd_rn(z, red_c[1][src]);
        }
        wc[c] = a;
        wc[m.row_len + c] = z;
      }
    }
  }
}

// The sums over blocks: one warp per output, dW (T^2), db (T), then dscale
// and dshift (C each, with an affine); each lane sums a fixed stride of the
// partials, then a shuffle tree.
__global__ void __launch_bounds__(kThreads)
psn_reduce_kernel(const float* __restrict__ ws, int nblk, int gy, int steps,
                  int channels, int affine, float* __restrict__ grads) {
  const int tt = steps * steps + steps;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o >= tt + (affine ? 2LL * channels : 0LL)) return;
  float v = 0.0f;
  if (o < tt) {
    for (int p = lane; p < nblk; p += 32)
      v = __fadd_rn(v, ws[static_cast<int64_t>(p) * tt + o]);
  } else {
    const int64_t q = (o - tt) / channels, c = (o - tt) % channels;
    const float* wc = ws + static_cast<int64_t>(nblk) * tt;
    for (int p = lane; p < gy; p += 32)
      v = __fadd_rn(v, wc[(static_cast<int64_t>(p) * 2 + q) * channels + c]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  if (lane == 0) grads[o] = v;
}

// ------------------------------------------------------------ host side

int sm_count() {
  static const int sms = [] {
    int device = 0, n = 132;
    if (cudaGetDevice(&device) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return sms;
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int occ = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0)
      != cudaSuccess || occ < 1)
    occ = 1;
  return occ;
}

struct Plan {
  Map map;
  dim3 grid;
  bool vec;
};

template <typename In>
Plan plan(int64_t n, int channels, bool affine, int occupancy,
          uintptr_t ptr_bits) {
  constexpr int V = Group<In>::V;
  Plan p;
  Map& m = p.map;
  m.n = n;
  m.row_len = affine ? channels : static_cast<int64_t>(V) * kThreads;
  m.rows = (n + m.row_len - 1) / m.row_len;
  m.groups = static_cast<int>((m.row_len + V - 1) / V);
  const int ntile = (m.groups + kThreads - 1) / kThreads;
  m.bx = (m.groups + ntile - 1) / ntile;
  m.by = kThreads / m.bx;
  const int64_t need = (m.rows + m.by - 1) / m.by;
  int64_t gy = static_cast<int64_t>(occupancy) * sm_count() / ntile;
  if (gy < 1) gy = 1;
  if (gy > need) gy = need;
  p.grid = dim3(ntile, static_cast<unsigned>(gy));
  p.vec = ptr_bits % 16 == 0 && n % V == 0 && (!affine || channels % V == 0);
  return p;
}

template <int T, typename In>
int64_t bwd_workspace(const Plan& p, bool affine) {
  const int64_t nblk = static_cast<int64_t>(p.grid.x) * p.grid.y;
  return nblk * (T * T + T)
         + (affine ? static_cast<int64_t>(p.grid.y) * 2 * p.map.row_len : 0);
}

template <int T, typename In, bool kH>
int fwd_launch(const void* x, const void* w, const void* b, int wdt,
               const float* scale, const float* shift, void* out, float* hout,
               int odt, int64_t n, int channels, cudaStream_t stream) {
  static const int occ = blocks_per_sm(psn_fwd_kernel<T, In, kH>);
  const Plan p = plan<In>(n, channels, scale != nullptr, occ,
                          reinterpret_cast<uintptr_t>(x)
                              | reinterpret_cast<uintptr_t>(out)
                              | reinterpret_cast<uintptr_t>(hout));
  psn_fwd_kernel<T, In, kH><<<p.grid, kThreads, 0, stream>>>(
      static_cast<const In*>(x), w, b, wdt, scale, shift, out, hout, odt,
      p.map, p.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int T, typename In>
int fwd(const void* x, const void* w, const void* b, int wdt,
        const float* scale, const float* shift, void* out, float* hout,
        int odt, int64_t n, int channels, cudaStream_t stream) {
  return hout == nullptr
      ? fwd_launch<T, In, false>(x, w, b, wdt, scale, shift, out, nullptr, odt,
                                 n, channels, stream)
      : fwd_launch<T, In, true>(x, w, b, wdt, scale, shift, out, hout, odt, n,
                                channels, stream);
}

template <int T, typename In>
Plan bwd_plan(int64_t n, int channels, bool affine, uintptr_t ptr_bits) {
  static const int occ = blocks_per_sm(psn_bwd_kernel<T, In>);
  return plan<In>(n, channels, affine, occ, ptr_bits);
}

template <int T, typename In>
int64_t bwd_size(int64_t n, int channels, bool affine) {
  return bwd_workspace<T, In>(bwd_plan<T, In>(n, channels, affine, 0),
                              affine);
}

template <int T, typename In>
int bwd(const void* x, const void* g, const void* w, const void* b, int wdt,
        const float* scale, const float* shift, void* dx, float* grads,
        float* ws, int64_t ws_floats, int64_t n, int channels,
        float half_alpha, float k, cudaStream_t stream) {
  const bool affine = scale != nullptr;
  const Plan p = bwd_plan<T, In>(n, channels, affine,
                                 reinterpret_cast<uintptr_t>(x)
                                     | reinterpret_cast<uintptr_t>(g)
                                     | reinterpret_cast<uintptr_t>(dx));
  if (bwd_workspace<T, In>(p, affine) > ws_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  psn_bwd_kernel<T, In><<<p.grid, kThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(g), w, b, wdt, scale,
      shift, static_cast<In*>(dx), ws, p.map, p.vec, half_alpha, k);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t outs = T * T + T + (affine ? 2LL * channels : 0LL);
  psn_reduce_kernel<<<static_cast<unsigned>((outs + kWarps - 1) / kWarps),
                      kThreads, 0, stream>>>(
      ws, static_cast<int>(p.grid.x * p.grid.y), static_cast<int>(p.grid.y),
      T, channels, affine ? 1 : 0, grads);
  return static_cast<int>(cudaGetLastError());
}

#define PSN_STEPS(X)                                                        \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16)

bool bad_args(int64_t n, int steps, int channels, const float* scale,
              const float* shift, int dtype, int wdt) {
  return n < 0 || steps < 1 || steps > kMaxSteps || channels < 1
         || (scale == nullptr) != (shift == nullptr) || dtype < 0 || dtype > 1
         || wdt < 0 || wdt > 1;
}

}  // namespace

// K2: the spikes of one PSN site over n columns of ``steps`` time steps
// (1-16). x is float32 (dtype 0) or bfloat16 (dtype 1), the spikes out are
// float32 (out_dtype 0) or bfloat16 (1), both contiguous [steps, n]; w
// [steps, steps] and b [steps] in float32 (w_dtype 0) or bfloat16 (1);
// scale and shift float32 [channels] on the last axis of x, or both null;
// hout, if not null, receives the float32 potential h [steps, n] whose sign
// made each spike. Returns the cudaError_t of the launch.
extern "C" int psn_fwd(const void* x, const void* w, const void* b,
                       const float* scale, const float* shift, void* out,
                       float* hout, int64_t n, int steps, int channels,
                       int dtype, int w_dtype, int out_dtype, void* stream) {
  if (bad_args(n, steps, channels, scale, shift, dtype, w_dtype)
      || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
#define PSN_FWD_CASE(TT)                                                     \
  case TT:                                                                   \
    return dtype == 0                                                        \
        ? fwd<TT, float>(x, w, b, w_dtype, scale, shift, out, hout,          \
                         out_dtype, n, channels, s)                          \
        : fwd<TT, __nv_bfloat16>(x, w, b, w_dtype, scale, shift, out, hout,  \
                                 out_dtype, n, channels, s);
    PSN_STEPS(PSN_FWD_CASE)
#undef PSN_FWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2b's float32 workspace, in floats, for a site of these sizes (the partial
// sums of each block); -1 for arguments psn_bwd refuses.
extern "C" int64_t psn_bwd_workspace(int64_t n, int steps, int channels,
                                     int affine, int dtype) {
  if (n < 0 || steps < 1 || steps > kMaxSteps || channels < 1 || dtype < 0
      || dtype > 1)
    return -1;
  if (n == 0) return 0;
  switch (steps) {
#define PSN_WS_CASE(TT)                                                      \
  case TT:                                                                   \
    return dtype == 0 ? bwd_size<TT, float>(n, channels, affine != 0)        \
                      : bwd_size<TT, __nv_bfloat16>(n, channels, affine != 0);
    PSN_STEPS(PSN_WS_CASE)
#undef PSN_WS_CASE
  }
  return -1;
}

// K2b: the VJP of one PSN site with the ATan surrogate. x (the saved
// pre-affine input), g (the spikes' cotangent) and dx are float32 (dtype 0)
// or bfloat16 (1), contiguous [steps, n]; w, b as psn_fwd's; scale and shift
// float32 [channels] or both null. grads receives, in float32, dW
// [steps, steps], db [steps], then (with an affine) dscale and dshift
// [channels]; ws is a float32 workspace of ws_floats >= psn_bwd_workspace().
// half_alpha = alpha / 2 and k = pi / 2 * alpha. Two launches on the stream
// (the site, then the sums over its blocks); returns the first cudaError_t.
extern "C" int psn_bwd(const void* x, const void* g, const void* w,
                       const void* b, const float* scale, const float* shift,
                       void* dx, float* grads, float* ws, int64_t ws_floats,
                       int64_t n, int steps, int channels, int dtype,
                       int w_dtype, float half_alpha, float k, void* stream) {
  if (bad_args(n, steps, channels, scale, shift, dtype, w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) {   // no column: every gradient is 0
    const int64_t outs = static_cast<int64_t>(steps) * steps + steps
                         + (scale != nullptr ? 2LL * channels : 0LL);
    return static_cast<int>(cudaMemsetAsync(
        grads, 0, outs * sizeof(float), static_cast<cudaStream_t>(stream)));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
#define PSN_BWD_CASE(TT)                                                     \
  case TT:                                                                   \
    return dtype == 0                                                        \
        ? bwd<TT, float>(x, g, w, b, w_dtype, scale, shift, dx, grads, ws,   \
                         ws_floats, n, channels, half_alpha, k, s)           \
        : bwd<TT, __nv_bfloat16>(x, g, w, b, w_dtype, scale, shift, dx,      \
                                 grads, ws, ws_floats, n, channels,          \
                                 half_alpha, k, s);
    PSN_STEPS(PSN_BWD_CASE)
#undef PSN_BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
