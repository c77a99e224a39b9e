// K3: event -> voxel-grid scatter-add for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdformerflow_tpu/ops/pallas_voxel.py:
// _voxel_kernel (pallas_call at :135, reached through _accumulate_core by
// voxel_grid_signed_pallas, voxel_grid_polarities_pallas,
// events_to_voxel_grid_v2_pallas and events_to_frames_pallas). One chain of
// kernels serves the four grids, as _accumulate_core serves them in JAX:
//
//   mode 0  signed      [bins, H, W]     value 2p - 1, 8 trilinear corners
//   mode 1  polarities  [bins, 2, H, W]  channel 0 for p == 1, else 1
//   mode 2  v2          [bins, H, W]     x/y truncated, p == 0 -> -1,
//                                        2 time corners (1 - dt, dt)
//   mode 3  frames      [F, 2, H, W]     relu'd x/y corner weights at the
//                                        integral frame trunc((F-1) t01)
//
// with t_n = (bins - 1) * (t - t0) / (t1 - t0) (a zero span read as 1),
// integer bases by truncation toward zero, corner weights 1 - |corner -
// coord| from the truncated base (so coords in (-1, 0) keep their signed
// weights), each corner dropped unless inside [0, W) x [0, H) x [0, bins),
// and events with valid == 0 dropped. The plain PyTorch forms are
// sdformerflow_tpu_torch/ops/voxel.py. A grid is a stack of planes of
// H x W cells: a plane is one bin (signed, v2) or one (bin, channel) pair
// (polarities, frames: plane 2 * bin + channel).
//
// What bounds it on H100: memory. At 2^20 events into 480x640x10 the
// function reads the events once (4 float32 arrays and a bool mask, 17.8
// MB) and writes the grid once (12.3 MB): about 0.009 ms at 3.35 TB/s.
// The arithmetic is ~50 operations an event.
//
// The design: a counting sort of the events by row on the card, then one
// CTA a tile of the grid, which sums its events in shared memory and
// writes its cells once. A memset of the counters (H + 4 words and one a
// tile), then four launches:
//
//   1. count    4096 events a block: the row key of each event, yi + 1 for
//               the integer base row yi of its y (-1 <= yi < H; v2: 0 <= yi
//               < H), or none when no corner can land in the frame or
//               valid == 0; a shared-memory histogram of the H + 1 keys,
//               added to global counts with one atomic a key a block. With
//               the valid span asked for, also the min and max t of the
//               valid events (order-preserving integer atomics).
//   2. plan     one CTA: the exclusive scan of the counts (each key's
//               offset), the time span (t0, t1 - t0), and the work items of
//               pass 4 (below).
//   3. scatter  as count, then each block reserves one range a key with one
//               global atomic, sorts its events by key in shared memory and
//               writes them as float4 (x, y, t, p) records, each key's run
//               contiguous: the records sorted by row, in no order inside a
//               row.
//   4. tiles    persistent CTAs take work items from a counter. An item is
//               a tile: a band of `rows` rows x a slab of `planes` planes x
//               a slab of columns. Its CTA zeroes the tile in shared memory,
//               walks the records of keys r0 .. r0 + rows (its rows, and row
//               r0 - 1 whose y + 1 corner lands in row r0; v2: its rows
//               only), adds each nonzero corner inside the tile with a
//               shared-memory atomic, and stores the tile with 16-byte
//               stores (a scalar head and tail where a row of W cells is
//               not 16-byte aligned, as at W = 346).
//
// Every cell of the grid is written exactly once, by one item, so the grid
// needs no memset and may be a row of a caller's [B, ...] output. The
// static geometry comes from hopper_voxel.k3_tiles: a row costs planes x W
// x 4 bytes (25.6 KB for a 10-bin signed row at W = 640); tiles are sized
// for at least 2 CTAs an SM and split planes, then columns, where one row
// does not fit.
//
// Skew: a band holding most of a window's events would set the pace of
// pass 4 (shared-memory float atomics are a compare-and-swap loop on this
// card, the cost that grows with a band's events). So pass 2 splits a band
// of at least twice the mean a band's records (and kMinItem) into shares
// of about the mean, at most kMaxSplit, each its own item: a share sums
// its part of the band's records into a partial tile in global memory, and
// the last share of the tile to finish (a counter a tile) adds the
// partials up in share order and stores the tile. The grid's cells are
// still written once. The split and its two constants were tuned on an
// invented window (9/10 of the events on 1/10 of the rows); no real
// window's row distribution has been measured, so they are unverified.
//
// Where its time goes: at 2^20 events the count, plan and scatter passes
// are a fixed cost of about half the total; the rest is pass 4, whose
// shared-memory compare-and-swap loops (up to 8 a record, 2 at integer
// x/y) set its pace. Measured in PERF.md (chip_smoke.py phase 4).
//
// What the TPU kernel needed and this one does not: scalar prefetch, the
// 128-lane-aligned DMA starts with masked leading lanes, the [R, E] x
// [E, W] one-hot matrix product and the partial-then-fold layout. The sort
// by row is here as on the TPU, but on the card: the host packs the events
// unsorted.
//
// Rounding: every weight is computed with explicitly rounded operations
// (__fmul_rn etc., no FMA contraction) in the order of the plain PyTorch
// forms, so kernel and twin differ only in the order of the sums, which
// the shared-memory atomics change from run to run. On inputs whose
// weights and sums are exact (coordinates on a 1/4 grid) the kernel equals
// the twin bit for bit; otherwise they agree to float32 rounding of the
// sums.
//
// voxel_scatter_atomic keeps the first K3 (one thread an event, a float
// atomic into the zeroed final grid for each surviving corner) as a
// same-run yardstick; no path of the package calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the atomic yardstick
constexpr int kBinThreads = 512;
constexpr int kItems = 8;          // events a thread in passes 1 and 3
constexpr int kChunk = kBinThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kTileThreads = 512;
// shares a heavy band is split into at most, and the records a share has
// at least (pass 2)
constexpr int kMaxSplit = 8;
constexpr int kMinItem = 256;

enum Mode { kSigned = 0, kPolarities = 1, kV2 = 2, kFrames = 3 };
// where (t0, t1) comes from: a device [2], the first and last event, the
// valid events' min and max, or two values
enum Span { kSpanPointer = 0, kSpanEnds = 1, kSpanValid = 2, kSpanValues = 3 };

// 1 - |corner - v|, each step rounded
__device__ __forceinline__ float corner_w(float corner, float v) {
  return __fsub_rn(1.0f, fabsf(__fsub_rn(corner, v)));
}

// the integer base of a coordinate, clipped to [-2, hi + 1] so that extreme
// values cannot wrap around int32 and alias a real cell; every clipped
// value lies outside [0, hi), so no surviving corner changes
__device__ __forceinline__ int base_index(float trunc_v, int hi) {
  return static_cast<int>(fminf(fmaxf(trunc_v, -2.0f),
                                static_cast<float>(hi) + 1.0f));
}

__device__ __forceinline__ bool inside(int v, int hi) {
  return v >= 0 && v < hi;
}

// Calls add(plane, row, col, w) for every corner of one valid event that
// lies inside the grid, with the weights of the plain forms.
template <class Add>
__device__ __forceinline__ void event_corners(float x, float y, float t,
                                              float p, int mode, int bins,
                                              int H, int W, float t_first,
                                              float denom, Add&& add) {
  const float dt_first = __fsub_rn(t, t_first);

  if (mode == kFrames) {
    const int ch = p == 1.0f ? 0 : (p == 0.0f ? 1 : -1);
    // (2 - 1) * (t - t0) / span, then trunc((F - 1) * that)
    const float t01 = __fdiv_rn(__fmul_rn(1.0f, dt_first), denom);
    const int fr = base_index(
        truncf(__fmul_rn(static_cast<float>(bins - 1), t01)), bins);
    if (ch < 0 || !inside(fr, bins)) return;
    const float x0 = truncf(x), y0 = truncf(y);
    const int xi = base_index(x0, W), yi = base_index(y0, H);
    const float wx[2] = {fmaxf(corner_w(x0, x), 0.0f),
                         fmaxf(corner_w(x0 + 1.0f, x), 0.0f)};
    const float wy[2] = {fmaxf(corner_w(y0, y), 0.0f),
                         fmaxf(corner_w(y0 + 1.0f, y), 0.0f)};
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int xl = xi + dx, yl = yi + dy;
        if (inside(xl, W) && inside(yl, H))
          add(fr * 2 + ch, yl, xl, __fmul_rn(wx[dx], wy[dy]));
      }
    return;
  }

  const float tn = __fdiv_rn(
      __fmul_rn(static_cast<float>(bins - 1), dt_first), denom);
  const float tb = truncf(tn);
  const int ti = base_index(tb, bins);

  if (mode == kV2) {
    const float xt = truncf(x), yt = truncf(y);
    const int xi = base_index(xt, W), yi = base_index(yt, H);
    if (!inside(xi, W) || !inside(yi, H)) return;
    const float pol = p == 0.0f ? -1.0f : p;
    const float dts = __fsub_rn(tn, tb);
    const float w[2] = {__fmul_rn(pol, __fsub_rn(1.0f, dts)),
                        __fmul_rn(pol, dts)};
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
      if (inside(ti + dt, bins)) add(ti + dt, yi, xi, w[dt]);
    return;
  }

  // signed and polarities: 8 trilinear corners
  const float x0 = truncf(x), y0 = truncf(y);
  const int xi = base_index(x0, W), yi = base_index(y0, H);
  const float wx[2] = {corner_w(x0, x), corner_w(x0 + 1.0f, x)};
  const float wy[2] = {corner_w(y0, y), corner_w(y0 + 1.0f, y)};
  const float wt[2] = {corner_w(tb, tn), corner_w(tb + 1.0f, tn)};
  const bool signed_grid = mode == kSigned;
  const float value = __fsub_rn(__fmul_rn(2.0f, p), 1.0f);
  const int stride = signed_grid ? 1 : 2;   // planes between time slices
  const int ch = signed_grid ? 0 : (p == 1.0f ? 0 : 1);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const int xl = xi + dx, yl = yi + dy, tl = ti + dt;
        if (!inside(xl, W) || !inside(yl, H) || !inside(tl, bins)) continue;
        // ((value * wx) * wy) * wt, or (wx * wy) * wt without a value
        const float w = signed_grid
            ? __fmul_rn(__fmul_rn(__fmul_rn(value, wx[dx]), wy[dy]), wt[dt])
            : __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wt[dt]);
        add(tl * stride + ch, yl, xl, w);
      }
}

// The row key of one valid event: yi + 1 for its base row yi, or -1 when
// none of its corners can land in the frame. Needs no time span.
__device__ __forceinline__ int event_key(float x, float y, float p, int mode,
                                         int H, int W) {
  const int xi = base_index(truncf(x), W), yi = base_index(truncf(y), H);
  if (mode == kV2) return inside(xi, W) && inside(yi, H) ? yi + 1 : -1;
  if (mode == kFrames && p != 1.0f && p != 0.0f) return -1;
  return xi >= -1 && xi < W && yi >= -1 && yi < H ? yi + 1 : -1;
}

// a float's bits mapped to an unsigned integer of the same order
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// out[0, n) = the exclusive prefix sums of in[0, n) (in == out allowed);
// returns the total. Every thread of the block calls it; `scratch` is 33
// ints of shared memory.
__device__ int block_exclusive_scan(const int* in, int* out, int n,
                                    int* scratch) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += in[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane]
                                                           : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += v;
    }
    scratch[lane] = wi - w;
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  int run = scratch[warp] + incl - own;
  const int total = scratch[32];
  for (int k = lo; k < hi; ++k) {
    const int c = in[k];
    out[k] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

struct Tiles {
  int rows, planes, cols, bands, plane_slabs, col_slabs, n_tiles,
      tile_floats;
};

// The workspace of one launch: int32 words (the zeroed counters first),
// then at 16-byte boundaries the work items, the partial tiles of split
// bands and the records.
struct Workspace {
  int* counts;          // [K], zeroed
  unsigned* span_keys;  // [2]: ~order_key(min t), order_key(max t), zeroed
  int* next_item;       // [1], zeroed: pass 4's work counter
  int* done;            // [n_tiles], zeroed: shares of a split tile done
  int* n_items;         // [1]
  int* cursor;          // [K]
  int* offsets;         // [K + 1]
  float* span;          // [2]: t0 and the span (a zero span read as 1)
  int4* items;          // [n_tiles x kMaxSplit]
  float* partials;      // [n_tiles x tile_floats]
  float4* records;      // [n]
  size_t zeroed_bytes, bytes;
};

inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// (base may be null to size it)
inline Workspace workspace(void* base, int64_t n, int keys, const Tiles& g) {
  Workspace w = {};
  const size_t zeroed = static_cast<size_t>(keys) + 3 + g.n_tiles;
  const size_t items_at = align16((zeroed + 2 * keys + 4) * 4);
  const size_t partials_at =
      items_at + 16 * static_cast<size_t>(g.n_tiles) * kMaxSplit;
  const size_t records_at =
      partials_at + 4 * static_cast<size_t>(g.n_tiles) * g.tile_floats;
  w.zeroed_bytes = zeroed * 4;
  w.bytes = records_at + 16 * static_cast<size_t>(n);
  if (base == nullptr) return w;
  int* words = static_cast<int*>(base);
  char* bytes = static_cast<char*>(base);
  w.counts = words;
  w.span_keys = reinterpret_cast<unsigned*>(words + keys);
  w.next_item = words + keys + 2;
  w.done = words + keys + 3;
  w.n_items = words + zeroed;
  w.cursor = w.n_items + 1;
  w.offsets = w.cursor + keys;
  w.span = reinterpret_cast<float*>(w.offsets + keys + 1);
  w.items = reinterpret_cast<int4*>(bytes + items_at);
  w.partials = reinterpret_cast<float*>(bytes + partials_at);
  w.records = reinterpret_cast<float4*>(bytes + records_at);
  return w;
}

// Passes 1 (kScatter false) and 3 (true): each block takes kChunk events.
template <bool kScatter>
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
           const float* __restrict__ ts, const float* __restrict__ ps,
           const uint8_t* __restrict__ valid, int64_t n, int mode, int H,
           int W, int span_mode, int* __restrict__ counts,
           unsigned* __restrict__ span_keys, int* __restrict__ cursor,
           float4* __restrict__ records) {
  // pass 3: [kChunk] staged records and their keys, then both passes: [K]
  // counts, and in pass 3 [K] block offsets and [K] global bases
  extern __shared__ float4 smem[];
  __shared__ float block_lo[kBinThreads / 32], block_hi[kBinThreads / 32];
  __shared__ int scratch[33];
  float4* stage = smem;
  int* stage_key = reinterpret_cast<int*>(stage + (kScatter ? kChunk : 0));
  int* hist = stage_key + (kScatter ? kChunk : 0);
  const int keys = H + 1;
  for (int k = threadIdx.x; k < keys; k += blockDim.x) hist[k] = 0;

  // all loads first, then the keys: each thread's loads are in flight
  // together
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk
                        + threadIdx.x;
  const bool want_span = !kScatter && span_mode == kSpanValid;
  const bool want_p = kScatter || mode == kFrames;
  float4 ev[kItems];
  bool ok[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * kBinThreads;
    ok[j] = i < n;
    ev[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok[j]) {
      if (valid != nullptr) ok[j] = valid[i] != 0;
      ev[j].x = xs[i];
      ev[j].y = ys[i];
      if (kScatter || want_span) ev[j].z = ts[i];
      if (want_p) ev[j].w = ps[i];
    }
  }
  __syncthreads();
  float lo = __int_as_float(0x7f800000), hi = -lo;   // +inf, -inf
  int key[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    key[j] = -1;
    rank[j] = 0;
    if (!ok[j]) continue;
    if (want_span) {
      lo = fminf(lo, ev[j].z);
      hi = fmaxf(hi, ev[j].z);
    }
    key[j] = event_key(ev[j].x, ev[j].y, ev[j].w, mode, H, W);
    if (key[j] >= 0) rank[j] = atomicAdd(&hist[key[j]], 1);
  }
  __syncthreads();

  if (!kScatter) {
    for (int k = threadIdx.x; k < keys; k += blockDim.x)
      if (hist[k] != 0) atomicAdd(&counts[k], hist[k]);
    if (want_span) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, d));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, d));
      }
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if (lane == 0) {
        block_lo[warp] = lo;
        block_hi[warp] = hi;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < kBinThreads / 32; ++w) {
          lo = fminf(lo, block_lo[w]);
          hi = fmaxf(hi, block_hi[w]);
        }
        if (lo <= hi) {   // the block holds a valid event
          atomicMax(&span_keys[0], ~order_key(lo));
          atomicMax(&span_keys[1], order_key(hi));
        }
      }
    }
    return;
  }

  int* block_off = hist + keys;
  int* base = block_off + keys;
  for (int k = threadIdx.x; k < keys; k += blockDim.x)
    if (hist[k] != 0) base[k] = atomicAdd(&cursor[k], hist[k]);
  const int staged = block_exclusive_scan(hist, block_off, keys, scratch);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (key[j] >= 0) {
      const int slot = block_off[key[j]] + rank[j];
      stage[slot] = ev[j];
      stage_key[slot] = key[j];
    }
  __syncthreads();
  // consecutive slots of a key go to consecutive records
  for (int s = threadIdx.x; s < staged; s += blockDim.x) {
    const int k = stage_key[s];
    records[base[k] + s - block_off[k]] = stage[s];
  }
}

// the first key a band's tile walks, and one past its last
__device__ __forceinline__ int band_first_key(int band, int mode,
                                              const Tiles& g) {
  return band * g.rows + (mode == kV2 ? 1 : 0);
}

__device__ __forceinline__ int band_end_key(int band, int H, const Tiles& g) {
  return min(H, (band + 1) * g.rows) + 1;
}

// Pass 2, one CTA: key offsets and cursors, the time span, the work items.
// A band of at least twice `target` records (the mean a band, and at
// least kMinItem) is split into floor(records / target) shares, at most
// kMaxSplit; each share of each of its static tiles is an item with a
// partial tile of its own.
__global__ void __launch_bounds__(kScanThreads)
plan_kernel(const int* __restrict__ counts,
            const unsigned* __restrict__ span_keys, int* __restrict__ cursor,
            int* __restrict__ offsets, float* __restrict__ span, int keys,
            int span_mode, const float* __restrict__ t_range,
            const float* __restrict__ ts, int64_t n, float t0_value,
            float t1_value, int mode, int H, Tiles g,
            int* __restrict__ n_items, int4* __restrict__ items) {
  // [K + 1] offsets, [bands] items, [bands] partials: kept in shared memory,
  // where the plan reads them again
  extern __shared__ int at[];
  int* band_at = at + keys + 1;
  int* band_part = band_at + g.bands;
  __shared__ int scratch[33];
  __shared__ long long warp_walked[kScanThreads / 32];
  for (int k = threadIdx.x; k < keys; k += blockDim.x) at[k] = counts[k];
  __syncthreads();
  const int total = block_exclusive_scan(at, at, keys, scratch);
  for (int k = threadIdx.x; k < keys; k += blockDim.x) {
    offsets[k] = at[k];
    cursor[k] = at[k];
  }
  if (threadIdx.x == 0) {
    at[keys] = total;
    offsets[keys] = total;
    float a = t0_value, b = t1_value;
    if (span_mode == kSpanPointer) {
      a = t_range[0];
      b = t_range[1];
    } else if (span_mode == kSpanEnds) {
      a = ts[0];
      b = ts[n - 1];
    } else if (span_mode == kSpanValid) {
      a = from_order_key(~span_keys[0]);
      b = from_order_key(span_keys[1]);
    }
    float denom = __fsub_rn(b, a);
    if (denom == 0.0f) denom = 1.0f;
    span[0] = a;
    span[1] = denom;
  }
  __syncthreads();

  auto records_of = [&](int b) {
    return static_cast<long long>(at[band_end_key(b, H, g)]
                                  - at[band_first_key(b, mode, g)]);
  };
  long long mine = 0;
  for (int b = threadIdx.x; b < g.bands; b += blockDim.x) mine += records_of(b);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    mine += __shfl_xor_sync(0xffffffffu, mine, d);
  if ((threadIdx.x & 31) == 0) warp_walked[threadIdx.x >> 5] = mine;
  __syncthreads();
  long long walked = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) walked += warp_walked[w];
  const long long target = max(static_cast<long long>(kMinItem),
      static_cast<long long>((walked + g.bands - 1) / g.bands));
  auto shares_of = [&](int b) {
    return static_cast<int>(min(static_cast<long long>(kMaxSplit),
                                max(1LL, records_of(b) / target)));
  };
  const int per_band = g.plane_slabs * g.col_slabs;
  for (int b = threadIdx.x; b < g.bands; b += blockDim.x) {
    const int shares = shares_of(b);
    band_at[b] = per_band * shares;
    band_part[b] = shares > 1 ? per_band * shares : 0;
  }
  __syncthreads();
  const int n_total = block_exclusive_scan(band_at, band_at, g.bands,
                                           scratch);
  block_exclusive_scan(band_part, band_part, g.bands, scratch);
  for (int b = threadIdx.x; b < g.bands; b += blockDim.x) {
    const int shares = shares_of(b);
    int at = band_at[b], part = band_part[b];
    for (int t = b * per_band; t < (b + 1) * per_band; ++t)
      for (int j = 0; j < shares; ++j)
        items[at++] = make_int4(t, j, shares, shares > 1 ? part++ : -1);
  }
  if (threadIdx.x == 0) *n_items = n_total;
}

// Pass 4: persistent CTAs, one work item at a time: a static tile, or one
// share of the records of a split tile. The last share of a split tile to
// finish sums the shares' partial tiles in share order.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float4* __restrict__ records,
            const int* __restrict__ offsets, const float* __restrict__ span,
            float* __restrict__ out, int mode, int bins, int H, int W,
            int n_planes, Tiles g, const int* __restrict__ n_items,
            int* __restrict__ next_item, const int4* __restrict__ items,
            int* __restrict__ done, float* __restrict__ partials) {
  extern __shared__ float4 tile4[];
  __shared__ int slot, last;
  float* tile = reinterpret_cast<float*>(tile4);
  const float t_first = span[0], denom = span[1];
  const int items_total = *n_items;
  for (;;) {
    if (threadIdx.x == 0) slot = atomicAdd(next_item, 1);
    __syncthreads();
    const int it = slot;
    if (it >= items_total) return;
    const int4 item = items[it];   // tile, share, shares, partial
    int id = item.x;
    const int cs = id % g.col_slabs;
    id /= g.col_slabs;
    const int qs = id % g.plane_slabs;
    const int band = id / g.plane_slabs;
    const int r0 = band * g.rows, nr = min(g.rows, H - r0);
    const int q0 = qs * g.planes, nq = min(g.planes, n_planes - q0);
    const int c0 = cs * g.cols, nc = min(g.cols, W - c0);
    const int vecs = (nq * nr * nc + 3) / 4;

    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) tile4[i] = zero;
    __syncthreads();

    // a zero weight (a corner of an integer coordinate) is not added: a
    // cell starts at +0 and never holds -0, so adding +-0 changes no bit
    auto add = [&](int plane, int row, int col, float w) {
      const int q = plane - q0, r = row - r0, c = col - c0;
      if (w != 0.0f && q >= 0 && q < nq && r >= 0 && r < nr && c >= 0
          && c < nc)
        atomicAdd(&tile[(q * nr + r) * nc + c], w);
    };
    const long long beg = offsets[band_first_key(band, mode, g)];
    const long long len = offsets[band_end_key(band, H, g)] - beg;
    const int end = static_cast<int>(beg + len * (item.y + 1) / item.z);
    for (int i = static_cast<int>(beg + len * item.y / item.z) + threadIdx.x;
         i < end; i += blockDim.x) {
      const float4 e = records[i];
      event_corners(e.x, e.y, e.z, e.w, mode, bins, H, W, t_first, denom,
                    add);
    }
    __syncthreads();

    if (item.z > 1) {
      float4* mine = reinterpret_cast<float4*>(
          partials + static_cast<int64_t>(item.w) * g.tile_floats);
      for (int i = threadIdx.x; i < vecs; i += blockDim.x) mine[i] = tile4[i];
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last = atomicAdd(&done[item.x], 1) == item.z - 1;
      __syncthreads();
      if (!last) continue;
      __threadfence();
      // the shares' partials are consecutive, share 0 first
      const float4* first = mine - static_cast<int64_t>(item.y)
                                   * (g.tile_floats / 4);
      for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
        float4 sum = __ldcg(first + i);
        for (int j = 1; j < item.z; ++j) {
          const float4 v = __ldcg(first + static_cast<int64_t>(j)
                                  * (g.tile_floats / 4) + i);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        tile4[i] = sum;
      }
      __syncthreads();
    }

    // runs of cells contiguous in the grid and in the tile: a plane's rows
    // when the tile spans the width, else one row
    const bool full = nc == W;
    const int run_len = full ? nr * nc : nc;
    const int runs = full ? nq : nq * nr;
    for (int r = 0; r < runs; ++r) {
      const int q = full ? r : r / nr, rr = full ? 0 : r % nr;
      float* dst = out + (static_cast<int64_t>(q0 + q) * H + r0 + rr) * W
                   + c0;
      const float* src = tile + (q * nr + rr) * nc;
      const int head = min(run_len, static_cast<int>(
          ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
      const int body = (run_len - head) >> 2;
      const int tail = run_len - head - 4 * body;
      for (int i = threadIdx.x; i < head + tail; i += blockDim.x) {
        const int o = i < head ? i : head + 4 * body + (i - head);
        dst[o] = src[o];
      }
      float4* dst4 = reinterpret_cast<float4*>(dst + head);
      const float* s = src + head;
      if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(s);
        for (int j = threadIdx.x; j < body; j += blockDim.x) dst4[j] = s4[j];
      } else {
        for (int j = threadIdx.x; j < body; j += blockDim.x)
          dst4[j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                s[4 * j + 3]);
      }
    }
    __syncthreads();
  }
}

// The first K3: one thread an event, one float atomic a surviving corner
// into the zeroed grid.
__global__ void atomic_kernel(const float* __restrict__ xs,
                              const float* __restrict__ ys,
                              const float* __restrict__ ts,
                              const float* __restrict__ ps,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ t_range,
                              float* __restrict__ out, int64_t n, int mode,
                              int bins, int H, int W) {
  const float t_first = t_range[0];
  float denom = __fsub_rn(t_range[1], t_first);
  if (denom == 0.0f) denom = 1.0f;
  const int64_t plane = static_cast<int64_t>(H) * W;
  auto add = [&](int q, int row, int col, float w) {
    atomicAdd(out + q * plane + static_cast<int64_t>(row) * W + col, w);
  };
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (valid != nullptr && valid[i] == 0) continue;
    event_corners(xs[i], ys[i], ts[i], ps[i], mode, bins, H, W, t_first,
                  denom, add);
  }
}

int sm_count(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

constexpr int kMaxDevices = 64;

// Opts a kernel into the most dynamic shared memory a block may take
// beside its static shared memory (227 KB in all on H100).
template <class Kernel>
cudaError_t raise_smem(Kernel kernel, int most) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      most - static_cast<int>(attr.sharedSizeBytes));
}

// ... for the plan, scatter and tile kernels, once a device
cudaError_t raise_smem(int device) {
  static bool raised[kMaxDevices] = {};
  if (raised[device]) return cudaSuccess;
  int most = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = raise_smem(plan_kernel, most);
  if (err == cudaSuccess) err = raise_smem(bin_kernel<true>, most);
  if (err == cudaSuccess) err = raise_smem(tile_kernel, most);
  raised[device] = err == cudaSuccess;
  return err;
}

// The persistent grid of pass 4: as many tile CTAs as the card holds at
// once, remembered for the last tile size asked on each device.
int tile_ctas(int device, size_t smem) {
  static size_t last_smem[kMaxDevices] = {};
  static int last_ctas[kMaxDevices] = {};
  if (last_smem[device] != smem || last_ctas[device] == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_kernel,
                                                  kTileThreads, smem);
    last_smem[device] = smem;
    last_ctas[device] = sm_count(device) * (per_sm > 0 ? per_sm : 1);
  }
  return last_ctas[device];
}

// The tiles of a launch, or false where its arguments are out of range.
bool make_tiles(int mode, int bins, int height, int width, int rows,
                int planes, int cols, Tiles* g) {
  const int n_planes = bins * (mode == kPolarities || mode == kFrames ? 2
                                                                      : 1);
  if (mode < kSigned || mode > kFrames || bins < 1 || height < 1
      || width < 1 || rows < 1 || planes < 1 || planes > n_planes
      || cols < 1 || cols > width)
    return false;
  g->rows = rows;
  g->planes = planes;
  g->cols = cols;
  g->bands = (height + rows - 1) / rows;
  g->plane_slabs = (n_planes + planes - 1) / planes;
  g->col_slabs = (width + cols - 1) / cols;
  g->n_tiles = g->bands * g->plane_slabs * g->col_slabs;
  g->tile_floats = (rows * planes * cols + 3) / 4 * 4;
  return true;
}

}  // namespace

// The bytes of the workspace that voxel_scatter takes for these arguments,
// or -1 where they are out of range.
extern "C" int64_t voxel_workspace_bytes(int64_t n, int mode, int bins,
                                         int height, int width, int rows,
                                         int planes, int cols) {
  Tiles g;
  if (!make_tiles(mode, bins, height, width, rows, planes, cols, &g))
    return -1;
  return static_cast<int64_t>(workspace(nullptr, n, height + 1, g).bytes);
}

// Writes the grid of n events into ``out`` (layout by mode, above), every
// cell once. ``valid`` may be null (every event valid). The time span is
// by ``span_mode``: 0 the device [2] ``t_range``, 1 the first and last
// event, 2 the valid events' min and max, 3 (t0, t1). The static tiles are
// `rows` x `planes` x `cols` cells; a band of many records is split into
// up to kMaxSplit shares (plan_kernel). ``workspace`` holds
// voxel_workspace_bytes(...) bytes on the device. Returns the cudaError_t
// of the launches.
extern "C" int voxel_scatter(const float* x, const float* y, const float* t,
                             const float* p, const uint8_t* valid,
                             const float* t_range, float t0, float t1,
                             int span_mode, float* out, int64_t n, int mode,
                             int bins, int height, int width, int rows,
                             int planes, int cols, void* workspace_ptr,
                             void* stream) {
  Tiles g;
  if (!make_tiles(mode, bins, height, width, rows, planes, cols, &g)
      || n < 1 || n > INT32_MAX || span_mode < kSpanPointer
      || span_mode > kSpanValues
      || (span_mode == kSpanPointer && t_range == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  err = raise_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_planes = bins * (mode == kPolarities || mode == kFrames ? 2
                                                                      : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int keys = height + 1;
  const Workspace w = workspace(workspace_ptr, n, keys, g);
  err = cudaMemsetAsync(w.counts, 0, w.zeroed_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int blocks = static_cast<int>((n + kChunk - 1) / kChunk);
  const size_t count_smem = static_cast<size_t>(keys) * 4;
  const size_t scatter_smem = static_cast<size_t>(kChunk) * 20
                              + 3 * count_smem;
  bin_kernel<false><<<blocks, kBinThreads, count_smem, s>>>(
      x, y, t, p, valid, n, mode, height, width, span_mode, w.counts,
      w.span_keys, w.cursor, w.records);
  const size_t plan_smem = (static_cast<size_t>(keys) + 1 + 2 * g.bands) * 4;
  plan_kernel<<<1, kScanThreads, plan_smem, s>>>(
      w.counts, w.span_keys, w.cursor, w.offsets, w.span, keys, span_mode,
      t_range, t, n, t0, t1, mode, height, g, w.n_items, w.items);
  bin_kernel<true><<<blocks, kBinThreads, scatter_smem, s>>>(
      x, y, t, p, valid, n, mode, height, width, span_mode, w.counts,
      w.span_keys, w.cursor, w.records);
  const size_t tile_smem = static_cast<size_t>(g.tile_floats) * 4;
  const int ctas = min(g.n_tiles * kMaxSplit, tile_ctas(device, tile_smem));
  tile_kernel<<<ctas, kTileThreads, tile_smem, s>>>(
      w.records, w.offsets, w.span, out, mode, bins, height, width,
      n_planes, g, w.n_items, w.next_item, w.items, w.done, w.partials);
  return static_cast<int>(cudaGetLastError());
}

// The first K3, kept as a yardstick: scatters n events into the zeroed
// grid ``out`` with one float atomic a corner. ``t_range`` is a device
// pointer to (t0, t1).
extern "C" int voxel_scatter_atomic(const float* x, const float* y,
                                    const float* t, const float* p,
                                    const uint8_t* valid,
                                    const float* t_range, float* out,
                                    int64_t n, int mode, int bins,
                                    int height, int width, void* stream) {
  if (mode < kSigned || mode > kFrames || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t max_blocks = static_cast<int64_t>(sm_count(device)) * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  atomic_kernel<<<static_cast<int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      x, y, t, p, valid, t_range, out, n, mode, bins, height, width);
  return static_cast<int>(cudaGetLastError());
}
