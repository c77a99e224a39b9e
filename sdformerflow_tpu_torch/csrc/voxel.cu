// K3: event -> voxel-grid scatter-add for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sdformerflow_tpu/ops/pallas_voxel.py:
// _voxel_kernel (pallas_call at :135, reached through _accumulate_core by
// voxel_grid_signed_pallas, voxel_grid_polarities_pallas,
// events_to_voxel_grid_v2_pallas and events_to_frames_pallas). One kernel
// serves the four grids, as _accumulate_core serves them in JAX:
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
// sdformerflow_tpu_torch/ops/voxel.py.
//
// What bounds it on H100: memory. At 2^20 events into 480x640x10 the
// function reads the events once (4 float32 arrays and a bool mask, 17.8
// MB) and writes the grid once (12.3 MB): about 0.009 ms at 3.35 TB/s.
// The arithmetic is ~50 operations an event.
// The design: one thread per event (grid-stride loop) reads its event with
// coalesced loads, computes its corner weights in registers and adds each
// surviving corner straight into its cell with a fire-and-forget float
// atomic (RED). The wrapper zeroes the grid first. The grid fits in the
// 50 MB L2, so the atomics resolve there and the grid goes to device
// memory about once. Nothing depends on the order of the events, so the
// host packs them unsorted. What the TPU kernel needed and this one does
// not: the y-row sort and searchsorted offsets, scalar prefetch, the
// 128-lane-aligned DMA starts with masked leading lanes, the [R, E] x
// [E, W] one-hot matrix product and the partial-then-fold layout. The
// scattered atomics are what stand between this and the bound; a
// row-banded version that sums in shared memory is a later speed step.
//
// Rounding: every weight is computed with explicitly rounded operations
// (__fmul_rn etc., no FMA contraction) in the order of the plain PyTorch
// forms, so kernel and twin differ only in the order of the sums, which
// float atomics change from run to run. On inputs whose weights and sums
// are exact (coordinates on a 1/4 grid) the kernel equals the twin bit for
// bit; otherwise they agree to float32 rounding of the sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kSigned = 0, kPolarities = 1, kV2 = 2, kFrames = 3 };

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

__global__ void voxel_kernel(const float* __restrict__ xs,
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
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (valid != nullptr && valid[i] == 0) continue;
    const float x = xs[i], y = ys[i], t = ts[i], p = ps[i];
    const float dt_first = __fsub_rn(t, t_first);

    if (mode == kFrames) {
      const int ch = p == 1.0f ? 0 : (p == 0.0f ? 1 : -1);
      // (2 - 1) * (t - t0) / span, then trunc((F - 1) * that)
      const float t01 = __fdiv_rn(__fmul_rn(1.0f, dt_first), denom);
      const int fr = base_index(
          truncf(__fmul_rn(static_cast<float>(bins - 1), t01)), bins);
      if (ch < 0 || !inside(fr, bins)) continue;
      const float x0 = truncf(x), y0 = truncf(y);
      const int xi = base_index(x0, W), yi = base_index(y0, H);
      const float wx[2] = {fmaxf(corner_w(x0, x), 0.0f),
                           fmaxf(corner_w(x0 + 1.0f, x), 0.0f)};
      const float wy[2] = {fmaxf(corner_w(y0, y), 0.0f),
                           fmaxf(corner_w(y0 + 1.0f, y), 0.0f)};
      float* base = out + (static_cast<int64_t>(fr) * 2 + ch) * plane;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int xl = xi + dx, yl = yi + dy;
          if (inside(xl, W) && inside(yl, H))
            atomicAdd(base + static_cast<int64_t>(yl) * W + xl,
                      __fmul_rn(wx[dx], wy[dy]));
        }
      continue;
    }

    const float tn = __fdiv_rn(
        __fmul_rn(static_cast<float>(bins - 1), dt_first), denom);
    const float tb = truncf(tn);
    const int ti = base_index(tb, bins);

    if (mode == kV2) {
      const float xt = truncf(x), yt = truncf(y);
      const int xi = base_index(xt, W), yi = base_index(yt, H);
      if (!inside(xi, W) || !inside(yi, H)) continue;
      const float pol = p == 0.0f ? -1.0f : p;
      const float dts = __fsub_rn(tn, tb);
      const float w[2] = {__fmul_rn(pol, __fsub_rn(1.0f, dts)),
                          __fmul_rn(pol, dts)};
      const int64_t cell = static_cast<int64_t>(yi) * W + xi;
#pragma unroll
      for (int dt = 0; dt < 2; ++dt)
        if (inside(ti + dt, bins))
          atomicAdd(out + (ti + dt) * plane + cell, w[dt]);
      continue;
    }

    // signed and polarities: 8 trilinear corners
    const float x0 = truncf(x), y0 = truncf(y);
    const int xi = base_index(x0, W), yi = base_index(y0, H);
    const float wx[2] = {corner_w(x0, x), corner_w(x0 + 1.0f, x)};
    const float wy[2] = {corner_w(y0, y), corner_w(y0 + 1.0f, y)};
    const float wt[2] = {corner_w(tb, tn), corner_w(tb + 1.0f, tn)};
    const bool signed_grid = mode == kSigned;
    const float value = __fsub_rn(__fmul_rn(2.0f, p), 1.0f);
    const int stride = signed_grid ? 1 : 2;   // bins between time slices
    const int ch = signed_grid ? 0 : (p == 1.0f ? 0 : 1);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dt = 0; dt < 2; ++dt) {
          const int xl = xi + dx, yl = yi + dy, tl = ti + dt;
          if (!inside(xl, W) || !inside(yl, H) || !inside(tl, bins))
            continue;
          // ((value * wx) * wy) * wt, or (wx * wy) * wt without a value
          const float w = signed_grid
              ? __fmul_rn(__fmul_rn(__fmul_rn(value, wx[dx]), wy[dy]),
                          wt[dt])
              : __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wt[dt]);
          atomicAdd(out + (static_cast<int64_t>(tl) * stride + ch) * plane
                        + static_cast<int64_t>(yl) * W + xl,
                    w);
        }
  }
}

}  // namespace

// Scatters n events into the zeroed grid ``out`` (layout by mode, above).
// ``valid`` may be null (every event valid); ``t_range`` is a device
// pointer to (t0, t1). Returns the cudaError_t of the launch.
extern "C" int voxel_scatter(const float* x, const float* y, const float* t,
                             const float* p, const uint8_t* valid,
                             const float* t_range, float* out, int64_t n,
                             int mode, int bins, int height, int width,
                             void* stream) {
  if (mode < kSigned || mode > kFrames || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  int sms = 132;
  int device = 0;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t max_blocks = static_cast<int64_t>(sms) * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  voxel_kernel<<<static_cast<int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, y, t, p, valid, t_range, out, n, mode, bins, height, width);
  return static_cast<int>(cudaGetLastError());
}
