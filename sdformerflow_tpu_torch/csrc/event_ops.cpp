// Host event-stream kernels for the raw-events serving path: the port's
// own copy of the JAX package's event packer (native/event_ops.cpp), kept
// here so that the port imports nothing of that package.
//
// It replaces the reference's numba loader internals (the ms_to_idx scan
// and per-window event slicing of DSEC_dataloader/event_representations.py:
// 174-232) and packs each window into the fixed-size buffers the device
// voxelizer (K3, csrc/voxel.cu) reads: timestamp indexing, monotone window
// slicing, and padded bucket packing.
//
// Built at first use with g++ (kernel_build.build_host_library) and bound
// with ctypes (native.py). There is no fallback: if the build fails, the
// bindings raise.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// searchsorted(t, v, side='left') over an int64 timestamp array.
int64_t lower_bound_i64(const int64_t* t, int64_t n, int64_t v) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (t[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Reference compute_ms_to_idx: ms_to_idx[ms] = first event index whose
// timestamp (us, offset removed) is >= ms*1000. Single monotone pass.
void compute_ms_to_idx(const int64_t* t_us, int64_t n, int64_t n_ms,
                       int64_t* ms_to_idx) {
    int64_t i = 0;
    for (int64_t ms = 0; ms < n_ms; ++ms) {
        const int64_t t_lim = ms * 1000;
        while (i < n && t_us[i] < t_lim) ++i;
        ms_to_idx[ms] = i;
    }
}

// Cut a sorted timestamp stream into W windows given W+1 boundaries (us):
// lo[w] = searchsorted(t, b[w]), hi[w] = searchsorted(t, b[w+1]).
// Two-pointer O(n + W) instead of W binary searches.
void slice_windows(const int64_t* t_us, int64_t n,
                   const int64_t* bounds, int64_t n_windows,
                   int64_t* lo, int64_t* hi) {
    int64_t i = lower_bound_i64(t_us, n, bounds[0]);
    for (int64_t w = 0; w < n_windows; ++w) {
        while (i < n && t_us[i] < bounds[w]) ++i;
        lo[w] = i;
        int64_t j = i;
        while (j < n && t_us[j] < bounds[w + 1]) ++j;
        hi[w] = j;
        i = j;
    }
}

// Pack one window's events into a fixed-capacity device buffer:
// copies up to cap events, zero-fills the tail, writes the valid mask.
// x/y/p arrays arrive as uint16/uint16/uint8 (DSEC storage dtypes) and are
// widened to float32; t arrives as int64 us and is converted to float32
// relative to t0 (f32 holds 100 ms windows at us resolution exactly).
void pack_window(const uint16_t* x, const uint16_t* y, const int64_t* t,
                 const uint8_t* p, int64_t n, int64_t t0, int64_t cap,
                 float* ox, float* oy, float* ot, float* op,
                 uint8_t* valid) {
    const int64_t m = n < cap ? n : cap;
    for (int64_t i = 0; i < m; ++i) {
        ox[i] = static_cast<float>(x[i]);
        oy[i] = static_cast<float>(y[i]);
        ot[i] = static_cast<float>(t[i] - t0);
        op[i] = static_cast<float>(p[i]);
        valid[i] = 1;
    }
    if (m < cap) {
        std::memset(ox + m, 0, sizeof(float) * (cap - m));
        std::memset(oy + m, 0, sizeof(float) * (cap - m));
        std::memset(ot + m, 0, sizeof(float) * (cap - m));
        std::memset(op + m, 0, sizeof(float) * (cap - m));
        std::memset(valid + m, 0, sizeof(uint8_t) * (cap - m));
    }
}

// Row-grouped packing: same contract as pack_window, but events are
// emitted grouped by the voxelizer's row key g = clip(trunc(y), -1, H-1)+1
// (counting sort, stable within a group) and the padded tail carries
// y = height so it lands in the LAST group. A row-banded voxelizer can take
// such a buffer without sorting on the device (the ``presorted`` contract);
// the port's scatter kernel is order-free and does not need it. Grouping
// (not total y order) is sufficient: a row-banded kernel only needs
// contiguous row groups, and the key is monotone non-decreasing in y.
void pack_window_sorted(const uint16_t* x, const uint16_t* y,
                        const int64_t* t, const uint8_t* p, int64_t n,
                        int64_t t0, int64_t cap, int64_t height,
                        float* ox, float* oy, float* ot, float* op,
                        uint8_t* valid) {
    const int64_t m = n < cap ? n : cap;
    const int64_t n_groups = height + 2;  // g in [0, height+1) -> [1, H]
    int64_t* counts = new int64_t[n_groups]();
    for (int64_t i = 0; i < m; ++i) {
        const int64_t g = (y[i] < height ? (int64_t)y[i] : height - 1) + 1;
        ++counts[g];
    }
    int64_t* offs = new int64_t[n_groups];
    int64_t acc = 0;
    for (int64_t g = 0; g < n_groups; ++g) { offs[g] = acc; acc += counts[g]; }
    for (int64_t i = 0; i < m; ++i) {
        const int64_t g = (y[i] < height ? (int64_t)y[i] : height - 1) + 1;
        const int64_t j = offs[g]++;
        ox[j] = static_cast<float>(x[i]);
        oy[j] = static_cast<float>(y[i]);
        ot[j] = static_cast<float>(t[i] - t0);
        op[j] = static_cast<float>(p[i]);
        valid[j] = 1;
    }
    delete[] counts;
    delete[] offs;
    for (int64_t i = m; i < cap; ++i) {
        ox[i] = 0.0f;
        oy[i] = static_cast<float>(height);  // last row group, weight 0
        ot[i] = 0.0f;
        op[i] = 0.0f;
        valid[i] = 0;
    }
}

// float32-coordinate variant (already-rebased times, t0 handled upstream).
// Handles negative / fractional y: g = clip(trunc(y), -1, H-1) + 1.
void pack_window_sorted_f32(const float* x, const float* y, const float* t,
                            const float* p, int64_t n, float t0, int64_t cap,
                            int64_t height,
                            float* ox, float* oy, float* ot, float* op,
                            uint8_t* valid) {
    const int64_t m = n < cap ? n : cap;
    const int64_t n_groups = height + 2;
    int64_t* counts = new int64_t[n_groups]();
    int64_t* gidx = new int64_t[m];
    for (int64_t i = 0; i < m; ++i) {
        double yt = std::trunc(static_cast<double>(y[i]));
        if (yt < -1.0) yt = -1.0;
        if (yt > static_cast<double>(height - 1)) yt = height - 1;
        gidx[i] = static_cast<int64_t>(yt) + 1;
        ++counts[gidx[i]];
    }
    int64_t* offs = new int64_t[n_groups];
    int64_t acc = 0;
    for (int64_t g = 0; g < n_groups; ++g) { offs[g] = acc; acc += counts[g]; }
    for (int64_t i = 0; i < m; ++i) {
        const int64_t j = offs[gidx[i]]++;
        ox[j] = x[i];
        oy[j] = y[i];
        ot[j] = t[i] - t0;
        op[j] = p[i];
        valid[j] = 1;
    }
    delete[] counts;
    delete[] offs;
    delete[] gidx;
    for (int64_t i = m; i < cap; ++i) {
        ox[i] = 0.0f;
        oy[i] = static_cast<float>(height);
        ot[i] = 0.0f;
        op[i] = 0.0f;
        valid[i] = 0;
    }
}

// float32 variant for loaders whose arrays are already float.
void pack_window_f32(const float* x, const float* y, const float* t,
                     const float* p, int64_t n, float t0, int64_t cap,
                     float* ox, float* oy, float* ot, float* op,
                     uint8_t* valid) {
    const int64_t m = n < cap ? n : cap;
    for (int64_t i = 0; i < m; ++i) {
        ox[i] = x[i];
        oy[i] = y[i];
        ot[i] = t[i] - t0;
        op[i] = p[i];
        valid[i] = 1;
    }
    if (m < cap) {
        std::memset(ox + m, 0, sizeof(float) * (cap - m));
        std::memset(oy + m, 0, sizeof(float) * (cap - m));
        std::memset(ot + m, 0, sizeof(float) * (cap - m));
        std::memset(op + m, 0, sizeof(float) * (cap - m));
        std::memset(valid + m, 0, sizeof(uint8_t) * (cap - m));
    }
}

}  // extern "C"
