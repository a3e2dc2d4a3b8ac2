// discodata — native host-side image preprocessing for the PyTorch port's
// input pipeline: the port's own copy of the JAX package's
// native/discodata.cpp, the same code under the same flags.
//
// The reference delegates these ops to OpenCV (cv2.dilate / cv2.resize at
// dataset.py:52-66); this library provides the same numerics as a single
// fused pass with no OpenCV dependency:
//
//   * edge thickening: the reference computes 255 - dilate3x3(255 - x),
//     which is exactly a 3x3 erosion (min filter) of x; cv2.dilate's
//     default constant border (-inf for dilate) makes it a min over the
//     valid neighbors.
//   * bilinear resize with half-pixel centers (cv2 float path).
//   * /255 normalization into float32 HWC.
//
// Built at first use by data/native.py (g++ -O3 -march=native -shared)
// into build/native/ under the repository root, bound via ctypes.
//
// Performance notes (a scalar version lost about 2x to cv2's SIMD loops;
// these are what closed the gap):
//   * The 3x3 min/max filters are SEPARABLE (min over a 3x3 window =
//     vertical 3-tap min of horizontal 3-tap mins) and operate on the
//     flattened row of w*c floats: the horizontal pass is an elementwise
//     min of the row against itself shifted by ±c — three contiguous
//     streams the compiler auto-vectorizes — and the vertical pass is an
//     elementwise min of three full rows. 9 scalar compares per sample
//     become ~4 vector ops, all on contiguous memory.
//   * The resize precomputes per-output-column source offsets and float
//     weights once, then blends two source rows per output row with an
//     optional fused output scale (the /255). Float arithmetic like
//     cv2's own float path (golden tests hold at 1e-4 of cv2).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

template <typename Op>
void morph3x3(const float* in, float* out, int h, int w, int c, Op op) {
    const int rc = w * c;
    std::vector<float> tmp(static_cast<size_t>(h) * rc);
    // Horizontal 3-tap pass over the flattened row (shift by one PIXEL
    // = c floats); edges take the valid-neighbor reduction only.
    for (int y = 0; y < h; ++y) {
        const float* r = in + static_cast<size_t>(y) * rc;
        float* t = tmp.data() + static_cast<size_t>(y) * rc;
        for (int i = c; i < rc - c; ++i)
            t[i] = op(r[i], op(r[i - c], r[i + c]));
        for (int i = 0; i < c && i + c < rc; ++i) t[i] = op(r[i], r[i + c]);
        for (int i = std::max(rc - c, c); i < rc; ++i)
            t[i] = op(r[i], r[i - c]);
        if (w == 1)
            for (int i = 0; i < rc; ++i) t[i] = r[i];
    }
    // Vertical 3-tap pass: elementwise over whole rows.
    for (int y = 0; y < h; ++y) {
        const float* mid = tmp.data() + static_cast<size_t>(y) * rc;
        const float* lo =
            tmp.data() + static_cast<size_t>(std::max(y - 1, 0)) * rc;
        const float* hi =
            tmp.data() + static_cast<size_t>(std::min(y + 1, h - 1)) * rc;
        float* o = out + static_cast<size_t>(y) * rc;
        if (y == 0 && h == 1) {
            for (int i = 0; i < rc; ++i) o[i] = mid[i];
        } else if (y == 0) {
            for (int i = 0; i < rc; ++i) o[i] = op(mid[i], hi[i]);
        } else if (y == h - 1) {
            for (int i = 0; i < rc; ++i) o[i] = op(lo[i], mid[i]);
        } else {
            for (int i = 0; i < rc; ++i) o[i] = op(mid[i], op(lo[i], hi[i]));
        }
    }
}

struct MinOp {
    float operator()(float a, float b) const { return a < b ? a : b; }
};
struct MaxOp {
    float operator()(float a, float b) const { return a > b ? a : b; }
};

// Core resize with fused output scale. Per-column source offsets (in
// floats, channel-expanded) and weights are precomputed; the inner loop
// blends contiguous channel groups.
void resize_bilinear_scaled(const float* in, float* out, int ih, int iw,
                            int oh, int ow, int c, float out_scale) {
    const double sy = static_cast<double>(ih) / oh;
    const double sx = static_cast<double>(iw) / ow;
    if (ih == oh && iw == ow) {
        // Identity mapping (the 512px tops2hanbok images arrive at the
        // target size): half-pixel centers give wx == wy == 0 exactly,
        // so this is a pure scaled copy — one vectorized stream.
        const size_t n = static_cast<size_t>(ih) * iw * c;
        for (size_t i = 0; i < n; ++i) out[i] = in[i] * out_scale;
        return;
    }
    std::vector<int> xo0(ow), xo1(ow);
    std::vector<float> wx1(ow);
    for (int x = 0; x < ow; ++x) {
        double fx = (x + 0.5) * sx - 0.5;
        int x0 = static_cast<int>(std::floor(fx));
        double wx = fx - x0;
        if (x0 < 0) { x0 = 0; wx = 0.0; }
        if (x0 > iw - 1) { x0 = iw - 1; wx = 0.0; }
        const int x1 = std::min(x0 + 1, iw - 1);
        xo0[x] = x0 * c;
        xo1[x] = x1 * c;
        wx1[x] = static_cast<float>(wx);
    }
    const size_t irc = static_cast<size_t>(iw) * c;
    const int orc = ow * c;

    // Two-pass (cv2's own structure): horizontally resample the needed
    // source rows into a two-row cache, then blend the cached rows
    // vertically — the vertical blend is one contiguous vectorized
    // stream, and consecutive output rows reuse a cached row whenever
    // their source windows overlap (always, for scale factors < 2).
    std::vector<float> rowbuf(2 * static_cast<size_t>(orc));
    int cached[2] = {-1, -1};

    auto hresample = [&](int src_row, int slot) {
        const float* r = in + src_row * irc;
        float* dst = rowbuf.data() + static_cast<size_t>(slot) * orc;
        if (c == 3) {
            for (int x = 0; x < ow; ++x) {
                const float wx = wx1[x];
                const float* a = r + xo0[x];
                const float* b = r + xo1[x];
                dst[3 * x + 0] = a[0] + (b[0] - a[0]) * wx;
                dst[3 * x + 1] = a[1] + (b[1] - a[1]) * wx;
                dst[3 * x + 2] = a[2] + (b[2] - a[2]) * wx;
            }
        } else {
            for (int x = 0; x < ow; ++x) {
                const float wx = wx1[x];
                const float* a = r + xo0[x];
                const float* b = r + xo1[x];
                for (int ch = 0; ch < c; ++ch)
                    dst[x * c + ch] = a[ch] + (b[ch] - a[ch]) * wx;
            }
        }
        cached[slot] = src_row;
    };
    auto slot_for = [&](int src_row) {
        for (int s = 0; s < 2; ++s)
            if (cached[s] == src_row) return s;
        // Evict the slot not holding the other needed row; callers always
        // request y0 before y1, so evicting a slot != the one just
        // returned is handled by choosing the least-recently-matched.
        const int s = (cached[0] == -1 || cached[0] < cached[1]) ? 0 : 1;
        hresample(src_row, s);
        return s;
    };

    for (int y = 0; y < oh; ++y) {
        double fy = (y + 0.5) * sy - 0.5;
        int y0 = static_cast<int>(std::floor(fy));
        double wyd = fy - y0;
        if (y0 < 0) { y0 = 0; wyd = 0.0; }
        if (y0 > ih - 1) { y0 = ih - 1; wyd = 0.0; }
        const int y1 = std::min(y0 + 1, ih - 1);
        const float wy = static_cast<float>(wyd);
        const float* t0 = rowbuf.data()
            + static_cast<size_t>(slot_for(y0)) * orc;
        const float* t1 = rowbuf.data()
            + static_cast<size_t>(slot_for(y1)) * orc;
        float* o = out + static_cast<size_t>(y) * orc;
        if (wy == 0.0f) {
            for (int i = 0; i < orc; ++i) o[i] = t0[i] * out_scale;
        } else {
            for (int i = 0; i < orc; ++i)
                o[i] = (t0[i] + (t1[i] - t0[i]) * wy) * out_scale;
        }
    }
}

}  // namespace

extern "C" {

// 3x3 min filter (== the reference's invert-dilate-invert edge op) on a
// float HWC image. Border: min over valid neighbors only.
void erode3x3_f32(const float* in, float* out, int h, int w, int c) {
    morph3x3(in, out, h, w, c, MinOp{});
}

// 3x3 max filter (plain dilation), same border convention.
void dilate3x3_f32(const float* in, float* out, int h, int w, int c) {
    morph3x3(in, out, h, w, c, MaxOp{});
}

// Bilinear resize, half-pixel centers (cv2 INTER_LINEAR float convention),
// float HWC in/out.
void resize_bilinear_f32(const float* in, float* out, int ih, int iw,
                         int oh, int ow, int c) {
    resize_bilinear_scaled(in, out, ih, iw, oh, ow, c, 1.0f);
}

// Fused reference preprocessing for one decoded RGB image:
//   uint8 HWC -> [optional left/right 256px crop] -> [optional edge
//   thickening (erosion)] -> bilinear resize to size x size -> /255
//   float32 HWC.
// domain: 0 = none, 1 = 'A' (left crop + edge), 2 = 'B' (right crop).
void preprocess_u8(const uint8_t* in, int h, int w, int c, int domain,
                   int size, float* out) {
    int x_off = 0, cw = w;
    if (domain == 1) { cw = std::min(256, w); }
    if (domain == 2) { x_off = std::min(256, w); cw = w - x_off; }

    // Degenerate crop (e.g. domain 'B' on a <=256px-wide image): the
    // Python wrapper raises before calling, but the raw C API must not
    // read out of bounds — zero-fill and return.
    if (cw <= 0 || h <= 0 || size <= 0) {
        std::fill(out, out + static_cast<size_t>(size) * size * c, 0.0f);
        return;
    }

    std::vector<float> buf(static_cast<size_t>(h) * cw * c);
    const int crc = cw * c;
    for (int y = 0; y < h; ++y) {
        const uint8_t* r = in + (static_cast<size_t>(y) * w + x_off) * c;
        float* t = buf.data() + static_cast<size_t>(y) * crc;
        for (int i = 0; i < crc; ++i) t[i] = static_cast<float>(r[i]);
    }

    std::vector<float> eroded;
    const float* src = buf.data();
    if (domain == 1) {
        eroded.resize(buf.size());
        erode3x3_f32(buf.data(), eroded.data(), h, cw, c);
        src = eroded.data();
    }

    resize_bilinear_scaled(src, out, h, cw, size, size, c, 1.0f / 255.0f);
}

}  // extern "C"
