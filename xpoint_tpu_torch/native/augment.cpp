// Fused host-side homographic augmentation engine.
//
// The training data pipeline applies, per sample: perspective warp of the
// image (bilinear, BORDER_REFLECT_101 or constant), valid-mask computation
// (nearest warp of ones + box erosion), and keypoint transformation. The
// reference does this as separate cv2 calls with Python glue between them
// (augmentation/augmentation.py:25-59); on a single-CPU host feeding a TPU
// the per-call overhead matters, so this engine does the whole thing in one
// C call. Exposed via ctypes (xpoint_tpu_torch/native/__init__.py), which
// builds it with g++ at first use into build/xpoint_tpu_torch/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Homography {
    double m[9];
};

inline void invert3x3(const double* h, double* out) {
    double a = h[0], b = h[1], c = h[2];
    double d = h[3], e = h[4], f = h[5];
    double g = h[6], hh = h[7], i = h[8];
    double A = e * i - f * hh;
    double B = -(d * i - f * g);
    double C = d * hh - e * g;
    double det = a * A + b * B + c * C;
    double inv_det = det != 0.0 ? 1.0 / det : 0.0;
    out[0] = A * inv_det;
    out[1] = -(b * i - c * hh) * inv_det;
    out[2] = (b * f - c * e) * inv_det;
    out[3] = B * inv_det;
    out[4] = (a * i - c * g) * inv_det;
    out[5] = -(a * f - c * d) * inv_det;
    out[6] = C * inv_det;
    out[7] = -(a * hh - b * g) * inv_det;
    out[8] = (a * e - b * d) * inv_det;
}

// mirror a coordinate into [0, n-1] without repeating the edge (REFLECT_101)
inline int reflect101(int p, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    p = p % period;
    if (p < 0) p += period;
    return p >= n ? period - p : p;
}

}  // namespace

extern "C" {

// Warp `src` (H x W float32) by the SOURCE->DEST pixel homography `h` into
// `dst` (H x W), bilinear sampling. border_mode: 0 = constant(0),
// 1 = BORDER_REFLECT_101. Also writes the nearest-sampled valid mask
// (uint8) when `mask` is non-null.
void warp_perspective(const float* src, float* dst, uint8_t* mask,
                      int H, int W, const double* h, int border_mode) {
    double inv[9];
    invert3x3(h, inv);
    // fast path: when the reverse map is affine (no perspective row) the
    // per-pixel divide disappears and source coords advance linearly in x
    const bool affine = inv[6] == 0.0 && inv[7] == 0.0 && inv[8] == 1.0;
    for (int y = 0; y < H; ++y) {
        const double base_x = inv[1] * y + inv[2];
        const double base_y = inv[4] * y + inv[5];
        const double base_w = inv[7] * y + inv[8];
        float* dst_row = dst + y * W;
        uint8_t* mask_row = mask ? mask + y * W : nullptr;
        for (int x = 0; x < W; ++x) {
            float sx, sy;
            if (affine) {
                sx = static_cast<float>(inv[0] * x + base_x);
                sy = static_cast<float>(inv[3] * x + base_y);
            } else {
                const float iw =
                    1.0f / static_cast<float>(inv[6] * x + base_w);
                sx = static_cast<float>(inv[0] * x + base_x) * iw;
                sy = static_cast<float>(inv[3] * x + base_y) * iw;
            }

            const float fsx = std::floor(sx);
            const float fsy = std::floor(sy);
            const int x0 = static_cast<int>(fsx);
            const int y0 = static_cast<int>(fsy);
            const float fx = sx - fsx;
            const float fy = sy - fsy;

            float v = 0.0f;
            if (x0 >= 0 && y0 >= 0 && x0 < W - 1 && y0 < H - 1) {
                // fully interior: no bounds logic
                const float* p0 = src + y0 * W + x0;
                const float* p1 = p0 + W;
                v = (1 - fy) * ((1 - fx) * p0[0] + fx * p0[1])
                    + fy * ((1 - fx) * p1[0] + fx * p1[1]);
            } else if (border_mode == 1) {
                const int xa = reflect101(x0, W), xb = reflect101(x0 + 1, W);
                const int ya = reflect101(y0, H), yb = reflect101(y0 + 1, H);
                const float v00 = src[ya * W + xa], v01 = src[ya * W + xb];
                const float v10 = src[yb * W + xa], v11 = src[yb * W + xb];
                v = (1 - fy) * ((1 - fx) * v00 + fx * v01)
                    + fy * ((1 - fx) * v10 + fx * v11);
            } else if (x0 >= -1 && y0 >= -1 && x0 < W && y0 < H) {
                auto at = [&](int yy, int xx) -> float {
                    if (yy < 0 || xx < 0 || yy >= H || xx >= W) return 0.0f;
                    return src[yy * W + xx];
                };
                v = (1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
                    + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1));
            }
            dst_row[x] = v;
            if (mask_row) {
                // nearest warp of an all-ones image (round like cv2)
                const int rx = static_cast<int>(sx + 0.5f) - (sx < -0.5f);
                const int ry = static_cast<int>(sy + 0.5f) - (sy < -0.5f);
                mask_row[x] = (rx >= 0 && ry >= 0 && rx < W && ry < H) ? 1 : 0;
            }
        }
    }
}

// In-place box erosion of a binary uint8 mask with a (2r+1)^2 kernel,
// separable two-pass min filter. `tmp` must hold H*W bytes.
void erode_box(uint8_t* mask, uint8_t* tmp, int H, int W, int r) {
    if (r <= 0) return;
    // horizontal pass
    for (int y = 0; y < H; ++y) {
        const uint8_t* row = mask + y * W;
        uint8_t* out = tmp + y * W;
        for (int x = 0; x < W; ++x) {
            uint8_t m = 1;
            const int x0 = std::max(0, x - r), x1 = std::min(W - 1, x + r);
            for (int k = x0; k <= x1; ++k) m &= row[k];
            out[x] = m;
        }
    }
    // vertical pass
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            uint8_t m = 1;
            const int y0 = std::max(0, y - r), y1 = std::min(H - 1, y + r);
            for (int k = y0; k <= y1; ++k) m &= tmp[k * W + x];
            mask[y * W + x] = m;
        }
    }
}

// Border-aware erosion matching compute_valid_mask(mask_border=True)
// (homographies.py:529-558): zero-pad by 1 before eroding so the image
// border erodes inward too.
void erode_box_with_border(uint8_t* mask, uint8_t* scratch,
                           int H, int W, int r) {
    if (r <= 0) return;
    const int Hp = H + 2, Wp = W + 2;
    // scratch layout: padded mask then padded tmp (caller provides 2*Hp*Wp)
    uint8_t* padded = scratch;
    uint8_t* tmp = scratch + Hp * Wp;
    std::memset(padded, 0, Hp * Wp);
    for (int y = 0; y < H; ++y)
        std::memcpy(padded + (y + 1) * Wp + 1, mask + y * W, W);
    erode_box(padded, tmp, Hp, Wp, r);
    for (int y = 0; y < H; ++y)
        std::memcpy(mask + y * W, padded + (y + 1) * Wp + 1, W);
}

// Perspective-transform keypoints given as (row, col) float64 pairs.
// Writes transformed (row, col); returns nothing (caller filters).
void warp_keypoints(const double* kps, double* out, int n, const double* h) {
    for (int i = 0; i < n; ++i) {
        const double x = kps[2 * i + 1];   // col
        const double y = kps[2 * i + 0];   // row
        const double w = h[6] * x + h[7] * y + h[8];
        const double iw = w != 0.0 ? 1.0 / w : 0.0;
        out[2 * i + 1] = (h[0] * x + h[1] * y + h[2]) * iw;
        out[2 * i + 0] = (h[3] * x + h[4] * y + h[5]) * iw;
    }
}

// Fused: warp image + valid mask (+ border erosion). Returns 0 on success.
int homographic_augment(const float* src, float* dst, uint8_t* mask,
                        uint8_t* scratch, int H, int W, const double* h,
                        int border_reflect, int erosion_radius,
                        int mask_border) {
    warp_perspective(src, dst, mask, H, W, h, border_reflect ? 1 : 0);
    if (erosion_radius > 0) {
        if (mask_border) {
            erode_box_with_border(mask, scratch, H, W, erosion_radius);
        } else {
            erode_box(mask, scratch, H, W, erosion_radius);
        }
    }
    return 0;
}

}  // extern "C"
