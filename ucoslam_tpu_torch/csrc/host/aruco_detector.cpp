// Native ArUco marker detector (C ABI, loaded from Python via ctypes).
//
// The port's copy of the repository's native/aruco_detector.cpp, with two
// changes: the caller always passes the dictionary (there is no built-in
// table), and `cv2_mode` repairs three faults of native/'s detector for the
// dictionaries that the reference detects with cv2.aruco:
//  - corner order: native/ puts corner i at quad[(i + rot) & 3], where rot
//    is the number of clockwise quarter turns that bring the sampled code
//    onto the dictionary's word; for rot 1 and 3 that is the dictionary's
//    top-left corner turned by half a turn. cv2_mode takes quad[(i - rot) & 3]:
//    the dictionary's top-left first, clockwise, as cv2.aruco orders them;
//  - the quad fit keeps the contour's first traced pixel as a vertex, and
//    fails when that pixel lies off a corner; cv2_mode starts the fit at a
//    corner;
//  - the cheap border probe of a large quad rejects it when its samples
//    show no contrast, which a marker whose probed interior cells are all
//    ink does too; cv2_mode leaves such a quad to the full decode, which
//    tests the contrast of every cell.
// Without cv2_mode the detector is native/'s, bit for bit: the port runs
// the native tables (ARUCO_MIP_36h12, ARUCO_MIP_16h3) so, as the reference
// detects them with native/'s code.
//
// Counterpart of the reference's vendored aruco library
// (3rdparty/aruco/aruco/markerdetector.h:88,276): adaptive threshold ->
// contour extraction -> quad fitting -> perspective bit sampling ->
// dictionary decode (ARUCO_MIP_36h12 by default) -> subpixel-ish corner
// refinement. Built from scratch; no OpenCV dependency.
//
// Pipeline (DM_NORMAL equivalent):
//  1. adaptive threshold: integral-image local mean, thresh = mean - C
//  2. border following (Suzuki-style outer contours) on the binary image
//  3. polygon approximation (Douglas-Peucker) to 4-vertex convex quads
//  4. homography sampling of an (n+2)x(n+2) cell grid, border must be black
//  5. 4-rotation lookup in the dictionary (max 1-bit correction)
//  6. corner refinement by maximal-gradient line intersection

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

struct Pt {
    float x, y;
};

// ---------------------------------------------------------------- threshold
static void adaptive_threshold(const uint8_t* gray, int w, int h, int win,
                               int offset, std::vector<uint8_t>& bin) {
    std::vector<uint32_t> integ((size_t)(w + 1) * (h + 1), 0);
    for (int y = 0; y < h; ++y) {
        uint32_t row = 0;
        for (int x = 0; x < w; ++x) {
            row += gray[y * w + x];
            integ[(size_t)(y + 1) * (w + 1) + (x + 1)] =
                integ[(size_t)y * (w + 1) + (x + 1)] + row;
        }
    }
    bin.assign((size_t)w * h, 0);
    int r = win / 2;
    for (int y = 0; y < h; ++y) {
        int y0 = std::max(0, y - r), y1 = std::min(h - 1, y + r);
        for (int x = 0; x < w; ++x) {
            int x0 = std::max(0, x - r), x1 = std::min(w - 1, x + r);
            uint32_t sum = integ[(size_t)(y1 + 1) * (w + 1) + (x1 + 1)] -
                           integ[(size_t)y0 * (w + 1) + (x1 + 1)] -
                           integ[(size_t)(y1 + 1) * (w + 1) + x0] +
                           integ[(size_t)y0 * (w + 1) + x0];
            int area = (x1 - x0 + 1) * (y1 - y0 + 1);
            int mean = (int)(sum / (uint32_t)area);
            // dark pixels (marker ink) -> 1
            bin[(size_t)y * w + x] = gray[y * w + x] < mean - offset ? 1 : 0;
        }
    }
}

// ---------------------------------------------------------------- contours
// Moore-neighbour border following over the binary image; visited borders
// are marked so each outer contour is traced once.
static const int DX8[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int DY8[8] = {0, 1, 1, 1, 0, -1, -1, -1};

static void trace_contour(const std::vector<uint8_t>& bin, std::vector<uint8_t>& mark,
                          int w, int h, int sx, int sy, std::vector<Pt>& out) {
    int x = sx, y = sy, dir = 7;
    int n = 0;
    const int maxlen = 4 * (w + h);
    do {
        out.push_back({(float)x, (float)y});
        mark[(size_t)y * w + x] = 1;
        int found = -1;
        for (int i = 0; i < 8; ++i) {
            int d = (dir + i) & 7;
            int nx = x + DX8[d], ny = y + DY8[d];
            if (nx >= 0 && ny >= 0 && nx < w && ny < h && bin[(size_t)ny * w + nx]) {
                found = d;
                x = nx;
                y = ny;
                break;
            }
        }
        if (found < 0) break;          // isolated pixel
        dir = (found + 6) & 7;         // turn back-right for Moore following
        if (++n > maxlen) break;       // safety
    } while (!(x == sx && y == sy));
}

// ------------------------------------------------------- polygon approx
static float pt_line_dist(const Pt& p, const Pt& a, const Pt& b) {
    float dx = b.x - a.x, dy = b.y - a.y;
    float len = std::sqrt(dx * dx + dy * dy);
    if (len < 1e-6f) return std::hypot(p.x - a.x, p.y - a.y);
    return std::fabs((p.x - a.x) * dy - (p.y - a.y) * dx) / len;
}

static void dp_simplify(const std::vector<Pt>& pts, int i0, int i1, float eps,
                        std::vector<int>& keep) {
    float dmax = 0;
    int imax = -1;
    for (int i = i0 + 1; i < i1; ++i) {
        float d = pt_line_dist(pts[i], pts[i0], pts[i1]);
        if (d > dmax) { dmax = d; imax = i; }
    }
    if (dmax > eps && imax > 0) {
        dp_simplify(pts, i0, imax, eps, keep);
        keep.push_back(imax);
        dp_simplify(pts, imax, i1, eps, keep);
    }
}

static bool approx_quad_impl(const std::vector<Pt>& contour, Pt quad[4]);

static bool approx_quad(const std::vector<Pt>& contour, Pt quad[4], int cv2_mode) {
    // Douglas-Peucker over a full-resolution contour is O(n * depth) per
    // eps iteration and dominated the whole detector on textured scenes;
    // decimate long contours first — the <=half-stride corner displacement
    // this introduces is along the contour and the subpixel line-fit
    // refinement downstream re-derives corners from edge geometry anyway.
    size_t n = contour.size();
    if (cv2_mode && n > 0) {
        // the split below keeps contour[0] as a vertex: native/ starts at the
        // traced contour's first pixel, which on a quad whose top edge is
        // nearly level lies a few pixels off a corner and leaves five
        // vertices; start at the point farthest from the centroid, a corner
        float cx = 0, cy = 0;
        for (const Pt& p : contour) { cx += p.x; cy += p.y; }
        cx /= (float)n; cy /= (float)n;
        size_t k = 0;
        float best = -1;
        for (size_t i = 0; i < n; ++i) {
            float d = std::hypot(contour[i].x - cx, contour[i].y - cy);
            if (d > best) { best = d; k = i; }
        }
        std::vector<Pt> turned(contour.begin() + k, contour.end());
        turned.insert(turned.end(), contour.begin(), contour.begin() + k);
        return approx_quad(turned, quad, 0);
    }
    if (n <= 128) return approx_quad_impl(contour, quad);
    size_t stride = (n + 95) / 96;
    std::vector<Pt> dec;
    dec.reserve(n / stride + 1);
    for (size_t i = 0; i < n; i += stride) dec.push_back(contour[i]);
    return approx_quad_impl(dec, quad);
}

static bool approx_quad_impl(const std::vector<Pt>& contour, Pt quad[4]) {
    size_t n = contour.size();
    if (n < 16) return false;
    // pick the point farthest from contour[0] as the split, approximate both
    // halves, collect vertices; accept exactly 4 strong corners
    float best = -1;
    size_t far_i = 0;
    for (size_t i = 1; i < n; ++i) {
        float d = std::hypot(contour[i].x - contour[0].x, contour[i].y - contour[0].y);
        if (d > best) { best = d; far_i = i; }
    }
    float eps = 0.05f * (float)n;  // perimeter-proportional tolerance
    for (int iter = 0; iter < 4; ++iter) {
        std::vector<int> keep;
        keep.push_back(0);
        dp_simplify(contour, 0, (int)far_i, eps, keep);
        keep.push_back((int)far_i);
        dp_simplify(contour, (int)far_i, (int)n - 1, eps, keep);
        if (keep.size() == 4) {
            for (int i = 0; i < 4; ++i) quad[i] = contour[(size_t)keep[i]];
            return true;
        }
        eps *= keep.size() > 4 ? 1.5f : 0.6f;  // adapt tolerance
    }
    return false;
}

static float quad_area(const Pt q[4]) {
    float a = 0;
    for (int i = 0; i < 4; ++i) {
        const Pt& p0 = q[i];
        const Pt& p1 = q[(i + 1) & 3];
        a += p0.x * p1.y - p1.x * p0.y;
    }
    return 0.5f * a;  // signed
}

// -------------------------------------------------------- homography sample
// homography mapping unit square (0..1)^2 -> quad (TL,TR,BR,BL order)
static void square_to_quad_h(const Pt q[4], double H[9]) {
    double dx1 = q[1].x - q[2].x, dx2 = q[3].x - q[2].x;
    double dy1 = q[1].y - q[2].y, dy2 = q[3].y - q[2].y;
    double sx = q[0].x - q[1].x + q[2].x - q[3].x;
    double sy = q[0].y - q[1].y + q[2].y - q[3].y;
    double den = dx1 * dy2 - dx2 * dy1;
    double g = (sx * dy2 - sy * dx2) / den;
    double hh = (dx1 * sy - dy1 * sx) / den;
    H[0] = q[1].x - q[0].x + g * q[1].x;
    H[1] = q[3].x - q[0].x + hh * q[3].x;
    H[2] = q[0].x;
    H[3] = q[1].y - q[0].y + g * q[1].y;
    H[4] = q[3].y - q[0].y + hh * q[3].y;
    H[5] = q[0].y;
    H[6] = g;
    H[7] = hh;
    H[8] = 1.0;
}

static inline Pt apply_h(const double H[9], double u, double v) {
    double w = H[6] * u + H[7] * v + H[8];
    return {(float)((H[0] * u + H[1] * v + H[2]) / w),
            (float)((H[3] * u + H[4] * v + H[5]) / w)};
}

// --------------------------------------------------------------- decoding
static int rotate_code(uint64_t code, int nbits_side, uint64_t* out) {
    // rotate the nxn bit matrix 90 degrees clockwise
    int n = nbits_side;
    uint64_t r = 0;
    for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) {
            int src = y * n + x;            // bit index from MSB
            int dst = x * n + (n - 1 - y);  // rotated position
            if (code & (1ULL << (n * n - 1 - src))) r |= 1ULL << (n * n - 1 - dst);
        }
    *out = r;
    return 0;
}

static int popcount64(uint64_t v) {
#if defined(__GNUC__)
    return __builtin_popcountll(v);
#else
    int c = 0;
    while (v) { v &= v - 1; ++c; }
    return c;
#endif
}

static int dict_lookup(uint64_t code, const uint64_t* dict, int dict_size,
                       int nbits_side, int max_correction, int* rotation) {
    uint64_t c = code;
    for (int rot = 0; rot < 4; ++rot) {
        for (int i = 0; i < dict_size; ++i) {
            if (popcount64(c ^ dict[i]) <= max_correction) {
                *rotation = rot;
                return i;
            }
        }
        uint64_t r;
        rotate_code(c, nbits_side, &r);
        c = r;
    }
    return -1;
}

// ------------------------------------------------------ corner refinement
// Refine each corner to the intersection of the two adjacent edge lines.
// Each edge line is fitted by TOTAL least squares (principal axis) to
// subpixel gradient-maximum points sampled along the edge: per sample, the
// directional gradient along the edge normal is evaluated with BILINEAR
// interpolation on a fine offset grid and its peak is localized with a
// parabolic fit. On hard (non-antialiased) edges a single sample is only
// good to ~half a pixel, but the line fit over many samples with varying
// subpixel phase recovers the edge to well under 0.1 px — the same
// principle as the reference aruco's lines/corner refinement
// (3rdparty/aruco markerdetector corner refinement modes).
static inline float bilinear(const uint8_t* gray, int w, int h, float x, float y) {
    if (x < 0) x = 0;
    if (y < 0) y = 0;
    if (x > (float)w - 1.001f) x = (float)w - 1.001f;
    if (y > (float)h - 1.001f) y = (float)h - 1.001f;
    int ix = (int)x, iy = (int)y;
    float fx = x - ix, fy = y - iy;
    const uint8_t* p = gray + (size_t)iy * w + ix;
    return p[0] * (1 - fx) * (1 - fy) + p[1] * fx * (1 - fy) +
           p[w] * (1 - fx) * fy + p[w + 1] * fx * fy;
}

static void refine_corners(const uint8_t* gray, int w, int h, Pt q[4]) {
    struct Line { Pt p, d; bool ok; };
    for (int pass = 0; pass < 2; ++pass) {
        Line lines[4];
        for (int e = 0; e < 4; ++e) {
            Pt a = q[e], b = q[(e + 1) & 3];
            float ex = b.x - a.x, ey = b.y - a.y;
            float elen = std::sqrt(ex * ex + ey * ey);
            lines[e] = {{(a.x + b.x) * 0.5f, (a.y + b.y) * 0.5f},
                        {ex / std::max(elen, 1e-6f), ey / std::max(elen, 1e-6f)},
                        false};
            if (elen < 8) continue;
            float nx = -ey / elen, ny = ex / elen;  // edge normal
            int S = (int)std::min(32.0f, std::max(8.0f, elen * 0.5f));
            const float step = 0.25f, half = 0.7f;
            // TLS accumulators over refined subpixel edge points
            double mx = 0, my = 0, sxx = 0, sxy = 0, syy = 0;
            int cnt = 0;
            Pt samples[32];
            for (int s = 0; s < S; ++s) {
                float t = 0.12f + 0.76f * (float)s / (float)(S - 1);
                float px = a.x + t * ex, py = a.y + t * ey;
                // directional-gradient profile along the normal
                float best_g = -1, best_o = 0;
                float prev_g = -1, g_at[64];
                int K = 0;
                for (float o = -2.0f; o <= 2.001f; o += step, ++K) {
                    float g = std::fabs(
                        bilinear(gray, w, h, px + (o + half) * nx, py + (o + half) * ny) -
                        bilinear(gray, w, h, px + (o - half) * nx, py + (o - half) * ny));
                    g_at[K] = g;
                    if (g > best_g) { best_g = g; best_o = o; }
                }
                (void)prev_g;
                if (best_g < 20) continue;  // no clear edge here
                // parabolic subpixel peak on the gradient profile
                int ki = (int)((best_o + 2.0f) / step + 0.5f);
                if (ki > 0 && ki < K - 1) {
                    float gm = g_at[ki - 1], g0 = g_at[ki], gp = g_at[ki + 1];
                    float den = gm - 2 * g0 + gp;
                    if (std::fabs(den) > 1e-6f) {
                        float d = 0.5f * (gm - gp) / den;
                        if (d > -1 && d < 1) best_o += d * step;
                    }
                }
                float rx = px + best_o * nx, ry = py + best_o * ny;
                samples[cnt % 32] = {rx, ry};
                mx += rx; my += ry;
                ++cnt;
            }
            if (cnt < 5) continue;
            int n_use = std::min(cnt, 32);
            // trimmed TLS: fit, drop samples far off the line (a sample that
            // latched onto a texture edge instead of the marker edge), refit
            double fmx = 0, fmy = 0, fdx = 0, fdy = 0;
            bool fit_ok = false;
            bool keep[32];
            for (int i = 0; i < n_use; ++i) keep[i] = true;
            for (int trim = 0; trim < 2; ++trim) {
                mx = my = sxx = sxy = syy = 0;
                int m = 0;
                for (int i = 0; i < n_use; ++i)
                    if (keep[i]) { mx += samples[i].x; my += samples[i].y; ++m; }
                if (m < 5) break;
                mx /= m; my /= m;
                for (int i = 0; i < n_use; ++i) {
                    if (!keep[i]) continue;
                    double dx = samples[i].x - mx, dy = samples[i].y - my;
                    sxx += dx * dx; sxy += dx * dy; syy += dy * dy;
                }
                // principal axis of the 2x2 covariance = TLS line direction
                double tr = sxx + syy, det = sxx * syy - sxy * sxy;
                double lam = 0.5 * tr + std::sqrt(std::max(0.25 * tr * tr - det, 0.0));
                double dx = sxy, dy = lam - sxx;
                double dn = std::sqrt(dx * dx + dy * dy);
                if (dn < 1e-9) { dx = lam - syy; dy = sxy; dn = std::sqrt(dx * dx + dy * dy); }
                if (dn < 1e-9) break;
                dx /= dn; dy /= dn;
                fmx = mx; fmy = my; fdx = dx; fdy = dy; fit_ok = true;
                if (trim == 1) break;
                // residual = distance to the fitted line; drop > 0.6 px
                int dropped = 0;
                for (int i = 0; i < n_use; ++i) {
                    if (!keep[i]) continue;
                    double rx = samples[i].x - mx, ry = samples[i].y - my;
                    double off = std::fabs(rx * dy - ry * dx);
                    if (off > 0.6) { keep[i] = false; ++dropped; }
                }
                if (dropped == 0) break;
            }
            if (!fit_ok) continue;
            // keep orientation consistent with the coarse edge direction
            if (fdx * (ex / elen) + fdy * (ey / elen) < 0) { fdx = -fdx; fdy = -fdy; }
            lines[e] = {{(float)fmx, (float)fmy}, {(float)fdx, (float)fdy}, true};
        }
        for (int c = 0; c < 4; ++c) {
            // corner c = intersection of edge (c-1) and edge c
            const Line& l1 = lines[(c + 3) & 3];
            const Line& l2 = lines[c];
            if (!l1.ok && !l2.ok) continue;
            float den = l1.d.x * l2.d.y - l1.d.y * l2.d.x;
            if (std::fabs(den) < 1e-6f) continue;
            float t = ((l2.p.x - l1.p.x) * l2.d.y - (l2.p.y - l1.p.y) * l2.d.x) / den;
            Pt r = {l1.p.x + t * l1.d.x, l1.p.y + t * l1.d.y};
            if (std::hypot(r.x - q[c].x, r.y - q[c].y) < 4.0f) q[c] = r;
        }
    }
}

}  // namespace

extern "C" {

// Returns number of markers found (<= max_out).
// out_corners: max_out * 8 floats (TL,TR,BR,BL x,y in the decoded rotation)
// out_ids: max_out ints.
static int detect_one_window(const uint8_t* gray, int w, int h, int win,
                 const uint64_t* dict, int dict_size, int nbits_side,
                 int min_perimeter, int max_correction, int cv2_mode,
                 float* out_corners, int* out_ids, int max_out) {
    int found = 0;
    std::vector<uint8_t> bin;
    std::vector<Pt> contour;
    {
    adaptive_threshold(gray, w, h, win, 7, bin);
    std::vector<uint8_t> mark((size_t)w * h, 0);
    for (int y = 1; y < h - 1 && found < max_out; ++y) {
        for (int x = 1; x < w - 1 && found < max_out; ++x) {
            size_t idx = (size_t)y * w + x;
            // outer-border start: foreground pixel with background to the left
            if (!bin[idx] || mark[idx] || bin[idx - 1]) continue;
            contour.clear();
            trace_contour(bin, mark, w, h, x, y, contour);
            if ((int)contour.size() < min_perimeter) continue;
            Pt quad[4];
            if (!approx_quad(contour, quad, cv2_mode)) continue;
            float area = quad_area(quad);
            if (std::fabs(area) < 100.0f) continue;
            if (area < 0) std::swap(quad[1], quad[3]);  // enforce CW in image

            // cheap border probe with the UNREFINED quad: textured scenes
            // produce hundreds of non-marker quad candidates per frame and
            // the subpixel corner refinement below is ~100us each — sample
            // one point per border cell and reject quads whose border is
            // not mostly ink. Only applied to large quads: small ones are
            // cheap to refine and their per-cell shift from the +-2px DP
            // corners could contaminate too many single-sample cells.
            if ((int)contour.size() >= 140) {
                double Hp[9];
                square_to_quad_h(quad, Hp);
                int n = nbits_side, N = n + 2;
                float vals[64];
                int nv = 0, inside = 0;
                float vmin = 1e9f, vmax = -1e9f;
                for (int i = 0; i < N && nv < 60; ++i) {
                    int cells[4][2] = {{0, i}, {N - 1, i}, {i, 0}, {i, N - 1}};
                    int reps = (i == 0 || i == N - 1) ? 2 : 4;  // skip dup corners
                    for (int k = 0; k < reps; ++k) {
                        double u = (cells[k][1] + 0.5) / N;
                        double v = (cells[k][0] + 0.5) / N;
                        Pt p = apply_h(Hp, u, v);
                        int ix = (int)(p.x + 0.5f), iy = (int)(p.y + 0.5f);
                        if (ix < 0 || iy < 0 || ix >= w || iy >= h) continue;
                        vals[nv++] = gray[(size_t)iy * w + ix];
                    }
                }
                // interior samples extend the contrast range
                for (int k = 0; k < 4 && nv < 64; ++k) {
                    double u = (0.3 + 0.15 * k), v = (0.3 + 0.12 * k);
                    Pt p = apply_h(Hp, u, v);
                    int ix = (int)(p.x + 0.5f), iy = (int)(p.y + 0.5f);
                    if (ix >= 0 && iy >= 0 && ix < w && iy < h) {
                        vals[nv] = gray[(size_t)iy * w + ix];
                        ++nv;
                        ++inside;
                    }
                }
                int nb = nv - inside;
                if (nb >= 12) {
                    for (int k = 0; k < nv; ++k) {
                        vmin = std::min(vmin, vals[k]);
                        vmax = std::max(vmax, vals[k]);
                    }
                    // no contrast: native/ rejects the quad, though a marker
                    // whose probed interior cells are all ink looks so too;
                    // cv2_mode leaves it to the full decode below
                    if (vmax - vmin < 30.0f) {
                        if (!cv2_mode) continue;
                    } else {
                        float split = 0.5f * (vmin + vmax);
                        int dark = 0;
                        for (int k = 0; k < nb; ++k) dark += vals[k] < split;
                        if (dark < nb - 6) continue;  // border not mostly ink
                    }
                }
            }
            // refine corners BEFORE decoding: the DP vertices are integer
            // contour pixels (±2 px), enough to shift the homography cell
            // grid into the quiet zone on rotated markers and break the
            // border test (observed failure mode on the parity scenes)
            refine_corners(gray, w, h, quad);

            // sample (n+2)x(n+2) cells through the homography. Cells are
            // classified on GRAY values with a per-quad Otsu-style split:
            // the adaptive-threshold binary hollows out large ink regions
            // (local mean ~ ink level), so it must not be used here.
            double H[9];
            square_to_quad_h(quad, H);
            int n = nbits_side, N = n + 2;
            float cell_mean[16 * 16];
            bool cell_ok[16 * 16];
            float vmin = 1e9f, vmax = -1e9f;
            for (int cy = 0; cy < N; ++cy)
                for (int cx = 0; cx < N; ++cx) {
                    float sum = 0;
                    int total = 0;
                    for (int sy = 0; sy < 3; ++sy)
                        for (int sx = 0; sx < 3; ++sx) {
                            double u = (cx + 0.25 + 0.25 * sx) / N;
                            double v = (cy + 0.25 + 0.25 * sy) / N;
                            Pt p = apply_h(H, u, v);
                            int ix = (int)(p.x + 0.5f), iy = (int)(p.y + 0.5f);
                            if (ix < 0 || iy < 0 || ix >= w || iy >= h) continue;
                            sum += gray[(size_t)iy * w + ix];
                            ++total;
                        }
                    cell_ok[cy * N + cx] = total > 0;
                    cell_mean[cy * N + cx] = total ? sum / total : 0.0f;
                    if (total) {
                        vmin = std::min(vmin, cell_mean[cy * N + cx]);
                        vmax = std::max(vmax, cell_mean[cy * N + cx]);
                    }
                }
            if (vmax - vmin < 30.0f) continue;  // no contrast: not a marker
            float split = 0.5f * (vmin + vmax);
            auto cell_value = [&](int cy, int cx) -> int {
                if (!cell_ok[cy * N + cx]) return -1;
                return cell_mean[cy * N + cx] < split ? 1 : 0;  // 1 = ink
            };
            // border must be dark; tolerate one contaminated cell (partial
            // occlusion / sampling at the very edge of the quad)
            int border_bad = 0;
            for (int i = 0; i < N; ++i) {
                border_bad += cell_value(0, i) != 1;
                border_bad += cell_value(N - 1, i) != 1;
                if (i > 0 && i < N - 1) {
                    border_bad += cell_value(i, 0) != 1;
                    border_bad += cell_value(i, N - 1) != 1;
                }
            }
            if (border_bad > 1) continue;
            uint64_t code = 0;
            bool valid = true;
            for (int cy = 0; cy < n && valid; ++cy)
                for (int cx = 0; cx < n; ++cx) {
                    int v = cell_value(cy + 1, cx + 1);
                    if (v < 0) { valid = false; break; }
                    // dictionary convention: 1 = white cell
                    code = (code << 1) | (uint64_t)(v ? 0 : 1);
                }
            if (!valid) continue;
            int rot = 0;
            int id = dict_lookup(code, dict, dict_size, n, max_correction, &rot);
            if (id < 0) continue;

            // rotate corner order so corner 0 = dictionary TL (native/'s
            // order turns it by half a turn when rot is odd)
            Pt final_q[4];
            int shift = cv2_mode ? 4 - rot : rot;
            for (int i = 0; i < 4; ++i) final_q[i] = quad[(i + shift) & 3];

            // dedup: the hollowed binary yields an inner ring contour that
            // decodes to the same id — keep the larger quad
            float cxm = 0, cym = 0;
            for (int i = 0; i < 4; ++i) { cxm += final_q[i].x; cym += final_q[i].y; }
            cxm *= 0.25f; cym *= 0.25f;
            float my_area = std::fabs(quad_area(final_q));
            int dup = -1;
            for (int f = 0; f < found; ++f) {
                if (out_ids[f] != id) continue;
                float ox = 0, oy = 0;
                for (int i = 0; i < 4; ++i) {
                    ox += out_corners[f * 8 + i * 2];
                    oy += out_corners[f * 8 + i * 2 + 1];
                }
                ox *= 0.25f; oy *= 0.25f;
                if (std::hypot(ox - cxm, oy - cym) <
                    std::sqrt(my_area)) { dup = f; break; }
            }
            int slot = found;
            if (dup >= 0) {
                Pt oq[4];
                for (int i = 0; i < 4; ++i)
                    oq[i] = {out_corners[dup * 8 + i * 2],
                             out_corners[dup * 8 + i * 2 + 1]};
                if (std::fabs(quad_area(oq)) >= my_area) continue;  // keep old
                slot = dup;
            }
            for (int i = 0; i < 4; ++i) {
                out_corners[slot * 8 + i * 2] = final_q[i].x;
                out_corners[slot * 8 + i * 2 + 1] = final_q[i].y;
            }
            out_ids[slot] = id;
            if (dup < 0) ++found;
        }
    }
    }
    return found;
}

int aruco_detect(const uint8_t* gray, int w, int h,
                 const uint64_t* dict, int dict_size, int nbits_side,
                 int min_perimeter, int max_correction, int cv2_mode,
                 float* out_corners, int* out_ids, int max_out) {
    if (dict == nullptr || dict_size <= 0 || nbits_side < 3 || nbits_side > 8) return -1;
    // multi-scale adaptive threshold sweep (the reference aruco's
    // DM_NORMAL thresholds at several window sizes; a single window misses
    // markers whose local context is skewed by adjacent texture), run
    // CONCURRENTLY — the reference parallelizes detection the same way
    // and the windows are fully independent until the merge.
    // max_correction < 0 encodes fast mode: one window only.
    const int windows_all[3] = {15, 9, 27};
    int n_windows = max_correction < 0 ? 1 : 3;
    if (max_correction < 0) max_correction = 0;
    struct WOut {
        std::vector<float> corners;
        std::vector<int> ids;
        int found = 0;
    };
    WOut wo[3];
    auto run_window = [&](int wi) {
        wo[wi].corners.resize((size_t)max_out * 8);
        wo[wi].ids.resize((size_t)max_out);
        wo[wi].found = detect_one_window(
            gray, w, h, windows_all[wi], dict, dict_size, nbits_side,
            min_perimeter, max_correction, cv2_mode,
            wo[wi].corners.data(), wo[wi].ids.data(), max_out);
    };
    if (n_windows == 1) {
        run_window(0);
    } else {
        std::thread t1(run_window, 1), t2(run_window, 2);
        run_window(0);
        t1.join();
        t2.join();
    }
    // merge across windows: same-id locality dedup, keep the larger quad
    int found = 0;
    for (int wi = 0; wi < n_windows; ++wi) {
        for (int c = 0; c < wo[wi].found && found < max_out; ++c) {
            Pt q[4];
            for (int i = 0; i < 4; ++i)
                q[i] = {wo[wi].corners[c * 8 + i * 2],
                        wo[wi].corners[c * 8 + i * 2 + 1]};
            int id = wo[wi].ids[c];
            float cxm = 0, cym = 0;
            for (int i = 0; i < 4; ++i) { cxm += q[i].x; cym += q[i].y; }
            cxm *= 0.25f; cym *= 0.25f;
            float my_area = std::fabs(quad_area(q));
            int dup = -1;
            for (int f = 0; f < found; ++f) {
                if (out_ids[f] != id) continue;
                float ox = 0, oy = 0;
                for (int i = 0; i < 4; ++i) {
                    ox += out_corners[f * 8 + i * 2];
                    oy += out_corners[f * 8 + i * 2 + 1];
                }
                ox *= 0.25f; oy *= 0.25f;
                if (std::hypot(ox - cxm, oy - cym) < std::sqrt(my_area)) {
                    dup = f;
                    break;
                }
            }
            int slot = found;
            if (dup >= 0) {
                Pt oq[4];
                for (int i = 0; i < 4; ++i)
                    oq[i] = {out_corners[dup * 8 + i * 2],
                             out_corners[dup * 8 + i * 2 + 1]};
                if (std::fabs(quad_area(oq)) >= my_area) continue;
                slot = dup;
            }
            for (int i = 0; i < 4; ++i) {
                out_corners[slot * 8 + i * 2] = q[i].x;
                out_corners[slot * 8 + i * 2 + 1] = q[i].y;
            }
            out_ids[slot] = id;
            if (dup < 0) ++found;
        }
    }
    return found;
}

}  // extern "C"
