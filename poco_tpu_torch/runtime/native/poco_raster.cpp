// Native z-buffer triangle rasterizer for the demo's mesh overlay: the
// port's own copy of poco_tpu/runtime/native/poco_raster.cpp, built by
// poco_tpu_torch/runtime/raster.py.
//
// One pass of edge functions over each face's pixel box, per-face flat
// colour, face depth = mean vertex z (bigger z = closer = wins), colours
// written into the caller's overlay buffer, which the caller blends.
// Unlike the JAX package's copy, the rows are split into bands, one
// thread a band: each thread walks every face in order over its own rows
// only, so every pixel sees the faces in the same order as one thread
// would, and the result is the single-threaded one exactly.
//
// `poco_label_triangles` paints integer triangles in the caller's order
// (the painter's algorithm of the GT part labels), each as cv2.fillPoly
// fills it. `poco_wireframe` and `poco_circles_aa` draw the demo's
// wireframe and keypoints as cv2 draws them, `poco_circles_filled` the
// synthetic data sets' blobs (cv2.circle, filled, LINE_8), and
// `poco_put_glyphs` its caption's glyphs (below).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

static void raster_band(
    float* overlay,          // (h, w, 3) float32 RGB, pre-filled with bg
    int h, int w,
    const float* uv,         // (n_verts, 2) pixel coords
    const float* face_z,     // (n_faces,) mean depth per face
    const int64_t* faces,    // (n_faces, 3)
    const float* face_rgb,   // (n_faces, 3) shaded colors, 0..255
    const uint8_t* onscreen, // (n_faces,) cull mask
    int n_faces, int row0, int row1)   // rows [row0, row1) of this band
{
    std::vector<float> zbuf((size_t)(row1 - row0) * (size_t)w, -1e30f);

    for (int f = 0; f < n_faces; ++f) {
        if (!onscreen[f]) continue;
        const int64_t* tri = faces + 3 * (size_t)f;
        const float x0 = uv[2 * tri[0]], y0 = uv[2 * tri[0] + 1];
        const float x1 = uv[2 * tri[1]], y1 = uv[2 * tri[1] + 1];
        const float x2 = uv[2 * tri[2]], y2 = uv[2 * tri[2] + 1];

        // clamp in FLOAT before the int cast: a blown-up camera can put
        // a vertex past int range, and float->int overflow is UB
        const float fminx =
            std::min(std::max(std::min({x0, x1, x2}), 0.f), (float)(w - 1));
        const float fmaxx =
            std::min(std::max(std::max({x0, x1, x2}), 0.f), (float)(w - 1));
        const float fminy =
            std::min(std::max(std::min({y0, y1, y2}), 0.f), (float)(h - 1));
        const float fmaxy =
            std::min(std::max(std::max({y0, y1, y2}), 0.f), (float)(h - 1));
        const int minx = (int)std::floor(fminx);
        const int maxx = (int)std::ceil(fmaxx);
        const int miny = std::max((int)std::floor(fminy), row0);
        const int maxy = std::min((int)std::ceil(fmaxy), row1 - 1);
        if (minx > maxx || miny > maxy) continue;

        float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
        if (std::fabs(area) < 1e-9f) continue;
        const float sgn = area > 0.f ? 1.f : -1.f;

        const float z = face_z[f];
        const float r = face_rgb[3 * f + 0];
        const float g = face_rgb[3 * f + 1];
        const float b = face_rgb[3 * f + 2];

        for (int py = miny; py <= maxy; ++py) {
            const float cy = (float)py + 0.5f;
            float* row = overlay + ((size_t)py * w) * 3;
            float* zrow = zbuf.data() + (size_t)(py - row0) * w;
            for (int px = minx; px <= maxx; ++px) {
                const float cx = (float)px + 0.5f;
                const float e0 =
                    ((x2 - x1) * (cy - y1) - (y2 - y1) * (cx - x1)) * sgn;
                const float e1 =
                    ((x0 - x2) * (cy - y2) - (y0 - y2) * (cx - x2)) * sgn;
                const float e2 =
                    ((x1 - x0) * (cy - y0) - (y1 - y0) * (cx - x0)) * sgn;
                if (e0 < 0.f || e1 < 0.f || e2 < 0.f) continue;
                if (z <= zrow[px]) continue;
                zrow[px] = z;
                float* p = row + 3 * (size_t)px;
                p[0] = r;
                p[1] = g;
                p[2] = b;
            }
        }
    }
}

extern "C" void poco_raster_mesh(
    float* overlay,          // (h, w, 3) float32 RGB, pre-filled with bg
    int h, int w,
    const float* uv,         // (n_verts, 2) pixel coords
    const float* face_z,     // (n_faces,) mean depth per face
    const int64_t* faces,    // (n_faces, 3)
    const float* face_rgb,   // (n_faces, 3) shaded colors, 0..255
    const uint8_t* onscreen, // (n_faces,) cull mask
    int n_verts, int n_faces)
{
    (void)n_verts;
    const int cores = (int)std::max(1u, std::thread::hardware_concurrency());
    const int bands = std::max(1, std::min({cores, 16, h / 32}));
    std::vector<std::thread> pool;
    for (int b = 1; b < bands; ++b)
        pool.emplace_back(raster_band, overlay, h, w, uv, face_z, faces, face_rgb,
                          onscreen, n_faces, h * b / bands, h * (b + 1) / bands);
    raster_band(overlay, h, w, uv, face_z, faces, face_rgb, onscreen, n_faces, 0, h / bands);
    for (auto& t : pool) t.join();
}

// OpenCV's clipLine, in place, on a (w, h) box of any unit (pixels, or
// pixels << 16); false when the line misses it.
static bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2)
{
    const int64_t right = w - 1, bottom = h - 1;
    auto code = [&](int64_t x, int64_t y) {
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8;
    };
    int c1 = code(x1, y1), c2 = code(x2, y2);
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

static bool inside(int w, int h, int64_t x, int64_t y)
{
    return x >= 0 && x < w && y >= 0 && y < h;
}

// cv2.line at LINE_8, thickness 1: OpenCV's LineIterator, clipped to the
// image, left to right; the minor axis moves when the error term is < 0.
// `put(x, y)` paints a pixel.
template <typename Put>
static void walk_line8(int h, int w, int64_t x0, int64_t y0, int64_t x1, int64_t y1, Put put)
{
    if (!(inside(w, h, x0, y0) && inside(w, h, x1, y1)) && !clip_line(w, h, x0, y0, x1, y1))
        return;
    if (x1 < x0) {
        std::swap(x0, x1);
        std::swap(y0, y1);
    }
    int64_t dx = x1 - x0, dy = y1 - y0;
    const int64_t step_y = dy < 0 ? -1 : 1;
    dy = std::abs(dy);
    const bool steep = dy > dx;
    if (steep) std::swap(dx, dy);
    int64_t err = dx - 2 * dy, x = x0, y = y0;
    for (int64_t i = 0; i <= dx; ++i) {
        put(x, y);
        const bool minor = err < 0;
        err += -2 * dy + (minor ? 2 * dx : 0);
        if (steep) {
            y += step_y;
            x += minor;
        } else {
            x += 1;
            y += minor ? step_y : 0;
        }
    }
}

static void label_line(uint8_t* img, int h, int w, int64_t x0, int64_t y0, int64_t x1,
                       int64_t y1, uint8_t value)
{
    walk_line8(h, w, x0, y0, x1, y1, [&](int64_t x, int64_t y) { img[(size_t)y * w + x] = value; });
}

// cv2.fillPoly of one triangle of integer points (shift 0, LINE_8), as
// OpenCV's drawing.cpp draws it: the clipped outline, then for each
// scanline the span between the two edges active on it, the edges in
// 16.16 fixed point (an edge that leaves the image rebased on its
// clipped ends), from the left one rounded up to the right one rounded
// down. An edge is active on rows [y0, y1); horizontal edges have none.
static void label_triangle(uint8_t* img, int h, int w, const int32_t* p, uint8_t value)
{
    const int shift = 16;
    struct Edge { int64_t y0, y1, x, dx; };
    Edge edges[3];
    int n = 0;
    for (int k = 0; k < 3; ++k) {
        const int64_t ax = p[2 * ((k + 2) % 3)], ay = p[2 * ((k + 2) % 3) + 1];
        const int64_t bx = p[2 * k], by = p[2 * k + 1];
        label_line(img, h, w, ax, ay, bx, by, value);
        int64_t ax_c = ax << shift, ay_c = ay, bx_c = bx << shift, by_c = by;
        if (!(inside(w, h, ax, ay) && inside(w, h, bx, by))) {
            int64_t tx0 = ax, ty0 = ay, tx1 = bx, ty1 = by;
            clip_line(w, h, tx0, ty0, tx1, ty1);
            ax_c = tx0 << shift;
            bx_c = tx1 << shift;
            if (ty0 != ty1) {
                ay_c = ty0;
                by_c = ty1;
            }
        }
        if (ay == by) continue;
        const int64_t dx = (bx_c - ax_c) / (by_c - ay_c);   // C's division, toward zero
        edges[n++] = ay < by ? Edge{ay, by, ax_c + (ay - ay_c) * dx, dx}
                             : Edge{by, ay, bx_c + (by - by_c) * dx, dx};
    }
    if (n < 2) return;
    int64_t y_min = edges[0].y0, y_max = edges[0].y1;
    for (int e = 1; e < n; ++e) {
        y_min = std::min(y_min, edges[e].y0);
        y_max = std::max(y_max, edges[e].y1);
    }
    for (int64_t y = std::max<int64_t>(y_min, 0); y < std::min<int64_t>(y_max, h); ++y) {
        int64_t xs[2];
        int m = 0;
        for (int e = 0; e < n && m < 2; ++e)
            if (edges[e].y0 <= y && y < edges[e].y1)
                xs[m++] = edges[e].x + (y - edges[e].y0) * edges[e].dx;
        if (m < 2) continue;
        const int64_t x1 = (std::min(xs[0], xs[1]) + (1 << shift) - 1) >> shift;
        const int64_t x2 = std::max(xs[0], xs[1]) >> shift;
        if (x1 >= w || x2 < 0) continue;
        for (int64_t x = std::max<int64_t>(x1, 0); x <= std::min<int64_t>(x2, w - 1); ++x)
            img[(size_t)y * w + x] = value;
    }
}

extern "C" void poco_label_triangles(
    uint8_t* img,            // (h, w) labels, painted in place
    int h, int w,
    const int32_t* pts,      // (n_faces, 3, 2) integer pixel corners
    const uint8_t* values,   // (n_faces,) label of each face
    int n_faces)
{
    for (int f = 0; f < n_faces; ++f)
        label_triangle(img, h, w, pts + 6 * (size_t)f, values[f]);
}

// ---------------------------------------------------------------------
// cv2's drawing calls of the demo, as OpenCV's drawing.cpp draws them
// (its integer arithmetic, 16.16 fixed point where it shifts), so that the
// port's pixels are cv2's without OpenCV:
//   * poco_wireframe: cv2.polylines(overlay, [tri], True, colour, 1,
//     LINE_AA) of each face in the caller's order on the float32 overlay
//     (cv2 draws LINE_AA only on 8-bit images; on float32 it draws the
//     8-connected line, LineIterator's pixels in the colour);
//   * poco_circles_aa: cv2.circle(img, c, r, colour, -1, LINE_AA) on an
//     8-bit RGB image: the circle's polygon (ellipse2Poly), its edges
//     anti-aliased (LineAA) and its inside filled (FillConvexPoly).

static const int XY_SHIFT = 16;
static const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;

extern "C" void poco_wireframe(
    float* img,              // (h, w, 3) float32 RGB, drawn in place
    int h, int w,
    const int32_t* pts,      // (n_faces, 3, 2) integer pixel corners
    const float* rgb,        // (n_faces, 3) colour of each face
    int n_faces)
{
    for (int f = 0; f < n_faces; ++f) {
        const int32_t* p = pts + 6 * (size_t)f;
        // a closed polyline: the last corner to the first, then in order
        for (int k = 0; k < 3; ++k) {
            const int a = (k + 2) % 3;
            const float* c = rgb + 3 * (size_t)f;
            walk_line8(h, w, p[2 * a], p[2 * a + 1], p[2 * k], p[2 * k + 1],
                       [&](int64_t x, int64_t y) {
                           float* q = img + ((size_t)y * w + x) * 3;
                           q[0] = c[0];
                           q[1] = c[1];
                           q[2] = c[2];
                       });
        }
    }
}

struct Rgb8 {
    uint8_t* img;
    int h, w;
    int c[3];
    void put(int64_t x, int64_t y) const
    {
        uint8_t* p = img + ((size_t)y * w + x) * 3;
        p[0] = (uint8_t)c[0];
        p[1] = (uint8_t)c[1];
        p[2] = (uint8_t)c[2];
    }
    void hline(int64_t y, int64_t x1, int64_t x2) const
    {
        for (int64_t x = x1; x <= x2; ++x) put(x, y);
    }
};

static const int SLOPE_CORR[] = {
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

static const int FILTER[] = {
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97,  89,  82,  75,  68,  62,  56,  50,  45,
    40,  36,  32,  28,  25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

// OpenCV's LineAA: a Wu-style line in 16.16 fixed point, each pixel of the
// three across the line blended toward the colour twice by the filter's
// weight, the ends weighted by their sub-pixel coverage.
static void line_aa(const Rgb8& im, int64_t x1, int64_t y1, int64_t x2, int64_t y2)
{
    if (!clip_line((int64_t)im.w << XY_SHIFT, (int64_t)im.h << XY_SHIFT, x1, y1, x2, y2))
        return;
    int64_t dx = x2 - x1, dy = y2 - y1;
    int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount, scount = 0, slope;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) {
            std::swap(x1, x2);
            std::swap(y1, y2);
        }
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        x2 += XY_ONE;
        ecount = (int)((x2 >> XY_SHIFT) - (x1 >> XY_SHIFT));
        j = -(x1 & (XY_ONE - 1));
        y1 += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((y_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (y_step < 0 ? 0x3f : 0);
        i = (x1 >> (XY_SHIFT - 7)) & 0x78;
        j = ((x2 - XY_ONE) >> (XY_SHIFT - 7)) & 0x78;
    } else {
        dx = (dx ^ i) - i;
        if (i) {
            std::swap(x1, x2);
            std::swap(y1, y2);
        }
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        y2 += XY_ONE;
        ecount = (int)((y2 >> XY_SHIFT) - (y1 >> XY_SHIFT));
        j = -(y1 & (XY_ONE - 1));
        x1 += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((x_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (x_step < 0 ? 0x3f : 0);
        i = (y1 >> (XY_SHIFT - 7)) & 0x78;
        j = ((y2 - XY_ONE) >> (XY_SHIFT - 7)) & 0x78;
    }
    slope = (slope & 0x20) ? 0x100 : SLOPE_CORR[slope];
    int ep[9];
    {
        const int t0 = slope << 7;
        const int t1 = (int)(((0x78 - i) | 4) * slope);
        const int t2 = (int)((j | 4) * slope);
        ep[0] = 0;
        ep[8] = slope;
        ep[1] = ep[3] = (int)(((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff);
        ep[2] = (t1 >> 8) & 0x1ff;
        ep[4] = (int)(((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff);
        ep[5] = ((t1 + t0) >> 8) & 0x1ff;
        ep[6] = (t2 >> 8) & 0x1ff;
        ep[7] = ((t2 + t0) >> 8) & 0x1ff;
    }
    auto blend = [&](int64_t x, int64_t y, int a) {
        uint8_t* p = im.img + ((size_t)y * im.w + x) * 3;
        for (int c = 0; c < 3; ++c) {
            int v = p[c];
            v += ((im.c[c] - v) * a + 127) >> 8;
            v += ((im.c[c] - v) * a + 127) >> 8;
            p[c] = (uint8_t)v;
        }
    };
    const bool x_major = ax > ay;
    int64_t along = x_major ? (x1 >> XY_SHIFT) : (y1 >> XY_SHIFT);
    int64_t across = x_major ? y1 : x1;
    const int64_t step = x_major ? y_step : x_step;
    const int64_t n_along = x_major ? im.w : im.h, n_across = x_major ? im.h : im.w;
    for (; ecount >= 0; along++, across += step, scount++, ecount--) {
        if ((uint64_t)along >= (uint64_t)n_along) continue;
        const int64_t k = (across >> XY_SHIFT) - 1;
        const int ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                               (((ecount >= 2) + 1) & (ecount | 2))];
        const int dist = (int)((across >> (XY_SHIFT - 5)) & 31);
        const int a[3] = {(ep_corr * FILTER[dist + 32] >> 8) & 0xff,
                          (ep_corr * FILTER[dist] >> 8) & 0xff,
                          (ep_corr * FILTER[63 - dist] >> 8) & 0xff};
        for (int o = 0; o < 3; ++o) {
            if ((uint64_t)(k + o) >= (uint64_t)n_across) continue;
            if (x_major)
                blend(along, k + o, a[o]);
            else
                blend(k + o, along, a[o]);
        }
    }
}

// OpenCV's FillConvexPoly at LINE_AA on points in 16.16 (shift XY_SHIFT):
// the anti-aliased outline, then each scanline's span between the two
// edges (the left one rounded up, the right one down).
static void fill_convex_poly_aa(const Rgb8& im, const int64_t* v, int npts)
{
    const int shift = XY_SHIFT;
    const int64_t delta = XY_ONE >> 1, delta1 = XY_ONE - 1, delta2 = 0;
    int64_t x0 = v[2 * (npts - 1)], y0 = v[2 * (npts - 1) + 1];
    int64_t xmin = v[0], xmax = v[0], ymin = v[1], ymax = v[1];
    int imin = 0;
    for (int k = 0; k < npts; ++k) {
        const int64_t x = v[2 * k], y = v[2 * k + 1];
        if (y < ymin) {
            ymin = y;
            imin = k;
        }
        ymax = std::max(ymax, y);
        xmax = std::max(xmax, x);
        xmin = std::min(xmin, x);
        line_aa(im, x0, y0, x, y);
        x0 = x;
        y0 = y;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.w || (int)ymin >= im.h)
        return;
    ymax = std::min<int64_t>(ymax, im.h - 1);
    struct { int idx, di; int64_t x, dx; int ye; } edge[2];
    edge[0].idx = edge[1].idx = imin;
    int y = (int)ymin;
    edge[0].ye = edge[1].ye = y;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    int edges = npts;
    do {
        if (y < (int)ymax || y == (int)ymin) {
            for (int e = 0; e < 2; ++e) {
                if (y < edge[e].ye) continue;
                int idx0 = edge[e].idx, di = edge[e].di;
                int idx = idx0 + di;
                if (idx >= npts) idx -= npts;
                for (; edges-- > 0;) {
                    const int ty = (int)((v[2 * idx + 1] + delta) >> shift);
                    if (ty > y) {
                        const int64_t xs = v[2 * idx0], xe = v[2 * idx];
                        edge[e].ye = ty;
                        edge[e].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) / (2 * ((int64_t)ty - y));
                        edge[e].x = xs;
                        edge[e].idx = idx;
                        break;
                    }
                    idx0 = idx;
                    idx += di;
                    if (idx >= npts) idx -= npts;
                }
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            const int left = edge[0].x > edge[1].x ? 1 : 0, right = 1 - left;
            int64_t xx1 = (edge[left].x + delta1) >> XY_SHIFT;
            int64_t xx2 = (edge[right].x + delta2) >> XY_SHIFT;
            if (xx2 >= 0 && xx1 < im.w) {
                xx1 = std::max<int64_t>(xx1, 0);
                xx2 = std::min<int64_t>(xx2, im.w - 1);
                im.hline(y, xx1, xx2);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= (int)ymax);
}

// sin of whole degrees as OpenCV's SinTable holds it (7 decimals, float).
static float sin_deg(int deg)
{
    return (float)(std::round(std::sin(deg * M_PI / 180.0) * 1e7) / 1e7);
}

// OpenCV's EllipseEx of a filled full circle: ellipse2Poly's polygon
// (angle 0, 0..360 degrees), rounded to 16.16, then FillConvexPoly.
static void fill_circle_poly_aa(const Rgb8& im, int64_t cx, int64_t cy, int64_t r)
{
    int delta = (int)((r + (XY_ONE >> 1)) >> XY_SHIFT);
    delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
    std::vector<int64_t> v;
    int64_t px = INT64_MIN, py = INT64_MIN;
    for (int a = 0; a < 360 + delta; a += delta) {
        const int ang = std::min(a, 360);
        const double x = (double)r * sin_deg(450 - ang);
        const double y = (double)r * sin_deg(ang);
        // alpha = cos 0 = 1, beta = sin 0 = 0: the polygon is axis-aligned
        const double fx = (double)cx + x, fy = (double)cy + y;
        int64_t ix = (int64_t)std::nearbyint(fx / XY_ONE) << XY_SHIFT;
        int64_t iy = (int64_t)std::nearbyint(fy / XY_ONE) << XY_SHIFT;
        ix += (int64_t)std::nearbyint(fx - ix);
        iy += (int64_t)std::nearbyint(fy - iy);
        if (ix != px || iy != py) {
            v.push_back(ix);
            v.push_back(iy);
            px = ix;
            py = iy;
        }
    }
    if (v.size() == 2) {
        v = {cx, cy, cx, cy};
    }
    fill_convex_poly_aa(im, v.data(), (int)v.size() / 2);
}

extern "C" void poco_circles_aa(
    uint8_t* img,            // (h, w, 3) uint8 RGB, drawn in place
    int h, int w,
    const int32_t* centers,  // (n, 2) integer pixel centres
    int n, int radius,
    const int32_t* rgb)      // (3,) colour
{
    const Rgb8 im{img, h, w, {rgb[0], rgb[1], rgb[2]}};
    for (int k = 0; k < n; ++k)
        fill_circle_poly_aa(im, (int64_t)centers[2 * k] << XY_SHIFT,
                            (int64_t)centers[2 * k + 1] << XY_SHIFT,
                            (int64_t)radius << XY_SHIFT);
}

// OpenCV's Circle(..., fill=1): cv2.circle(img, c, r, colour, -1), LINE_8
// and shift 0, the midpoint walk that paints four horizontal spans a step,
// each clipped to the image's columns; a span whose row lies outside the
// image is skipped.
static void fill_circle8(const Rgb8& im, int cx, int cy, int radius)
{
    auto span = [&](int y, int x0, int x1) {
        if ((unsigned)y >= (unsigned)im.h)
            return;
        x0 = std::max(x0, 0);
        x1 = std::min(x1, im.w - 1);
        for (int x = x0; x <= x1; ++x)
            im.put(x, y);
    };
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    while (dx >= dy) {
        const int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        const int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        // OpenCV draws nothing of a step whose wide span misses the image
        if (x11 < im.w && x12 >= 0 && y21 < im.h && y22 >= 0) {
            span(y11, x11, x12);
            span(y12, x11, x12);
            if (x21 < im.w && x22 >= 0) {
                span(y21, x21, x22);
                span(y22, x21, x22);
            }
        }
        dy++;
        err += plus;
        plus += 2;
        const int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

extern "C" void poco_circles_filled(
    uint8_t* img,            // (h, w, 3) uint8, drawn in place
    int h, int w,
    const int32_t* centers,  // (n, 2) integer pixel centres
    int n, int radius,
    const int32_t* rgb)      // (3,) colour, written to the channels in order
{
    const Rgb8 im{img, h, w, {rgb[0], rgb[1], rgb[2]}};
    for (int k = 0; k < n; ++k)
        fill_circle8(im, centers[2 * k], centers[2 * k + 1], radius);
}

// The caption's glyphs as OpenCV 5's putText draws its TrueType font: the
// rasteriser of stb_truetype (version 2), in float as there. Each glyph's
// TrueType points (integer font units, y up) become a polyline, its
// quadratic curves cut in halves until they are flat to 0.35 px; each
// edge adds its exact signed area to the cells it crosses, row by row,
// and a running sum along the row gives the coverage, quantised to
// 0..255. Every glyph is rasterised into its own bitmap over its integer
// box, then blended at its pen position by that coverage a:
// (dst * (255 - a) + colour * a + 127) / 255.

namespace glyph {

struct Pt { float x, y; };
struct Edge { float x0, y0, x1, y1; int invert; };
struct Active { float fx, fdx, fdy, direction, sy, ey; };

void tesselate(std::vector<Pt>& out, float x0, float y0, float x1, float y1, float x2, float y2,
               float flat2, int n)
{
    const float mx = (x0 + 2 * x1 + x2) / 4, my = (y0 + 2 * y1 + y2) / 4;
    const float dx = (x0 + x2) / 2 - mx, dy = (y0 + y2) / 2 - my;
    if (n > 16) return;
    if (dx * dx + dy * dy > flat2) {
        tesselate(out, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flat2, n + 1);
        tesselate(out, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flat2, n + 1);
    } else {
        out.push_back({x2, y2});
    }
}

// One contour's TrueType points as a closed polyline in font units.
void flatten_contour(const int32_t* p, int n, float flat2, std::vector<Pt>& out)
{
    int i = 0, sx, sy, scx = 0, scy = 0, cx = 0, cy = 0;
    const bool start_off = !p[2];
    if (start_off) {
        scx = p[0];
        scy = p[1];
        if (!p[5]) {
            sx = (p[0] + p[3]) >> 1;
            sy = (p[1] + p[4]) >> 1;
        } else {
            sx = p[3];
            sy = p[4];
            ++i;
        }
    } else {
        sx = p[0];
        sy = p[1];
    }
    out.push_back({(float)sx, (float)sy});
    float px = (float)sx, py = (float)sy;
    bool was_off = false;
    auto line = [&](int x, int y) { out.push_back({(float)x, (float)y}); px = (float)x; py = (float)y; };
    auto curve = [&](int x, int y, int ccx, int ccy) {
        tesselate(out, px, py, (float)ccx, (float)ccy, (float)x, (float)y, flat2, 0);
        px = (float)x;
        py = (float)y;
    };
    for (++i; i < n; ++i) {
        const int x = p[3 * i], y = p[3 * i + 1];
        if (!p[3 * i + 2]) {
            if (was_off) curve((cx + x) >> 1, (cy + y) >> 1, cx, cy);
            cx = x;
            cy = y;
            was_off = true;
        } else {
            if (was_off) curve(x, y, cx, cy);
            else line(x, y);
            was_off = false;
        }
    }
    if (start_off) {
        if (was_off) curve((cx + scx) >> 1, (cy + scy) >> 1, cx, cy);
        curve(sx, sy, scx, scy);
    } else {
        if (was_off) curve(sx, sy, cx, cy);
        else line(sx, sy);
    }
}

bool edge_less(const Edge& a, const Edge& b) { return a.y0 < b.y0; }

void sort_edges_quick(Edge* p, int n)
{
    while (n > 12) {
        const int m = n >> 1;
        const bool c01 = edge_less(p[0], p[m]), c12 = edge_less(p[m], p[n - 1]);
        if (c01 != c12) {
            const bool c = edge_less(p[0], p[n - 1]);
            std::swap(p[(c == c12) ? 0 : n - 1], p[m]);
        }
        std::swap(p[0], p[m]);
        int i = 1, j = n - 1;
        for (;;) {
            for (;; ++i) if (!edge_less(p[i], p[0])) break;
            for (;; --j) if (!edge_less(p[0], p[j])) break;
            if (i >= j) break;
            std::swap(p[i], p[j]);
            ++i;
            --j;
        }
        if (j < n - i) {
            sort_edges_quick(p, j);
            p += i;
            n -= i;
        } else {
            sort_edges_quick(p + i, n - i);
            n = j;
        }
    }
}

void sort_edges(Edge* p, int n)
{
    sort_edges_quick(p, n);
    for (int i = 1; i < n; ++i) {
        const Edge t = p[i];
        int j = i;
        while (j > 0 && edge_less(t, p[j - 1])) {
            p[j] = p[j - 1];
            --j;
        }
        p[j] = t;
    }
}

void clipped_edge(float* scanline, int x, const Active& e, float x0, float y0, float x1, float y1)
{
    if (y0 == y1) return;
    if (y0 > e.ey) return;
    if (y1 < e.sy) return;
    if (y0 < e.sy) {
        x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0);
        y0 = e.sy;
    }
    if (y1 > e.ey) {
        x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0);
        y1 = e.ey;
    }
    if (x0 <= x && x1 <= x)
        scanline[x] += e.direction * (y1 - y0);
    else if (x0 >= x + 1 && x1 >= x + 1)
        ;
    else
        scanline[x] += e.direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

float trapezoid(float height, float tx0, float tx1, float bx0, float bx1)
{
    return ((tx1 - tx0) + (bx1 - bx0)) / 2.0f * height;
}

void fill_active(float* scanline, float* fill, int len, const std::vector<Active>& active, float y_top)
{
    const float y_bottom = y_top + 1;
    for (const Active& e : active) {
        if (e.fdx == 0) {
            const float x0 = e.fx;
            if (x0 < len) {
                if (x0 >= 0) {
                    clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
                    clipped_edge(fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
                } else {
                    clipped_edge(fill - 1, 0, e, x0, y_top, x0, y_bottom);
                }
            }
            continue;
        }
        float x0 = e.fx, dx = e.fdx, xb = x0 + dx, dy = e.fdy;
        float x_top, x_bottom, sy0, sy1;
        if (e.sy > y_top) {
            x_top = x0 + dx * (e.sy - y_top);
            sy0 = e.sy;
        } else {
            x_top = x0;
            sy0 = y_top;
        }
        if (e.ey < y_bottom) {
            x_bottom = x0 + dx * (e.ey - y_top);
            sy1 = e.ey;
        } else {
            x_bottom = xb;
            sy1 = y_bottom;
        }
        if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
            if ((int)x_top == (int)x_bottom) {
                const int x = (int)x_top;
                const float height = (sy1 - sy0) * e.direction;
                scanline[x] += trapezoid(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
                fill[x] += height;
            } else {
                if (x_top > x_bottom) {
                    sy0 = y_bottom - (sy0 - y_top);
                    sy1 = y_bottom - (sy1 - y_top);
                    std::swap(sy0, sy1);
                    std::swap(x_bottom, x_top);
                    dx = -dx;
                    dy = -dy;
                    std::swap(x0, xb);
                }
                const int x1 = (int)x_top, x2 = (int)x_bottom;
                float y_crossing = y_top + dy * (x1 + 1 - x0);
                float y_final = y_top + dy * (x2 - x0);
                if (y_crossing > y_bottom) y_crossing = y_bottom;
                const float sign = e.direction;
                float area = sign * (y_crossing - sy0);
                scanline[x1] += area * (x1 + 1 - x_top) / 2;
                if (y_final > y_bottom) {
                    const int denom = x2 - (x1 + 1);
                    y_final = y_bottom;
                    if (denom != 0) dy = (y_final - y_crossing) / denom;
                }
                const float step = sign * dy * 1;
                for (int x = x1 + 1; x < x2; ++x) {
                    scanline[x] += area + step / 2;
                    area += step;
                }
                scanline[x2] += area + sign * trapezoid(sy1 - y_final, (float)x2, x2 + 1.0f, x_bottom, x2 + 1.0f);
                fill[x2] += sign * (sy1 - sy0);
            }
        } else {
            for (int x = 0; x < len; ++x) {
                const float y0 = y_top, xx1 = (float)x, xx2 = (float)(x + 1), x3 = xb, y3 = y_bottom;
                const float y1 = (x - x0) / dx + y_top, y2 = (x + 1 - x0) / dx + y_top;
                if (x0 < xx1 && x3 > xx2) {
                    clipped_edge(scanline, x, e, x0, y0, xx1, y1);
                    clipped_edge(scanline, x, e, xx1, y1, xx2, y2);
                    clipped_edge(scanline, x, e, xx2, y2, x3, y3);
                } else if (x3 < xx1 && x0 > xx2) {
                    clipped_edge(scanline, x, e, x0, y0, xx2, y2);
                    clipped_edge(scanline, x, e, xx2, y2, xx1, y1);
                    clipped_edge(scanline, x, e, xx1, y1, x3, y3);
                } else if (x0 < xx1 && x3 > xx1) {
                    clipped_edge(scanline, x, e, x0, y0, xx1, y1);
                    clipped_edge(scanline, x, e, xx1, y1, x3, y3);
                } else if (x3 < xx1 && x0 > xx1) {
                    clipped_edge(scanline, x, e, x0, y0, xx1, y1);
                    clipped_edge(scanline, x, e, xx1, y1, x3, y3);
                } else if (x0 < xx2 && x3 > xx2) {
                    clipped_edge(scanline, x, e, x0, y0, xx2, y2);
                    clipped_edge(scanline, x, e, xx2, y2, x3, y3);
                } else if (x3 < xx2 && x0 > xx2) {
                    clipped_edge(scanline, x, e, x0, y0, xx2, y2);
                    clipped_edge(scanline, x, e, xx2, y2, x3, y3);
                } else {
                    clipped_edge(scanline, x, e, x0, y0, x3, y3);
                }
            }
        }
    }
}

}  // namespace glyph

using namespace glyph;

extern "C" void poco_put_glyphs(
    uint8_t* img, int h, int w,
    const int32_t* pts, const int32_t* contour_len, const int32_t* glyph_contours,
    const int32_t* pen_x, int n_glyphs, int baseline, float scale, const int32_t* rgb)
{
    const float flat = 0.35f / scale, flat2 = flat * flat;
    std::vector<Pt> poly;
    std::vector<int> lens;
    std::vector<Edge> edges;
    std::vector<Active> active;
    std::vector<float> scan;
    std::vector<uint8_t> bitmap;
    for (int g = 0; g < n_glyphs; ++g) {
        poly.clear();
        lens.clear();
        int xmin = 1 << 30, xmax = -(1 << 30), ymin = 1 << 30, ymax = -(1 << 30);
        for (int c = 0; c < glyph_contours[g]; ++c) {
            const int n = *contour_len++;
            for (int i = 0; i < n; ++i) {
                xmin = std::min(xmin, pts[3 * i]);
                xmax = std::max(xmax, pts[3 * i]);
                ymin = std::min(ymin, pts[3 * i + 1]);
                ymax = std::max(ymax, pts[3 * i + 1]);
            }
            const size_t before = poly.size();
            flatten_contour(pts, n, flat2, poly);
            lens.push_back((int)(poly.size() - before));
            pts += 3 * n;
        }
        if (poly.empty()) continue;
        const int ix0 = (int)std::floor(xmin * scale), iy0 = (int)std::floor(-ymax * scale);
        const int ix1 = (int)std::ceil(xmax * scale), iy1 = (int)std::ceil(-ymin * scale);
        const int bw = ix1 - ix0, bh = iy1 - iy0;
        if (bw <= 0 || bh <= 0) continue;
        edges.clear();
        size_t m = 0;
        for (int len : lens) {
            const Pt* p = poly.data() + m;
            m += len;
            for (int k = 0, j = len - 1; k < len; j = k++) {
                if (p[j].y == p[k].y) continue;
                int a = k, b = j, inv = 0;
                if (p[j].y > p[k].y) {
                    inv = 1;
                    a = j;
                    b = k;
                }
                edges.push_back({p[a].x * scale, p[a].y * -scale, p[b].x * scale, p[b].y * -scale, inv});
            }
        }
        const int n_edges = (int)edges.size();
        sort_edges(edges.data(), n_edges);
        edges.push_back({0, (float)(iy0 + bh) + 1, 0, 0, 0});
        bitmap.assign((size_t)bw * bh, 0);
        scan.assign((size_t)bw * 2 + 1, 0.f);
        active.clear();
        const Edge* e = edges.data();
        for (int j = 0, y = iy0; j < bh; ++j, ++y) {
            const float top = y + 0.0f, bottom = y + 1.0f;
            std::fill(scan.begin(), scan.end(), 0.f);
            active.erase(std::remove_if(active.begin(), active.end(),
                                        [&](const Active& z) { return z.ey <= top; }), active.end());
            while (e->y0 <= bottom) {
                if (e->y0 != e->y1) {
                    const float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
                    Active z;
                    z.fdx = dxdy;
                    z.fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
                    z.fx = e->x0 + dxdy * (top - e->y0);
                    z.fx -= ix0;
                    z.direction = e->invert ? 1.0f : -1.0f;
                    z.sy = e->y0;
                    z.ey = e->y1;
                    if (j == 0 && iy0 != 0 && z.ey < top) z.ey = top;
                    active.insert(active.begin(), z);
                }
                ++e;
            }
            if (!active.empty()) fill_active(scan.data(), scan.data() + bw + 1, bw, active, top);
            float sum = 0;
            for (int i = 0; i < bw; ++i) {
                sum += scan[bw + i];
                float k = scan[i] + sum;
                k = std::fabs(k) * 255 + 0.5f;
                bitmap[(size_t)j * bw + i] = (uint8_t)std::min((int)k, 255);
            }
            for (Active& z : active) z.fx += z.fdx;
        }
        for (int j = 0; j < bh; ++j) {
            const int iy = baseline + iy0 + j;
            if (iy < 0 || iy >= h) continue;
            for (int i = 0; i < bw; ++i) {
                const int ix = pen_x[g] + ix0 + i;
                const int a = bitmap[(size_t)j * bw + i];
                if (ix < 0 || ix >= w || !a) continue;
                uint8_t* q = img + ((size_t)iy * w + ix) * 3;
                for (int c = 0; c < 3; ++c) q[c] = (uint8_t)((q[c] * (255 - a) + rgb[c] * a + 127) / 255);
            }
        }
    }
}
