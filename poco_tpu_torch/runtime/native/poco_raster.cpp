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
// fills it.

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

// OpenCV's clipLine on integer points, in place; false when the line
// misses the image.
static bool clip_line(int w, int h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2)
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
static void label_line(uint8_t* img, int h, int w, int64_t x0, int64_t y0, int64_t x1,
                       int64_t y1, uint8_t value)
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
        img[(size_t)y * w + x] = value;
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
