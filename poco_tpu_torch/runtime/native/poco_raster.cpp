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
