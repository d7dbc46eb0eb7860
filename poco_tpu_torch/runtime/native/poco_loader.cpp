// Host-side image loader of the PyTorch port: JPEG (and PNG) decode,
// EXIF orientation, and the bilinear affine crop, one image or a whole
// batch on a C++ thread pool.
//
// The port's copy of poco_tpu/runtime/native/poco_loader.cpp. The port
// has no OpenCV to fall back to, so two things differ:
//   * EXIF orientation 2-8 is applied here (transposes and flips, as
//     cv2.imread does), where the JAX copy returns -4 and leaves the file
//     to cv2;
//   * a 16-bit PNG returns -6 (the Python side raises naming the file),
//     where the JAX copy's -5 sends it to cv2.
//
// Two decoders, chosen when the library is built (one per build):
//   * libjpeg (+ libpng with -DPOCO_HAS_PNG): decode on the host;
//   * -DPOCO_NVJPEG: nvJPEG from the CUDA toolkit, for hosts without
//     libjpeg's headers. It decodes on the card to YCbCr planes (Huffman
//     on the calling thread, IDCT on the device, each worker on its own
//     stream and state, kept in a pool for the life of the process:
//     cudaFree waits for the whole card, so device memory is replaced only
//     when an image is larger than any before), copies the planes back,
//     and rebuilds RGB on the host with libjpeg's upsampling and colour
//     tables; the warp runs on the host as in the libjpeg build. JPEG
//     only.
// The crop, the warp and EXIF handling are the same code in both builds.
//
// JPEG encode (poco_encode_jpeg, the demo's outputs) goes the build's
// route too: jpeg_compress on libjpeg; with nvJPEG, the YCbCr 4:2:0 planes
// made on the host as libjpeg makes them and nvjpegEncodeYUV on the card.
// Both take RGB8 at a quality (the demo's is cv2.imwrite's default, 95)
// with 4:2:0 chroma, as cv2 writes.
//
// Built by poco_tpu_torch/runtime/loader.py with g++:
//   -ljpeg [-lpng -DPOCO_HAS_PNG]        (route "libjpeg"), or
//   -DPOCO_NVJPEG -I<cuda>/include -L<cuda>/lib64 -lnvjpeg -lcudart
//                                        (route "nvjpeg").
//
// Status codes: 0 ok, -1 decode error, -2 over the size limit, -3 file
// unreadable, -5 unsupported format, -6 16-bit PNG, -7 CUDA or nvJPEG
// failure, -8 encode error, -9 encode buffer too small (the size needed is
// returned).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <algorithm>
#include <mutex>
#include <thread>
#include <vector>

#ifdef POCO_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#ifdef POCO_HAS_PNG
#include <png.h>
#endif
#endif

namespace {

constexpr int kDecodeError = -1;
constexpr int kTooLarge = -2;
constexpr int kUnreadable = -3;
constexpr int kUnsupported = -5;
constexpr int kPng16 = -6;
constexpr int kCudaError = -7;
constexpr int kEncodeError = -8;
constexpr int kBufferTooSmall = -9;

inline bool is_png(const uint8_t* d, size_t n) {
  static const uint8_t kMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                    0x1A, '\n'};
  return n >= 8 && std::memcmp(d, kMagic, 8) == 0;
}

inline bool is_jpeg(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

// Scan JPEG APP1 for the EXIF Orientation tag (0x0112). Returns the
// orientation value (1..8) or 1 when absent/unparseable.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return 1;
  size_t i = 2;
  while (i + 4 <= n) {
    if (d[i] != 0xFF) return 1;
    const uint8_t marker = d[i + 1];
    if (marker == 0xDA || marker == 0xD9) return 1;  // SOS/EOI: no EXIF
    const size_t seg = (static_cast<size_t>(d[i + 2]) << 8) | d[i + 3];
    if (seg < 2 || i + 2 + seg > n) return 1;
    if (marker == 0xE1 && seg >= 16 &&
        std::memcmp(d + i + 4, "Exif\0\0", 6) == 0) {
      const uint8_t* t = d + i + 10;          // TIFF header
      const size_t tn = seg - 8;
      if (tn < 8) return 1;
      const bool le = t[0] == 'I';
      auto rd16 = [&](size_t off) -> uint32_t {
        return le ? (t[off] | (t[off + 1] << 8))
                  : ((t[off] << 8) | t[off + 1]);
      };
      auto rd32 = [&](size_t off) -> uint32_t {
        return le ? (t[off] | (t[off + 1] << 8) | (t[off + 2] << 16) |
                     (static_cast<uint32_t>(t[off + 3]) << 24))
                  : ((static_cast<uint32_t>(t[off]) << 24) |
                     (t[off + 1] << 16) | (t[off + 2] << 8) | t[off + 3]);
      };
      const size_t ifd = rd32(4);
      if (ifd + 2 > tn) return 1;
      const uint32_t count = rd16(ifd);
      for (uint32_t e = 0; e < count; ++e) {
        const size_t off = ifd + 2 + 12 * static_cast<size_t>(e);
        if (off + 12 > tn) return 1;
        if (rd16(off) == 0x0112) {
          const uint32_t v = rd16(off + 8);
          return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
        }
      }
      return 1;
    }
    i += 2 + seg;
  }
  return 1;
}

// Stored (h, w) from the JPEG SOFn marker or the PNG IHDR chunk, without
// decoding; 0 on success.
int header_dims(const uint8_t* d, size_t n, int* h, int* w) {
  if (is_png(d, n)) {
    if (n < 24) return kDecodeError;
    *w = static_cast<int>((uint32_t(d[16]) << 24) | (d[17] << 16) |
                          (d[18] << 8) | d[19]);
    *h = static_cast<int>((uint32_t(d[20]) << 24) | (d[21] << 16) |
                          (d[22] << 8) | d[23]);
    return 0;
  }
  if (!is_jpeg(d, n)) return kUnsupported;
  size_t i = 2;
  while (i + 4 <= n) {
    if (d[i] != 0xFF) return kDecodeError;
    const uint8_t marker = d[i + 1];
    if (marker == 0xFF) {  // fill byte
      ++i;
      continue;
    }
    const size_t seg = (static_cast<size_t>(d[i + 2]) << 8) | d[i + 3];
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      if (i + 9 > n) return kDecodeError;
      *h = (d[i + 5] << 8) | d[i + 6];
      *w = (d[i + 7] << 8) | d[i + 8];
      return 0;
    }
    if (marker == 0xDA || marker == 0xD9) return kDecodeError;
    i += 2 + seg;
  }
  return kDecodeError;
}

// Apply EXIF orientation o (2..8) to src (h, w, 3) into dst, as
// cv2.imread does (loadsave.cpp ExifTransform): 2 flip left-right,
// 3 rotate 180, 4 flip up-down, 5 transpose, 6 transpose + flip
// left-right (90 clockwise), 7 transpose + rotate 180, 8 transpose +
// flip up-down (90 counter-clockwise). Sets the output (h, w).
void apply_orientation(const uint8_t* src, int h, int w, int o,
                       std::vector<uint8_t>& dst, int* out_h, int* out_w) {
  const bool swap = o >= 5;
  const int oh = swap ? w : h;
  const int ow = swap ? h : w;
  dst.resize(static_cast<size_t>(oh) * ow * 3);
  // after the transpose (o >= 5) the image is (oh, ow) with t[y][x] =
  // src[x][y]; then a flip of rows and/or columns
  const bool flip_x = o == 2 || o == 3 || o == 6 || o == 7;
  const bool flip_y = o == 3 || o == 4 || o == 7 || o == 8;
  for (int y = 0; y < oh; ++y) {
    const int ty = flip_y ? oh - 1 - y : y;
    uint8_t* row = dst.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const int tx = flip_x ? ow - 1 - x : x;
      const int sy = swap ? tx : ty;
      const int sx = swap ? ty : tx;
      const uint8_t* p = src + (static_cast<size_t>(sy) * w + sx) * 3;
      row[3 * x] = p[0];
      row[3 * x + 1] = p[1];
      row[3 * x + 2] = p[2];
    }
  }
  *out_h = oh;
  *out_w = ow;
}

// libjpeg's default reconstruction of RGB from decoded YCbCr planes
// (libjpeg-turbo jdsample.c fancy upsampling and jdcolor.c
// ycc_rgb_convert), so that a decoder that hands back the planes (nvJPEG)
// gives libjpeg's pixels up to its IDCT's rounding.

// Upsample one chroma plane (pw x ph, factors hf x vf) to (w x h):
// h2v1, h1v2 and h2v2 by the triangle filter with libjpeg's alternating
// rounding biases, every other factor by replication; rows outside the
// plane replicate its edge rows, as libjpeg's context rows do.
void upsample_plane(const uint8_t* in, int pw, int ph, int hf, int vf, int w,
                    int h, uint8_t* out) {
  auto row = [&](int y) {
    return in + static_cast<size_t>(std::min(std::max(y, 0), ph - 1)) * pw;
  };
  std::vector<int> sums(pw);
  std::vector<uint8_t> wide(static_cast<size_t>(2) * pw);
  for (int oy = 0; oy < h; ++oy) {
    uint8_t* dst = out + static_cast<size_t>(oy) * w;
    if (hf == 1 && vf == 1) {
      std::memcpy(dst, row(oy), w);
    } else if (hf == 1 && vf == 2) {
      const uint8_t* near = row(oy / 2);
      const uint8_t* far = row(oy % 2 ? oy / 2 + 1 : oy / 2 - 1);
      const int bias = oy % 2 ? 2 : 1;
      for (int x = 0; x < w; ++x) dst[x] = (near[x] * 3 + far[x] + bias) >> 2;
    } else if (hf == 2 && vf == 1 && pw > 2) {
      const uint8_t* in0 = row(oy);
      wide[0] = in0[0];
      wide[1] = (in0[0] * 3 + in0[1] + 2) >> 2;
      for (int i = 1; i < pw - 1; ++i) {
        wide[2 * i] = (in0[i] * 3 + in0[i - 1] + 1) >> 2;
        wide[2 * i + 1] = (in0[i] * 3 + in0[i + 1] + 2) >> 2;
      }
      wide[2 * pw - 2] = (in0[pw - 1] * 3 + in0[pw - 2] + 1) >> 2;
      wide[2 * pw - 1] = in0[pw - 1];
      std::memcpy(dst, wide.data(), w);
    } else if (hf == 2 && vf == 2 && pw > 2) {
      const uint8_t* near = row(oy / 2);
      const uint8_t* far = row(oy % 2 ? oy / 2 + 1 : oy / 2 - 1);
      for (int i = 0; i < pw; ++i) sums[i] = near[i] * 3 + far[i];
      wide[0] = (sums[0] * 4 + 8) >> 4;
      wide[1] = (sums[0] * 3 + sums[1] + 7) >> 4;
      for (int i = 1; i < pw - 1; ++i) {
        wide[2 * i] = (sums[i] * 3 + sums[i - 1] + 8) >> 4;
        wide[2 * i + 1] = (sums[i] * 3 + sums[i + 1] + 7) >> 4;
      }
      wide[2 * pw - 2] = (sums[pw - 1] * 3 + sums[pw - 2] + 8) >> 4;
      wide[2 * pw - 1] = (sums[pw - 1] * 4 + 7) >> 4;
      std::memcpy(dst, wide.data(), w);
    } else {
      const uint8_t* in0 = row(oy / vf);
      for (int x = 0; x < w; ++x) dst[x] = in0[std::min(x / hf, pw - 1)];
    }
  }
}

// YCbCr planes (Y at w x h, chroma at pw x ph with factors hf x vf) or
// one grey plane (components 1) to interleaved RGB8, with libjpeg's
// fixed-point tables (16 fraction bits, the same roundings).
void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                int components, int w, int h, int pw, int ph, int hf, int vf,
                std::vector<uint8_t>& out) {
  out.resize(static_cast<size_t>(h) * w * 3);
  const size_t n = static_cast<size_t>(h) * w;
  if (components == 1) {
    for (size_t i = 0; i < n; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return;
  }
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static std::once_flag tables;
  std::call_once(tables, [] {
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  });
  std::vector<uint8_t> cb_full(n), cr_full(n);
  upsample_plane(cb, pw, ph, hf, vf, w, h, cb_full.data());
  upsample_plane(cr, pw, ph, hf, vf, w, h, cr_full.data());
  auto clamp8 = [](int v) { return static_cast<uint8_t>(std::min(std::max(v, 0), 255)); };
  for (size_t i = 0; i < n; ++i) {
    const int yy = y[i], b = cb_full[i], r = cr_full[i];
    out[3 * i] = clamp8(yy + cr_r[r]);
    out[3 * i + 1] = clamp8(yy + static_cast<int>((cb_g[b] + cr_g[r]) >> 16));
    out[3 * i + 2] = clamp8(yy + cb_b[b]);
  }
}

#ifndef POCO_NVJPEG

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Encode RGB8 (rows packed at w*3) to a JPEG in memory: baseline, the
// given quality, 4:2:0 (jpeg_set_defaults' sampling), as cv2.imwrite.
int encode_jpeg_libjpeg(const uint8_t* rgb, int h, int w, int quality,
                        std::vector<uint8_t>& out) {
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  unsigned char* mem = nullptr;
  unsigned long mem_size = 0;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::free(mem);
    return kEncodeError;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_size);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  out.assign(mem, mem + mem_size);
  jpeg_destroy_compress(&cinfo);
  std::free(mem);
  return 0;
}

// Decode a JPEG byte buffer to RGB8 as stored (no EXIF), into a buffer
// sized from the header.
int decode_jpeg_raw(const uint8_t* data, size_t size,
                    std::vector<uint8_t>& out_vec, int max_h, int max_w,
                    int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = static_cast<int>(cinfo.output_height);
  const int w = static_cast<int>(cinfo.output_width);
  if (h > max_h || w > max_w) {
    jpeg_destroy_decompress(&cinfo);
    return kTooLarge;
  }
  if (out_vec.size() < static_cast<size_t>(h) * w * 3)
    out_vec.resize(static_cast<size_t>(h) * w * 3);
  *out_h = h;
  *out_w = w;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out_vec.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// One worker's decoder: libjpeg keeps no state between images.
struct Decoder {
  int jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
           int max_h, int max_w, int* h, int* w) {
    return decode_jpeg_raw(data, size, out, max_h, max_w, h, w);
  }
};
struct DecoderLease {
  Decoder decoder;
  Decoder* get() { return &decoder; }
};

#else  // POCO_NVJPEG

// One worker's nvJPEG state, stream and device buffer. Decoders live in
// a pool for the life of the process: a worker leases one for a call and
// returns it, so device memory is replaced only when an image is larger
// than any before.
struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> planes;  // the decoded planes, copied back
  nvjpegEncoderState_t enc_state = nullptr;   // made at the first encode
  nvjpegEncoderParams_t enc_params = nullptr;
  bool ok = false;

  int jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
           int max_h, int max_w, int* h, int* w);
  int encode(const uint8_t* rgb, int h, int w, int quality,
             std::vector<uint8_t>& out);
  int reserve(size_t bytes);
};

std::once_flag g_handle_once;
nvjpegHandle_t g_handle = nullptr;
bool g_handle_ok = false;
std::mutex g_pool_mutex;
std::vector<Decoder*> g_pool;

Decoder* acquire_decoder() {
  std::call_once(g_handle_once, [] {
    g_handle_ok = nvjpegCreateSimple(&g_handle) == NVJPEG_STATUS_SUCCESS;
  });
  {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    if (!g_pool.empty()) {
      Decoder* d = g_pool.back();
      g_pool.pop_back();
      return d;
    }
  }
  Decoder* d = new Decoder();
  d->ok = g_handle_ok &&
          nvjpegJpegStateCreate(g_handle, &d->state) ==
              NVJPEG_STATUS_SUCCESS &&
          cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking) ==
              cudaSuccess;
  return d;
}

void release_decoder(Decoder* d) {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  g_pool.push_back(d);
}

struct DecoderLease {
  Decoder* decoder = acquire_decoder();
  ~DecoderLease() { release_decoder(decoder); }
  Decoder* get() { return decoder; }
};

// The chroma factors of a subsampling, (0, 0) where the loader does not
// take it.
void chroma_factors(nvjpegChromaSubsampling_t ss, int* hf, int* vf) {
  switch (ss) {
    case NVJPEG_CSS_444: *hf = 1; *vf = 1; return;
    case NVJPEG_CSS_422: *hf = 2; *vf = 1; return;
    case NVJPEG_CSS_420: *hf = 2; *vf = 2; return;
    case NVJPEG_CSS_440: *hf = 1; *vf = 2; return;
    case NVJPEG_CSS_411: *hf = 4; *vf = 1; return;
    case NVJPEG_CSS_410: *hf = 4; *vf = 2; return;
    default: *hf = 0; *vf = 0; return;
  }
}

// Decode on the card to planar YCbCr at the stored subsampling, copy the
// planes back, and rebuild RGB on the host as libjpeg does (nvJPEG's own
// RGB output upsamples and converts otherwise, and misses cv2's pixels by
// more than chip_smoke.py's thumbnail bar).
int Decoder::jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
                  int max_h, int max_w, int* out_h, int* out_w) {
  if (!ok) return kCudaError;
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_handle, data, size, &components, &subsampling,
                         widths, heights) != NVJPEG_STATUS_SUCCESS)
    return kDecodeError;
  const int h = heights[0], w = widths[0];
  if (h <= 0 || w <= 0) return kDecodeError;
  if (h > max_h || w > max_w) return kTooLarge;
  int hf = 1, vf = 1;
  if (components == 3) {
    chroma_factors(subsampling, &hf, &vf);
    if (hf == 0) return kUnsupported;
  } else if (components != 1) {
    return kUnsupported;  // CMYK / YCCK
  }
  size_t offsets[3] = {0, 0, 0};
  size_t bytes = 0;
  for (int c = 0; c < components; ++c) {
    offsets[c] = bytes;
    bytes += static_cast<size_t>(widths[c]) * heights[c];
  }
  if (reserve(bytes) != 0) return kCudaError;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  for (int c = 0; c < components; ++c) {
    image.channel[c] = dev + offsets[c];
    image.pitch[c] = static_cast<size_t>(widths[c]);
  }
  if (nvjpegDecode(g_handle, state, data, size,
                   components == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV,
                   &image, stream) != NVJPEG_STATUS_SUCCESS)
    return kDecodeError;
  planes.resize(bytes);
  if (cudaMemcpyAsync(planes.data(), dev, bytes, cudaMemcpyDeviceToHost,
                      stream) != cudaSuccess ||
      cudaStreamSynchronize(stream) != cudaSuccess)
    return kCudaError;
  const uint8_t* p = planes.data();
  ycc_to_rgb(p, p + offsets[1], p + offsets[2], components, w, h,
             components == 3 ? widths[1] : 0, components == 3 ? heights[1] : 0,
             hf, vf, out);
  *out_h = h;
  *out_w = w;
  return 0;
}

// Device memory of at least `bytes`, replaced only when larger than before.
int Decoder::reserve(size_t bytes) {
  if (bytes <= cap) return 0;
  if (dev != nullptr && cudaFree(dev) != cudaSuccess) return kCudaError;
  dev = nullptr;
  cap = 0;
  if (cudaMalloc(reinterpret_cast<void**>(&dev), bytes) != cudaSuccess)
    return kCudaError;
  cap = bytes;
  return 0;
}

// RGB8 -> the Y, Cb and Cr planes of a 4:2:0 JPEG, made as libjpeg's
// compressor makes them: jccolor.c's fixed-point RGB -> YCbCr (16-bit
// fractions, Cb and Cr rounded with 0.5 - epsilon) and jcsample.c's
// h2v2_downsample (2x2 sums with the bias 1, 2, 1, 2, ... along a row),
// the last column and row repeated for odd sizes.
void rgb_to_ycc420(const uint8_t* rgb, int h, int w, std::vector<uint8_t>& planes) {
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
  const int32_t half = 1 << 15, offset = 128 << 16;
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  planes.resize(static_cast<size_t>(h) * w + 2 * static_cast<size_t>(ch) * cw);
  uint8_t* y = planes.data();
  uint8_t* cb = y + static_cast<size_t>(h) * w;
  uint8_t* cr = cb + static_cast<size_t>(ch) * cw;
  std::vector<uint8_t> full_cb(static_cast<size_t>(2 * ch) * 2 * cw);
  std::vector<uint8_t> full_cr(full_cb.size());
  for (int r = 0; r < 2 * ch; ++r) {
    const uint8_t* row = rgb + static_cast<size_t>(std::min(r, h - 1)) * w * 3;
    for (int c = 0; c < 2 * cw; ++c) {
      const uint8_t* px = row + std::min(c, w - 1) * 3;
      const int32_t R = px[0], G = px[1], B = px[2];
      if (r < h && c < w)
        y[static_cast<size_t>(r) * w + c] = static_cast<uint8_t>(
            (fix(0.29900) * R + fix(0.58700) * G + fix(0.11400) * B + half) >> 16);
      const size_t i = static_cast<size_t>(r) * 2 * cw + c;
      full_cb[i] = static_cast<uint8_t>((-fix(0.16874) * R - fix(0.33126) * G +
                                         fix(0.50000) * B + offset + half - 1) >> 16);
      full_cr[i] = static_cast<uint8_t>((fix(0.50000) * R - fix(0.41869) * G -
                                         fix(0.08131) * B + offset + half - 1) >> 16);
    }
  }
  for (int r = 0; r < ch; ++r) {
    int bias = 1;
    for (int c = 0; c < cw; ++c) {
      const size_t a = static_cast<size_t>(2 * r) * 2 * cw + 2 * c, b = a + 2 * cw;
      cb[static_cast<size_t>(r) * cw + c] = static_cast<uint8_t>(
          (full_cb[a] + full_cb[a + 1] + full_cb[b] + full_cb[b + 1] + bias) >> 2);
      cr[static_cast<size_t>(r) * cw + c] = static_cast<uint8_t>(
          (full_cr[a] + full_cr[a + 1] + full_cr[b] + full_cr[b + 1] + bias) >> 2);
      bias ^= 3;
    }
  }
}

// Encode RGB8 on the card: the 4:2:0 planes made on the host as libjpeg
// makes them, copied up, nvjpegEncodeYUV at the given quality, the
// bitstream copied back. (nvjpegEncodeImage's own RGB conversion and
// chroma decimation wrote the full-HD test frame 3.5 dB PSNR below
// cv2.imwrite at quality 95 on an H100's host; these planes, 0.1 dB:
// chip_smoke.py phase 4j.)
int Decoder::encode(const uint8_t* rgb, int h, int w, int quality,
                    std::vector<uint8_t>& out) {
  if (!ok) return kCudaError;
  if (enc_state == nullptr &&
      nvjpegEncoderStateCreate(g_handle, &enc_state, stream) !=
          NVJPEG_STATUS_SUCCESS) {
    enc_state = nullptr;
    return kCudaError;
  }
  if (enc_params == nullptr &&
      nvjpegEncoderParamsCreate(g_handle, &enc_params, stream) !=
          NVJPEG_STATUS_SUCCESS) {
    enc_params = nullptr;
    return kCudaError;
  }
  if (nvjpegEncoderParamsSetQuality(enc_params, quality, stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(enc_params, NVJPEG_CSS_420,
                                            stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetOptimizedHuffman(enc_params, 0, stream) !=
          NVJPEG_STATUS_SUCCESS)
    return kEncodeError;
  rgb_to_ycc420(rgb, h, w, planes);
  const size_t luma = static_cast<size_t>(h) * w;
  const size_t cw = (w + 1) / 2, chroma = cw * ((h + 1) / 2);
  if (reserve(planes.size()) != 0 ||
      cudaMemcpyAsync(dev, planes.data(), planes.size(), cudaMemcpyHostToDevice,
                      stream) != cudaSuccess)
    return kCudaError;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = dev;
  image.pitch[0] = static_cast<size_t>(w);
  image.channel[1] = dev + luma;
  image.pitch[1] = cw;
  image.channel[2] = dev + luma + chroma;
  image.pitch[2] = cw;
  if (nvjpegEncodeYUV(g_handle, enc_state, enc_params, &image, NVJPEG_CSS_420,
                      w, h, stream) != NVJPEG_STATUS_SUCCESS)
    return kEncodeError;
  size_t length = 0;
  if (nvjpegEncodeRetrieveBitstream(g_handle, enc_state, nullptr, &length,
                                    stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(stream) != cudaSuccess)
    return kEncodeError;
  out.resize(length);
  if (nvjpegEncodeRetrieveBitstream(g_handle, enc_state, out.data(), &length,
                                    stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(stream) != cudaSuccess)
    return kEncodeError;
  out.resize(length);
  return 0;
}

#endif  // POCO_NVJPEG

#ifdef POCO_HAS_PNG
struct PngMemSrc {
  const uint8_t* data;
  size_t size;
  size_t off;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngMemSrc* src = static_cast<PngMemSrc*>(png_get_io_ptr(png));
  if (src->off + n > src->size) png_error(png, "truncated PNG");
  std::memcpy(out, src->data + src->off, n);
  src->off += n;
}

// Decode a PNG byte buffer to RGB8 with the classic libpng read API, as
// cv2.imread(IMREAD_COLOR) reads it: palette and low-bit grey expand to
// 8-bit RGB, alpha is dropped (never composited), gamma and colour
// chunks are ignored. 16-bit files return -6: libpng's 16->8 conversion
// is not cv2's.
int decode_png_vec(const uint8_t* data, size_t size,
                   std::vector<uint8_t>& out_vec,
                   int max_h, int max_w, int* out_h, int* out_w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                             nullptr);
  if (!png) return kDecodeError;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kDecodeError;
  }
  // png_error longjmps here, past any destructor: nothing with one may
  // live in this scope (the pixels go to the caller's out_vec).
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kDecodeError;
  }
  PngMemSrc src{data, size, 0};
  png_set_read_fn(png, &src, png_mem_read);
  png_read_info(png, info);

  const png_uint_32 w32 = png_get_image_width(png, info);
  const png_uint_32 h32 = png_get_image_height(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kPng16;
  }
  if (h32 > static_cast<png_uint_32>(max_h) ||
      w32 > static_cast<png_uint_32>(max_w)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kTooLarge;
  }
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const int h = static_cast<int>(h32);
  const int w = static_cast<int>(w32);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kDecodeError;
  }
  if (out_vec.size() < static_cast<size_t>(h) * w * 3)
    out_vec.resize(static_cast<size_t>(h) * w * 3);
  png_bytep* rows = static_cast<png_bytep*>(
      std::malloc(sizeof(png_bytep) * h));
  if (!rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kDecodeError;
  }
  for (int i = 0; i < h; ++i)
    rows[i] = out_vec.data() + static_cast<size_t>(i) * w * 3;
  if (setjmp(png_jmpbuf(png))) {
    std::free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return kDecodeError;
  }
  png_read_image(png, rows);
  std::free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  *out_h = h;
  *out_w = w;
  return 0;
}
#endif  // POCO_HAS_PNG

// Content-sniffing decode (extensions lie; magic bytes do not) to RGB8 at
// stride w*3, EXIF orientation applied; `scratch` holds the stored
// pixels of a reoriented JPEG. The size limit holds for the output.
int decode_image_vec(Decoder* dec, const uint8_t* data, size_t size,
                     std::vector<uint8_t>& out_vec,
                     std::vector<uint8_t>& scratch,
                     int max_h, int max_w, int* out_h, int* out_w) {
  if (is_jpeg(data, size)) {
    const int o = exif_orientation(data, size);
    if (o == 1) return dec->jpeg(data, size, out_vec, max_h, max_w, out_h, out_w);
    int h = 0, w = 0;
    // the stored image is (w, h) when the orientation transposes it
    const int rc = o >= 5 ? dec->jpeg(data, size, scratch, max_w, max_h, &h, &w)
                          : dec->jpeg(data, size, scratch, max_h, max_w, &h, &w);
    if (rc != 0) return rc;
    apply_orientation(scratch.data(), h, w, o, out_vec, out_h, out_w);
    return 0;
  }
#ifdef POCO_HAS_PNG
  if (is_png(data, size))
    return decode_png_vec(data, size, out_vec, max_h, max_w, out_h, out_w);
#endif
  return kUnsupported;
}

// cv2-parity bilinear sample with BORDER_CONSTANT=0.
inline void sample_bilinear(const uint8_t* img, int h, int w,
                            float x, float y, float* rgb) {
  const int x0 = static_cast<int>(std::floor(x));
  const int y0 = static_cast<int>(std::floor(y));
  const float wx = x - x0;
  const float wy = y - y0;
  if (x0 >= 0 && y0 >= 0 && x0 + 1 < w && y0 + 1 < h) {
    // Fast interior path: all four taps in bounds, no branches.
    const uint8_t* p0 = img + (static_cast<size_t>(y0) * w + x0) * 3;
    const uint8_t* p1 = p0 + static_cast<size_t>(w) * 3;
    const float f00 = (1.f - wy) * (1.f - wx);
    const float f01 = (1.f - wy) * wx;
    const float f10 = wy * (1.f - wx);
    const float f11 = wy * wx;
    rgb[0] = f00 * p0[0] + f01 * p0[3] + f10 * p1[0] + f11 * p1[3];
    rgb[1] = f00 * p0[1] + f01 * p0[4] + f10 * p1[1] + f11 * p1[4];
    rgb[2] = f00 * p0[2] + f01 * p0[5] + f10 * p1[2] + f11 * p1[5];
    return;
  }
  for (int c = 0; c < 3; ++c) rgb[c] = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy < 0 || yy >= h) continue;
    const float fy = dy ? wy : 1.f - wy;
    for (int dx = 0; dx < 2; ++dx) {
      const int xx = x0 + dx;
      if (xx < 0 || xx >= w) continue;
      const float f = fy * (dx ? wx : 1.f - wx);
      const uint8_t* p = img + (static_cast<size_t>(yy) * w + xx) * 3;
      rgb[0] += f * p[0];
      rgb[1] += f * p[1];
      rgb[2] += f * p[2];
    }
  }
}

void affine_crop_impl(const uint8_t* img, int h, int w, float cx, float cy,
                      float bbox_size, int out_res, float* out) {
  const float scale = bbox_size / out_res;
  for (int i = 0; i < out_res; ++i) {
    const float sy = (i - out_res * 0.5f) * scale + cy;
    for (int j = 0; j < out_res; ++j) {
      const float sx = (j - out_res * 0.5f) * scale + cx;
      sample_bilinear(img, h, w,
                      sx, sy,
                      out + (static_cast<size_t>(i) * out_res + j) * 3);
    }
  }
}

// General 2x3 output->source affine warp (rotation / flip / scale encoded
// in the matrix, built host-side with the same cv2-convention math as the
// Python path) + per-channel gain with [0,255] clamp (channel-noise aug).
void affine_warp_impl(const uint8_t* img, int h, int w, const float* m,
                      const float* gain, int out_res, float* out) {
  const float g0 = gain[0], g1 = gain[1], g2 = gain[2];
  for (int i = 0; i < out_res; ++i) {
    // Source coordinates advance by a constant step along the row.
    float sx = m[1] * i + m[2];
    float sy = m[4] * i + m[5];
    float* px = out + static_cast<size_t>(i) * out_res * 3;
    for (int j = 0; j < out_res; ++j, px += 3, sx += m[0], sy += m[3]) {
      sample_bilinear(img, h, w, sx, sy, px);
      px[0] = std::min(std::max(px[0] * g0, 0.f), 255.f);
      px[1] = std::min(std::max(px[1] * g1, 0.f), 255.f);
      px[2] = std::min(std::max(px[2] * g2, 0.f), 255.f);
    }
  }
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // reject ftell errors and absurd sizes (a mislabeled multi-GB file
  // must become statuses=-3, not a bad_alloc out of a worker thread)
  if (size < 0 || size > (512L << 20)) {
    std::fclose(f);
    return buf;
  }
  buf.resize(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) buf.clear();
  std::fclose(f);
  return buf;
}

// Run fn(decoder, i) for i in [0, n) on num_threads threads (0: one a
// core), each thread with its own decoder.
template <typename Fn>
void parallel_items(int n, int num_threads, Fn fn) {
  if (num_threads < 1) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads < 1) num_threads = 1;
  }
  num_threads = std::max(1, std::min(num_threads, n));
  auto worker = [&](int tid) {
    DecoderLease lease;
    std::vector<uint8_t> decode_buf, scratch;
    for (int i = tid; i < n; i += num_threads)
      fn(lease.get(), decode_buf, scratch, i);
  };
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// 1: libjpeg (host), 2: nvJPEG (card).
int poco_route(void) {
#ifdef POCO_NVJPEG
  return 2;
#else
  return 1;
#endif
}

// 1 when PNG decode was compiled in (libpng present at build time).
int poco_has_png(void) {
#ifdef POCO_HAS_PNG
  return 1;
#else
  return 0;
#endif
}

// (h, w) of the decoded image, EXIF orientation applied, from the
// headers alone.
int poco_image_dims(const uint8_t* data, size_t size, int* out_h,
                    int* out_w) {
  int h = 0, w = 0;
  const int rc = header_dims(data, size, &h, &w);
  if (rc != 0) return rc;
  const bool swap = is_jpeg(data, size) && exif_orientation(data, size) >= 5;
  *out_h = swap ? w : h;
  *out_w = swap ? h : w;
  return 0;
}

// Format-sniffing single-image decode (JPEG or PNG, EXIF applied) into a
// caller buffer of at least max_h*max_w*3 bytes, rows packed at stride
// w*3.
int poco_decode_image(const uint8_t* data, size_t size, uint8_t* out,
                      int max_h, int max_w, int* out_h, int* out_w) {
  try {
    DecoderLease lease;
    std::vector<uint8_t> buf, scratch;
    const int rc = decode_image_vec(lease.get(), data, size, buf, scratch,
                                    max_h, max_w, out_h, out_w);
    if (rc == 0)
      std::memcpy(out, buf.data(), static_cast<size_t>(*out_h) * *out_w * 3);
    return rc;
  } catch (...) {
    return kDecodeError;  // no exception crosses the C boundary
  }
}

void poco_affine_crop(const uint8_t* img, int h, int w, float cx, float cy,
                      float bbox_size, int out_res, float* out) {
  affine_crop_impl(img, h, w, cx, cy, bbox_size, out_res, out);
}

// One image through the batch path's warp: affine (6,) output->source,
// gain (3,).
void poco_affine_warp(const uint8_t* img, int h, int w, const float* affine,
                      const float* gain, int out_res, float* out) {
  affine_warp_impl(img, h, w, affine, gain, out_res, out);
}

// Decode + crop a batch of files in parallel.
//   paths: n C strings; centers: (n, 2); bbox_sizes: (n,)
//   out: (n, out_res, out_res, 3) float32
//   statuses: (n,) int (0 ok, negative = failure)
void poco_batch_decode_crop(const char** paths, int n,
                            const float* centers, const float* bbox_sizes,
                            int out_res, int max_h, int max_w,
                            float* out, int* statuses, int num_threads) {
  parallel_items(n, num_threads, [&](Decoder* dec, std::vector<uint8_t>& buf,
                                     std::vector<uint8_t>& scratch, int i) {
    try {
      std::vector<uint8_t> bytes = read_file(paths[i]);
      if (bytes.empty()) {
        statuses[i] = kUnreadable;
        return;
      }
      int h = 0, w = 0;
      const int rc = decode_image_vec(dec, bytes.data(), bytes.size(), buf,
                                      scratch, max_h, max_w, &h, &w);
      statuses[i] = rc;
      if (rc != 0) return;
      affine_crop_impl(buf.data(), h, w, centers[2 * i], centers[2 * i + 1],
                       bbox_sizes[i], out_res,
                       out + static_cast<size_t>(i) * out_res * out_res * 3);
    } catch (...) {
      statuses[i] = kUnreadable;  // no exception may escape a worker thread
    }
  });
}

// Decode + general affine warp of a batch of files in parallel, the
// whole-batch training input path (augmented crops).
//   affines: (n, 6) row-major 2x3 output->source matrices
//   gains:   (n, 3) per-channel multipliers (clamped to [0, 255])
//   dims:    (n, 2) int32 out, decoded (h, w) per image
void poco_batch_decode_affine(const char** paths, int n,
                              const float* affines, const float* gains,
                              int out_res, int max_h, int max_w,
                              float* out, int* statuses, int* dims,
                              int num_threads) {
  parallel_items(n, num_threads, [&](Decoder* dec, std::vector<uint8_t>& buf,
                                     std::vector<uint8_t>& scratch, int i) {
    try {
      std::vector<uint8_t> bytes = read_file(paths[i]);
      if (bytes.empty()) {
        statuses[i] = kUnreadable;
        return;
      }
      int h = 0, w = 0;
      const int rc = decode_image_vec(dec, bytes.data(), bytes.size(), buf,
                                      scratch, max_h, max_w, &h, &w);
      statuses[i] = rc;
      if (rc != 0) return;
      dims[2 * i] = h;
      dims[2 * i + 1] = w;
      affine_warp_impl(buf.data(), h, w, affines + 6 * i, gains + 3 * i,
                       out_res,
                       out + static_cast<size_t>(i) * out_res * out_res * 3);
    } catch (...) {
      statuses[i] = kUnreadable;  // no exception may escape a worker thread
    }
  });
}

// Encode RGB8 (h, w, 3), rows packed, as a JPEG at `quality` with 4:2:0
// chroma into `out` (capacity `cap`); *out_size is the JPEG's length, or
// the length needed when the status is -9.
int poco_encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                     uint8_t* out, size_t cap, size_t* out_size) {
  try {
    std::vector<uint8_t> jpeg;
#ifdef POCO_NVJPEG
    DecoderLease lease;
    const int rc = lease.get()->encode(rgb, h, w, quality, jpeg);
#else
    const int rc = encode_jpeg_libjpeg(rgb, h, w, quality, jpeg);
#endif
    if (rc != 0) return rc;
    *out_size = jpeg.size();
    if (jpeg.size() > cap) return kBufferTooSmall;
    std::memcpy(out, jpeg.data(), jpeg.size());
    return 0;
  } catch (...) {
    return kEncodeError;  // no exception crosses the C boundary
  }
}

}  // extern "C"
