// podtpu native runtime: image decode/resize pipeline + COCO eval matcher.
//
// TPU-native replacement for the reference's native-code layer, which lives
// entirely in dependencies (SURVEY.md §2.2): PIL/libjpeg image decode inside
// torch DataLoader worker processes (reference
// miso/object_detection/dataset/dataset.py:18, training.py:64-83) and the
// pycocotools C extension (engine/coco_eval.py).  Exposed to Python via
// ctypes (no pybind11 in this image).
//
// The PyTorch port's copy of native/podtpu_native.cpp.  It declares the six
// libtiff functions and the macros it uses instead of including <tiffio.h>,
// so it builds where libtiff's shared library is installed without its
// header.  podtpu_torch/core/native.py builds it at first use with
// native/Makefile's flags (-march=native included: without it the compiler
// does not contract the bilinear resize into FMAs and a few bytes differ).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <csetjmp>
#include <cstdarg>
#include <jpeglib.h>
#include <png.h>

// From <tiffio.h> (libtiff 4): the functions and macros decode_tiff uses.
extern "C" {
typedef struct tiff TIFF;
typedef void (*TIFFErrorHandler)(const char*, const char*, va_list);
TIFF* TIFFOpen(const char*, const char*);
void TIFFClose(TIFF*);
int TIFFGetField(TIFF*, uint32_t, ...);
int TIFFReadRGBAImageOriented(TIFF*, uint32_t, uint32_t, uint32_t*, int, int);
TIFFErrorHandler TIFFSetWarningHandler(TIFFErrorHandler);
TIFFErrorHandler TIFFSetErrorHandler(TIFFErrorHandler);
}
#define TIFFTAG_IMAGEWIDTH 256
#define TIFFTAG_IMAGELENGTH 257
#define ORIENTATION_TOPLEFT 1
#define TIFFGetR(abgr) ((abgr) & 0xff)
#define TIFFGetG(abgr) (((abgr) >> 8) & 0xff)
#define TIFFGetB(abgr) (((abgr) >> 16) & 0xff)

extern "C" {

// ---------------------------------------------------------------------------
// Image decode (JPEG via libjpeg, PNG via libpng) to RGB888.
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decodes a JPEG file to RGB. Returns heap buffer (caller frees) or nullptr.
static uint8_t* decode_jpeg(FILE* fp, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  uint8_t* buf = static_cast<uint8_t*>(malloc(size_t(*w) * *h * 3));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return buf;
}

static uint8_t* decode_png(FILE* fp, int* w, int* h) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return nullptr;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_set_expand(png);          // palette/1-bit -> 8-bit
  png_set_strip_16(png);        // 16-bit -> 8-bit
  png_set_strip_alpha(png);     // drop alpha
  png_set_gray_to_rgb(png);     // grayscale -> RGB
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  uint8_t* buf = static_cast<uint8_t*>(malloc(size_t(*w) * *h * 3));
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = buf + size_t(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return buf;
}

// Micrograph scans are frequently TIFF (the reference's directory-inference
// rglob includes tiff/tif, miso/object_detection/inference.py:78-88, and its
// deps pull imagecodecs/scikit-image for them).  TIFFReadRGBAImageOriented
// handles strip/tile layouts and the common compressions in one call.
static uint8_t* decode_tiff(const char* path, int* w, int* h) {
  // libtiff logs warnings (e.g. unknown EXIF tags) to stderr per image;
  // silence them once — failures still surface as nullptr returns.
  static bool quiet = [] {
    TIFFSetWarningHandler(nullptr);
    TIFFSetErrorHandler(nullptr);
    return true;
  }();
  (void)quiet;
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return nullptr;
  uint32_t ww = 0, hh = 0;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &ww);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &hh);
  if (!ww || !hh || size_t(ww) * hh > (size_t(1) << 31)) {
    TIFFClose(tif);
    return nullptr;
  }
  std::vector<uint32_t> raster;
  raster.resize(size_t(ww) * hh);
  int ok = TIFFReadRGBAImageOriented(tif, ww, hh, raster.data(),
                                     ORIENTATION_TOPLEFT, 0);
  TIFFClose(tif);
  if (!ok) return nullptr;
  uint8_t* buf = static_cast<uint8_t*>(malloc(size_t(ww) * hh * 3));
  if (!buf) return nullptr;
  for (size_t i = 0; i < size_t(ww) * hh; ++i) {
    uint32_t p = raster[i];
    buf[i * 3 + 0] = TIFFGetR(p);
    buf[i * 3 + 1] = TIFFGetG(p);
    buf[i * 3 + 2] = TIFFGetB(p);
  }
  *w = int(ww);
  *h = int(hh);
  return buf;
}

static uint8_t* decode_file(const char* path, int* w, int* h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, fp);
  rewind(fp);
  uint8_t* out = nullptr;
  bool is_tiff =
      n >= 4 && ((magic[0] == 'I' && magic[1] == 'I' && magic[2] == 0x2A &&
                  magic[3] == 0x00) ||
                 (magic[0] == 'M' && magic[1] == 'M' && magic[2] == 0x00 &&
                  magic[3] == 0x2A));
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    out = decode_jpeg(fp, w, h);
  } else if (n >= 4 && magic[0] == 0x89 && magic[1] == 'P' &&
             magic[2] == 'N' && magic[3] == 'G') {
    out = decode_png(fp, w, h);
  }
  fclose(fp);
  if (!out && is_tiff) {
    out = decode_tiff(path, w, h);  // libtiff opens by path itself
  }
  return out;
}

// ---------------------------------------------------------------------------
// Aspect-preserving bilinear fit-resize into a zero-padded float32 canvas.
// Matches podtpu.data.dataset.fit_resize semantics (scale = min(ch/h, cw/w),
// image placed top-left, normalised to [0,1]).
// ---------------------------------------------------------------------------

// Fractional box-filter coverage of [d*f, (d+1)*f) over source cells,
// shared by the area-resample path (cv2 INTER_AREA semantics).
static void area_weights(int dst, float f, std::vector<int>& starts,
                         std::vector<int>& counts,
                         std::vector<float>& weights, int src_size) {
  starts.resize(dst);
  counts.resize(dst);
  weights.clear();
  for (int d = 0; d < dst; ++d) {
    float a = d * f, b = (d + 1) * f;
    int s0 = int(std::floor(a));
    int s1 = std::min(int(std::ceil(b)), src_size);
    starts[d] = s0;
    counts[d] = s1 - s0;
    for (int s = s0; s < s1; ++s) {
      float lo = std::max(a, float(s));
      float hi = std::min(b, float(s + 1));
      weights.push_back(std::max(hi - lo, 0.0f) / f);
    }
  }
}

}  // extern "C" — the helpers below use overloads/templates (C++ linkage);
// exported entry points re-declare extern "C" individually.

// Output stores: float canvases are normalised to [0,1]; uint8 canvases
// keep the byte range (the device normalises) — 4x less host->device
// transfer and no quantisation pass on the wrapper.
static inline void store_px(float v, float* p) { *p = v * (1.0f / 255.0f); }
static inline void store_px(float v, uint8_t* p) {
  float r = v + 0.5f;
  *p = (uint8_t)(r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r));
}

template <typename OutT>
static void resize_into_canvas(const uint8_t* src, int sh, int sw,
                               OutT* canvas, int ch, int cw,
                               float* scale_out) {
  float scale = std::min(float(ch) / sh, float(cw) / sw);
  int nh = std::max(1, int(std::lround(sh * scale)));
  int nw = std::max(1, int(std::lround(sw * scale)));
  *scale_out = scale;
  memset(canvas, 0, size_t(ch) * cw * 3 * sizeof(OutT));
  const float fy = float(sh) / nh;
  const float fx = float(sw) / nw;

  if (scale < 1.0f) {
    // Downscale: fractional box filter (cv2 INTER_AREA), matching the
    // python fit_resize path's interpolation choice.
    std::vector<int> ys, yc, xs, xc;
    std::vector<float> yw, xw;
    area_weights(nh, fy, ys, yc, yw, sh);
    area_weights(nw, fx, xs, xc, xw, sw);
    std::vector<int> yoff(nh), xoff(nw);
    for (int y = 0, o = 0; y < nh; ++y) { yoff[y] = o; o += yc[y]; }
    for (int x = 0, o = 0; x < nw; ++x) { xoff[x] = o; o += xc[x]; }
    for (int y = 0; y < nh; ++y) {
      OutT* dst_row = canvas + size_t(y) * cw * 3;
      for (int x = 0; x < nw; ++x) {
        float acc[3] = {0, 0, 0};
        for (int i = 0; i < yc[y]; ++i) {
          const uint8_t* srow = src + size_t(ys[y] + i) * sw * 3;
          float wyv = yw[yoff[y] + i];
          for (int j = 0; j < xc[x]; ++j) {
            float w = wyv * xw[xoff[x] + j];
            const uint8_t* p = srow + size_t(xs[x] + j) * 3;
            acc[0] += w * p[0];
            acc[1] += w * p[1];
            acc[2] += w * p[2];
          }
        }
        store_px(acc[0], dst_row + x * 3 + 0);
        store_px(acc[1], dst_row + x * 3 + 1);
        store_px(acc[2], dst_row + x * 3 + 2);
      }
    }
    return;
  }

  // Upscale: bilinear, OpenCV convention (sample at (d + 0.5)/scale - 0.5).
  for (int y = 0; y < nh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int y0 = int(std::floor(syf));
    float wy = syf - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(y0 + 1, sh - 1);
    if (y0 < 0) wy = 0.0f;
    OutT* dst_row = canvas + size_t(y) * cw * 3;
    const uint8_t* r0 = src + size_t(y0c) * sw * 3;
    const uint8_t* r1 = src + size_t(y1c) * sw * 3;
    for (int x = 0; x < nw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int x0 = int(std::floor(sxf));
      float wx = sxf - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(x0 + 1, sw - 1);
      if (x0 < 0) wx = 0.0f;
      for (int c = 0; c < 3; ++c) {
        float v00 = r0[x0c * 3 + c], v01 = r0[x1c * 3 + c];
        float v10 = r1[x0c * 3 + c], v11 = r1[x1c * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        store_px(top + (bot - top) * wy, dst_row + x * 3 + c);
      }
    }
  }
}

// Decode one image into a canvas slot.  Returns 0 on success, -1 on
// decode failure.
template <typename OutT>
static int decode_resize_t(const char* path, OutT* canvas, int canvas_h,
                           int canvas_w, float* scale_out, int* orig_h,
                           int* orig_w) {
  int w = 0, h = 0;
  uint8_t* rgb = decode_file(path, &w, &h);
  if (!rgb) return -1;
  *orig_h = h;
  *orig_w = w;
  resize_into_canvas(rgb, h, w, canvas, canvas_h, canvas_w, scale_out);
  free(rgb);
  return 0;
}

extern "C" int podtpu_decode_resize(const char* path, float* canvas, int canvas_h,
                         int canvas_w, float* scale_out, int* orig_h,
                         int* orig_w) {
  return decode_resize_t(path, canvas, canvas_h, canvas_w, scale_out,
                         orig_h, orig_w);
}

// Threaded batch decode: paths is n concatenated NUL-terminated strings.
// canvases: [n, canvas_h, canvas_w, 3] float32. Returns count of failures.
template <typename OutT>
static int decode_resize_batch_t(const char* const* paths, int n,
                                 OutT* canvases, int canvas_h, int canvas_w,
                                 float* scales, int* orig_hw,
                                 int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      OutT* canvas = canvases + size_t(i) * canvas_h * canvas_w * 3;
      int rc = decode_resize_t(paths[i], canvas, canvas_h, canvas_w,
                               &scales[i], &orig_hw[i * 2],
                               &orig_hw[i * 2 + 1]);
      if (rc != 0) failures.fetch_add(1);
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

extern "C" int podtpu_decode_resize_batch(const char* const* paths, int n, float* canvases,
                               int canvas_h, int canvas_w, float* scales,
                               int* orig_hw, int num_threads) {
  return decode_resize_batch_t(paths, n, canvases, canvas_h, canvas_w,
                               scales, orig_hw, num_threads);
}

// uint8 canvases (the loader's preferred contract).
extern "C" int podtpu_decode_resize_batch_u8(const char* const* paths, int n,
                                  uint8_t* canvases, int canvas_h,
                                  int canvas_w, float* scales, int* orig_hw,
                                  int num_threads) {
  return decode_resize_batch_t(paths, n, canvases, canvas_h, canvas_w,
                               scales, orig_hw, num_threads);
}

// ---------------------------------------------------------------------------
// COCO evaluation inner loop (pycocotools C-extension equivalent):
// greedy score-ordered matching of D detections to G ground truths at T IoU
// thresholds.  Inputs are one (image, class) pair, detections pre-sorted by
// descending score, gts sorted non-ignored-first.
// ---------------------------------------------------------------------------

extern "C" void podtpu_coco_match(const double* iou,      // [D, G]
                       const uint8_t* gt_ig,   // [G]
                       const double* det_area, // [D]
                       const double* thrs,     // [T]
                       int D, int G, int T, double area_lo, double area_hi,
                       uint8_t* dtm,           // [T, D] out
                       uint8_t* dtig) {        // [T, D] out
  std::vector<uint8_t> gt_used(G);
  for (int t = 0; t < T; ++t) {
    std::fill(gt_used.begin(), gt_used.end(), 0);
    double thr = thrs[t];
    for (int d = 0; d < D; ++d) {
      int best = -1;
      double best_iou = thr - 1e-10;
      for (int g = 0; g < G; ++g) {
        if (gt_used[g]) continue;
        // Once matched to a non-ignored gt, never switch to an ignored one.
        if (best > -1 && !gt_ig[best] && gt_ig[g]) break;
        if (iou[size_t(d) * G + g] < best_iou) continue;
        best_iou = iou[size_t(d) * G + g];
        best = g;
      }
      uint8_t matched = best != -1;
      dtm[size_t(t) * D + d] = matched;
      if (matched) {
        gt_used[best] = 1;
        dtig[size_t(t) * D + d] = gt_ig[best];
      } else {
        dtig[size_t(t) * D + d] =
            det_area[d] < area_lo || det_area[d] > area_hi;
      }
    }
  }
}

