// Native image loader: threaded JPEG/PNG decode + area resize.
//
// The port's own copy of gsplat_tpu/native/loader.cpp. A C++ thread pool
// decodes with libjpeg(-turbo)/libpng and box-filters straight to the
// training resolution, exposed to Python over ctypes. float32 CHW RGBA
// output, alpha=1 when the file has none.
//
// Build: see gsplat_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17 loader.cpp -ljpeg -lpng). No other dependencies.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> rgba;  // H*W*4
  int w = 0, h = 0;
  bool has_alpha = false;
};

// ----------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->has_alpha = false;
  out->rgba.resize(size_t(out->w) * out->h * 4);
  std::vector<uint8_t> row(size_t(out->w) * 3);
  uint8_t* rowp = row.data();
  for (int y = 0; y < out->h; y++) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out->rgba.data() + size_t(y) * out->w * 4;
    for (int x = 0; x < out->w; x++) {
      dst[4 * x + 0] = row[3 * x + 0];
      dst[4 * x + 1] = row[3 * x + 1];
      dst[4 * x + 2] = row[3 * x + 2];
      dst[4 * x + 3] = 255;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------------ PNG

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize everything to 8-bit RGBA
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->has_alpha = (color_type & PNG_COLOR_MASK_ALPHA) ||
                   png_get_valid(png, info, PNG_INFO_tRNS);
  out->rgba.resize(size_t(w) * h * 4);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = out->rgba.data() + size_t(y) * w * 4;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && !memcmp(magic, "\x89PNG\r\n\x1a\n", 8)) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// --------------------------------------------------------------- resize
// Area (box) filter: exact average of the covered source region — the
// right filter for the heavy downscales of camera_utils' resolution policy.

void area_resize_to_chw(const Image& src, int ow, int oh, float* dst) {
  const double sx = double(src.w) / ow;
  const double sy = double(src.h) / oh;
  const size_t plane = size_t(ow) * oh;
  for (int oy = 0; oy < oh; oy++) {
    const double y0 = oy * sy, y1 = (oy + 1) * sy;
    const int iy0 = int(y0), iy1 = std::min(int(std::ceil(y1)), src.h);
    for (int ox = 0; ox < ow; ox++) {
      const double x0 = ox * sx, x1 = (ox + 1) * sx;
      const int ix0 = int(x0), ix1 = std::min(int(std::ceil(x1)), src.w);
      double acc[4] = {0, 0, 0, 0};
      double wsum = 0;
      for (int y = iy0; y < iy1; y++) {
        const double wy =
            std::min<double>(y + 1, y1) - std::max<double>(y, y0);
        const uint8_t* row = src.rgba.data() + size_t(y) * src.w * 4;
        for (int x = ix0; x < ix1; x++) {
          const double wx =
              std::min<double>(x + 1, x1) - std::max<double>(x, x0);
          const double wgt = wx * wy;
          acc[0] += wgt * row[4 * x + 0];
          acc[1] += wgt * row[4 * x + 1];
          acc[2] += wgt * row[4 * x + 2];
          acc[3] += wgt * row[4 * x + 3];
          wsum += wgt;
        }
      }
      const double inv = wsum > 0 ? 1.0 / (255.0 * wsum) : 0.0;
      const size_t o = size_t(oy) * ow + ox;
      dst[0 * plane + o] = float(acc[0] * inv);
      dst[1 * plane + o] = float(acc[1] * inv);
      dst[2 * plane + o] = float(acc[2] * inv);
      dst[3 * plane + o] = float(acc[3] * inv);
    }
  }
}

void copy_to_chw(const Image& src, float* dst) {
  const size_t plane = size_t(src.w) * src.h;
  constexpr float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < plane; i++) {
    const uint8_t* px = src.rgba.data() + 4 * i;
    dst[0 * plane + i] = px[0] * inv;
    dst[1 * plane + i] = px[1] * inv;
    dst[2 * plane + i] = px[2] * inv;
    dst[3 * plane + i] = px[3] * inv;
  }
}

}  // namespace

extern "C" {

// Probe dimensions without a full decode (header-only where possible).
int gs_image_size(const char* path, int* w, int* h) {
  Image img;  // full decode fallback keeps it simple & correct
  if (!decode_file(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

// Decode one image to float32 CHW RGBA at (ow, oh); ow==0 keeps the source
// size (caller must have sized `dst` via gs_image_size). Returns 0 on
// success, 1 if the file had a real alpha channel, negative on error.
int gs_decode_image(const char* path, int ow, int oh, float* dst) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  if (ow <= 0 || (ow == img.w && oh == img.h)) {
    copy_to_chw(img, dst);
  } else {
    area_resize_to_chw(img, ow, oh, dst);
  }
  return img.has_alpha ? 1 : 0;
}

// Batch decode across a thread pool. Every image lands at (ow, oh) in
// dst[i * 4*ow*oh]. has_alpha[i] gets the per-file alpha flag. Returns the
// number of failures (0 = all good).
int gs_decode_batch(const char** paths, int n, int ow, int oh, float* dst,
                    int* has_alpha, int n_threads) {
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int> next(0), failures(0);
  const size_t stride = size_t(4) * ow * oh;
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = gs_decode_image(paths[i], ow, oh, dst + stride * i);
      if (rc < 0) {
        failures.fetch_add(1);
        has_alpha[i] = -1;
      } else {
        has_alpha[i] = rc;
      }
    }
  };
  std::vector<std::thread> pool;
  const int k = std::min(n_threads, n);
  pool.reserve(k);
  for (int t = 0; t < k; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
