// sprc_tpu_torch native data-plane: image decode + preprocess.
//
// The port's own copy of the JAX package's sprc_tpu/native/dataplane.cpp:
// the port compiles this file and never includes or builds the JAX one.
// tests/test_torch_dataplane.py pins its C ABI and its resampling equal to
// the original's text.
//
// The reference's input pipeline is PIL decode + torchvision transforms in
// torch DataLoader worker processes (reference src/data_utils.py:91-105).
// The hot path here is native: libjpeg / libpng decode, antialiased
// separable Catmull-Rom resampling (PIL-compatible bicubic, a = -0.5,
// support scaled by the downscale factor), TargetPad/center-crop geometry
// and CLIP normalization fused into one pass over the image, plus a
// std::thread batch API. Exposed as a C ABI for ctypes.
//
// Build: sprc_tpu_torch/native/build.py (g++ -O3 -shared -fPIC dataplane.cpp
// -ljpeg -lpng into sprc_tpu_torch/_build/).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

struct Image {
  std::vector<uint8_t> data;  // RGB, row-major
  int w = 0;
  int h = 0;
};

// ------------------------------------------------------------------ decode

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + count > st->len) {
    png_error(png, "read past end");
  }
  memcpy(out, st->data + st->pos, count);
  st->pos += count;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  if (png_sig_cmp(buf, 0, 8) != 0) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
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
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  // apply transparency chunk -> alpha -> stripped
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  int channels = png_get_channels(png, info);
  std::vector<uint8_t> row(size_t(out->w) * channels);
  out->data.resize(size_t(out->w) * out->h * 3);
  for (int y = 0; y < out->h; ++y) {
    png_read_row(png, row.data(), nullptr);
    uint8_t* dst = out->data.data() + size_t(y) * out->w * 3;
    if (channels == 3) {
      memcpy(dst, row.data(), size_t(out->w) * 3);
    } else {
      for (int x = 0; x < out->w; ++x) {
        for (int c = 0; c < 3; ++c) dst[x * 3 + c] = row[x * channels + std::min(c, channels - 1)];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_any(const uint8_t* buf, size_t len, Image* out) {
  if (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf, len, out);
  if (len > 8 && png_sig_cmp(buf, 0, 8) == 0) return decode_png(buf, len, out);
  return false;
}

// ------------------------------------------------- PIL-compatible resample

// Catmull-Rom-style cubic, a = -0.5 (PIL's BICUBIC filter).
inline double bicubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds_min;
  std::vector<int> bounds_size;
  std::vector<double> coeffs;
  int ksize = 0;
};

// Precompute per-output-pixel kernels with PIL's antialias support scaling
// (filter support * max(1, in/out)); mirrors ImagingResampleHorizontal.
ResampleCoeffs precompute(int in_size, int out_size, double offset, double scale_len) {
  ResampleCoeffs rc;
  const double support_base = 2.0;  // bicubic support
  double filterscale = scale_len;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = support_base * filterscale;
  rc.ksize = int(std::ceil(support)) * 2 + 1;
  rc.bounds_min.resize(out_size);
  rc.bounds_size.resize(out_size);
  rc.coeffs.assign(size_t(out_size) * rc.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = offset + (xx + 0.5) * scale_len;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    int n = xmax - xmin;
    double* k = rc.coeffs.data() + size_t(xx) * rc.ksize;
    double ww = 0.0;
    for (int x = 0; x < n; ++x) {
      double w = bicubic_filter((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < n; ++x) k[x] /= ww;
    }
    rc.bounds_min[xx] = xmin;
    rc.bounds_size[xx] = n;
  }
  return rc;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return uint8_t(v + 0.5);
}

// Resize RGB uint8 (PIL convert("RGB") happens pre-resize in the pipeline).
Image resize_bicubic(const Image& src, int out_w, int out_h) {
  Image tmp;  // horizontal pass
  tmp.w = out_w;
  tmp.h = src.h;
  tmp.data.resize(size_t(out_w) * src.h * 3);
  ResampleCoeffs rh = precompute(src.w, out_w, 0.0, double(src.w) / out_w);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.data.data() + size_t(y) * src.w * 3;
    uint8_t* drow = tmp.data.data() + size_t(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const double* k = rh.coeffs.data() + size_t(xx) * rh.ksize;
      int xmin = rh.bounds_min[xx], n = rh.bounds_size[xx];
      for (int c = 0; c < 3; ++c) {
        double acc = 0.0;
        for (int x = 0; x < n; ++x) acc += srow[(xmin + x) * 3 + c] * k[x];
        drow[xx * 3 + c] = clip8(acc);
      }
    }
  }
  Image out;  // vertical pass
  out.w = out_w;
  out.h = out_h;
  out.data.resize(size_t(out_w) * out_h * 3);
  ResampleCoeffs rv = precompute(src.h, out_h, 0.0, double(src.h) / out_h);
  for (int yy = 0; yy < out_h; ++yy) {
    const double* k = rv.coeffs.data() + size_t(yy) * rv.ksize;
    int ymin = rv.bounds_min[yy], n = rv.bounds_size[yy];
    uint8_t* drow = out.data.data() + size_t(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      for (int c = 0; c < 3; ++c) {
        double acc = 0.0;
        for (int y = 0; y < n; ++y)
          acc += tmp.data[(size_t(ymin + y) * out_w + xx) * 3 + c] * k[y];
        drow[xx * 3 + c] = clip8(acc);
      }
    }
  }
  return out;
}

// -------------------------------------------------------------- preprocess

// TargetPad geometry (reference data_utils.py:49-72): returns padded dims
// and offsets of the original image inside the padded canvas.
void target_pad_geometry(int w, int h, double target_ratio, int* pw, int* ph,
                         int* ox, int* oy) {
  double actual = double(std::max(w, h)) / std::min(w, h);
  *pw = w;
  *ph = h;
  *ox = 0;
  *oy = 0;
  if (actual < target_ratio) return;
  double scaled = double(std::max(w, h)) / target_ratio;
  int hp = std::max(int((scaled - w) / 2), 0);
  int vp = std::max(int((scaled - h) / 2), 0);
  *pw = w + 2 * hp;
  *ph = h + 2 * vp;
  *ox = hp;
  *oy = vp;
}

int preprocess_one(const uint8_t* bytes, size_t len, int dim,
                   double target_ratio, int use_target_pad, float* out) {
  Image img;
  if (!decode_any(bytes, len, &img)) return -1;

  // pad canvas
  int pw, ph, ox, oy;
  if (use_target_pad) {
    target_pad_geometry(img.w, img.h, target_ratio, &pw, &ph, &ox, &oy);
  } else {  // SquarePad (data_utils.py:27-46)
    int m = std::max(img.w, img.h);
    ox = (m - img.w) / 2;
    oy = (m - img.h) / 2;
    pw = ph = m;
  }
  Image padded;
  if (pw != img.w || ph != img.h) {
    padded.w = pw;
    padded.h = ph;
    padded.data.assign(size_t(pw) * ph * 3, 0);
    for (int y = 0; y < img.h; ++y) {
      memcpy(padded.data.data() + (size_t(y + oy) * pw + ox) * 3,
             img.data.data() + size_t(y) * img.w * 3, size_t(img.w) * 3);
    }
  } else {
    padded = std::move(img);
  }

  // shorter side -> dim (torchvision Resize(int) semantics). Sizes and crop
  // offsets round half to even, as Python's round() in the PIL path does
  // (std::nearbyint in the default rounding mode; the JAX package's copy
  // rounds half away from zero, which shifts the crop by a pixel).
  int nw, nh;
  if (padded.w <= padded.h) {
    nw = dim;
    nh = std::max(1, int(std::nearbyint(double(padded.h) * dim / padded.w)));
  } else {
    nh = dim;
    nw = std::max(1, int(std::nearbyint(double(padded.w) * dim / padded.h)));
  }
  Image resized = resize_bicubic(padded, nw, nh);

  // center crop + normalize, fused
  int left = int(std::nearbyint((nw - dim) / 2.0));
  int top = int(std::nearbyint((nh - dim) / 2.0));
  for (int y = 0; y < dim; ++y) {
    const uint8_t* srow = resized.data.data() + (size_t(y + top) * nw + left) * 3;
    float* drow = out + size_t(y) * dim * 3;
    for (int x = 0; x < dim; ++x) {
      for (int c = 0; c < 3; ++c) {
        drow[x * 3 + c] = (srow[x * 3 + c] / 255.0f - kMean[c]) / kStd[c];
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode only: fills *w/*h; out must hold w*h*3 bytes (call with out=null
// first to query dims via decode_dims).
int sprc_decode_dims(const uint8_t* bytes, size_t len, int* w, int* h) {
  Image img;
  if (!decode_any(bytes, len, &img)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

int sprc_decode(const uint8_t* bytes, size_t len, uint8_t* out, size_t out_len) {
  Image img;
  if (!decode_any(bytes, len, &img)) return -1;
  if (img.data.size() > out_len) return -2;
  memcpy(out, img.data.data(), img.data.size());
  return int(img.data.size());
}

// Full preprocess: encoded bytes -> float32 [dim, dim, 3] normalized.
int sprc_preprocess(const uint8_t* bytes, size_t len, int dim,
                    double target_ratio, int use_target_pad, float* out) {
  return preprocess_one(bytes, len, dim, target_ratio, use_target_pad, out);
}

// Batch preprocess with a thread pool. offsets[i]..offsets[i+1] delimit each
// image's bytes inside `blob`. Returns number of failures; failed slots are
// zero-filled and flagged in `ok`.
int sprc_preprocess_batch(const uint8_t* blob, const size_t* offsets, int n,
                          int dim, double target_ratio, int use_target_pad,
                          float* out, uint8_t* ok, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t stride = size_t(dim) * dim * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* bytes = blob + offsets[i];
      size_t len = offsets[i + 1] - offsets[i];
      int rc = preprocess_one(bytes, len, dim, target_ratio, use_target_pad,
                              out + stride * i);
      if (rc != 0) {
        memset(out + stride * i, 0, stride * sizeof(float));
        ok[i] = 0;
        failures.fetch_add(1);
      } else {
        ok[i] = 1;
      }
    }
  };
  int nt = std::max(1, num_threads);
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
