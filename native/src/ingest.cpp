// tpusfm native ingest: threaded image decoding for pipeline/pod-scale feeds.
//
// Capability parity with the reference's host-side ingest path — OpenMVG
// ReadImage + the OpenMP parallel-for over views (reference:
// src/sparseBuilder/sparseBuilder.cpp:679-752) — rebuilt as a standalone
// C++ library with a worker pool, exposed through a C ABI consumed by
// tpusfm.io.native_ingest via ctypes.  Decoders: JPEG (libjpeg), PNG
// (libpng), PPM/PGM, BMP(24/32).  Output is either float32 grayscale in
// [0,1] (the device feed format) or interleaved RGB u8 (colorization).
//
// The accelerator compute path never runs on the host; this library exists so image
// decode keeps up with the accelerator when feeding batches (SURVEY.md §7
// hard part 7: host/device split for ingest).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved, c channels
};

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG ----

bool decode_png(FILE* f, Image* out) {
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return false;
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ------------------------------------------------------------- PPM/PGM ----

bool decode_pnm(FILE* f, Image* out) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return false;
  bool gray = !strcmp(magic, "P5");
  bool rgb = !strcmp(magic, "P6");
  if (!gray && !rgb) return false;
  int vals[3], got = 0, c;
  while (got < 3) {  // w, h, maxval with comment support
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    } else if (c >= '0' && c <= '9') {
      ungetc(c, f);
      if (fscanf(f, "%d", &vals[got++]) != 1) return false;
    } else if (c == EOF) {
      return false;
    }
  }
  fgetc(f);  // single whitespace after maxval
  out->w = vals[0];
  out->h = vals[1];
  out->c = rgb ? 3 : 1;
  size_t n = size_t(out->w) * out->h * out->c;
  out->data.resize(n);
  return fread(out->data.data(), 1, n, f) == n;
}

// ----------------------------------------------------------------- BMP ----

bool decode_bmp(FILE* f, Image* out) {
  uint8_t hdr[54];
  if (fread(hdr, 1, 54, f) != 54 || hdr[0] != 'B' || hdr[1] != 'M') return false;
  auto rd32 = [&](int o) { return int(hdr[o] | hdr[o + 1] << 8 | hdr[o + 2] << 16 | hdr[o + 3] << 24); };
  int offset = rd32(10);
  int w = rd32(18), h = rd32(22);
  int bpp = hdr[28] | hdr[29] << 8;
  if (w <= 0 || h == 0 || (bpp != 24 && bpp != 32)) return false;
  bool flip = h > 0;
  h = h < 0 ? -h : h;
  fseek(f, offset, SEEK_SET);
  int stride = ((w * bpp / 8) + 3) & ~3;
  std::vector<uint8_t> row(stride);
  out->w = w;
  out->h = h;
  out->c = 3;
  out->data.resize(size_t(w) * h * 3);
  for (int y = 0; y < h; ++y) {
    if (fread(row.data(), 1, stride, f) != size_t(stride)) return false;
    uint8_t* dst = out->data.data() + size_t(flip ? h - 1 - y : y) * w * 3;
    for (int x = 0; x < w; ++x) {
      dst[x * 3 + 0] = row[x * bpp / 8 + 2];  // BGR -> RGB
      dst[x * 3 + 1] = row[x * bpp / 8 + 1];
      dst[x * 3 + 2] = row[x * bpp / 8 + 0];
    }
  }
  return true;
}

// ------------------------------------------------------------- dispatch ----

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t sig[8] = {0};
  size_t n = fread(sig, 1, 8, f);
  fseek(f, 0, SEEK_SET);
  bool ok = false;
  if (n >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) ok = decode_jpeg(f, out);
  else if (n >= 8 && !png_sig_cmp(sig, 0, 8)) ok = decode_png(f, out);
  else if (sig[0] == 'P' && (sig[1] == '5' || sig[1] == '6')) ok = decode_pnm(f, out);
  else if (sig[0] == 'B' && sig[1] == 'M') ok = decode_bmp(f, out);
  fclose(f);
  return ok;
}

void to_gray_f32(const Image& img, float* out) {
  size_t n = size_t(img.w) * img.h;
  if (img.c == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = img.data[i] / 255.0f;
  } else {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = img.data.data() + i * img.c;
      out[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) / 255.0f;
    }
  }
}

void to_rgb_u8(const Image& img, uint8_t* out) {
  size_t n = size_t(img.w) * img.h;
  if (img.c == 3) {
    memcpy(out, img.data.data(), n * 3);
  } else {
    for (size_t i = 0; i < n; ++i)
      out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = img.data[i];
  }
}

// Simple run-to-completion worker pool (the ConcurrentQueue analog,
// reference src/utils/ConcurrentQueue.h, but pooled).
void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int nt = std::min(n_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // namespace


// ---------------------------------------------------------------------------
// EXIF (JPEG APP1 / TIFF IFD) parsing — native counterpart of the
// reference's Exif_IO_EasyExif usage (src/sparseBuilder/sparseBuilder.cpp:
// 389-465: focal length, camera make/model for the sensor-width database,
// GPS position priors via getGPS, .cpp:112).  Pure bounds-checked binary
// walk; no third-party EXIF library.
// ---------------------------------------------------------------------------

namespace exif {

struct Tiff {
  const uint8_t* p;
  size_t n;
  bool le;  // little-endian ("II")
  uint16_t u16(size_t o) const {
    if (o + 2 > n) return 0;
    return le ? uint16_t(p[o] | p[o + 1] << 8) : uint16_t(p[o] << 8 | p[o + 1]);
  }
  uint32_t u32(size_t o) const {
    if (o + 4 > n) return 0;
    return le ? (uint32_t(p[o]) | uint32_t(p[o + 1]) << 8 |
                 uint32_t(p[o + 2]) << 16 | uint32_t(p[o + 3]) << 24)
              : (uint32_t(p[o]) << 24 | uint32_t(p[o + 1]) << 16 |
                 uint32_t(p[o + 2]) << 8 | uint32_t(p[o + 3]));
  }
  double rational(size_t o) const {
    double num = u32(o), den = u32(o + 4);
    return den != 0.0 ? num / den : 0.0;
  }
};

struct Entry {
  uint16_t tag, type;
  uint32_t count;
  size_t val_off;  // offset of the value bytes inside the TIFF block
};

inline size_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
    default: return 0;
  }
}

// Walk one IFD, calling fn(entry) per entry. Returns offset of next IFD.
template <typename F>
uint32_t walk_ifd(const Tiff& t, uint32_t ifd_off, F&& fn) {
  if (ifd_off + 2 > t.n) return 0;
  uint16_t n_entries = t.u16(ifd_off);
  if (n_entries > 512) return 0;  // corrupt
  for (uint16_t i = 0; i < n_entries; ++i) {
    size_t e = ifd_off + 2 + size_t(i) * 12;
    if (e + 12 > t.n) break;
    Entry ent;
    ent.tag = t.u16(e);
    ent.type = t.u16(e + 2);
    ent.count = t.u32(e + 4);
    size_t sz = type_size(ent.type) * size_t(ent.count);
    ent.val_off = sz <= 4 ? e + 8 : t.u32(e + 8);
    if (ent.val_off + sz <= t.n) fn(ent);
  }
  return t.u32(ifd_off + 2 + size_t(n_entries) * 12);
}

struct Result {
  double focal_mm = 0, focal35 = 0, lat = 0, lon = 0, alt = 0;
  int has = 0;  // bitmask: 1 focal, 2 focal35mm, 4 gps, 8 make/model
  char make[64] = {0}, model[64] = {0};
};

inline void copy_ascii(const Tiff& t, const Entry& e, char* dst, size_t cap) {
  size_t n = std::min(size_t(e.count), cap - 1);
  for (size_t i = 0; i < n; ++i) dst[i] = char(t.p[e.val_off + i]);
  dst[n] = 0;
  // Trim trailing spaces/NULs.
  for (size_t i = n; i > 0 && (dst[i - 1] == ' ' || dst[i - 1] == 0); --i)
    dst[i - 1] = 0;
}

inline double dms(const Tiff& t, const Entry& e) {
  if (e.type != 5 || e.count < 3) return 0.0;
  return t.rational(e.val_off) + t.rational(e.val_off + 8) / 60.0 +
         t.rational(e.val_off + 16) / 3600.0;
}

// Parse the TIFF block of an EXIF payload.
inline bool parse_tiff(const uint8_t* p, size_t n, Result* out) {
  if (n < 8) return false;
  Tiff t{p, n, false};
  if (p[0] == 'I' && p[1] == 'I') t.le = true;
  else if (p[0] == 'M' && p[1] == 'M') t.le = false;
  else return false;
  if (t.u16(2) != 42) return false;
  uint32_t exif_ifd = 0, gps_ifd = 0;
  walk_ifd(t, t.u32(4), [&](const Entry& e) {
    if (e.tag == 0x010F) { copy_ascii(t, e, out->make, sizeof out->make); out->has |= 8; }
    else if (e.tag == 0x0110) { copy_ascii(t, e, out->model, sizeof out->model); out->has |= 8; }
    else if (e.tag == 0x8769) exif_ifd = t.u32(e.val_off);
    else if (e.tag == 0x8825) gps_ifd = t.u32(e.val_off);
  });
  if (exif_ifd) {
    walk_ifd(t, exif_ifd, [&](const Entry& e) {
      if (e.tag == 0x920A && e.type == 5) {
        out->focal_mm = t.rational(e.val_off);
        if (out->focal_mm > 0) out->has |= 1;
      } else if (e.tag == 0xA405 && e.type == 3) {
        out->focal35 = t.u16(e.val_off);
        if (out->focal35 > 0) out->has |= 2;
      }
    });
  }
  if (gps_ifd) {
    char lat_ref = 0, lon_ref = 0;
    uint8_t alt_ref = 0;
    double lat = 0, lon = 0, alt = 0;
    bool got_lat = false, got_lon = false;
    walk_ifd(t, gps_ifd, [&](const Entry& e) {
      if (e.tag == 1 && e.count >= 1) lat_ref = char(t.p[e.val_off]);
      else if (e.tag == 2) { lat = dms(t, e); got_lat = true; }
      else if (e.tag == 3 && e.count >= 1) lon_ref = char(t.p[e.val_off]);
      else if (e.tag == 4) { lon = dms(t, e); got_lon = true; }
      else if (e.tag == 5 && e.count >= 1) alt_ref = t.p[e.val_off];
      else if (e.tag == 6 && e.type == 5) alt = t.rational(e.val_off);
    });
    if (got_lat && got_lon) {
      out->lat = lat_ref == 'S' ? -lat : lat;
      out->lon = lon_ref == 'W' ? -lon : lon;
      out->alt = alt_ref == 1 ? -alt : alt;
      out->has |= 4;
    }
  }
  return out->has != 0;
}

// Find the EXIF APP1 payload inside a JPEG and parse it.
inline bool parse_jpeg_file(const char* path, Result* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[2];
  if (fread(hdr, 1, 2, f) != 2 || hdr[0] != 0xFF || hdr[1] != 0xD8) {
    fclose(f);
    return false;
  }
  bool found = false;
  std::vector<uint8_t> buf;
  for (int seg = 0; seg < 64; ++seg) {  // markers precede scan data
    uint8_t mk[2];
    if (fread(mk, 1, 2, f) != 2 || mk[0] != 0xFF) break;
    if (mk[1] == 0xD9 || mk[1] == 0xDA) break;  // EOI / SOS
    uint8_t ln[2];
    if (fread(ln, 1, 2, f) != 2) break;
    size_t len = (size_t(ln[0]) << 8 | ln[1]);
    if (len < 2) break;
    len -= 2;
    if (mk[1] == 0xE1 && len > 6) {
      buf.resize(len);
      if (fread(buf.data(), 1, len, f) != len) break;
      if (memcmp(buf.data(), "Exif\0\0", 6) == 0 &&
          parse_tiff(buf.data() + 6, len - 6, out)) {
        found = true;
        break;
      }
    } else if (fseek(f, long(len), SEEK_CUR) != 0) {
      break;
    }
  }
  fclose(f);
  return found;
}

}  // namespace exif

extern "C" {

// Returns 1 on success; fills w/h/channels without full decode where cheap
// (falls back to decode).
int tsfm_image_info(const char* path, int* w, int* h, int* c) {
  Image img;
  if (!decode_file(path, &img)) return 0;
  *w = img.w;
  *h = img.h;
  *c = img.c;
  return 1;
}

// Decode one image to float32 grayscale [0,1]. Buffer must hold w*h floats
// matching the file's true size (query tsfm_image_info first). Returns 1 ok.
int tsfm_load_gray(const char* path, float* out, int w, int h) {
  Image img;
  if (!decode_file(path, &img) || img.w != w || img.h != h) return 0;
  to_gray_f32(img, out);
  return 1;
}

int tsfm_load_rgb(const char* path, uint8_t* out, int w, int h) {
  Image img;
  if (!decode_file(path, &img) || img.w != w || img.h != h) return 0;
  to_rgb_u8(img, out);
  return 1;
}

// Batch decode with a worker pool. paths: n C strings; all images must be
// (w, h); out_gray: n*w*h floats (nullable); out_rgb: n*w*h*3 bytes
// (nullable); status: n ints. Returns number of successes.
int tsfm_load_batch(const char** paths, int n, int w, int h, float* out_gray,
                    uint8_t* out_rgb, int* status, int n_threads) {
  std::atomic<int> ok_count{0};
  parallel_for(n, n_threads, [&](int i) {
    Image img;
    bool ok = decode_file(paths[i], &img) && img.w == w && img.h == h;
    if (ok) {
      if (out_gray) to_gray_f32(img, out_gray + size_t(i) * w * h);
      if (out_rgb) to_rgb_u8(img, out_rgb + size_t(i) * w * h * 3);
      ok_count.fetch_add(1);
    }
    if (status) status[i] = ok ? 1 : 0;
  });
  return ok_count.load();
}


// EXIF metadata of a JPEG: focal length (mm), 35mm-equivalent focal, GPS
// (lat/lon deg, alt m), camera make/model. Returns a bitmask of what was
// found (1 focal, 2 focal35, 4 gps, 8 make/model); 0 = none / not a JPEG.
int tsfm_exif(const char* path, double* focal_mm, double* focal35,
              double* lat, double* lon, double* alt,
              char* make, int make_cap, char* model, int model_cap) {
  exif::Result r;
  if (!exif::parse_jpeg_file(path, &r)) return 0;
  if (focal_mm) *focal_mm = r.focal_mm;
  if (focal35) *focal35 = r.focal35;
  if (lat) *lat = r.lat;
  if (lon) *lon = r.lon;
  if (alt) *alt = r.alt;
  if (make && make_cap > 0) {
    strncpy(make, r.make, size_t(make_cap) - 1);
    make[make_cap - 1] = 0;
  }
  if (model && model_cap > 0) {
    strncpy(model, r.model, size_t(model_cap) - 1);
    model[model_cap - 1] = 0;
  }
  return r.has;
}

}  // extern "C"\n