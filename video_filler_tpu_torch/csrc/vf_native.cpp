// vf_native — native data-loading runtime, copied from native/vf_native.cpp
// for video_filler_tpu_torch (its data/native.py builds and binds it).
//
// The reference's native data path, rebuilt: the Torch
// `threads` donkey pool (data/data.lua:26-60) and the `image` C library's
// JPEG/PNG decode + bilinear scale (data/donkey_folder.lua:39-62).  One call
// decodes a batch of clips in parallel (libjpeg/libpng, no Python in the
// loop), short-side-resizes, and applies ONE shared random crop per clip
// (all frames + reported offsets so Python can crop the logo mask to match,
// datavid/donkey_folder.lua:138-163).  Exposed via ctypes; the GIL is
// released for the whole batch.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -o libvf_native.so
//        vf_native.cpp -ljpeg -lpng -lpthread (data/native.py builds it on
//        demand into build/video_filler_tpu_torch/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB interleaved
  int h = 0, w = 0;
};

// ---------- JPEG ----------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
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
  try {
    out->data.resize(size_t(out->h) * out->w * 3);
  } catch (...) {
    // decompression-bomb header (e.g. 60000x60000 -> ~10 GB): treat as a
    // decode failure instead of leaking cinfo while the alloc error unwinds
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------- PNG (simplified API) ----------

bool decode_png(const char* path, Image* out) {
  png_image img;
  memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return false;
  img.format = PNG_FORMAT_RGB;
  out->w = img.width;
  out->h = img.height;
  try {
    out->data.resize(PNG_IMAGE_SIZE(img));
  } catch (...) {
    png_image_free(&img);
    return false;
  }
  if (!png_image_finish_read(&img, nullptr, out->data.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[4] = {0};
  size_t got = fread(magic, 1, 4, f);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rewind(f);
    bool ok = decode_jpeg(f, out);
    fclose(f);
    return ok;
  }
  fclose(f);
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') {
    return decode_png(path, out);
  }
  return false;
}

// ---------- bilinear resize (RGB u8) ----------

// Fixed-point bilinear resize with precomputed horizontal LUTs; the
// horizontal pass is done once into a per-row int16 cache and reused for the
// vertical blend (classic separable two-pass schedule).  `out`/`row_stride`:
// destination rows (stride in bytes) — lets vf_load_frames resize straight
// into its padded slot without an intermediate full-frame copy.
void resize_bilinear_into(const Image& src, int nh, int nw, uint8_t* out,
                          size_t row_stride) {
  const float sy = nh > 1 ? float(src.h - 1) / (nh - 1) : 0.f;
  const float sx = nw > 1 ? float(src.w - 1) / (nw - 1) : 0.f;

  std::vector<int> x0s(nw), x1s(nw), wxs(nw);  // wx in 0..256
  for (int x = 0; x < nw; ++x) {
    const float fx = x * sx;
    int x0 = int(fx);
    if (x0 > src.w - 1) x0 = src.w - 1;
    x0s[x] = x0 * 3;
    x1s[x] = (x0 + 1 < src.w ? x0 + 1 : x0) * 3;
    wxs[x] = int((fx - x0) * 256.f + 0.5f);
  }

  // Horizontal pass cache: two rows of int16 (value << 0, 0..255*256 range
  // fits int32; store int32 for headroom).
  std::vector<int32_t> rowA(size_t(nw) * 3), rowB(size_t(nw) * 3);
  int cachedA = -1, cachedB = -1;

  auto hpass = [&](int sy_row, std::vector<int32_t>& out) {
    const uint8_t* r = src.data.data() + size_t(sy_row) * src.w * 3;
    for (int x = 0; x < nw; ++x) {
      const int wx = wxs[x], iwx = 256 - wx;
      const uint8_t* p0 = r + x0s[x];
      const uint8_t* p1 = r + x1s[x];
      out[x * 3 + 0] = p0[0] * iwx + p1[0] * wx;
      out[x * 3 + 1] = p0[1] * iwx + p1[1] * wx;
      out[x * 3 + 2] = p0[2] * iwx + p1[2] * wx;
    }
  };

  for (int y = 0; y < nh; ++y) {
    const float fy = y * sy;
    int y0 = int(fy);
    if (y0 > src.h - 1) y0 = src.h - 1;
    const int y1 = y0 + 1 < src.h ? y0 + 1 : y0;
    const int wy = int((fy - y0) * 256.f + 0.5f), iwy = 256 - wy;
    if (cachedA != y0) {
      if (cachedB == y0) {
        std::swap(rowA, rowB);
        std::swap(cachedA, cachedB);
      } else {
        hpass(y0, rowA);
        cachedA = y0;
      }
    }
    if (cachedB != y1) {
      hpass(y1, rowB);
      cachedB = y1;
    }
    uint8_t* drow = out + size_t(y) * row_stride;
    const int n3 = nw * 3;
    for (int i = 0; i < n3; ++i) {
      drow[i] = uint8_t((rowA[i] * iwy + rowB[i] * wy + (1 << 15)) >> 16);
    }
  }
}

void resize_bilinear(const Image& src, int nh, int nw, Image* dst) {
  dst->h = nh;
  dst->w = nw;
  dst->data.resize(size_t(nh) * nw * 3);
  resize_bilinear_into(src, nh, nw, dst->data.data(), size_t(nw) * 3);
}

// (nh, nw) of a short-side resize to load_size; (h, w) if load_size <= 0.
void short_side_dims(const Image& img, int load_size, int* nh, int* nw) {
  if (load_size <= 0) {
    *nh = img.h;
    *nw = img.w;
  } else if (img.w < img.h) {
    *nw = load_size;
    *nh = int(0.5 + double(load_size) * img.h / img.w);
  } else {
    *nh = load_size;
    *nw = int(0.5 + double(load_size) * img.w / img.h);
  }
}

void short_side_resize(Image* img, int load_size) {
  if (load_size <= 0) return;
  int nh, nw;
  short_side_dims(*img, load_size, &nh, &nw);
  if (nh == img->h && nw == img->w) return;
  Image out;
  resize_bilinear(*img, nh, nw, &out);
  *img = std::move(out);
}

// xorshift64* — deterministic per-clip crop offsets from a seed.
uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

}  // namespace

extern "C" {

// Decode one image; returns (h, w) without pixel output. 0 on success.
int vf_image_size(const char* path, int* h, int* w) {
  // A C++ exception must never cross the extern "C" / ctypes boundary (UB).
  try {
    Image img;
    if (!decode_file(path, &img)) return 1;
    *h = img.h;
    *w = img.w;
    return 0;
  } catch (...) {
    return 1;
  }
}

// Decode + short-side-resize `n` single frames in parallel (the wholeim /
// logo donkeys' heavy per-sample work, datavid/donkey_wholeim.lua:141-216 —
// full-frame decode, no crop: the translate/slice geometry is data-dependent
// and stays with the caller).  out[i] is a max_h*max_w*3 slot, frame rows
// packed at stride max_w*3 from the top-left; hw[i*2..] = (h, w) after the
// resize, (0, 0) on failure (decode error or resized frame exceeding the
// slot).  Returns the number of failed frames; the caller Python-decodes
// those with identical error semantics to the clip path.
int vf_load_frames(const char** paths, int n, int load_size, int max_h,
                   int max_w, uint8_t* out, int* hw, int n_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t slot = size_t(max_h) * max_w * 3;

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      // Per-item exception containment: an uncaught std::bad_alloc (e.g.
      // an extreme-aspect frame whose resize needs gigabytes) inside a
      // std::thread would std::terminate the whole host process; count the
      // frame failed instead — the Python fallback owns it, matching the
      // documented per-item failure contract.
      try {
        Image img;
        int nh = 0, nw = 0;
        bool ok = decode_file(paths[i], &img);
        if (ok) {
          short_side_dims(img, load_size, &nh, &nw);
          ok = nh <= max_h && nw <= max_w;
        }
        uint8_t* dst = out + slot * i;
        if (!ok) {
          hw[i * 2 + 0] = 0;
          hw[i * 2 + 1] = 0;
          failures.fetch_add(1);
          continue;
        }
        hw[i * 2 + 0] = nh;
        hw[i * 2 + 1] = nw;
        if (nh == img.h && nw == img.w) {  // no resize: copy rows to slot
          for (int y = 0; y < nh; ++y) {
            memcpy(dst + size_t(y) * max_w * 3,
                   img.data.data() + size_t(y) * nw * 3, size_t(nw) * 3);
          }
        } else {  // resize straight into the strided slot — no temp frame
          resize_bilinear_into(img, nh, nw, dst, size_t(max_w) * 3);
        }
      } catch (...) {
        hw[i * 2 + 0] = 0;
        hw[i * 2 + 1] = 0;
        failures.fetch_add(1);
      }
    }
  };

  int nt = n_threads > 0 ? n_threads : int(std::thread::hardware_concurrency());
  if (nt > n) nt = n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return failures.load();
}

// Load `n_clips` clips of `frames` files each (paths flat, row-major).
// Per clip: decode frames, short-side resize to load_size, apply ONE random
// crop (seeded) shared by all frames, write channel-folded uint8 to
// out[n_clips][crop][crop][frames*3].  offsets[n_clips*4] out: y, x,
// resized_h, resized_w (so the caller can crop its mask identically).
// Returns number of failed clips (their slots are zeroed).
int vf_load_clips(const char** paths, int n_clips, int frames, int load_size,
                  int crop, const uint64_t* seeds, uint8_t* out,
                  int* offsets, int n_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t clip_bytes = size_t(crop) * crop * frames * 3;

  auto worker = [&]() {
    for (int ci = next.fetch_add(1); ci < n_clips; ci = next.fetch_add(1)) {
      uint8_t* dst = out + clip_bytes * ci;
      // Same per-item exception containment as vf_load_frames: a bad_alloc
      // escaping this std::thread would std::terminate the host process.
      try {
      uint64_t seed = seeds[ci] ? seeds[ci] : 0x9E3779B97F4A7C15ULL;
      bool ok = true;
      int y0 = 0, x0 = 0, rh = 0, rw = 0;
      std::vector<Image> imgs(frames);
      for (int fi = 0; fi < frames && ok; ++fi) {
        ok = decode_file(paths[ci * frames + fi], &imgs[fi]);
        if (ok) short_side_resize(&imgs[fi], load_size);
      }
      if (ok) {
        rh = imgs[0].h;
        rw = imgs[0].w;
        for (int fi = 1; fi < frames; ++fi)
          if (imgs[fi].h != rh || imgs[fi].w != rw) ok = false;
        if (rh < crop || rw < crop) ok = false;
      }
      if (ok) {
        // Lua parity: math.ceil(torch.uniform(1e-2, iH-oH)) is 1..iH-oH
        // 1-based == 0..iH-oH-1 0-based — the extreme offset never occurs.
        y0 = rh <= crop ? 0 : int(xorshift(&seed) % uint64_t(rh - crop));
        x0 = rw <= crop ? 0 : int(xorshift(&seed) % uint64_t(rw - crop));
        // channel-fold: out[y][x][fi*3+c]
        for (int y = 0; y < crop; ++y) {
          for (int fi = 0; fi < frames; ++fi) {
            const uint8_t* srow =
                imgs[fi].data.data() + (size_t(y0 + y) * rw + x0) * 3;
            uint8_t* drow = dst + (size_t(y) * crop) * frames * 3 + fi * 3;
            for (int x = 0; x < crop; ++x) {
              drow[x * frames * 3 + 0] = srow[x * 3 + 0];
              drow[x * frames * 3 + 1] = srow[x * 3 + 1];
              drow[x * frames * 3 + 2] = srow[x * 3 + 2];
            }
          }
        }
      } else {
        memset(dst, 0, clip_bytes);
        failures.fetch_add(1);
        // offsets.resized_h == 0 is the per-clip failure flag; rh/rw may
        // have been set before a size-check failure, so clear explicitly.
        y0 = x0 = rh = rw = 0;
      }
      if (offsets) {
        offsets[ci * 4 + 0] = y0;
        offsets[ci * 4 + 1] = x0;
        offsets[ci * 4 + 2] = rh;
        offsets[ci * 4 + 3] = rw;
      }
      } catch (...) {
        memset(dst, 0, clip_bytes);
        failures.fetch_add(1);
        if (offsets) {
          offsets[ci * 4 + 0] = offsets[ci * 4 + 1] = 0;
          offsets[ci * 4 + 2] = offsets[ci * 4 + 3] = 0;
        }
      }
    }
  };

  int nt = n_threads > 0 ? n_threads : int(std::thread::hardware_concurrency());
  if (nt > n_clips) nt = n_clips;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return failures.load();
}

}  // extern "C"
