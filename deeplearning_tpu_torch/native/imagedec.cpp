// Native JPEG decode (+ optional fused bilinear resize) batch worker.
//
// The reference's input pipeline leans on native decode underneath
// torchvision/cv2 (YOLOX setup_env.py configures cv2 threads; swin's
// zipreader feeds PIL from zip bytes). This is the TPU-era equivalent:
// a C-ABI libjpeg path the Python DataLoader calls via ctypes, decoding
// off the GIL with its own thread pool so one host core can still keep
// the feed ahead of the device. Plain C ABI (no pybind11 in the image).
//
// Exported:
//   decode_jpeg_info(buf, len, &w, &h)      -> 0 ok
//   decode_jpeg(buf, len, out, cap)         -> 0 ok (RGB8, w*h*3 bytes)
//   decode_resize_batch(bufs, lens, n, oh, ow, out, n_threads) -> #errors
//     (each output slot oh*ow*3 RGB8; failed decodes are zero-filled)

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jump, 1);
}

int decode_rgb(const uint8_t* buf, long len, std::vector<uint8_t>* out,
               int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// half-pixel-center bilinear (the cv2/PIL "linear" convention)
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* d = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

int decode_jpeg_info(const uint8_t* buf, long len, int* w, int* h) {
  // header-only: this runs before EVERY single-image decode (the Python
  // wrapper sizes its output buffer from it), so no scanline work here
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_jpeg(const uint8_t* buf, long len, uint8_t* out, long cap) {
  std::vector<uint8_t> tmp;
  int w = 0, h = 0;
  if (decode_rgb(buf, len, &tmp, &w, &h)) return 1;
  if (static_cast<long>(tmp.size()) > cap) return 2;
  std::memcpy(out, tmp.data(), tmp.size());
  return 0;
}

int decode_resize_batch(const uint8_t** bufs, const long* lens, int n,
                        int out_h, int out_w, uint8_t* out, int n_threads) {
  std::atomic<int> next(0), errs(0);
  const size_t slot = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    std::vector<uint8_t> tmp;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int w = 0, h = 0;
      uint8_t* dst = out + slot * i;
      if (decode_rgb(bufs[i], lens[i], &tmp, &w, &h)) {
        errs.fetch_add(1);
        std::memset(dst, 0, slot);
        continue;
      }
      resize_bilinear(tmp.data(), w, h, dst, out_w, out_h);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return errs.load();
}

}  // extern "C"
