// Native image decode (JPEG via libjpeg, PNG via libpng) fused with the
// preprocess kernel in preprocess.cpp: bytes -> RGB -> shorter-side resize ->
// center crop -> [-1, 1] float32, all in one C call.
//
// This completes the native replacement for the reference's PIL pipeline
// (src/data_utils.py:24-30): the Python path decodes with PIL and only the
// resize/crop/normalize ran natively; here the decode itself is native too.
// JPEG decode optionally uses libjpeg's DCT scaling (scale_denom in
// {2,4,8}) to decode directly at a reduced size when the target is much
// smaller than the source — the decoder then does proportionally less IDCT
// work, the classic fast path PIL does not use by default.
//
// Unsupported inputs (CMYK JPEGs, exotic PNG formats, other containers)
// return a nonzero code and the Python caller falls back to PIL.

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" int vcd_preprocess_image(const uint8_t* src, int sh, int sw,
                                    int sc, float* dst, int out_res);

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void jpeg_err_silent(j_common_ptr, int) {}
void jpeg_err_silent_msg(j_common_ptr) {}

// Decode JPEG bytes to RGB. When allow_dct_scale and target_short > 0, pick
// the largest scale_denom in {1,2,4,8} that keeps the decoded shorter side
// >= target_short, so downstream resampling still downsamples.
int decode_jpeg(const uint8_t* bytes, size_t n, int target_short,
                int allow_dct_scale, std::vector<uint8_t>* out, int* h,
                int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_err_silent;
  jerr.pub.output_message = jpeg_err_silent_msg;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 10;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(bytes),
               static_cast<unsigned long>(n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 11;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr -> RGB in-decoder
  if (allow_dct_scale && target_short > 0) {
    const unsigned int short_side =
        std::min(cinfo.image_width, cinfo.image_height);
    unsigned int denom = 1;
    while (denom < 8 &&
           short_side / (denom * 2) >= static_cast<unsigned>(target_short)) {
      denom *= 2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 12;
  }
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  out->resize(static_cast<size_t>(*h) * *w * 3);
  const size_t row_stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + cinfo.output_scanline * row_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_png(const uint8_t* bytes, size_t n, std::vector<uint8_t>* out,
               int* h, int* w) {
  png_image pimg;
  std::memset(&pimg, 0, sizeof(pimg));
  pimg.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pimg, bytes, n)) return 20;
  pimg.format = PNG_FORMAT_RGB;  // palette/gray/alpha all converted
  out->resize(PNG_IMAGE_SIZE(pimg));
  if (!png_image_finish_read(&pimg, nullptr, out->data(), 0, nullptr)) {
    png_image_free(&pimg);
    return 21;
  }
  *w = static_cast<int>(pimg.width);
  *h = static_cast<int>(pimg.height);
  return 0;
}

}  // namespace

extern "C" {

// bytes -> decoded RGB -> preprocess to (out_res, out_res, 3) float32 in
// [-1, 1]. allow_dct_scale enables JPEG reduced-size decode (faster; the
// resample filter still runs, from a 1/2-1/8 decoded image). Returns 0 on
// success; 3 = unrecognized container; 1x/2x = decoder failure (caller
// should fall back to a Python decoder).
int vcd_decode_preprocess(const uint8_t* bytes, long n, float* dst,
                          int out_res, int allow_dct_scale) {
  if (!bytes || n < 8 || !dst || out_res <= 0) return 1;
  std::vector<uint8_t> rgb;
  int h = 0, w = 0, rc;
  if (bytes[0] == 0xFF && bytes[1] == 0xD8 && bytes[2] == 0xFF) {
    rc = decode_jpeg(bytes, static_cast<size_t>(n), out_res, allow_dct_scale,
                     &rgb, &h, &w);
  } else if (bytes[0] == 0x89 && bytes[1] == 'P' && bytes[2] == 'N' &&
             bytes[3] == 'G') {
    rc = decode_png(bytes, static_cast<size_t>(n), &rgb, &h, &w);
  } else {
    return 3;
  }
  if (rc != 0) return rc;
  return vcd_preprocess_image(rgb.data(), h, w, 3, dst, out_res);
}

}  // extern "C"
