// deplex_tpu_torch native runtime: host-side PNG16 decode and back-projection.
//
// The subset of PNG that depth sensors write: 16-bit (and 8-bit) grayscale,
// non-interlaced, filter types 0-4, decoded straight into a caller-provided
// buffer; plus a fused uint16 -> float32 organized-cloud back-projection.
// Exposed to Python through ctypes (deplex_tpu_torch/native/__init__.py),
// with a plain C interface; the calls release the interpreter lock, so
// decoding threads overlap.
//
// zlib is reached through the one function the decoder needs, uncompress(),
// declared below and resolved against the runtime's libz.so.1: no zlib
// header and no libz.so development link are needed to build.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread deplex_native.cpp
//            deplex_loader.cpp /path/to/libz.so.1

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

// zlib's one-shot inflate (zlib.h): Z_OK (0) on success, *dest_len set to
// the bytes written.
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source, unsigned long source_len);

namespace {

constexpr unsigned char kPngMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
};

// Parse chunks, collect IDAT, return header info. Returns 0 on success.
int parse_png(const unsigned char* data, size_t size, PngInfo* info,
              std::vector<unsigned char>* idat) {
  if (size < 8 || std::memcmp(data, kPngMagic, 8) != 0) return -1;  // not a PNG
  size_t pos = 8;
  bool saw_ihdr = false, saw_iend = false;
  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const unsigned char* type = data + pos + 4;
    pos += 8;
    if (pos + len + 4 > size) return -2;  // truncated chunk
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return -3;
      info->width = be32(data + pos);
      info->height = be32(data + pos + 4);
      info->bit_depth = data[pos + 8];
      info->color_type = data[pos + 9];
      info->interlace = data[pos + 12];
      saw_ihdr = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), data + pos, data + pos + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      saw_iend = true;
      break;
    }
    pos += len + 4;  // skip data + CRC (integrity left to transport, like stb)
  }
  if (!saw_ihdr || !saw_iend) return -4;
  return 0;
}

// Inflate the concatenated IDAT stream in one call; its raw size is known
// (height rows of one filter byte + row bytes), and must come out exactly.
int inflate_idat(const std::vector<unsigned char>& idat, unsigned char* out,
                 size_t out_size) {
  unsigned long n = static_cast<unsigned long>(out_size);
  int ret = uncompress(out, &n, idat.data(), static_cast<unsigned long>(idat.size()));
  return (ret == 0 && n == out_size) ? 0 : -2;
}

// Undo PNG scanline filters in place over the raw (filter byte + row) stream.
int unfilter(unsigned char* raw, uint32_t height, size_t row_bytes, int bpp) {
  unsigned char* prev = nullptr;
  for (uint32_t y = 0; y < height; ++y) {
    unsigned char* line = raw + y * (row_bytes + 1);
    int filter = line[0];
    unsigned char* cur = line + 1;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < row_bytes; ++i) cur[i] = cur[i] + cur[i - bpp];
        break;
      case 2:  // Up
        if (prev)
          for (size_t i = 0; i < row_bytes; ++i) cur[i] = cur[i] + prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < row_bytes; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = cur[i] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < row_bytes; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
          cur[i] = cur[i] + paeth(a, b, c);
        }
        break;
      default:
        return -1;
    }
    prev = cur;
  }
  return 0;
}

}  // namespace

extern "C" {

// Read the (width, height) of a grayscale PNG. Returns 0 on success.
int deplex_png16_info(const unsigned char* data, size_t size, uint32_t* width,
                      uint32_t* height) {
  PngInfo info;
  std::vector<unsigned char> idat;
  int rc = parse_png(data, size, &info, &idat);
  if (rc != 0) return rc;
  *width = info.width;
  *height = info.height;
  return 0;
}

// Decode a grayscale (color type 0) non-interlaced PNG of bit depth 8 or 16
// into out[width*height] uint16 (8-bit samples are widened, not scaled).
// Returns 0 on success, negative error code otherwise: -5 colour or
// interlaced, -6 another bit depth (formats the caller may decode another
// way), -1..-4 not a PNG or truncated, -7 out too small, -8 bad zlib data,
// -9 bad filter type.
int deplex_png16_decode(const unsigned char* data, size_t size, uint16_t* out,
                        size_t out_capacity) {
  PngInfo info;
  std::vector<unsigned char> idat;
  int rc = parse_png(data, size, &info, &idat);
  if (rc != 0) return rc;
  if (info.color_type != 0 || info.interlace != 0) return -5;  // unsupported
  if (info.bit_depth != 8 && info.bit_depth != 16) return -6;
  size_t n = size_t(info.width) * info.height;
  if (out_capacity < n) return -7;

  int bpp = info.bit_depth / 8;
  size_t row_bytes = size_t(info.width) * bpp;
  std::vector<unsigned char> raw((row_bytes + 1) * info.height);
  rc = inflate_idat(idat, raw.data(), raw.size());
  if (rc != 0) return -8;
  if (unfilter(raw.data(), info.height, row_bytes, bpp) != 0) return -9;

  for (uint32_t y = 0; y < info.height; ++y) {
    const unsigned char* cur = raw.data() + y * (row_bytes + 1) + 1;
    uint16_t* dst = out + size_t(y) * info.width;
    if (info.bit_depth == 16) {
      for (uint32_t x = 0; x < info.width; ++x)
        dst[x] = (uint16_t(cur[2 * x]) << 8) | cur[2 * x + 1];  // PNG is BE
    } else {
      for (uint32_t x = 0; x < info.width; ++x) dst[x] = cur[x];
    }
  }
  return 0;
}

// Fused pinhole back-projection: uint16 depth (H, W) -> float32 (H*W, 3)
// organized cloud, x=(u-cx)/fx*z, y=(v-cy)/fy*z, z raw units, in the operation
// order of utils/depth_image.backproject.
void deplex_backproject(const uint16_t* depth, uint32_t height, uint32_t width,
                        float fx, float fy, float cx, float cy, float* out) {
  for (uint32_t v = 0; v < height; ++v) {
    float yv = (float(v) - cy) / fy;
    const uint16_t* row = depth + size_t(v) * width;
    float* dst = out + size_t(v) * width * 3;
    for (uint32_t u = 0; u < width; ++u) {
      float z = float(row[u]);
      dst[3 * u + 0] = (float(u) - cx) / fx * z;
      dst[3 * u + 1] = yv * z;
      dst[3 * u + 2] = z;
    }
  }
}

}  // extern "C"
