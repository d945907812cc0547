// Native dataset loader: threaded PNG decode + half-resolution resize.
//
// The reference's Dataset::NextFrame (src/dataset.cpp:53-86) decodes two
// PNGs and resizes them synchronously on the tracking thread via OpenCV.
// Here decode/resize runs in a worker pool that prefetches ahead of the
// consumer, so host I/O overlaps device compute; frames are handed out
// strictly in order.  Exposed as a small C API consumed via ctypes
// (legoslam_tpu_torch/native/loader.py).  The port's copy of the JAX
// package's loader: the same C API and behaviour, with PNG decoding on
// zlib alone (no libpng), so it builds wherever zlib's header is present,
// and a loader opened at `start` > 0 hands out `start` first (the JAX
// package's waits for frame 0, which it never decodes).
//
// Build: g++ -O3 -shared -fPIC -std=c++14 loader.cpp -o libpngloader.so -lz -lpthread

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> data;  // grayscale 0..255
};

constexpr unsigned char kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out->insert(out->end(), buf, buf + n);
  fclose(f);
  return true;
}

// The five PNG row filters, undone in place; `rows` holds height rows of
// 1 + stride bytes (the filter byte first).
bool unfilter(std::vector<uint8_t>* rows, size_t height, size_t stride, size_t bpp) {
  std::vector<uint8_t> zero(stride, 0);
  for (size_t y = 0; y < height; ++y) {
    uint8_t* row = rows->data() + y * (stride + 1);
    const uint8_t* prior = y ? rows->data() + (y - 1) * (stride + 1) + 1 : zero.data();
    uint8_t* x = row + 1;
    switch (row[0]) {
      case 0: break;
      case 1: for (size_t i = bpp; i < stride; ++i) x[i] = uint8_t(x[i] + x[i - bpp]); break;
      case 2: for (size_t i = 0; i < stride; ++i) x[i] = uint8_t(x[i] + prior[i]); break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? x[i - bpp] : 0;
          x[i] = uint8_t(x[i] + ((a + prior[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? x[i - bpp] : 0, b = prior[i], c = i >= bpp ? prior[i - bpp] : 0;
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          x[i] = uint8_t(x[i] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c)));
        }
        break;
      default: return false;
    }
  }
  return true;
}

// png_set_rgb_to_gray_fixed(png, 1, 29900, 58700) without gamma
// (pngrtran.c): equal channels keep their value, others take 15-bit
// weights, rounded at 16 bits and truncated at 8.
constexpr uint32_t kRed = 29900u * 32768u / 100000u, kGreen = 58700u * 32768u / 100000u,
                   kBlue = 32768u - kRed - kGreen;

uint32_t rgb_to_gray(uint32_t r, uint32_t g, uint32_t b, int depth) {
  if (r == g && r == b) return r;
  uint32_t s = kRed * r + kGreen * g + kBlue * b;
  return depth == 16 ? (s + 16384) >> 15 : s >> 15;
}

// Decode a PNG to grayscale float with libpng's conversions as the JAX
// package's loader configures them (16-bit cut to its high byte, alpha
// dropped, 1/2/4-bit gray scaled to 8 bits, palettes expanded, colour by
// BT.601 luma as cv::IMREAD_GRAYSCALE), parsing the chunks here and
// inflating with zlib.  Interlaced files are refused.
bool decode_png_gray(const char* path, Image* out) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file) || file.size() < 8 || memcmp(file.data(), kSignature, 8) != 0) return false;
  uint32_t width = 0, height = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat, palette;
  for (size_t pos = 8; pos + 8 <= file.size();) {
    uint32_t len = be32(&file[pos]);
    const uint8_t* kind = &file[pos + 4];
    const uint8_t* body = &file[pos + 8];
    if (pos + 12 + size_t(len) > file.size()) return false;
    if (!memcmp(kind, "IHDR", 4) && len >= 13) {
      width = be32(body);
      height = be32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
    } else if (!memcmp(kind, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(kind, "IEND", 4)) {
      break;
    }
    pos += 12 + size_t(len);
  }
  int ch = color == 0 ? 1 : color == 2 ? 3 : color == 3 ? 1 : color == 4 ? 2 : color == 6 ? 4 : 0;
  if (!width || !height || !ch || interlace || idat.empty() || (color == 3 && palette.empty())) return false;
  size_t stride = (size_t(width) * ch * depth + 7) / 8;
  uLongf raw_len = uLongf(height * (stride + 1));
  std::vector<uint8_t> rows(raw_len);
  if (uncompress(rows.data(), &raw_len, idat.data(), uLong(idat.size())) != Z_OK ||
      raw_len != rows.size())
    return false;
  if (!unfilter(&rows, height, stride, std::max<size_t>(1, size_t(ch) * depth / 8))) return false;

  out->width = static_cast<int>(width);
  out->height = static_cast<int>(height);
  out->data.resize(static_cast<size_t>(width) * height);
  const uint32_t low_scale = depth < 8 ? 255u / ((1u << depth) - 1u) : 1u;
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* r = rows.data() + y * (stride + 1) + 1;
    float* dst = out->data.data() + static_cast<size_t>(y) * width;
    for (uint32_t x = 0; x < width; ++x) {
      uint32_t s[4] = {0, 0, 0, 0};
      if (depth == 16) {
        for (int c = 0; c < ch; ++c) s[c] = (uint32_t(r[2 * (x * ch + c)]) << 8) | r[2 * (x * ch + c) + 1];
      } else if (depth == 8) {
        for (int c = 0; c < ch; ++c) s[c] = r[x * ch + c];
      } else {
        size_t bit = size_t(x) * depth;
        s[0] = (r[bit / 8] >> (8 - depth - bit % 8)) & ((1u << depth) - 1u);
      }
      uint32_t g;
      if (color == 3) {
        size_t i = 3 * size_t(s[0]);
        if (i + 2 >= palette.size()) return false;
        g = rgb_to_gray(palette[i], palette[i + 1], palette[i + 2], 8);
      } else if (color == 0 || color == 4) {
        g = depth == 16 ? s[0] >> 8 : s[0] * low_scale;
      } else {
        g = rgb_to_gray(s[0], s[1], s[2], depth);
        if (depth == 16) g >>= 8;
      }
      dst[x] = static_cast<float>(g);
    }
  }
  return true;
}

// cv::resize INTER_NEAREST at exactly 0.5: even rows/cols (dataset.cpp:76).
void nearest_half(const Image& src, Image* dst) {
  dst->width = src.width / 2;
  dst->height = src.height / 2;
  dst->data.resize(static_cast<size_t>(dst->width) * dst->height);
  for (int y = 0; y < dst->height; ++y) {
    const float* s = src.data.data() + static_cast<size_t>(2 * y) * src.width;
    float* d = dst->data.data() + static_cast<size_t>(y) * dst->width;
    for (int x = 0; x < dst->width; ++x) d[x] = s[2 * x];
  }
}

struct Frame {
  int index = -1;
  Image left, right;
  bool ok = false;
};

class Loader {
 public:
  Loader(std::string dir, int start, int count, bool half, int workers, int prefetch)
      : dir_(std::move(dir)), start_(start), count_(count), half_(half), prefetch_(prefetch),
        next_to_consume_(start) {
    next_to_decode_.store(start_);
    for (int i = 0; i < workers; ++i) threads_.emplace_back([this] { Work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Blocking, in-order. Returns false at end of sequence or on decode error.
  bool Next(Frame* out) {
    std::unique_lock<std::mutex> lock(mu_);
    int want = next_to_consume_;
    if (want >= start_ + count_) return false;
    cv_ready_.wait(lock, [&] { return stop_ || ready_.count(want) > 0; });
    if (stop_ && ready_.count(want) == 0) return false;
    *out = std::move(ready_[want]);
    ready_.erase(want);
    ++next_to_consume_;
    cv_space_.notify_all();
    return out->ok;
  }

 private:
  void Work() {
    for (;;) {
      int idx = next_to_decode_.fetch_add(1);
      if (idx >= start_ + count_) return;
      Frame fr;
      fr.index = idx;
      char path[1024];
      Image raw_l, raw_r;
      snprintf(path, sizeof(path), "%s/image_0/%06d.png", dir_.c_str(), idx);
      bool ok_l = decode_png_gray(path, &raw_l);
      snprintf(path, sizeof(path), "%s/image_1/%06d.png", dir_.c_str(), idx);
      bool ok_r = decode_png_gray(path, &raw_r);
      fr.ok = ok_l && ok_r;
      if (fr.ok) {
        if (half_) {
          nearest_half(raw_l, &fr.left);
          nearest_half(raw_r, &fr.right);
        } else {
          fr.left = std::move(raw_l);
          fr.right = std::move(raw_r);
        }
      }
      std::unique_lock<std::mutex> lock(mu_);
      // Bound the prefetch window so memory stays flat.
      cv_space_.wait(lock, [&] { return stop_ || idx < next_to_consume_ + prefetch_; });
      if (stop_) return;
      ready_[idx] = std::move(fr);
      cv_ready_.notify_all();
    }
  }

  std::string dir_;
  int start_, count_;
  bool half_;
  int prefetch_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::map<int, Frame> ready_;
  std::atomic<int> next_to_decode_{0};
  int next_to_consume_;  // the first index handed out is `start`
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* ls_loader_open(const char* dir, int start, int count, int half, int workers, int prefetch) {
  auto* l = new Loader(dir, start, count, half != 0, workers > 0 ? workers : 4,
                       prefetch > 0 ? prefetch : 8);
  return l;
}

// Returns: 1 frame produced, 0 end-of-sequence/failure.  Buffers must hold
// width*height floats (probe the size first: ls_decode_png with no buffer).
int ls_loader_next(void* handle, float* left, float* right, int* frame_index,
                   int* width, int* height, int capacity) {
  auto* l = static_cast<Loader*>(handle);
  Frame fr;
  if (!l->Next(&fr)) return 0;
  int n = fr.left.width * fr.left.height;
  if (n > capacity || fr.right.width != fr.left.width || fr.right.height != fr.left.height)
    return 0;
  memcpy(left, fr.left.data.data(), sizeof(float) * n);
  memcpy(right, fr.right.data.data(), sizeof(float) * n);
  *frame_index = fr.index;
  *width = fr.left.width;
  *height = fr.left.height;
  return 1;
}

void ls_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

// Decode a single PNG (for probing sizes / tests). Returns 1 on success.
int ls_decode_png(const char* path, float* buffer, int capacity, int* width, int* height,
                  int half) {
  Image img;
  if (!decode_png_gray(path, &img)) return 0;
  Image out;
  if (half) {
    nearest_half(img, &out);
  } else {
    out = std::move(img);
  }
  int n = out.width * out.height;
  if (buffer) {
    if (n > capacity) return 0;
    memcpy(buffer, out.data.data(), sizeof(float) * n);
  }
  *width = out.width;
  *height = out.height;
  return 1;
}

}  // extern "C"
