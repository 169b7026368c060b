// Native stereo-frame loader: libpng decode + downsample + prefetch threads.
//
// The port's own copy of the JAX package's native/dataloader.cpp, with the
// same C ABI. The C++ system reads each frame with cv::imread and
// cv::resize on its main loop; here PNG decode and the 2x nearest-neighbour
// decimation run in a worker-thread pool that stays ahead of the consumer,
// so the host-side image feed does not stall the device. C ABI for ctypes.
//
// Build (io/native_loader.py does it at first use):
//   g++ -O3 -fPIC -std=c++17 -shared -o libsvslam_loader.so dataloader.cpp \
//       -lpng -lpthread

#include <png.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Decode an 8/16-bit PNG (gray or RGB) to float32 grayscale with optional
// integer decimation. Returns false on any error.
bool decode_png_gray(const char* path, int downsample, std::vector<float>& out,
                     int* out_h, int* out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);

  // normalize to 8-bit gray
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color_type == PNG_COLOR_TYPE_RGB ||
      color_type == PNG_COLOR_TYPE_RGB_ALPHA ||
      color_type == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray(png, 1 /* error_action: silent */, -1.0, -1.0);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  const int d = downsample > 0 ? downsample : 1;
  const int oh = static_cast<int>(height) / d;
  const int ow = static_cast<int>(width) / d;
  out.resize(static_cast<size_t>(oh) * ow);

  int out_row = 0;
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (static_cast<int>(y) % d == 0 && out_row < oh) {
      float* dst = out.data() + static_cast<size_t>(out_row) * ow;
      for (int x = 0; x < ow; ++x) dst[x] = static_cast<float>(row[x * d]);
      ++out_row;
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_h = oh;
  *out_w = ow;
  return true;
}

struct Slot {
  std::vector<float> left, right;
  int h = 0, w = 0;
  int frame_id = -1;
  bool ok = false;
  bool ready = false;
};

struct Loader {
  std::string left_dir, right_dir;
  int downsample = 2;
  int n_slots = 4;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<int> end_fid{1 << 30};  // first known-missing frame id
  int next_to_load = 0;   // next frame id a worker should fetch
  std::vector<std::thread> workers;

  std::string path_for(const std::string& dir, int id) const {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "/%06d.png", id);
    return dir + buf;
  }

  void worker() {
    while (!stop.load()) {
      int fid;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        // claim the next frame; don't prefetch past the known end
        fid = next_to_load;
        slot = &slots[fid % n_slots];
        // a slot is claimable only when free (frame_id == -1): in-flight and
        // decoded-but-unconsumed frames must never be overwritten
        if (fid >= end_fid.load() || slot->frame_id != -1) {
          cv.wait_for(lk, std::chrono::milliseconds(20));
          continue;
        }
        slot->frame_id = fid;
        slot->ready = false;
        next_to_load++;
      }
      int h = 0, w = 0;
      bool ok = decode_png_gray(path_for(left_dir, fid).c_str(), downsample,
                                slot->left, &h, &w);
      if (ok)
        ok = decode_png_gray(path_for(right_dir, fid).c_str(), downsample,
                             slot->right, &h, &w);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->h = h;
        slot->w = w;
        slot->ok = ok;
        slot->ready = true;
        if (!ok) {
          // first missing frame marks the end of the sequence; frames
          // already claimed below it still finish decoding
          int cur = end_fid.load();
          while (fid < cur && !end_fid.compare_exchange_weak(cur, fid)) {
          }
        }
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* svslam_loader_create(const char* left_dir, const char* right_dir,
                           int downsample, int n_prefetch, int n_threads) {
  auto* L = new Loader();
  L->left_dir = left_dir;
  L->right_dir = right_dir;
  L->downsample = downsample;
  L->n_slots = n_prefetch > 1 ? n_prefetch : 2;
  L->slots.resize(L->n_slots);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until frame `fid` is decoded; copies into caller buffers (row-major
// float32 of size max_h*max_w). Returns 1 on success, 0 at end-of-sequence.
// h/w receive the decoded size.
int svslam_loader_get(void* handle, int fid, float* left, float* right,
                      int max_h, int max_w, int* h, int* w) {
  auto* L = static_cast<Loader*>(handle);
  Slot* slot = &L->slots[fid % L->n_slots];
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [&] {
    return (slot->ready && slot->frame_id == fid) ||
           fid >= L->end_fid.load() || L->stop.load();
  });
  if (!(slot->ready && slot->frame_id == fid && slot->ok)) return 0;
  *h = slot->h;
  *w = slot->w;
  if (slot->h > max_h || slot->w > max_w) return 0;
  std::memcpy(left, slot->left.data(), slot->left.size() * sizeof(float));
  std::memcpy(right, slot->right.data(), slot->right.size() * sizeof(float));
  slot->ready = false;
  slot->frame_id = -1;  // free the ring slot for the workers
  lk.unlock();
  L->cv.notify_all();
  return 1;
}

void svslam_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot decode helper (no prefetching) for tools/tests.
int svslam_decode_png(const char* path, int downsample, float* out, int max_h,
                      int max_w, int* h, int* w) {
  std::vector<float> buf;
  if (!decode_png_gray(path, downsample, buf, h, w)) return 0;
  if (*h > max_h || *w > max_w) return 0;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

}  // extern "C"
