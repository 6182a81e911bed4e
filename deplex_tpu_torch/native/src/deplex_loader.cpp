// deplex_tpu_torch native runtime: threaded depth-sequence loader.
//
// A worker pool decodes the PNGs of a sequence into an ordered, bounded
// ring of slots, so the caller always finds the next frame ready:
// create -> next / next_cloud (blocking, in order) -> destroy. Frames whose
// size is not the loader's fail with -10. Exposed through ctypes
// (deplex_tpu_torch/native/__init__.py); built into the same library as
// deplex_native.cpp.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int deplex_png16_decode(const unsigned char* data, size_t size,
                                   uint16_t* out, size_t out_capacity);
extern "C" int deplex_png16_info(const unsigned char* data, size_t size,
                                 uint32_t* width, uint32_t* height);
extern "C" void deplex_backproject(const uint16_t* depth, uint32_t height,
                                   uint32_t width, float fx, float fy,
                                   float cx, float cy, float* out);

namespace {

struct Slot {
  std::vector<uint16_t> depth;
  int status = 0;  // 0 = empty, 1 = ready, negative = error code
};

struct Loader {
  std::vector<std::string> paths;
  uint32_t width = 0, height = 0;
  size_t queue_depth = 0;
  std::vector<Slot> slots;            // ring: frame i -> slot i % queue_depth
  size_t next_to_consume = 0;         // consumer cursor
  size_t next_to_produce = 0;         // next frame index workers may claim
  bool stopping = false;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_free;    // workers wait for slot freed
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stopping || next_to_produce >= paths.size()) return;
        idx = next_to_produce++;
      }
      // Decode outside the lock.
      std::ifstream f(paths[idx], std::ios::binary);
      std::vector<unsigned char> bytes((std::istreambuf_iterator<char>(f)),
                                       std::istreambuf_iterator<char>());
      std::vector<uint16_t> depth(size_t(width) * height);
      uint32_t w = 0, h = 0;
      int rc = -100;  // unreadable file
      if (!bytes.empty()) {
        rc = deplex_png16_info(bytes.data(), bytes.size(), &w, &h);
        if (rc == 0 && (w != width || h != height)) rc = -10;
        if (rc == 0)
          rc = deplex_png16_decode(bytes.data(), bytes.size(), depth.data(),
                                   depth.size());
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        // Wait until the ring slot for this frame is free (consumer has
        // taken frame idx - queue_depth).
        cv_free.wait(lk, [&] {
          return stopping || idx < next_to_consume + queue_depth;
        });
        if (stopping) return;
        Slot& s = slots[idx % queue_depth];
        s.depth = std::move(depth);
        s.status = rc == 0 ? 1 : (rc < 0 ? rc : -1);
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// paths: concatenated NUL-separated UTF-8 strings. Returns handle or null.
void* deplex_loader_create(const char* paths_blob, size_t blob_len,
                           int n_paths, uint32_t width, uint32_t height,
                           int queue_depth, int n_workers) {
  auto* L = new Loader();
  const char* p = paths_blob;
  const char* end = paths_blob + blob_len;
  for (int i = 0; i < n_paths && p < end; ++i) {
    size_t len = strnlen(p, size_t(end - p));
    L->paths.emplace_back(p, len);
    p += len + 1;
  }
  if ((int)L->paths.size() != n_paths) {
    delete L;
    return nullptr;
  }
  L->width = width;
  L->height = height;
  L->queue_depth = queue_depth > 0 ? size_t(queue_depth) : 4;
  L->slots.resize(L->queue_depth);
  int nw = n_workers > 0 ? n_workers : 2;
  for (int i = 0; i < nw; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking: copies the next frame (in sequence order) into out[width*height].
// Returns 0 ok, 1 end-of-sequence, negative decode error.
int deplex_loader_next(void* handle, uint16_t* out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_consume >= L->paths.size()) return 1;
  size_t idx = L->next_to_consume;
  Slot& s = L->slots[idx % L->queue_depth];
  L->cv_ready.wait(lk, [&] { return s.status != 0; });
  int rc = s.status == 1 ? 0 : s.status;
  if (rc == 0)
    std::memcpy(out, s.depth.data(), s.depth.size() * sizeof(uint16_t));
  s.status = 0;
  s.depth.clear();
  L->next_to_consume++;
  L->cv_free.notify_all();
  return rc;
}

// Blocking: next frame back-projected to an organized cloud (H*W x 3 f32).
int deplex_loader_next_cloud(void* handle, float fx, float fy, float cx,
                             float cy, float* out_xyz) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<uint16_t> tmp(size_t(L->width) * L->height);
  int rc = deplex_loader_next(handle, tmp.data());
  if (rc != 0) return rc;
  deplex_backproject(tmp.data(), L->height, L->width, fx, fy, cx, cy, out_xyz);
  return 0;
}

void deplex_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stopping = true;
    L->cv_free.notify_all();
    L->cv_ready.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
