// frameloader — native streaming frame source for the preprocessing engine.
//
// Role: the host-side data path the reference leaves to its consumers (OpenCV
// VideoCapture / cudaMemcpy2DAsync staging, e.g. tests/resize/
// test_fused_resize.cu:40-46). Here it is a first-class native component:
// raw NV12 / packed-RGB frame sequences are read from disk by a background
// prefetch thread into an aligned ring of reusable buffers, so the Python/JAX
// side always has the next frame host-resident (zero-copy numpy view) while
// the device crunches the previous one.
//
// C ABI (ctypes-consumed; see cvgpuspeedup_tpu/utils/frameloader.py):
//   flv_open(path, frame_bytes, ring_depth) -> handle (or 0 on error)
//   flv_frame_count(h)                      -> total frames in file
//   flv_next(h, &index)                     -> ptr to frame payload (blocks
//                                              until prefetched; NULL at EOF)
//   flv_release(h, ptr)                     -> recycle the ring slot
//   flv_close(h)
//   flv_last_error()                        -> static string
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kAlign = 4096;  // page-aligned buffers: DMA/pin friendly

struct Slot {
  uint8_t* data = nullptr;
  int64_t index = -1;
  bool ready = false;
};

struct Loader {
  FILE* file = nullptr;
  size_t frame_bytes = 0;
  int64_t total_frames = 0;
  int64_t next_to_read = 0;

  std::vector<Slot> ring;
  std::deque<int> free_slots;   // slots available for prefetch
  std::deque<int> ready_slots;  // prefetched, in order
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread worker;
  std::atomic<bool> stop{false};

  ~Loader() {
    stop.store(true);
    cv_free.notify_all();
    if (worker.joinable()) worker.join();
    for (auto& s : ring) ::free(s.data);
    if (file) fclose(file);
  }
};

thread_local std::string g_error;

void prefetch_loop(Loader* L) {
  for (;;) {
    int slot;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] { return L->stop.load() || !L->free_slots.empty(); });
      if (L->stop.load()) return;
      if (L->next_to_read >= L->total_frames) return;  // EOF: stop prefetching
      slot = L->free_slots.front();
      L->free_slots.pop_front();
      // publish the claim under the lock: flv_next's wait predicate reads
      // slot indices and next_to_read to detect in-flight work, so both
      // must be updated while the mutex is held (no claimed-but-unindexed
      // window -> no premature-EOF race)
      L->ring[slot].index = L->next_to_read++;
    }
    Slot& s = L->ring[slot];
    size_t got = fread(s.data, 1, L->frame_bytes, L->file);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      if (got == L->frame_bytes) {
        s.ready = true;
        L->ready_slots.push_back(slot);
      } else {
        // short read: treat as EOF
        L->total_frames = s.index;
        s.index = -1;
        L->free_slots.push_back(slot);
      }
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* flv_open(const char* path, uint64_t frame_bytes, int ring_depth) {
  if (frame_bytes == 0 || ring_depth < 1) {
    g_error = "frame_bytes must be > 0 and ring_depth >= 1";
    return nullptr;
  }
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_error = std::string("cannot open ") + path;
    return nullptr;
  }
  fseeko(f, 0, SEEK_END);
  int64_t size = ftello(f);
  fseeko(f, 0, SEEK_SET);

  auto* L = new Loader();
  L->file = f;
  L->frame_bytes = frame_bytes;
  L->total_frames = size / static_cast<int64_t>(frame_bytes);
  L->ring.resize(ring_depth);
  for (int i = 0; i < ring_depth; ++i) {
    void* p = nullptr;
    if (posix_memalign(&p, kAlign, frame_bytes) != 0) {
      g_error = "allocation failed";
      delete L;
      return nullptr;
    }
    L->ring[i].data = static_cast<uint8_t*>(p);
    L->free_slots.push_back(i);
  }
  L->worker = std::thread(prefetch_loop, L);
  return L;
}

int64_t flv_frame_count(void* h) {
  return h ? static_cast<Loader*>(h)->total_frames : -1;
}

const uint8_t* flv_next(void* h, int64_t* index_out) {
  auto* L = static_cast<Loader*>(h);
  if (!L) return nullptr;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    if (!L->ready_slots.empty()) return true;
    // nothing ready and nothing left to read -> EOF
    bool exhausted = L->next_to_read >= L->total_frames;
    bool in_flight = false;
    for (auto& s : L->ring)
      if (s.index >= 0 && !s.ready && s.index < L->total_frames) in_flight = true;
    return exhausted && !in_flight;
  });
  if (L->ready_slots.empty()) return nullptr;  // EOF
  int slot = L->ready_slots.front();
  L->ready_slots.pop_front();
  if (index_out) *index_out = L->ring[slot].index;
  return L->ring[slot].data;
}

void flv_release(void* h, const uint8_t* ptr) {
  auto* L = static_cast<Loader*>(h);
  if (!L || !ptr) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    for (size_t i = 0; i < L->ring.size(); ++i) {
      if (L->ring[i].data == ptr) {
        L->ring[i].ready = false;
        L->ring[i].index = -1;
        L->free_slots.push_back(static_cast<int>(i));
        break;
      }
    }
  }
  L->cv_free.notify_all();
}

void flv_close(void* h) { delete static_cast<Loader*>(h); }

const char* flv_last_error() { return g_error.c_str(); }

}  // extern "C"
