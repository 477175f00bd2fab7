// hostpipe: native host-side frame runtime for the on-device SLAM engine.
//
// The reference leans on OpenCV C++ for its host frame path
// (cv2.cvtColor/resize per frame in the driver loop,
// reference main/run_slam.py:116). The engine's host duties are
// (a) pixel-format conversion + resize feeding device batches and
// (b) keeping the device fed: a threaded producer/consumer frame ring
// so video decode overlaps device compute (the host<->device
// pipelining SURVEY.md §7 calls out).
//
// Plain C ABI for ctypes binding (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RGB(A)/BGR -> grayscale with integer Rec.601 weights, optional
// nearest-neighbor resize, in one pass over the source.
// src: h*w*channels uint8, dst: oh*ow uint8.
void hp_gray_resize(const uint8_t* src, int h, int w, int channels,
                    int swap_rb, uint8_t* dst, int oh, int ow) {
  const int wr = swap_rb ? 29 : 77;   // Rec.601 weights * 256
  const int wg = 150;
  const int wb = swap_rb ? 77 : 29;
  for (int oy = 0; oy < oh; ++oy) {
    const int sy = (int)((int64_t)oy * h / oh);
    const uint8_t* row = src + (int64_t)sy * w * channels;
    uint8_t* out = dst + (int64_t)oy * ow;
    if (channels == 1) {
      for (int ox = 0; ox < ow; ++ox) {
        out[ox] = row[(int)((int64_t)ox * w / ow)];
      }
    } else {
      for (int ox = 0; ox < ow; ++ox) {
        const uint8_t* p = row + (int64_t)((int64_t)ox * w / ow) * channels;
        out[ox] = (uint8_t)((wr * p[0] + wg * p[1] + wb * p[2]) >> 8);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Bounded MPMC frame ring (blocking push/pop), for decode/compute overlap.

struct HpRing {
  std::vector<uint8_t> data;
  std::vector<int64_t> sizes;
  size_t frame_bytes;
  size_t capacity;
  size_t head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
};

void* hp_ring_create(int capacity, int64_t frame_bytes) {
  HpRing* r = new HpRing();
  r->capacity = (size_t)capacity;
  r->frame_bytes = (size_t)frame_bytes;
  r->data.resize((size_t)capacity * frame_bytes);
  r->sizes.resize((size_t)capacity);
  return r;
}

// returns 1 on success, 0 if the ring was closed.
int hp_ring_push(void* handle, const uint8_t* frame, int64_t nbytes) {
  HpRing* r = (HpRing*)handle;
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_full.wait(lk, [&] { return r->count < r->capacity || r->closed; });
  if (r->closed) return 0;
  size_t slot = r->head % r->capacity;
  std::memcpy(r->data.data() + slot * r->frame_bytes, frame,
              (size_t)nbytes);
  r->sizes[slot] = nbytes;
  r->head++;
  r->count++;
  r->not_empty.notify_one();
  return 1;
}

// returns bytes read (>0), 0 when closed AND drained.
int64_t hp_ring_pop(void* handle, uint8_t* out) {
  HpRing* r = (HpRing*)handle;
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_empty.wait(lk, [&] { return r->count > 0 || r->closed; });
  if (r->count == 0) return 0;  // closed and drained
  size_t slot = r->tail % r->capacity;
  int64_t n = r->sizes[slot];
  std::memcpy(out, r->data.data() + slot * r->frame_bytes, (size_t)n);
  r->tail++;
  r->count--;
  r->not_full.notify_one();
  return n;
}

void hp_ring_close(void* handle) {
  HpRing* r = (HpRing*)handle;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->not_full.notify_all();
  r->not_empty.notify_all();
}

void hp_ring_destroy(void* handle) { delete (HpRing*)handle; }

int hp_ring_size(void* handle) {
  HpRing* r = (HpRing*)handle;
  std::lock_guard<std::mutex> lk(r->mu);
  return (int)r->count;
}

}  // extern "C"
