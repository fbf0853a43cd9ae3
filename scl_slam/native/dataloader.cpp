// Native data loader: threaded KITTI .bin scan reader with prefetch.
//
// The reference's data path is rosbag replay feeding sensor callbacks
// (launch/test_distributed_loop.launch) — a C++ process decoding and
// queueing scans off the critical path. This is the equivalent here:
// a worker pool reads velodyne .bin files (float32 x,y,z,reflectance),
// pads/truncates into fixed-capacity host buffers (the static-shape
// contract of the device pipeline), and hands them over through a bounded
// ring buffer so disk I/O and host->device transfer overlap with compute.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Scan {
  int64_t index = -1;
  int32_t n_points = 0;  // valid points (<= capacity)
  std::vector<float> xyz; // [capacity * 3], padded with pad_value
};

struct Loader {
  std::vector<std::string> paths;
  int capacity;
  float pad_value;
  int n_workers;

  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  // min-heap by index so scans pop in order
  struct Cmp {
    bool operator()(const Scan* a, const Scan* b) const {
      return a->index > b->index;
    }
  };
  std::priority_queue<Scan*, std::vector<Scan*>, Cmp> ready;
  int64_t next_to_read = 0;   // next file index to claim
  int64_t next_to_pop = 0;    // next index the consumer expects
  size_t max_queue;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    std::lock_guard<std::mutex> lk(mu);
    while (!ready.empty()) { delete ready.top(); ready.pop(); }
  }
};

void worker_main(Loader* L) {
  for (;;) {
    int64_t idx;
    {
      std::lock_guard<std::mutex> lk(L->mu);
      if (L->stop.load() || L->next_to_read >= (int64_t)L->paths.size()) return;
      idx = L->next_to_read++;
    }
    auto* scan = new Scan();
    scan->index = idx;
    scan->xyz.assign((size_t)L->capacity * 3, L->pad_value);

    FILE* f = fopen(L->paths[idx].c_str(), "rb");
    if (f) {
      // velodyne .bin: interleaved float32 x,y,z,r
      std::vector<float> buf(4096 * 4);
      int32_t count = 0;
      size_t got;
      while ((got = fread(buf.data(), sizeof(float), buf.size(), f)) > 0) {
        size_t pts = got / 4;
        for (size_t p = 0; p < pts && count < L->capacity; ++p, ++count) {
          scan->xyz[(size_t)count * 3 + 0] = buf[p * 4 + 0];
          scan->xyz[(size_t)count * 3 + 1] = buf[p * 4 + 1];
          scan->xyz[(size_t)count * 3 + 2] = buf[p * 4 + 2];
        }
        if (count >= L->capacity) break;
      }
      fclose(f);
      scan->n_points = count;
    } else {
      scan->n_points = -1;  // signal read error
    }

    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_space.wait(lk, [&] {
      return L->stop.load() || L->ready.size() < L->max_queue;
    });
    if (L->stop.load()) { delete scan; return; }
    L->ready.push(scan);
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int capacity,
                    float pad_value, int n_workers, int queue_depth) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->capacity = capacity;
  L->pad_value = pad_value;
  L->n_workers = n_workers > 0 ? n_workers : 2;
  L->max_queue = queue_depth > 0 ? (size_t)queue_depth : 4;
  for (int i = 0; i < L->n_workers; ++i)
    L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocking in-order pop. Returns valid point count, -1 on read error,
// -2 when the sequence is exhausted. out_xyz must hold capacity*3 floats.
int loader_next(void* handle, float* out_xyz) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_pop >= (int64_t)L->paths.size()) return -2;
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() && L->ready.top()->index == L->next_to_pop;
  });
  Scan* s = L->ready.top();
  L->ready.pop();
  L->next_to_pop++;
  L->cv_space.notify_all();
  lk.unlock();
  std::memcpy(out_xyz, s->xyz.data(), s->xyz.size() * sizeof(float));
  int n = s->n_points;
  delete s;
  return n;
}

int loader_capacity(void* handle) {
  return static_cast<Loader*>(handle)->capacity;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// ---------------------------------------------------------------------------
// Host-side Scan Context binning (input-pipeline descriptor prep).
//
// Max-height polar binning is scatter-shaped work (the device path is a
// dense [bins, block] compare — scl_slam/ops/pointcloud.py::
// scatter_max_image). On the host it IS a scatter: one pass over the points, ~60 ns/point/core. This
// computes descriptors in the data-loading pipeline so they overlap the
// previous chunk's device compute, the same way the .bin reader above
// overlaps disk I/O.
//
// Semantics mirror ops/pointcloud.py::polar_bins (f32 atan2/sqrt,
// truncating int casts, clip to [0, bins-1], r < max_radius gate,
// min_radius = 0) and scatter_max_image(init=0) over z + lidar_height —
// reference include/descriptor.h:1404-1461. atan2f may differ from XLA's
// atan2 by ~1 ulp, so a point exactly on a sector boundary can land one
// bin over; tests bound the resulting image disagreement.

// Branchless polynomial atan on [0, 1]: minimax degree-11 odd polynomial,
// max error ~2e-7 rad. glibc atan2f is a ~25 ns libm call that blocks
// SIMD; this form auto-vectorizes. A point within ~2e-7 rad of a sector
// boundary (probability ~4e-6 per point at 60 sectors) may land one
// sector over vs the device's atan2 — the same class of boundary drift
// that already exists between glibc and XLA's atan2 lowerings.
static inline float atan_poly01(float t) {
  float t2 = t * t;
  float p = -0.01172120f;
  p = p * t2 + 0.05265332f;
  p = p * t2 + -0.11643287f;
  p = p * t2 + 0.19354346f;
  p = p * t2 + -0.33262347f;
  p = p * t2 + 0.99997726f;
  return p * t;
}

static void sc_bin_frames(const float* xyz, const unsigned char* mask,
                          int64_t b0, int64_t b1, int64_t n,
                          int num_rings, int num_sectors, float max_radius,
                          float lidar_height, float* out) {
  const float kPi = 3.14159274101257324f;       // f32(pi), as jnp.pi casts
  const float kTwoPi = 6.28318548202514648f;    // f32(2*pi)
  const float kHalfPi = 1.57079632679489662f;
  constexpr int64_t kBlock = 4096;
  std::vector<int32_t> idx(kBlock);
  std::vector<float> val(kBlock);
  for (int64_t b = b0; b < b1; ++b) {
    float* img = out + b * num_rings * num_sectors;
    std::memset(img, 0, sizeof(float) * num_rings * num_sectors);
    const float* pts = xyz + b * n * 3;
    const unsigned char* mk = mask ? mask + b * n : nullptr;
    for (int64_t q0 = 0; q0 < n; q0 += kBlock) {
      int64_t m = std::min(kBlock, n - q0);
      // pass 1: branchless bin/value computation (SIMD-friendly)
      for (int64_t i = 0; i < m; ++i) {
        int64_t p = q0 + i;
        float x = pts[p * 3 + 0];
        float y = pts[p * 3 + 1];
        float z = pts[p * 3 + 2];
        float r = sqrtf(x * x + y * y);
        // octant-reduced atan2(y, x)
        float ax = fabsf(x), ay = fabsf(y);
        float num = fminf(ax, ay), den = fmaxf(fmaxf(ax, ay), 1e-30f);
        float a = atan_poly01(num / den);
        a = (ay > ax) ? (kHalfPi - a) : a;
        a = (x < 0.0f) ? (kPi - a) : a;
        a = (y < 0.0f) ? -a : a;
        float frac = (a + kPi) / kTwoPi;
        int sector = (int)(frac * (float)num_sectors);
        sector = sector < 0 ? 0 : sector;
        sector = sector >= num_sectors ? num_sectors - 1 : sector;
        int ring = (int)(r / max_radius * (float)num_rings);
        ring = ring < 0 ? 0 : ring;
        ring = ring >= num_rings ? num_rings - 1 : ring;
        bool ok = (r < max_radius) && (!mk || mk[p]);
        idx[i] = ok ? ring * num_sectors + sector : -1;
        val[i] = z + lidar_height;
      }
      // pass 2: scalar scatter-max
      for (int64_t i = 0; i < m; ++i) {
        int32_t k = idx[i];
        if (k >= 0 && val[i] > img[k]) img[k] = val[i];
      }
    }
  }
}

// Batched Scan Context images: xyz [B, N, 3] f32, mask [B, N] u8 (may be
// null = all valid), out_images [B, num_rings, num_sectors] f32.
void sc_images_batch(const float* xyz, const unsigned char* mask,
                     int64_t batch, int64_t n, int num_rings, int num_sectors,
                     float max_radius, float lidar_height, float* out_images,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > batch) n_threads = (int)batch;
  if (n_threads == 1) {
    sc_bin_frames(xyz, mask, 0, batch, n, num_rings, num_sectors,
                  max_radius, lidar_height, out_images);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min<int64_t>(batch, b0 + per);
    if (b0 >= b1) break;
    ts.emplace_back(sc_bin_frames, xyz, mask, b0, b1, n, num_rings,
                    num_sectors, max_radius, lidar_height, out_images);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
