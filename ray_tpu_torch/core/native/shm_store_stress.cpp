// Concurrency stress harness for the shared-memory store, built under
// -fsanitize=address / -fsanitize=thread by tests/test_torch_sanitizers.py
// (role-equivalent to the reference's TSAN/ASAN Bazel configs,
// .bazelrc:112-133 — the store is the one component where
// cross-process data races would corrupt user payloads silently).
//
// Threads hammer one arena through the public extern-C surface:
//   - writers: create -> fill -> seal (or seal_pinned -> release)
//   - readers: get -> verify payload -> release
//   - reapers: delete / evict pressure via create_autoevict-sized creates
// The arena mutex is process-shared; TSAN sees the same lock/unlock pairs a
// multi-process run would produce.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <unistd.h>

extern "C" {
void* store_create(const char* path, uint64_t capacity);
void* store_attach(const char* path);
void store_detach(void* s);
int64_t store_create_obj(void* s, const uint8_t* id, uint64_t size);
int store_seal(void* s, const uint8_t* id);
int64_t store_seal_pinned(void* s, const uint8_t* id, uint64_t* size_out);
int64_t store_get(void* s, const uint8_t* id, uint64_t* size_out);
int store_release(void* s, const uint8_t* id);
int store_contains(void* s, const uint8_t* id);
int store_delete(void* s, const uint8_t* id);
uint64_t store_used(void* s);
uint64_t store_num_objects(void* s);
uint8_t* store_base(void* s);
}

static uint8_t* base_of(void* s) { return store_base(s); }

static void make_id(uint8_t* id, int t, int i) {
  std::memset(id, 0, 20);
  std::snprintf(reinterpret_cast<char*>(id), 20, "t%02d-%06d", t, i);
}

int main() {
  char path[] = "/tmp/raytpu_stress_XXXXXX";
  int fd = mkstemp(path);
  if (fd >= 0) close(fd);
  void* s = store_create(path, 8ull << 20);  // small: forces reuse/contention
  if (!s) { std::fprintf(stderr, "store_create failed\n"); return 2; }

  std::atomic<int> errors{0};
  const int kThreads = 4, kIters = 2000, kSize = 1024;

  auto worker = [&](int t) {
    // Half the threads share the creator's handle (one mapping — the layout
    // TSan can actually analyze for races; this is also the in-process
    // client model, one SharedMemoryClient shared by worker threads), half
    // attach their own (the cross-process model).
    void* h = (t % 2) ? store_attach(path) : s;
    if (!h) { errors++; return; }
    uint8_t id[20];
    for (int i = 0; i < kIters; i++) {
      make_id(id, t, i);
      int64_t off = store_create_obj(h, id, kSize);
      if (off < 0) continue;  // full: older entries still pinned elsewhere
      uint8_t* p = base_of(h) + off;
      std::memset(p, (t * 31 + i) & 0xff, kSize);
      if (i % 2 == 0) {
        if (store_seal(h, id) != 0) { errors++; continue; }
        uint64_t sz = 0;
        int64_t g = store_get(h, id, &sz);
        if (g >= 0) {
          uint8_t expect = (uint8_t)((t * 31 + i) & 0xff);
          uint8_t* q = base_of(h) + g;
          for (int b = 0; b < kSize; b += 97)
            if (q[b] != expect) { errors++; break; }
          store_release(h, id);
        }
      } else {
        uint64_t sz = 0;
        if (store_seal_pinned(h, id, &sz) < 0) { errors++; continue; }
        store_release(h, id);
      }
      if (i % 3 == 0) store_delete(h, id);  // may be pinned elsewhere: ok
      if (i > 8) {  // cross-thread reads of a neighbour's recent object
        uint8_t other[20];
        make_id(other, (t + 1) % kThreads, i - 8);
        uint64_t sz = 0;
        int64_t g = store_get(h, other, &sz);
        if (g >= 0) store_release(h, other);
      }
    }
    if (h != s) store_detach(h);
  };

  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; t++) ts.emplace_back(worker, t);
  for (auto& th : ts) th.join();
  store_detach(s);
  unlink(path);
  if (errors.load() != 0) {
    std::fprintf(stderr, "stress errors: %d\n", errors.load());
    return 1;
  }
  std::printf("stress ok\n");
  return 0;
}
