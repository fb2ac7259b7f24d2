// Shared-memory object store: the TPU-native plasma equivalent.
//
// Role-equivalent to the reference's plasma store
// (src/ray/object_manager/plasma: ObjectStore/ObjectLifecycleManager,
// dlmalloc arena, LRU EvictionPolicy) re-designed for the host side of a TPU pod:
// a single mmap'd arena per node, shared by the node daemon and every worker
// process. Workers attach the same file and read object payloads zero-copy
// (numpy frombuffer over the mapped pages). Unlike plasma there is no unix-
// socket/fd-passing client protocol (plasma.fbs / fling.cc): all metadata ops
// are direct function calls into this library under a process-shared robust
// mutex, which removes a full IPC round trip from the put/get hot path.
//
// Layout of the arena file:
//   [Header | object table (open-addressing hash) | data region]
// Allocation: offset-sorted first-fit free list with coalescing, nodes embedded
// in the free blocks themselves. Eviction: LRU over sealed, unpinned objects.
//
// C ABI (ctypes-consumed; see ../object_store.py):
//   store_create / store_attach / store_detach
//   store_create_obj / store_seal / store_get / store_release
//   store_contains / store_delete / store_evict
//   store_capacity / store_used / store_num_objects
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7470755f73746f72ULL;  // "tpu_stor"
constexpr uint32_t kIdSize = 20;
constexpr uint32_t kMaxObjects = 1 << 16;  // 65536 slots
constexpr uint64_t kAlign = 64;

enum ObjState : uint32_t { kEmpty = 0, kCreated = 1, kSealed = 2, kTombstone = 3 };

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  int32_t refcount;     // pin count from readers/writer
  uint64_t offset;      // into data region
  uint64_t size;
  uint64_t lru_tick;
};

struct FreeBlock {
  uint64_t next;  // offset of next free block, or ~0
  uint64_t size;
};
constexpr uint64_t kNil = ~0ULL;

struct Header {
  uint64_t magic;
  uint64_t capacity;       // data region bytes
  uint64_t data_start;     // file offset of data region
  uint64_t used;
  uint64_t num_objects;
  uint64_t lru_counter;
  uint64_t free_head;      // offset (data-relative) of first free block
  pthread_mutex_t mutex;
  Entry table[kMaxObjects];
};

struct Store {
  Header* hdr;
  uint8_t* base;      // mmap base
  uint64_t map_size;
  int fd;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return h;
}

class Guard {
 public:
  explicit Guard(Header* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->mutex);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&h_->mutex);
  }
  ~Guard() { pthread_mutex_unlock(&h_->mutex); }
 private:
  Header* h_;
};

Entry* find_entry(Header* h, const uint8_t* id) {
  uint64_t idx = hash_id(id) & (kMaxObjects - 1);
  for (uint32_t probe = 0; probe < kMaxObjects; probe++) {
    Entry* e = &h->table[idx];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kTombstone && memcmp(e->id, id, kIdSize) == 0) return e;
    idx = (idx + 1) & (kMaxObjects - 1);
  }
  return nullptr;
}

Entry* alloc_entry(Header* h, const uint8_t* id) {
  uint64_t idx = hash_id(id) & (kMaxObjects - 1);
  Entry* tomb = nullptr;
  for (uint32_t probe = 0; probe < kMaxObjects; probe++) {
    Entry* e = &h->table[idx];
    if (e->state == kEmpty) {
      Entry* slot = tomb ? tomb : e;
      memcpy(slot->id, id, kIdSize);
      return slot;
    }
    if (e->state == kTombstone) {
      if (!tomb) tomb = e;
    } else if (memcmp(e->id, id, kIdSize) == 0) {
      return nullptr;  // already exists
    }
    idx = (idx + 1) & (kMaxObjects - 1);
  }
  if (tomb) { memcpy(tomb->id, id, kIdSize); return tomb; }
  return nullptr;  // table full
}

FreeBlock* fb_at(Store* s, uint64_t off) {
  return reinterpret_cast<FreeBlock*>(s->base + s->hdr->data_start + off);
}

// First-fit allocate from the offset-sorted free list.
int64_t arena_alloc(Store* s, uint64_t size) {
  Header* h = s->hdr;
  size = align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
  uint64_t prev = kNil, cur = h->free_head;
  while (cur != kNil) {
    FreeBlock* b = fb_at(s, cur);
    if (b->size >= size) {
      uint64_t remaining = b->size - size;
      if (remaining >= align_up(sizeof(FreeBlock))) {
        uint64_t new_off = cur + size;
        FreeBlock* nb = fb_at(s, new_off);
        nb->next = b->next;
        nb->size = remaining;
        if (prev == kNil) h->free_head = new_off; else fb_at(s, prev)->next = new_off;
      } else {
        size += remaining;  // absorb tail fragment
        if (prev == kNil) h->free_head = b->next; else fb_at(s, prev)->next = b->next;
      }
      h->used += size;
      return (int64_t)cur;
    }
    prev = cur;
    cur = b->next;
  }
  return -1;
}

// Insert freed block keeping list sorted by offset; coalesce neighbours.
void arena_free(Store* s, uint64_t off, uint64_t size) {
  Header* h = s->hdr;
  size = align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
  h->used -= size;
  uint64_t prev = kNil, cur = h->free_head;
  while (cur != kNil && cur < off) { prev = cur; cur = fb_at(s, cur)->next; }
  FreeBlock* nb = fb_at(s, off);
  nb->next = cur;
  nb->size = size;
  if (prev == kNil) h->free_head = off; else fb_at(s, prev)->next = off;
  // Coalesce with next.
  if (cur != kNil && off + size == cur) {
    FreeBlock* cn = fb_at(s, cur);
    nb->size += cn->size;
    nb->next = cn->next;
  }
  // Coalesce with prev.
  if (prev != kNil) {
    FreeBlock* pb = fb_at(s, prev);
    if (prev + pb->size == off) {
      pb->size += nb->size;
      pb->next = nb->next;
    }
  }
}

// The allocated size for an entry (mirrors rounding in arena_alloc). Tail
// absorption means the stored size may slightly undershoot; we track the
// rounded figure which matches except for absorbed fragments (<64B) — those
// leak at most kAlign per object until the neighbouring block coalesces.
uint64_t alloc_size_for(uint64_t size) {
  return align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
}

int evict_locked(Store* s, uint64_t need, uint8_t* out_ids, uint32_t max_ids, uint32_t* n_out) {
  Header* h = s->hdr;
  uint64_t freed = 0;
  uint32_t n = 0;
  while (freed < need) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kMaxObjects; i++) {
      Entry* e = &h->table[i];
      if (e->state == kSealed && e->refcount == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) break;
    if (out_ids && n < max_ids) memcpy(out_ids + (uint64_t)n * kIdSize, victim->id, kIdSize);
    n++;
    freed += alloc_size_for(victim->size);
    arena_free(s, victim->offset, victim->size);
    victim->state = kTombstone;
    h->num_objects--;
  }
  if (n_out) *n_out = n;
  return freed >= need ? 0 : -1;
}

}  // namespace

extern "C" {

void* store_create(const char* path, uint64_t capacity) {
  int fd = open(path, O_RDWR | O_CREAT, 0600);
  if (fd < 0) return nullptr;
  uint64_t data_start = align_up(sizeof(Header));
  uint64_t map_size = data_start + capacity;
  if (ftruncate(fd, (off_t)map_size) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  // Pre-fault the low region of the arena at daemon startup: first-touch
  // page faults on tmpfs are pathologically slow on some hosts (measured
  // 0.09 GB/s vs 2.7 GB/s warm here), and without this every client pays
  // them inside its first put into each fresh region. Capped at 8 GB: the
  // first-fit allocator hands out low offsets first (and reuses freed
  // regions, which stay warm), so the cap covers the hot region without
  // committing a huge configured capacity up front — tmpfs pages are
  // unreclaimable, so a full prefault of a large store would both stall
  // startup and push the node straight toward the OOM-kill threshold while
  // holding zero objects. MADV_POPULATE_WRITE (Linux 5.14+) faults without
  // dirtying semantics changes; fall back to touching one byte per page.
  uint64_t prefault = map_size < (8ull << 30) ? map_size : (8ull << 30);
#ifdef MADV_POPULATE_WRITE
  if (madvise(base, prefault, MADV_POPULATE_WRITE) != 0)
#endif
  {
    volatile uint8_t* p = reinterpret_cast<volatile uint8_t*>(base);
    for (uint64_t off = 0; off < prefault; off += 4096) p[off] = 0;
  }
  Header* h = reinterpret_cast<Header*>(base);
  memset(h, 0, sizeof(Header));
  h->capacity = capacity;
  h->data_start = data_start;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  // One big free block spanning the data region.
  Store* s = new Store{h, reinterpret_cast<uint8_t*>(base), map_size, fd};
  h->free_head = 0;
  FreeBlock* fb = fb_at(s, 0);
  fb->next = kNil;
  fb->size = capacity;
  std::atomic_thread_fence(std::memory_order_seq_cst);
  h->magic = kMagic;
  return s;
}

uint8_t* store_base(void* sv) {
  // Mapping base for offset arithmetic (offsets from create/get are
  // file-absolute). Exported so out-of-tree users (the sanitizer stress
  // harness) need not depend on Store's private layout.
  return reinterpret_cast<Store*>(sv)->base;
}

void* store_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Header* h = reinterpret_cast<Header*>(base);
  if (h->magic != kMagic) { munmap(base, (size_t)st.st_size); close(fd); return nullptr; }
  return new Store{h, reinterpret_cast<uint8_t*>(base), (uint64_t)st.st_size, fd};
}

void store_detach(void* sv) {
  Store* s = reinterpret_cast<Store*>(sv);
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

// Returns absolute file offset of the writable payload, -1 = exists,
// -2 = out of memory (even after eviction), -3 = table full / too large.
int64_t store_create_obj(void* sv, const uint8_t* id, uint64_t size) {
  Store* s = reinterpret_cast<Store*>(sv);
  Header* h = s->hdr;
  Guard g(h);
  if (alloc_size_for(size) > h->capacity) return -3;
  if (find_entry(h, id)) return -1;
  // No silent auto-eviction here: the caller must store_evict() explicitly so
  // evicted ids can be reported to the object directory (the reference's
  // plasma likewise routes eviction through its EvictionPolicy + notifications).
  int64_t off = arena_alloc(s, size);
  if (off < 0) return -2;
  Entry* e = alloc_entry(h, id);
  if (!e) { arena_free(s, (uint64_t)off, size); return -3; }
  e->state = kCreated;
  e->refcount = 1;  // writer pin
  e->offset = (uint64_t)off;
  e->size = size;
  e->lru_tick = h->lru_counter++;
  h->num_objects++;
  return (int64_t)(h->data_start + (uint64_t)off);
}

int store_seal(void* sv, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  if (!e || e->state != kCreated) return -1;
  e->state = kSealed;
  e->refcount -= 1;  // drop writer pin
  e->lru_tick = s->hdr->lru_counter++;
  return 0;
}

// Seal while KEEPING the writer pin as the caller's read pin (atomic under
// the arena mutex): a transient value handed to same-arena consumers must
// never have an unpinned window in which another process's create_autoevict
// could LRU-evict it between seal and re-pin. Returns payload offset, -1 if
// absent/not-in-created-state.
int64_t store_seal_pinned(void* sv, const uint8_t* id, uint64_t* size_out) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  if (!e || e->state != kCreated) return -1;
  e->state = kSealed;
  e->lru_tick = s->hdr->lru_counter++;
  if (size_out) *size_out = e->size;
  return (int64_t)(s->hdr->data_start + e->offset);
}

// Returns absolute file offset (payload) and size; pins the object. -1 = absent/unsealed.
int64_t store_get(void* sv, const uint8_t* id, uint64_t* size_out) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  if (!e || e->state != kSealed) return -1;
  e->refcount += 1;
  e->lru_tick = s->hdr->lru_counter++;
  if (size_out) *size_out = e->size;
  return (int64_t)(s->hdr->data_start + e->offset);
}

int store_release(void* sv, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  if (!e || e->refcount <= 0) return -1;
  e->refcount -= 1;
  return 0;
}

int store_contains(void* sv, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  return (e && e->state == kSealed) ? 1 : 0;
}

int store_delete(void* sv, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  Entry* e = find_entry(s->hdr, id);
  if (!e) return -1;
  if (e->refcount > 0) return -2;  // pinned
  arena_free(s, e->offset, e->size);
  e->state = kTombstone;
  s->hdr->num_objects--;
  return 0;
}

// List LRU sealed+unpinned eviction candidates (WITHOUT removing them) whose
// combined allocation would free nbytes beyond what is already available.
// Lets the caller spill payloads to disk before deleting (reference: raylet
// LocalObjectManager::SpillObjectUptoMaxThroughput chooses victims, writes
// them via IO workers, then releases — local_object_manager.h:109).
// Returns the number of candidate ids written to out_ids.
int store_evict_candidates(void* sv, uint64_t nbytes, uint8_t* out_ids, uint32_t max_ids) {
  Store* s = reinterpret_cast<Store*>(sv);
  Header* h = s->hdr;
  Guard g(h);
  uint64_t avail = h->capacity - h->used;
  if (avail >= nbytes) return 0;
  uint64_t need = nbytes - avail;
  uint64_t freed = 0;
  uint32_t n = 0;
  uint64_t last_tick = 0;
  while (freed < need && n < max_ids) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kMaxObjects; i++) {
      Entry* e = &h->table[i];
      if (e->state == kSealed && e->refcount == 0 && e->lru_tick >= last_tick) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) break;
    memcpy(out_ids + (uint64_t)n * kIdSize, victim->id, kIdSize);
    n++;
    freed += alloc_size_for(victim->size);
    last_tick = victim->lru_tick + 1;
  }
  return (int)n;
}

// Evict LRU sealed+unpinned objects until nbytes are free; evicted ids are
// written to out_ids (kIdSize bytes each). Returns number evicted.
int store_evict(void* sv, uint64_t nbytes, uint8_t* out_ids, uint32_t max_ids) {
  Store* s = reinterpret_cast<Store*>(sv);
  Guard g(s->hdr);
  uint64_t avail = s->hdr->capacity - s->hdr->used;
  uint32_t n = 0;
  if (avail < nbytes) evict_locked(s, nbytes - avail, out_ids, max_ids, &n);
  return (int)n;
}

// List sealed objects: ids (kIdSize each) + sizes. Returns count written.
// Used to rebuild the object directory when a node re-registers after a
// control-plane restart (reference: GCS FT resource/object view rebuild).
int store_list(void* sv, uint8_t* out_ids, uint64_t* out_sizes, uint32_t max_ids) {
  Store* s = reinterpret_cast<Store*>(sv);
  Header* h = s->hdr;
  Guard g(h);
  uint32_t n = 0;
  for (uint32_t i = 0; i < kMaxObjects && n < max_ids; i++) {
    Entry* e = &h->table[i];
    if (e->state == kSealed) {
      memcpy(out_ids + (uint64_t)n * kIdSize, e->id, kIdSize);
      out_sizes[n] = e->size;
      n++;
    }
  }
  return (int)n;
}

uint64_t store_capacity(void* sv) { return reinterpret_cast<Store*>(sv)->hdr->capacity; }
uint64_t store_used(void* sv) { return reinterpret_cast<Store*>(sv)->hdr->used; }
uint64_t store_num_objects(void* sv) { return reinterpret_cast<Store*>(sv)->hdr->num_objects; }

}  // extern "C"
