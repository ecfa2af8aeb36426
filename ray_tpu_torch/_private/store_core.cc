// Native object-store core: arena allocator + object index.
//
// The plasma-store role of the reference (`src/ray/object_manager/plasma/`:
// one mmap'd shared-memory arena per node with dlmalloc inside,
// `plasma_allocator.h:41`, object index + lifecycle in
// `object_lifecycle_manager.h:101`), reduced to its essential core:
//
//  - one /dev/shm-backed arena file per session; objects are 64-byte
//    aligned [offset, size) slices of it.  Consumers mmap the arena once
//    and read slices zero-copy (the fd-passing/mmap model of plasma,
//    minus the unix-socket hop — the head hands out offsets instead).
//  - a first-fit free list with neighbor coalescing (the dlmalloc slot),
//    so freed object space is recycled: recycled pages skip the
//    fault-and-zero cost that made fresh per-object files ~2x slower.
//  - an oid -> {offset, size, sealed} index with create/seal/get/delete.
//
// Single-PROCESS writer: the head owns allocation/decommit; other
// processes only read (their locations arrive via the control plane), so
// no SHARED-memory locking is needed — the same split as plasma, where
// only the store process mutates the arena.  WITHIN the head, however,
// several threads hit this API concurrently (driver puts, reaper
// deletes) and ctypes releases the GIL for
// the duration of each call — so the handle carries its own mutex; every
// exported call serializes on it (the role of plasma's store event loop).
// Uncontended cost is ~20ns against a multi-us allocation.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>
#include <mutex>
#include <string>
#include <unordered_map>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;
constexpr uint64_t kDataStart = 4096;  // page 0 reserved for a header/magic

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

struct Entry {
  uint64_t offset;
  uint64_t size;       // payload size
  uint64_t allocated;  // aligned block size
  bool sealed;
};

struct Arena {
  std::string path;
  int fd = -1;
  uint64_t capacity = 0;
  uint64_t bump = kDataStart;
  uint64_t used = 0;  // allocated bytes (aligned)
  // free blocks by offset -> size (coalescing needs ordered neighbors)
  std::map<uint64_t, uint64_t> free_blocks;
  std::unordered_map<std::string, Entry> index;
  std::mutex mu;  // serializes all API calls (see header comment)
};

// Every Arena ever created stays reachable here (closed ones included):
// close() cannot delete the struct — a GIL-released call can be blocked
// on its mutex — so this keeps the intentional leak reachable (and
// therefore invisible to LeakSanitizer, which is right: it IS reachable).
std::mutex g_arenas_mu;
std::vector<Arena*>& g_arenas() {
  // heap-allocated and never destroyed: a static vector's destructor
  // would run at exit BEFORE the leak checker, orphaning the arenas it
  // is keeping reachable
  static std::vector<Arena*>* v = new std::vector<Arena*>();
  return *v;
}

std::string oid_key(const uint8_t* oid) {
  return std::string(reinterpret_cast<const char*>(oid), 16);
}

// first-fit over the free list, else bump
int64_t arena_alloc(Arena* a, uint64_t need) {
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= need) {
      uint64_t off = it->first;
      uint64_t remain = it->second - need;
      a->free_blocks.erase(it);
      if (remain >= kAlign) a->free_blocks.emplace(off + need, remain);
      a->used += need;
      return static_cast<int64_t>(off);
    }
  }
  if (a->bump + need > a->capacity) return -1;
  uint64_t off = a->bump;
  a->bump += need;
  a->used += need;
  return static_cast<int64_t>(off);
}

void arena_release(Arena* a, uint64_t off, uint64_t alloc_size) {
  a->used -= alloc_size;
  auto next = a->free_blocks.lower_bound(off);
  // coalesce with the following block
  if (next != a->free_blocks.end() && off + alloc_size == next->first) {
    alloc_size += next->second;
    next = a->free_blocks.erase(next);
  }
  // coalesce with the preceding block
  if (next != a->free_blocks.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second == off) {
      prev->second += alloc_size;
      // merged block now adjacent to the bump frontier? retreat the bump
      if (prev->first + prev->second == a->bump) {
        a->bump = prev->first;
        a->free_blocks.erase(prev);
      }
      return;
    }
  }
  if (off + alloc_size == a->bump) {
    a->bump = off;  // retreat instead of listing
    return;
  }
  a->free_blocks.emplace(off, alloc_size);
}

}  // namespace

extern "C" {

// Create the arena file (O_EXCL) sized to `capacity`; returns NULL on error.
void* rtpu_store_create(const char* path, uint64_t capacity) {
  int fd = ::open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    ::close(fd);
    ::unlink(path);
    return nullptr;
  }
  auto* a = new Arena();
  a->path = path;
  a->fd = fd;
  a->capacity = capacity;
  // magic header so sweepers can identify arena files
  static const char kMagic[] = "RTPUARENA1";
  (void)!::pwrite(fd, kMagic, sizeof(kMagic), 0);
  {
    std::lock_guard<std::mutex> g(g_arenas_mu);
    g_arenas().push_back(a);
  }
  return a;
}

// Allocate + index an unsealed object. Returns 0 and writes *offset_out,
// -1 if oid exists, -2 if the arena is full.
int rtpu_store_put(void* h, const uint8_t* oid, uint64_t size,
                   uint64_t* offset_out) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto key = oid_key(oid);
  if (a->index.count(key)) return -1;
  uint64_t need = align_up(size ? size : 1);
  int64_t off = arena_alloc(a, need);
  if (off < 0) return -2;
  a->index.emplace(key, Entry{static_cast<uint64_t>(off), size, need, false});
  *offset_out = static_cast<uint64_t>(off);
  return 0;
}

int rtpu_store_seal(void* h, const uint8_t* oid) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->index.find(oid_key(oid));
  if (it == a->index.end()) return -1;
  it->second.sealed = true;
  return 0;
}

// Look up an object: writes offset/size/sealed. Returns 0, or -1 if absent.
int rtpu_store_get(void* h, const uint8_t* oid, uint64_t* offset_out,
                   uint64_t* size_out, int* sealed_out) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->index.find(oid_key(oid));
  if (it == a->index.end()) return -1;
  *offset_out = it->second.offset;
  *size_out = it->second.size;
  *sealed_out = it->second.sealed ? 1 : 0;
  return 0;
}

// Delete + reclaim. Returns 0, or -1 if absent.
int rtpu_store_delete(void* h, const uint8_t* oid) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->index.find(oid_key(oid));
  if (it == a->index.end()) return -1;
  uint64_t off = it->second.offset, alloc = it->second.allocated;
  a->index.erase(it);
  arena_release(a, off, alloc);
  // Pages stay resident (high-water-mark memory, like plasma's arena):
  // recycling faulted-in pages is what makes repeated puts run at memcpy
  // speed instead of the kernel's fault-and-zero path.  The arena is
  // bounded by its capacity, so residency is the store's memory budget.
  return 0;
}

uint64_t rtpu_store_bytes_used(void* h) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return a->used;
}

uint64_t rtpu_store_capacity(void* h) {
  auto* a = static_cast<Arena*>(h);
  // close() zeroes capacity under mu; an unlocked read here would race it
  std::lock_guard<std::mutex> g(a->mu);
  return a->capacity;
}

uint64_t rtpu_store_num_objects(void* h) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return a->index.size();
}

uint64_t rtpu_store_num_free_blocks(void* h) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return a->free_blocks.size();
}

void rtpu_store_close(void* h, int unlink_file) {
  auto* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  if (a->fd >= 0) {
    ::close(a->fd);
    a->fd = -1;  // idempotent: a second close is a no-op
  }
  if (unlink_file && !a->path.empty()) {
    ::unlink(a->path.c_str());
    a->path.clear();
  }
  a->index.clear();
  a->free_blocks.clear();
  // a put that was blocked on mu during this close must FAIL (-2), not
  // publish an object into a closed/unlinked arena: zero the capacity
  // so arena_alloc's bump check rejects everything from now on
  a->capacity = 0;
  a->bump = kDataStart;
  a->used = 0;
  // The Arena struct itself is intentionally NOT deleted: a reaper or
  // blob-reader thread can be blocked on mu right now (ctypes releases
  // the GIL, so shutdown can race an in-flight call), and destroying a
  // held/contended mutex is UB.  One small struct leaks per session at
  // process exit — the price of making every call safe against close.
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RefIndex: the head registry's hot maps, pushed down from Python.
//
// The reference keeps reference counts and object locations in C++
// (`src/ray/core_worker/reference_count.h`, ownership-based object
// directory) precisely because they are touched per task arg; our head
// did both in a Python dict under a Python lock, which serialized every
// submission wave.  This index absorbs exactly the per-oid hot state:
//
//   - ref_count          lifetime source of truth (may go negative while
//                        the producer hasn't sealed yet — same contract
//                        as the Python _Entry)
//   - pins[8]            advisory per-reason counts (handle/task_arg/
//                        contained/lineage/...; Python owns the
//                        reason-name <-> slot mapping)
//   - sealed             the delete-at-zero gate: entries are erased when
//                        count <= 0 AND sealed, atomically with the
//                        decrement that got them there
//   - origin slot +      location SET as small-int node slots (Python
//     replica mask + rr   owns slot <-> node_id/addr); `locate` picks the
//                        pull source per oid (prefer-own-node, else
//                        round-robin over origin+replicas)
//
// All calls take packed arrays of 16-byte oids and run with the GIL
// released (ctypes); one mutex serializes the index — the win over the
// Python path is batch granularity (one lock hop per MESSAGE instead of
// per oid) plus true GIL-free execution, not lock-free cleverness.
// Cold metadata (payload location, owner attribution, sealed Events,
// containment lists) stays in Python, keyed by the same oid, so the
// ownership/memory audits read identical rows.

namespace {

constexpr int kNumReasons = 8;
constexpr int kMaxSlots = 64;  // replica node slots per object (bitmask)
constexpr int kOidLen = 16;

struct RefEntry {
  int64_t count = 1;
  int32_t pins[kNumReasons] = {0};
  uint64_t replicas = 0;  // bit i = node slot i holds a pulled copy
  int16_t origin_slot = -1;
  uint16_t rr = 0;
  bool sealed = false;
};

struct RefIndex {
  std::unordered_map<std::string, RefEntry> map;
  std::mutex mu;
};

// same keep-reachable discipline as the arenas: a GIL-released call can
// be parked on `mu` while Python shuts down, so destroy() never frees
std::mutex g_refs_mu;
std::vector<RefIndex*>& g_refs() {
  static std::vector<RefIndex*>* v = new std::vector<RefIndex*>();
  return *v;
}

inline std::string ref_key(const uint8_t* oids, int64_t i) {
  return std::string(reinterpret_cast<const char*>(oids) + i * kOidLen,
                     kOidLen);
}

}  // namespace

extern "C" {

void* rtpu_refs_create() {
  auto* r = new RefIndex();
  {
    std::lock_guard<std::mutex> g(g_refs_mu);
    g_refs().push_back(r);
  }
  return r;
}

// Create entries for any missing oid with the creator's initial handle
// pin (count=1, pins[reason]=1 — Python passes the "handle" slot).
// Existing entries are untouched (setdefault semantics).
void rtpu_refs_ensure(void* h, const uint8_t* oids, int64_t n,
                      int32_t reason) {
  auto* r = static_cast<RefIndex*>(h);
  if (reason < 0 || reason >= kNumReasons) reason = kNumReasons - 1;
  std::lock_guard<std::mutex> g(r->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto res = r->map.emplace(ref_key(oids, i), RefEntry{});
    if (res.second) res.first->second.pins[reason] = 1;
  }
}

int rtpu_refs_contains(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  return r->map.count(std::string(reinterpret_cast<const char*>(oid),
                                  kOidLen))
             ? 1
             : 0;
}

// Batch increment; missing oids are a no-op (a ref to a deleted object
// is the caller's stale handle, same as the Python path).
void rtpu_refs_add(void* h, const uint8_t* oids, int64_t n, int32_t reason,
                   int64_t delta) {
  auto* r = static_cast<RefIndex*>(h);
  if (reason < 0 || reason >= kNumReasons) reason = kNumReasons - 1;
  std::lock_guard<std::mutex> g(r->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = r->map.find(ref_key(oids, i));
    if (it == r->map.end()) continue;
    it->second.count += delta;
    it->second.pins[reason] += static_cast<int32_t>(delta);
  }
}

// Batch decrement.  An entry whose count drops to <= 0 while sealed is
// erased HERE, atomically with the decrement (a concurrent add can then
// never resurrect it — add on a missing key is a no-op), and its oid is
// appended to dead_out (capacity n * 16 bytes).  Returns the dead count;
// Python reaps payload/metadata for exactly those oids.
int64_t rtpu_refs_remove(void* h, const uint8_t* oids, int64_t n,
                         int32_t reason, int64_t delta, uint8_t* dead_out) {
  auto* r = static_cast<RefIndex*>(h);
  if (reason < 0 || reason >= kNumReasons) reason = kNumReasons - 1;
  int64_t dead = 0;
  std::lock_guard<std::mutex> g(r->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto key = ref_key(oids, i);
    auto it = r->map.find(key);
    if (it == r->map.end()) continue;
    RefEntry& e = it->second;
    e.count -= delta;
    int32_t left = e.pins[reason] - static_cast<int32_t>(delta);
    e.pins[reason] = left > 0 ? left : 0;
    if (e.count <= 0 && e.sealed) {
      std::memcpy(dead_out + dead * kOidLen, key.data(), kOidLen);
      ++dead;
      r->map.erase(it);
    }
  }
  return dead;
}

// Mark sealed.  Returns 1 when the entry died at seal time (every handle
// dropped before the producer finished — fire-and-forget reclaim: the
// entry is erased and the caller discards the payload), 0 on a live
// seal, -1 when the entry is missing (concurrent deletion won).
int rtpu_refs_seal(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  it->second.sealed = true;
  if (it->second.count <= 0) {
    r->map.erase(it);
    return 1;
  }
  return 0;
}

// Node-loss un-seal: the only copy died, lineage will refill the slot.
// The entry survives at its current count; replicas were already dropped
// via rtpu_refs_drop_slot.
int rtpu_refs_unseal(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  it->second.sealed = false;
  it->second.origin_slot = -1;
  it->second.replicas = 0;
  return 0;
}

int rtpu_refs_erase(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  return r->map.erase(
             std::string(reinterpret_cast<const char*>(oid), kOidLen))
             ? 0
             : -1;
}

// Snapshot one entry (audit path): count, sealed, all pin slots.
int rtpu_refs_get(void* h, const uint8_t* oid, int64_t* count_out,
                  int32_t* sealed_out, int32_t* pins_out /* [8] */) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  *count_out = it->second.count;
  *sealed_out = it->second.sealed ? 1 : 0;
  std::memcpy(pins_out, it->second.pins, sizeof(it->second.pins));
  return 0;
}

// Batch snapshot for the memory audit: one mutex hop for the whole table
// page instead of one per row.  Missing oids get count = INT64_MIN.
void rtpu_refs_get_batch(void* h, const uint8_t* oids, int64_t n,
                         int64_t* counts, int32_t* pins /* n*8 */) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = r->map.find(ref_key(oids, i));
    if (it == r->map.end()) {
      counts[i] = INT64_MIN;
      continue;
    }
    counts[i] = it->second.count;
    std::memcpy(pins + i * kNumReasons, it->second.pins,
                sizeof(it->second.pins));
  }
}

uint64_t rtpu_refs_size(void* h) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  return r->map.size();
}

// -- location sets ---------------------------------------------------------

int rtpu_refs_set_origin(void* h, const uint8_t* oid, int32_t slot) {
  auto* r = static_cast<RefIndex*>(h);
  if (slot < -1 || slot >= kMaxSlots) return -2;
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  it->second.origin_slot = static_cast<int16_t>(slot);
  return 0;
}

// Record a pulled copy.  1 = added, 0 = already present / is the origin,
// -1 = missing entry, -2 = slot out of mask range (callers just skip:
// the location set is a pull-spreading optimization, not correctness).
int rtpu_refs_add_replica(void* h, const uint8_t* oid, int32_t slot) {
  auto* r = static_cast<RefIndex*>(h);
  if (slot < 0 || slot >= kMaxSlots) return -2;
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  RefEntry& e = it->second;
  if (slot == e.origin_slot) return 0;
  uint64_t bit = 1ULL << slot;
  if (e.replicas & bit) return 0;
  e.replicas |= bit;
  return 1;
}

// Remove and return the lowest replica slot (node-loss promotion picks a
// survivor); -1 when the entry has no replicas or is missing.
int rtpu_refs_pop_replica(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end() || it->second.replicas == 0) return -1;
  int slot = __builtin_ctzll(it->second.replicas);
  it->second.replicas &= it->second.replicas - 1;
  return slot;
}

// The raw replica slot mask (0 for missing entries) — Python decodes the
// bits back to node ids for `replica_nodes`/broadcast planning.
uint64_t rtpu_refs_replica_mask(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  return it == r->map.end() ? 0 : it->second.replicas;
}

// Spill path: the shm segment is leaving; every pulled copy of it gets
// unlinked, so the location set empties without touching sealed state.
int rtpu_refs_clear_replicas(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  it->second.replicas = 0;
  return 0;
}

int rtpu_refs_num_replicas(void* h, const uint8_t* oid) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  auto it = r->map.find(
      std::string(reinterpret_cast<const char*>(oid), kOidLen));
  if (it == r->map.end()) return -1;
  return __builtin_popcountll(it->second.replicas);
}

// A node died: clear its slot bit from every location set (cold path —
// full scan, like the Python mark_node_lost scan it replaces).
void rtpu_refs_drop_slot(void* h, int32_t slot) {
  auto* r = static_cast<RefIndex*>(h);
  if (slot < 0 || slot >= kMaxSlots) return;
  uint64_t mask = ~(1ULL << slot);
  std::lock_guard<std::mutex> g(r->mu);
  for (auto& kv : r->map) kv.second.replicas &= mask;
}

// Pick the pull source for each oid (one call per dep set — the `locate`
// batch API).  out[i]: -2 unknown entry, -1 use the primary location,
// otherwise the chosen replica slot.  prefer_slot is the consumer's own
// node (its copy wins: zero-copy attach); with no preference match the
// choice round-robins over {origin} + replicas in ascending-slot order.
void rtpu_refs_locate(void* h, const uint8_t* oids, int64_t n,
                      int32_t prefer_slot, int32_t* out) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = r->map.find(ref_key(oids, i));
    if (it == r->map.end()) {
      out[i] = -2;
      continue;
    }
    RefEntry& e = it->second;
    if (e.replicas == 0) {
      out[i] = -1;
      continue;
    }
    if (prefer_slot >= 0) {
      if (prefer_slot == e.origin_slot) {
        out[i] = -1;
        continue;
      }
      if (prefer_slot < kMaxSlots && (e.replicas & (1ULL << prefer_slot))) {
        out[i] = prefer_slot;
        continue;
      }
    }
    int n_rep = __builtin_popcountll(e.replicas);
    int idx = e.rr % (1 + n_rep);
    ++e.rr;
    if (idx == 0) {
      out[i] = -1;  // the origin's turn
      continue;
    }
    uint64_t m = e.replicas;
    for (int k = 1; k < idx; ++k) m &= m - 1;  // drop idx-1 lowest bits
    out[i] = __builtin_ctzll(m);
  }
}

void rtpu_refs_clear(void* h) {
  auto* r = static_cast<RefIndex*>(h);
  std::lock_guard<std::mutex> g(r->mu);
  r->map.clear();
}

}  // extern "C"
