// The port's copy of dlrover_tpu/data/csrc/shm_ring.cpp. The control
// block and the slot layout must stay byte for byte the JAX package's:
// a producer of either package attaches to a ring the other created
// (tests/test_torch_shm_data.py holds both directions).
//
// Shared-memory batch ring buffer (native data plane).
//
// Parity reference: atorch/atorch/data/shm_context.py:139 —
// ShmDataContext: a ring of POSIX shared-memory buffers carrying batches
// from CPU "coworker" processes to accelerator trainers. The reference
// implements the ring in Python over multiprocessing shm; here the ring
// is native C++: a single shm segment holds the control block
// (process-shared mutex + condvars + head/tail) and the slot array, so
// producers/consumers in different processes coordinate without a Python
// broker and without pickling overhead on the hot path.
//
// Layout:  [Control][slot 0][slot 1]...[slot n-1]
// Each slot: [uint64 payload_size][payload bytes]
// MPMC, blocking push/pop with millisecond timeouts.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Control {
  uint64_t magic;
  uint64_t slot_size;      // payload capacity per slot
  uint64_t num_slots;
  uint64_t head;           // next slot to pop
  uint64_t tail;           // next slot to push
  uint64_t count;          // filled slots
  uint64_t closed;         // producer-side EOF flag
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

constexpr uint64_t kMagic = 0x444C525452494E47ULL;  // "DLRTRING"

struct Ring {
  Control* ctl;
  uint8_t* slots;
  size_t map_size;
  int owner;  // created (vs attached): unlink on destroy
  char name[256];
};

inline uint8_t* slot_ptr(Ring* r, uint64_t idx) {
  return r->slots + idx * (sizeof(uint64_t) + r->ctl->slot_size);
}

void abs_deadline(timespec* ts, long timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure.
void* shm_ring_create(const char* name, uint64_t slot_size,
                      uint64_t num_slots) {
  size_t map_size =
      sizeof(Control) + num_slots * (sizeof(uint64_t) + slot_size);
  shm_unlink(name);  // stale segment from a crashed predecessor
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Control* ctl = static_cast<Control*>(mem);
  std::memset(ctl, 0, sizeof(Control));
  ctl->slot_size = slot_size;
  ctl->num_slots = num_slots;

  pthread_mutexattr_t mattr;
  pthread_mutexattr_init(&mattr);
  pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
  // a producer dying mid-push must not wedge the job: robust mutex
  pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&ctl->mutex, &mattr);
  pthread_condattr_t cattr;
  pthread_condattr_init(&cattr);
  pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&ctl->not_full, &cattr);
  pthread_cond_init(&ctl->not_empty, &cattr);
  ctl->magic = kMagic;

  Ring* r = new Ring();
  r->ctl = ctl;
  r->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(Control);
  r->map_size = map_size;
  r->owner = 1;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

void* shm_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      static_cast<size_t>(st.st_size) < sizeof(Control)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Control* ctl = static_cast<Control*>(mem);
  if (ctl->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Ring* r = new Ring();
  r->ctl = ctl;
  r->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(Control);
  r->map_size = static_cast<size_t>(st.st_size);
  r->owner = 0;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

static int lock_robust(Control* ctl) {
  int rc = pthread_mutex_lock(&ctl->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&ctl->mutex);
    rc = 0;
  }
  return rc;
}

// 0 ok; -1 timeout; -2 payload too large; -3 ring closed; -4 error.
int shm_ring_push(void* handle, const uint8_t* data, uint64_t size,
                  long timeout_ms) {
  Ring* r = static_cast<Ring*>(handle);
  Control* ctl = r->ctl;
  if (size > ctl->slot_size) return -2;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(ctl) != 0) return -4;
  while (ctl->count == ctl->num_slots && !ctl->closed) {
    int rc = pthread_cond_timedwait(&ctl->not_full, &ctl->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&ctl->mutex);
      return -1;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&ctl->mutex);
  }
  if (ctl->closed) {
    pthread_mutex_unlock(&ctl->mutex);
    return -3;
  }
  uint8_t* slot = slot_ptr(r, ctl->tail);
  std::memcpy(slot, &size, sizeof(uint64_t));
  std::memcpy(slot + sizeof(uint64_t), data, size);
  ctl->tail = (ctl->tail + 1) % ctl->num_slots;
  ctl->count += 1;
  pthread_cond_signal(&ctl->not_empty);
  pthread_mutex_unlock(&ctl->mutex);
  return 0;
}

// >=0: payload size; -1 timeout; -2 buffer too small; -3 closed+drained;
// -4 error.
int64_t shm_ring_pop(void* handle, uint8_t* out, uint64_t out_capacity,
                     long timeout_ms) {
  Ring* r = static_cast<Ring*>(handle);
  Control* ctl = r->ctl;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  if (lock_robust(ctl) != 0) return -4;
  while (ctl->count == 0) {
    if (ctl->closed) {
      pthread_mutex_unlock(&ctl->mutex);
      return -3;
    }
    int rc = pthread_cond_timedwait(&ctl->not_empty, &ctl->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&ctl->mutex);
      return -1;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&ctl->mutex);
  }
  uint8_t* slot = slot_ptr(r, ctl->head);
  uint64_t size;
  std::memcpy(&size, slot, sizeof(uint64_t));
  if (size > out_capacity) {
    pthread_mutex_unlock(&ctl->mutex);
    return -2;
  }
  std::memcpy(out, slot + sizeof(uint64_t), size);
  ctl->head = (ctl->head + 1) % ctl->num_slots;
  ctl->count -= 1;
  pthread_cond_signal(&ctl->not_full);
  pthread_mutex_unlock(&ctl->mutex);
  return static_cast<int64_t>(size);
}

// Actual per-slot payload capacity from the control block, so attachers
// size their pop buffers to the creator's layout instead of guessing.
uint64_t shm_ring_slot_size(void* handle) {
  return static_cast<Ring*>(handle)->ctl->slot_size;
}

int shm_ring_size(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  if (lock_robust(r->ctl) != 0) return -1;
  int n = static_cast<int>(r->ctl->count);
  pthread_mutex_unlock(&r->ctl->mutex);
  return n;
}

// Producer EOF: consumers drain remaining slots then see -3.
void shm_ring_close(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  if (lock_robust(r->ctl) != 0) return;
  r->ctl->closed = 1;
  pthread_cond_broadcast(&r->ctl->not_empty);
  pthread_cond_broadcast(&r->ctl->not_full);
  pthread_mutex_unlock(&r->ctl->mutex);
}

void shm_ring_destroy(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  int owner = r->owner;
  char name[256];
  std::strncpy(name, r->name, sizeof(name));
  munmap(r->ctl, r->map_size);
  if (owner) shm_unlink(name);
  delete r;
}

}  // extern "C"
