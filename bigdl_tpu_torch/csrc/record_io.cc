// Host record I/O of the port: CRC32C, the TFRecord writer and the
// threaded prefetching TFRecord reader (counterpart of the JAX package's
// native/src/bigdl_native.cc, CRC :38-95, writer and prefetcher
// :118-294).  Plain C++17, no CUDA: it feeds the data pipeline on the
// host.  Built with g++ at first use by bigdl_tpu_torch/dataset/
// record_io.py and loaded over ctypes through the plain C interface
// below.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// CRC32C (Castagnoli, polynomial 0x1EDC6F41, reflected 0x82F63B78),
// slice-by-8
// ---------------------------------------------------------------------
static uint32_t kTable[8][256];
static std::atomic<bool> table_done{false};
static std::mutex table_mu;

static void table_init() {
  if (table_done.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> lock(table_mu);
  if (table_done.load(std::memory_order_relaxed)) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    kTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = kTable[0][i];
    for (int t = 1; t < 8; ++t) {
      c = (c >> 8) ^ kTable[0][c & 0xFF];
      kTable[t][i] = c;
    }
  }
  table_done.store(true, std::memory_order_release);
}

uint32_t rio_crc32c(const uint8_t* data, uint64_t n, uint32_t crc0) {
  table_init();
  uint32_t crc = ~crc0;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    crc ^= (uint32_t)word;
    uint32_t hi = (uint32_t)(word >> 32);
    crc = kTable[7][crc & 0xFF] ^ kTable[6][(crc >> 8) & 0xFF] ^
          kTable[5][(crc >> 16) & 0xFF] ^ kTable[4][crc >> 24] ^
          kTable[3][hi & 0xFF] ^ kTable[2][(hi >> 8) & 0xFF] ^
          kTable[1][(hi >> 16) & 0xFF] ^ kTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kTable[0][(crc ^ *data++) & 0xFF];
  return ~crc;
}

// TFRecord's masked CRC: rotr(crc, 15) + 0xa282ead8
uint32_t rio_masked_crc32c(const uint8_t* data, uint64_t n) {
  uint32_t c = rio_crc32c(data, n, 0);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------
// TFRecord writer: len (8 B LE), masked crc of len, data, masked crc of
// data
// ---------------------------------------------------------------------
struct Writer {
  FILE* f;
};

void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  return new Writer{f};
}

int rio_write(void* wp, const uint8_t* data, uint64_t n) {
  Writer* w = (Writer*)wp;
  uint64_t len = n;
  uint32_t len_crc = rio_masked_crc32c((const uint8_t*)&len, 8);
  uint32_t data_crc = rio_masked_crc32c(data, n);
  if (fwrite(&len, 8, 1, w->f) != 1) return -1;
  if (fwrite(&len_crc, 4, 1, w->f) != 1) return -1;
  if (n && fwrite(data, 1, n, w->f) != n) return -1;
  if (fwrite(&data_crc, 4, 1, w->f) != 1) return -1;
  return 0;
}

int rio_writer_close(void* wp) {
  Writer* w = (Writer*)wp;
  int rc = fclose(w->f);
  delete w;
  return rc == 0 ? 0 : -1;
}

// ---------------------------------------------------------------------
// Threaded prefetching reader
//
// Worker threads take shard files in turn and read whole records (CRC
// checked) into a bounded queue; the consumer pops them one at a time.
// One worker reads a file from start to end, so the records of one file
// arrive in file order; files read by different workers interleave.  A
// record whose data CRC fails is skipped (counted); a failed length CRC
// or an impossible length abandons the rest of that file (counted).
// ---------------------------------------------------------------------
struct Prefetcher {
  std::vector<std::string> files;
  std::deque<std::vector<uint8_t>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  uint64_t capacity = 1024;
  std::atomic<uint64_t> next_file{0};
  std::atomic<bool> stop{false};
  std::atomic<int> active{0};
  std::atomic<uint64_t> crc_errors{0};
  std::vector<std::thread> workers;
  bool verify = true;

  bool push(std::vector<uint8_t>&& rec) {
    std::unique_lock<std::mutex> lock(mu);
    cv_push.wait(lock, [&] { return queue.size() < capacity || stop.load(); });
    if (stop.load()) return false;
    queue.push_back(std::move(rec));
    cv_pop.notify_one();
    return true;
  }

  void read_file(FILE* f) {
    for (;;) {
      uint64_t len;
      uint32_t len_crc, data_crc;
      if (fread(&len, 8, 1, f) != 1) return;
      if (fread(&len_crc, 4, 1, f) != 1) return;
      if (verify && rio_masked_crc32c((const uint8_t*)&len, 8) != len_crc) {
        crc_errors.fetch_add(1);
        return;  // the framing is lost
      }
      if (len > (1ull << 31)) {
        crc_errors.fetch_add(1);
        return;
      }
      std::vector<uint8_t> buf;
      try {
        buf.resize(len);
      } catch (const std::exception&) {
        crc_errors.fetch_add(1);
        return;
      }
      if (len && fread(buf.data(), 1, len, f) != len) return;
      if (fread(&data_crc, 4, 1, f) != 1) return;
      if (verify && rio_masked_crc32c(buf.data(), len) != data_crc) {
        crc_errors.fetch_add(1);
        continue;  // the framing still holds
      }
      if (!push(std::move(buf))) return;
    }
  }

  void worker() {
    for (;;) {
      uint64_t idx = next_file.fetch_add(1);
      if (idx >= files.size() || stop.load()) break;
      FILE* f = fopen(files[idx].c_str(), "rb");
      if (!f) continue;
      read_file(f);
      fclose(f);
      if (stop.load()) break;
    }
    {
      // under the lock, so the consumer cannot miss the last wake-up
      std::lock_guard<std::mutex> lock(mu);
      active.fetch_sub(1);
    }
    cv_pop.notify_all();
  }
};

void* rio_prefetcher_create(const char** paths, uint64_t n_paths,
                            uint64_t n_threads, uint64_t capacity,
                            int verify) {
  Prefetcher* p = new Prefetcher();
  for (uint64_t i = 0; i < n_paths; ++i) p->files.push_back(paths[i]);
  if (capacity) p->capacity = capacity;
  p->verify = verify != 0;
  if (n_threads == 0) n_threads = 4;
  p->active.store((int)n_threads);
  for (uint64_t i = 0; i < n_threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// The next record's length (0 is a valid empty record), or -1 once every
// worker has finished and the queue is empty.
int64_t rio_prefetcher_next_size(void* pp) {
  Prefetcher* p = (Prefetcher*)pp;
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_pop.wait(lock, [&] {
    return !p->queue.empty() || p->active.load() == 0 || p->stop.load();
  });
  if (p->queue.empty()) return -1;
  return (int64_t)p->queue.front().size();
}

// Copies the front record into out (at most out_cap bytes) and pops it;
// returns its length, or -1 when the queue is empty.
int64_t rio_prefetcher_pop(void* pp, uint8_t* out, uint64_t out_cap) {
  Prefetcher* p = (Prefetcher*)pp;
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->queue.empty()) return -1;
  std::vector<uint8_t> r = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_push.notify_one();
  lock.unlock();
  uint64_t n = r.size() < out_cap ? r.size() : out_cap;
  if (n) memcpy(out, r.data(), n);
  return (int64_t)n;
}

uint64_t rio_prefetcher_crc_errors(void* pp) {
  return ((Prefetcher*)pp)->crc_errors.load();
}

void rio_prefetcher_destroy(void* pp) {
  Prefetcher* p = (Prefetcher*)pp;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop.store(true);
  }
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
