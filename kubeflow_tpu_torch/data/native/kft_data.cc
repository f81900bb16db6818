// A copy of kubeflow_tpu/data/native/kft_data.cc, the JAX package's
// native data core: the port builds it on its own, into
// kubeflow_tpu_torch/data/_build/ (data/loader.py).
//
// kft_data — native record-reading core of the input pipeline.
//
// Role in the stack: the host-side data path must keep a TPU chip fed
// without stealing cycles from the python process that drives the device
// (dispatch is async; input starvation shows up directly as step-time
// jitter).  The reference framework had no first-party loader at all —
// its input pipelines lived inside external TF binaries (SURVEY.md §2.2);
// this file is the TPU-native equivalent of that C++ capability.
//
// Design: N reader threads pull files off a shared queue, stream
// length-prefixed records, and push them into a bounded ring buffer
// (backpressure = bounded memory).  The ring carries *batches* of
// records, not single records: per-record mutex/condvar traffic is what
// caps a multi-threaded reader below a single-threaded loop (measured
// 10k vs 18k rec/s on 256 KiB records), so producers stage up to
// kBatchRecords locally and cross the lock once per batch, and the
// consumer drains whole batches per acquisition.  The consumer side
// optionally applies reservoir-style shuffle.  Records are returned as
// malloc'd buffers the caller frees (kft_free), so Python can wrap them
// zero-copy via ctypes -> numpy.frombuffer without the GIL held during
// reads.
//
// File format "KFTR1": [magic 'K''F''T''R'][u8 version=1][records...]
// record: [u32 little-endian payload length][payload bytes].

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Record {
  uint8_t* data;
  uint64_t len;
};

// One tensor slot of the KTE1 payload schema (data/loader.py
// encode_example: 'KTE1', u16 n_keys, then per key [u16 klen][u16 dlen]
// [key][dtype][u8 ndim][i64 shape*ndim][u64 nbytes][raw bytes]).
struct SchemaEntry {
  std::string key;
  std::string dtype;
  std::vector<int64_t> shape;
  uint64_t nbytes = 0;
};

struct TensorView {
  const uint8_t* data;
  uint64_t nbytes;
};

// Parse a KTE1 payload; fills entries (schema) and views (raw tensor
// bytes, aliasing `p`).  Returns false on malformed input.
static bool parse_kte1(const uint8_t* p, uint64_t len,
                       std::vector<SchemaEntry>* entries,
                       std::vector<TensorView>* views) {
  if (len < 6 || memcmp(p, "KTE1", 4) != 0) return false;
  uint16_t n_keys;
  memcpy(&n_keys, p + 4, 2);
  uint64_t off = 6;
  entries->clear();
  views->clear();
  for (uint16_t k = 0; k < n_keys; ++k) {
    if (off + 4 > len) return false;
    uint16_t klen, dlen;
    memcpy(&klen, p + off, 2);
    memcpy(&dlen, p + off + 2, 2);
    off += 4;
    if (off + klen + dlen + 1 > len) return false;
    SchemaEntry e;
    e.key.assign(reinterpret_cast<const char*>(p + off), klen);
    off += klen;
    e.dtype.assign(reinterpret_cast<const char*>(p + off), dlen);
    off += dlen;
    uint8_t ndim = p[off++];
    if (off + 8ull * ndim + 8 > len) return false;
    e.shape.resize(ndim);
    memcpy(e.shape.data(), p + off, 8ull * ndim);
    off += 8ull * ndim;
    memcpy(&e.nbytes, p + off, 8);
    off += 8;
    // Subtraction form: `off + e.nbytes > len` can wrap for nbytes
    // near 2^64 and pass the check with an out-of-range view.
    if (e.nbytes > len - off) return false;
    views->push_back(TensorView{p + off, e.nbytes});
    off += e.nbytes;
    entries->push_back(std::move(e));
  }
  return true;
}

// numpy dtype strings carry the itemsize as their trailing digits
// ('<f4' -> 4, '|u1' -> 1).  0 = unparsable.
static uint64_t dtype_itemsize(const std::string& dtype) {
  size_t i = dtype.size();
  while (i > 0 && isdigit(static_cast<unsigned char>(dtype[i - 1]))) --i;
  if (i == dtype.size()) return 0;
  return strtoull(dtype.c_str() + i, nullptr, 10);
}

// Records staged per lock crossing.  Small enough that batch latency is
// invisible next to a train step, large enough to amortise the mutex.
constexpr size_t kBatchRecords = 16;

struct Loader {
  std::vector<std::string> paths;
  size_t next_path = 0;
  int repeat = 1;  // -1 = forever
  int epoch = 0;

  size_t capacity;  // bound on buffered records (across batches)
  size_t buffered_records = 0;
  std::deque<std::vector<Record>> buffer;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;

  std::vector<std::thread> readers;
  int active_readers = 0;
  bool stopped = false;
  char error[256] = {0};

  // Consumer-side staging (drained batch) + shuffle reservoir.
  std::vector<Record> staged;
  size_t staged_pos = 0;
  std::vector<Record> reservoir;
  size_t shuffle_buffer;
  std::mt19937_64 rng;

  // Buffer pool: consumed records come back via kft_loader_free_batch
  // and are reissued to readers.  Without reuse every record is a fresh
  // allocation the consumer frees on another thread — glibc arena
  // ping-pong — and the ring streams through cold DRAM; with it, a
  // shallow queue runs entirely in cache-hot recycled buffers.
  std::mutex pool_mu;
  std::multimap<size_t, uint8_t*> pool;  // capacity -> free buffer
  std::unordered_map<void*, size_t> cap_of;  // every live pooled alloc
  size_t pool_bytes = 0;
  size_t pool_bytes_limit = 512u << 20;

  uint8_t* alloc(uint64_t len) {
    size_t want = len ? len : 1;
    {
      std::lock_guard<std::mutex> lock(pool_mu);
      auto it = pool.lower_bound(want);
      if (it != pool.end()) {
        uint8_t* buf = it->second;
        pool_bytes -= it->first;
        pool.erase(it);
        return buf;
      }
    }
    auto* buf = static_cast<uint8_t*>(malloc(want));
    if (buf) {
      std::lock_guard<std::mutex> lock(pool_mu);
      cap_of[buf] = want;
    }
    return buf;
  }

  // Forget a buffer that leaves pool ownership (single-record API hands
  // buffers to plain kft_free): without this, cap_of grows per record
  // and keeps dangling pointer keys that can alias later allocations.
  void untrack(void* ptr) {
    std::lock_guard<std::mutex> lock(pool_mu);
    cap_of.erase(ptr);
  }

  void release_batch(void** ptrs, int n) {
    std::lock_guard<std::mutex> lock(pool_mu);
    for (int i = 0; i < n; ++i) {
      auto it = cap_of.find(ptrs[i]);
      if (it == cap_of.end()) {
        free(ptrs[i]);
        continue;
      }
      if (pool_bytes + it->second > pool_bytes_limit) {
        free(ptrs[i]);
        cap_of.erase(it);
        continue;
      }
      pool_bytes += it->second;
      pool.emplace(it->second, static_cast<uint8_t*>(ptrs[i]));
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopped = true;
    }
    not_full.notify_all();
    not_empty.notify_all();
    for (auto& t : readers) {
      if (t.joinable()) t.join();
    }
    if (has_pending) free(pending.data);
    for (auto& batch : buffer)
      for (auto& r : batch) free(r.data);
    for (size_t i = staged_pos; i < staged.size(); ++i)
      free(staged[i].data);
    for (auto& r : reservoir) free(r.data);
    for (auto& kv : pool) free(kv.second);
  }

  bool take_path(std::string* out) {
    std::lock_guard<std::mutex> lock(mu);
    if (stopped) return false;
    if (next_path >= paths.size()) {
      if (repeat < 0 || ++epoch < repeat) {
        next_path = 0;
      } else {
        return false;
      }
    }
    *out = paths[next_path++];
    return true;
  }

  void fail(const char* msg, const std::string& path) {
    std::lock_guard<std::mutex> lock(mu);
    if (!error[0]) {
      snprintf(error, sizeof(error), "%s: %s", msg, path.c_str());
    }
  }

  // One lock crossing per staged batch; frees the batch if stopping.
  // Returns false when the loader is shutting down.
  bool push_batch(std::vector<Record>&& batch) {
    if (batch.empty()) return true;
    std::unique_lock<std::mutex> lock(mu);
    not_full.wait(lock, [&] {
      return buffered_records < capacity || stopped;
    });
    if (stopped) {
      lock.unlock();
      for (auto& r : batch) free(r.data);
      return false;
    }
    buffered_records += batch.size();
    buffer.push_back(std::move(batch));
    lock.unlock();
    not_empty.notify_one();
    return true;
  }

  void read_file(const std::string& path) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) {
      fail("open failed", path);
      return;
    }
    // 1 MiB stdio buffer: record-sized freads otherwise degrade to many
    // small kernel reads for large records.
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    char magic[5] = {0};
    if (fread(magic, 1, 5, f) != 5 || memcmp(magic, "KFTR\x01", 5) != 0) {
      fail("bad magic (want KFTR v1)", path);
      fclose(f);
      return;
    }
    std::vector<Record> staging;
    staging.reserve(kBatchRecords);
    for (;;) {
      uint32_t len_le;
      size_t n = fread(&len_le, 1, 4, f);
      if (n == 0) break;  // clean EOF
      if (n != 4) {
        fail("truncated length", path);
        break;
      }
      uint64_t len = len_le;
      // A corrupt length prefix must surface as a loader error, not a
      // multi-GiB malloc; no KFTR shard record is anywhere near this.
      static const uint64_t kMaxRecordBytes = 1ull << 30;
      if (len > kMaxRecordBytes) {
        fail("record length exceeds 1 GiB cap (corrupt shard?)", path);
        break;
      }
      uint8_t* data = alloc(len);
      if (data == nullptr) {
        fail("allocation failed", path);
        break;
      }
      if (len && fread(data, 1, len, f) != len) {
        void* p = data;
        release_batch(&p, 1);
        fail("truncated payload", path);
        break;
      }
      staging.push_back(Record{data, len});
      if (staging.size() >= kBatchRecords) {
        if (!push_batch(std::move(staging))) {
          fclose(f);
          return;  // stopped
        }
        staging = std::vector<Record>();
        staging.reserve(kBatchRecords);
      }
    }
    push_batch(std::move(staging));
    fclose(f);
  }

  void reader_main() {
    std::string path;
    while (take_path(&path)) read_file(path);
    std::lock_guard<std::mutex> lock(mu);
    if (--active_readers == 0) not_empty.notify_all();
  }

  // Refill the consumer staging vector from the ring (blocking).
  // Returns false on end-of-data.  Consumer-side record handout then
  // runs lock-free out of `staged`.
  bool refill_staged() {
    std::unique_lock<std::mutex> lock(mu);
    not_empty.wait(lock, [&] {
      return !buffer.empty() || active_readers == 0 || stopped;
    });
    if (buffer.empty()) return false;
    staged = std::move(buffer.front());
    buffer.pop_front();
    buffered_records -= staged.size();
    staged_pos = 0;
    lock.unlock();
    not_full.notify_all();
    return true;
  }

  // Pop one record (blocking); false on end-of-data.
  bool pop(Record* out) {
    if (staged_pos >= staged.size() && !refill_staged()) return false;
    *out = staged[staged_pos++];
    return true;
  }

  // Pop up to max_n records; at most one lock acquisition (the refill).
  int pop_batch(Record* out, int max_n) {
    int n = 0;
    while (n < max_n) {
      if (staged_pos >= staged.size()) {
        // Don't block for a second batch once we have records in hand.
        if (n > 0) break;
        if (!refill_staged()) break;
      }
      out[n++] = staged[staged_pos++];
    }
    return n;
  }

  // Stacked-batch state: the schema locked in by the first record, plus
  // a pending record held between schema peek and the first fill.
  std::vector<SchemaEntry> schema;
  Record pending{nullptr, 0};
  bool has_pending = false;

  // Shuffled next: keep a reservoir topped up; emit a random element.
  bool next(Record* out) {
    if (shuffle_buffer <= 1) return pop(out);
    Record r;
    while (reservoir.size() < shuffle_buffer && pop(&r)) {
      reservoir.push_back(r);
    }
    if (reservoir.empty()) return false;
    size_t idx = rng() % reservoir.size();
    *out = reservoir[idx];
    if (pop(&r)) {
      reservoir[idx] = r;
    } else {
      reservoir[idx] = reservoir.back();
      reservoir.pop_back();
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* kft_loader_create(const char** paths, int n_paths, int n_threads,
                        int prefetch, int shuffle_buffer, uint64_t seed,
                        int repeat) {
  if (n_paths <= 0) return nullptr;
  // NOTE: no mallopt(M_MMAP_THRESHOLD) here even though record-sized
  // mallocs cross glibc's mmap threshold — that knob is process-global
  // (it would change allocator behavior for the embedding trainer and
  // disable glibc's dynamic threshold for good).  The loader-local
  // buffer pool below provides the reuse instead.
  auto* loader = new Loader();
  for (int i = 0; i < n_paths; ++i) loader->paths.emplace_back(paths[i]);
  loader->capacity = prefetch > 0 ? prefetch : 64;
  loader->shuffle_buffer = shuffle_buffer > 0 ? shuffle_buffer : 0;
  loader->rng.seed(seed);
  loader->repeat = repeat;
  if (n_threads < 1) n_threads = 1;
  loader->active_readers = n_threads;
  for (int i = 0; i < n_threads; ++i) {
    loader->readers.emplace_back([loader] { loader->reader_main(); });
  }
  return loader;
}

// Returns 1 and fills (*data, *len) on success; 0 on end-of-data.
// The caller owns *data and must release it with kft_free.
int kft_loader_next(void* handle, void** data, uint64_t* len) {
  auto* loader = static_cast<Loader*>(handle);
  Record r;
  if (!loader->next(&r)) return 0;
  loader->untrack(r.data);  // ownership moves to the caller (kft_free)
  *data = r.data;
  *len = r.len;
  return 1;
}

// Batched variant: fills up to max_n (data, len) pairs, returns the
// count (0 = end-of-data).  One FFI round-trip per batch instead of per
// record; every returned buffer is caller-owned (kft_free/_batch).
// Shuffled loaders still draw through the reservoir one at a time
// (correctness of the sampling), unshuffled ones drain the ring in one
// locked sweep.
int kft_loader_next_batch(void* handle, void** datas, uint64_t* lens,
                          int max_n) {
  auto* loader = static_cast<Loader*>(handle);
  if (max_n <= 0) return 0;
  if (loader->shuffle_buffer > 1) {
    int n = 0;
    Record r;
    while (n < max_n && loader->next(&r)) {
      datas[n] = r.data;
      lens[n] = r.len;
      ++n;
    }
    return n;
  }
  std::vector<Record> recs(static_cast<size_t>(max_n));
  int n = loader->pop_batch(recs.data(), max_n);
  for (int i = 0; i < n; ++i) {
    datas[i] = recs[i].data;
    lens[i] = recs[i].len;
  }
  return n;
}

// Return consumed buffers to the loader's pool for reader reuse.
void kft_loader_free_batch(void* handle, void** datas, int n) {
  static_cast<Loader*>(handle)->release_batch(datas, n);
}

// ---------------------------------------------------------------------
// Stacked batches: KTE1 decode + batch assembly inside the core.
//
// The per-record handout path costs two python-side copies per record
// (ctypes bytes, then np.stack) plus a GIL-bound decode loop; for
// batch-consuming trainers that loop IS the pipeline bottleneck.  Here
// the consumer instead asks the core to fill ONE contiguous buffer per
// schema key with `batch` records' tensors — python wraps the buffers
// zero-copy, so the python cost per BATCH is a ctypes call and a dict.
// ---------------------------------------------------------------------

// Peek the schema from the next record (held pending, not consumed).
// Writes "key|dtype|d0,d1;..." into buf.  Returns bytes written,
// 0 on end-of-data, -1 on error (not KTE1 / malformed / buf too small).
int kft_loader_schema(void* handle, char* buf, int buf_len) {
  auto* loader = static_cast<Loader*>(handle);
  if (!loader->has_pending) {
    if (!loader->next(&loader->pending)) return 0;
    loader->has_pending = true;
  }
  std::vector<TensorView> views;
  if (!parse_kte1(loader->pending.data, loader->pending.len,
                  &loader->schema, &views)) {
    loader->fail("not a KTE1 payload", "stacked batch");
    return -1;
  }
  // Lock-in validation: the consumer sizes its per-key buffers from
  // shape x dtype, and fill_batch memcpys nbytes — any disagreement
  // (corrupt or crafted record) would be a heap overflow, so it is an
  // error here, not later.  Keys must also survive the '|'/';'-joined
  // schema wire (the python side rejects such keys at encode time;
  // foreign shards fall back to the python decode path).
  for (const auto& e : loader->schema) {
    if (e.key.find('|') != std::string::npos ||
        e.key.find(';') != std::string::npos) {
      loader->fail("key contains schema separator", "stacked batch");
      return -1;
    }
    uint64_t itemsize = dtype_itemsize(e.dtype);
    uint64_t count = 1;
    for (int64_t d : e.shape) {
      if (d < 0) { count = 0; break; }
      count *= static_cast<uint64_t>(d);
    }
    if (itemsize == 0 || count * itemsize != e.nbytes) {
      loader->fail("record nbytes disagrees with shape x dtype",
                   "stacked batch");
      return -1;
    }
  }
  std::string out;
  for (size_t i = 0; i < loader->schema.size(); ++i) {
    const auto& e = loader->schema[i];
    if (i) out += ';';
    out += e.key;
    out += '|';
    out += e.dtype;
    out += '|';
    for (size_t d = 0; d < e.shape.size(); ++d) {
      if (d) out += ',';
      out += std::to_string(e.shape[d]);
    }
  }
  if (static_cast<int>(out.size()) + 1 > buf_len) {
    loader->fail("schema buffer too small", "stacked batch");
    return -1;
  }
  memcpy(buf, out.c_str(), out.size() + 1);
  return static_cast<int>(out.size());
}

// Fill caller-allocated per-key buffers with up to `batch` records.
// dests[k] must hold batch * schema[k].nbytes bytes.  Every record must
// match the locked-in schema (keys, order, dtype, shape).  Returns rows
// filled (0 = end-of-data), or -1 with the error set.
int kft_loader_fill_batch(void* handle, void** dests, int n_keys,
                          int batch) {
  auto* loader = static_cast<Loader*>(handle);
  if (loader->schema.empty()) {
    char tmp[4096];
    int rc = kft_loader_schema(handle, tmp, sizeof(tmp));
    if (rc <= 0) return rc;
  }
  if (n_keys != static_cast<int>(loader->schema.size())) {
    loader->fail("schema key-count mismatch", "stacked batch");
    return -1;
  }
  std::vector<SchemaEntry> entries;
  std::vector<TensorView> views;
  int row = 0;
  Record r;
  while (row < batch) {
    if (loader->has_pending) {
      r = loader->pending;
      loader->has_pending = false;
    } else if (!loader->next(&r)) {
      break;
    }
    bool ok = parse_kte1(r.data, r.len, &entries, &views);
    if (ok) {
      for (int k = 0; ok && k < n_keys; ++k) {
        const auto& want = loader->schema[k];
        const auto& got = entries[k];
        ok = got.key == want.key && got.dtype == want.dtype &&
             got.shape == want.shape && got.nbytes == want.nbytes;
      }
    }
    if (!ok) {
      void* p = r.data;
      loader->release_batch(&p, 1);
      loader->fail("record does not match batch schema", "stacked batch");
      return -1;
    }
    for (int k = 0; k < n_keys; ++k) {
      memcpy(static_cast<uint8_t*>(dests[k]) +
                 static_cast<uint64_t>(row) * loader->schema[k].nbytes,
             views[k].data, views[k].nbytes);
    }
    void* p = r.data;
    loader->release_batch(&p, 1);
    ++row;
  }
  return row;
}

// Handle-less variants (no pooling): for buffers from kft_loader_next.
void kft_free_batch(void** datas, int n) {
  for (int i = 0; i < n; ++i) free(datas[i]);
}

// Last error message ('' if none); valid until destroy.
const char* kft_loader_error(void* handle) {
  return static_cast<Loader*>(handle)->error;
}

void kft_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

void kft_free(void* data) { free(data); }

}  // extern "C"
