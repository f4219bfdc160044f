// Host data pipeline of the PyTorch port: a bounded, threaded, deterministic
// batcher over host record arrays, built with the host compiler and loaded
// through ctypes (plain C interface).
//
// Worker threads gather records into a ring of `depth` slots while the
// consumer (blocked in device work) takes batches in order. Two modes:
//   - seeded: each epoch is a Fisher-Yates permutation of the records from
//     mt19937_64(seed + epoch * 0x9E3779B97F4A7C15);
//   - explicit order: the caller gives the per-epoch record order
//     ([n_epochs, order_len], epochs wrap modulo), e.g. a federated trainer
//     streaming only a client's real records in its training order.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> x, y;
  int64_t count = 0;  // records in this batch
  int64_t seq = -1;   // the batch sequence number it holds
  bool ready = false;
};

struct Pipeline {
  const uint8_t* x = nullptr;
  const uint8_t* y = nullptr;
  int64_t n_records = 0, x_rec_bytes = 0, y_rec_bytes = 0, batch = 0;
  bool drop_last = false;
  uint64_t seed = 0;
  int64_t n_batches = 0;  // per epoch

  // explicit-order mode: an owned copy, [ext_epochs, ext_len] row-major
  std::vector<int64_t> ext_orders;
  int64_t ext_epochs = 0, ext_len = 0;

  std::vector<Slot> slots;
  std::atomic<int64_t> next_fetch{0};  // next batch to be produced
  int64_t next_deliver = 0;            // next batch the consumer takes
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool stop = false;
  std::vector<std::thread> workers;

  // Seeded permutations, built on first use and shared, so a worker keeps
  // its epoch's permutation alive after the map prunes it (with a tiny
  // dataset the batches in flight can span more epochs than the map keeps).
  std::map<int64_t, std::shared_ptr<std::vector<int64_t>>> perms;
  std::mutex perm_mu;

  std::shared_ptr<std::vector<int64_t>> perm_for_epoch(int64_t e) {
    std::lock_guard<std::mutex> g(perm_mu);
    auto it = perms.find(e);
    if (it != perms.end()) return it->second;
    auto p = std::make_shared<std::vector<int64_t>>(n_records);
    for (int64_t i = 0; i < n_records; ++i) (*p)[i] = i;
    std::mt19937_64 rng(seed + static_cast<uint64_t>(e) * 0x9E3779B97F4A7C15ull);
    for (int64_t i = n_records - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
      std::swap((*p)[i], (*p)[j]);
    }
    while (perms.size() >= 3) perms.erase(perms.begin());
    perms.emplace(e, p);
    return p;
  }

  void fill(int64_t seq_no, Slot& s) {
    int64_t epoch = seq_no / n_batches;
    int64_t start = (seq_no % n_batches) * batch;
    const int64_t* src_idx;
    int64_t limit;
    std::shared_ptr<std::vector<int64_t>> keepalive;
    if (!ext_orders.empty()) {
      src_idx = ext_orders.data() + (epoch % ext_epochs) * ext_len + start;
      limit = ext_len;
    } else {
      keepalive = perm_for_epoch(epoch);
      src_idx = keepalive->data() + start;
      limit = n_records;
    }
    int64_t count = std::min(batch, limit - start);
    for (int64_t r = 0; r < count; ++r) {
      int64_t src = src_idx[r];
      std::memcpy(s.x.data() + r * x_rec_bytes, x + src * x_rec_bytes, x_rec_bytes);
      if (y_rec_bytes)
        std::memcpy(s.y.data() + r * y_rec_bytes, y + src * y_rec_bytes, y_rec_bytes);
    }
    s.count = count;
  }

  void worker_loop() {
    for (;;) {
      int64_t seq_no = next_fetch.fetch_add(1, std::memory_order_relaxed);
      Slot& s = slots[seq_no % slots.size()];
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until the consumer has taken what this slot held (delivery
        // is in order, so batch seq_no - depth comes first)
        cv_free.wait(lk, [&] {
          return stop || (!s.ready && next_deliver + static_cast<int64_t>(slots.size()) > seq_no);
        });
        if (stop) return;
      }
      fill(seq_no, s);
      {
        std::lock_guard<std::mutex> lk(mu);
        s.seq = seq_no;
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }

  void start(int n_threads, int depth) {
    if (depth < 2) depth = 2;
    slots.resize(depth);
    for (auto& s : slots) {
      s.x.resize(static_cast<size_t>(batch) * x_rec_bytes);
      s.y.resize(static_cast<size_t>(batch) * (y_rec_bytes ? y_rec_bytes : 1));
    }
    n_threads = std::max(1, std::min(n_threads, depth));
    for (int t = 0; t < n_threads; ++t) workers.emplace_back([this] { worker_loop(); });
  }
};

}  // namespace

extern "C" void* fed_pipeline_create(const uint8_t* x, const uint8_t* y, int64_t n_records,
                                     int64_t x_rec_bytes, int64_t y_rec_bytes, int64_t batch,
                                     uint64_t seed, int n_threads, int depth, int drop_last) {
  if (n_records <= 0 || batch <= 0 || x_rec_bytes <= 0) return nullptr;
  int64_t n_batches = drop_last ? n_records / batch : (n_records + batch - 1) / batch;
  if (n_batches <= 0) return nullptr;
  auto* p = new Pipeline;
  p->x = x;
  p->y = y;
  p->n_records = n_records;
  p->x_rec_bytes = x_rec_bytes;
  p->y_rec_bytes = y_rec_bytes;
  p->batch = batch;
  p->drop_last = drop_last != 0;
  p->seed = seed;
  p->n_batches = n_batches;
  p->start(n_threads, depth);
  return p;
}

extern "C" void* fed_pipeline_create_ordered(const uint8_t* x, const uint8_t* y,
                                             int64_t n_records, int64_t x_rec_bytes,
                                             int64_t y_rec_bytes, int64_t batch,
                                             const int64_t* orders, int64_t n_epochs,
                                             int64_t order_len, int n_threads, int depth) {
  if (n_records <= 0 || batch <= 0 || x_rec_bytes <= 0 || orders == nullptr || n_epochs <= 0 ||
      order_len <= 0)
    return nullptr;
  // a bad entry fails here, not in a worker mid-copy
  for (int64_t i = 0; i < n_epochs * order_len; ++i)
    if (orders[i] < 0 || orders[i] >= n_records) return nullptr;
  auto* p = new Pipeline;
  p->x = x;
  p->y = y;
  p->n_records = n_records;
  p->x_rec_bytes = x_rec_bytes;
  p->y_rec_bytes = y_rec_bytes;
  p->batch = batch;
  p->ext_orders.assign(orders, orders + n_epochs * order_len);
  p->ext_epochs = n_epochs;
  p->ext_len = order_len;
  p->n_batches = (order_len + batch - 1) / batch;
  p->start(n_threads, depth);
  return p;
}

// Blocks until the next batch in order is ready, copies it out and frees
// its slot. Returns its record count (a full batch, or fewer for the last
// batch of an epoch without drop_last), or -1 once the pipeline stopped.
extern "C" int64_t fed_pipeline_next(void* pv, uint8_t* x_out, uint8_t* y_out) {
  auto* p = static_cast<Pipeline*>(pv);
  int64_t want = p->next_deliver;
  Slot& s = p->slots[want % p->slots.size()];
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return p->stop || (s.ready && s.seq == want); });
    if (p->stop) return -1;
  }
  int64_t count = s.count;
  std::memcpy(x_out, s.x.data(), static_cast<size_t>(count) * p->x_rec_bytes);
  if (p->y_rec_bytes && y_out)
    std::memcpy(y_out, s.y.data(), static_cast<size_t>(count) * p->y_rec_bytes);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    s.ready = false;
    p->next_deliver = want + 1;
  }
  p->cv_free.notify_all();
  return count;
}

extern "C" int64_t fed_pipeline_batches_per_epoch(void* pv) {
  return static_cast<Pipeline*>(pv)->n_batches;
}

extern "C" void fed_pipeline_destroy(void* pv) {
  auto* p = static_cast<Pipeline*>(pv);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_ready.notify_all();
  p->cv_free.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}
