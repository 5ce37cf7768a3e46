// seedx_io — native shard reader for the seedx_tpu_torch data pipeline (a
// copy of seedx_tpu/data/native/seedx_io.cc; keep the two identical).
//
// The reference trains through torchdata's DataLoader2 whose readers are
// C++-backed (reference: src/train/train_sft.py dataloader section); the
// equivalent here is this small library: N worker threads stream
// ustar-format webdataset shards from disk and push (shard_id, member_name,
// bytes) records into one bounded ring; Python groups members into samples
// per shard and does the (PIL) decode.  Corrupt headers/members are skipped,
// matching the reference's exception-swallowing TarArchiveLoaderWoException
// (src/data/datapipes.py:15-44).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

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

namespace {

struct Record {
  int32_t shard_id;        // index into the open() path list
  std::string name;        // tar member name
  std::vector<uint8_t> data;
  bool end_of_shard;       // sentinel flushed after a shard finishes
};

struct Reader {
  std::vector<std::string> paths;
  size_t queue_cap;
  std::deque<Record> queue;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
  std::atomic<size_t> next_shard{0};
  std::atomic<int> live_workers{0};
  std::vector<std::thread> workers;
  bool closed = false;

  void push(Record&& r) {
    std::unique_lock<std::mutex> lk(mu);
    not_full.wait(lk, [&] { return queue.size() < queue_cap || closed; });
    if (closed) return;
    queue.push_back(std::move(r));
    not_empty.notify_one();
  }
};

// Parse one ustar header block; returns member size or -1 on a corrupt
// header (NUL block handled by caller).  Supports the GNU 'L' long-name
// extension the way webdataset shards use it.
int64_t octal_field(const char* p, size_t n) {
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') return -1;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

void read_shard(Reader* r, int32_t shard_id) {
  const std::string& path = r->paths[shard_id];
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    std::fprintf(stderr, "seedx_io: skipping unreadable shard %s\n",
                 path.c_str());
    return;
  }
  char header[512];
  std::string long_name;
  while (std::fread(header, 1, 512, f) == 512) {
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (header[i]) { all_zero = false; break; }
    if (all_zero) break;  // end-of-archive

    int64_t size = octal_field(header + 124, 12);
    if (size < 0) {
      std::fprintf(stderr, "seedx_io: corrupt header in %s, dropping rest\n",
                   path.c_str());
      break;
    }
    char type = header[156];
    std::string name;
    if (!long_name.empty()) {
      name.swap(long_name);
    } else {
      name.assign(header, strnlen(header, 100));
    }
    int64_t padded = (size + 511) & ~int64_t(511);

    if (type == 'L') {  // GNU long name: data block holds the real name
      std::vector<char> buf(padded);
      if ((int64_t)std::fread(buf.data(), 1, padded, f) != padded) break;
      long_name.assign(buf.data(), strnlen(buf.data(), size));
      continue;
    }
    if (type == 'x' || type == 'X') {  // PAX extended header (python tarfile
      // default): records are "<len> <keyword>=<value>\n"; "path" overrides
      // the next member's name.
      std::vector<char> buf(padded);
      if ((int64_t)std::fread(buf.data(), 1, padded, f) != padded) break;
      int64_t pos = 0;
      while (pos < size) {
        long rec_len = std::strtol(buf.data() + pos, nullptr, 10);
        if (rec_len <= 0 || pos + rec_len > size) break;
        std::string rec(buf.data() + pos, rec_len);
        size_t sp = rec.find(' '), eq = rec.find('=');
        if (sp != std::string::npos && eq != std::string::npos && eq > sp) {
          std::string kw = rec.substr(sp + 1, eq - sp - 1);
          if (kw == "path") {
            // value runs to the trailing newline
            long_name = rec.substr(eq + 1, rec.size() - eq - 2);
          }
        }
        pos += rec_len;
      }
      continue;
    }
    if (type == 'g') {  // PAX global header: skip payload
      if (std::fseek(f, padded, SEEK_CUR) != 0) break;
      continue;
    }
    if (type != '0' && type != '\0') {  // not a regular file: skip payload
      if (std::fseek(f, padded, SEEK_CUR) != 0) break;
      continue;
    }
    Record rec;
    rec.shard_id = shard_id;
    rec.name = std::move(name);
    rec.data.resize(size);
    rec.end_of_shard = false;
    if ((int64_t)std::fread(rec.data.data(), 1, size, f) != size) {
      std::fprintf(stderr, "seedx_io: truncated member in %s\n", path.c_str());
      break;
    }
    if (std::fseek(f, padded - size, SEEK_CUR) != 0) break;
    r->push(std::move(rec));
  }
  std::fclose(f);
  Record eos;
  eos.shard_id = shard_id;
  eos.end_of_shard = true;
  r->push(std::move(eos));
}

void worker(Reader* r) {
  for (;;) {
    size_t i = r->next_shard.fetch_add(1);
    if (i >= r->paths.size()) break;
    read_shard(r, (int32_t)i);
  }
  if (r->live_workers.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lk(r->mu);
    r->not_empty.notify_all();
  }
}

}  // namespace

extern "C" {

void* sx_tar_open(const char** paths, int n_paths, int n_threads,
                  int queue_cap) {
  Reader* r = new Reader();
  r->paths.assign(paths, paths + n_paths);
  r->queue_cap = queue_cap > 0 ? queue_cap : 64;
  int nt = n_threads > 0 ? n_threads : 4;
  if (nt > n_paths && n_paths > 0) nt = n_paths;
  r->live_workers = nt;
  for (int i = 0; i < nt; ++i) r->workers.emplace_back(worker, r);
  return r;
}

// Returns 1 and fills the out params on a member record, 2 on an
// end-of-shard sentinel (shard_id valid), 0 when the stream is exhausted.
// data_out is malloc'd; free with sx_free.
int sx_tar_next(void* h, int32_t* shard_id, char* name_out, int name_cap,
                uint8_t** data_out, uint64_t* size_out) {
  Reader* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_empty.wait(lk, [&] {
    return !r->queue.empty() || r->live_workers.load() == 0;
  });
  if (r->queue.empty()) return 0;
  Record rec = std::move(r->queue.front());
  r->queue.pop_front();
  r->not_full.notify_one();
  lk.unlock();

  *shard_id = rec.shard_id;
  if (rec.end_of_shard) return 2;
  std::snprintf(name_out, name_cap, "%s", rec.name.c_str());
  *size_out = rec.data.size();
  *data_out = (uint8_t*)std::malloc(rec.data.size());
  std::memcpy(*data_out, rec.data.data(), rec.data.size());
  return 1;
}

void sx_free(uint8_t* p) { std::free(p); }

void sx_tar_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
    r->not_full.notify_all();
  }
  // drain so workers blocked on push can exit
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(r->mu);
      r->queue.clear();
    }
    if (r->live_workers.load() == 0) break;
    std::this_thread::yield();
  }
  for (auto& t : r->workers) t.join();
  delete r;
}

}  // extern "C"
