// Native host data path of mdgan_tpu_torch: raw-format dataset decoding and
// the threaded row gather that materializes per-worker shards, in C++ with
// std::thread fan-out, behind a plain C ABI loaded with ctypes
// (mdgan_tpu_torch/data/native/__init__.py, which also holds a plain numpy
// version of each function).
//
// After mdgan_tpu/data/native/fastloader.cpp:12-133: the functions, their
// signatures and return conventions are unchanged.  One change of method:
// decode_cifar10_bin reads up to 8,192 records per fread and interleaves
// them on several threads, where the original reads one 3,073-byte record
// per fread (a read syscall every 4 KiB) and interleaves on one thread.  No
// GPU code: this is host code, built with
//   g++ -O3 -shared -fPIC -pthread fastloader.cpp -o libfastloader_<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Runs work(lo, hi) over [0, num_rows) split across up to num_threads
// threads; on the calling thread alone below min_rows rows.
template <typename Work>
void parallel_rows(int64_t num_rows, int num_threads, int64_t min_rows, Work work) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads == 1 || num_rows < min_rows) {
    work(0, num_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (num_rows + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(num_rows, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

int host_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : (int)std::min(8u, n);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// CIFAR-10 binary format (cifar-10-batches-bin/data_batch_N.bin):
// 10000 records of [1 label byte][3072 pixel bytes, CHW planar].
// Decodes to NHWC uint8 and int64 labels. Returns #examples or -1.
// Whole records only: a file's trailing partial record is ignored.
// ---------------------------------------------------------------------------
int64_t decode_cifar10_bin(const char* dir, uint8_t* out, int64_t* labels,
                           int64_t max_examples, int train) {
  const int64_t kRecord = 1 + 3072;
  const int64_t kChunk = 8192;  // records per fread (25 MB)
  std::vector<std::string> files;
  if (train) {
    for (int i = 1; i <= 5; ++i)
      files.push_back(std::string(dir) + "/data_batch_" + std::to_string(i) + ".bin");
  } else {
    files.push_back(std::string(dir) + "/test_batch.bin");
  }
  const int threads = host_threads();
  int64_t n = 0;
  std::vector<uint8_t> buf;
  for (const auto& path : files) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return -1;
    while (n < max_examples) {
      int64_t want = std::min(kChunk, max_examples - n);
      buf.resize(want * kRecord);
      int64_t got = (int64_t)fread(buf.data(), 1, want * kRecord, f) / kRecord;
      const uint8_t* src = buf.data();
      uint8_t* dst0 = out + n * 3072;
      int64_t* lab0 = labels + n;
      parallel_rows(got, threads, 1024, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
          const uint8_t* rec = src + i * kRecord;
          lab0[i] = rec[0];
          // CHW planar -> HWC interleaved
          uint8_t* dst = dst0 + i * 3072;
          const uint8_t* r = rec + 1;
          const uint8_t* g = r + 1024;
          const uint8_t* b = g + 1024;
          for (int p = 0; p < 1024; ++p) {
            dst[p * 3 + 0] = r[p];
            dst[p * 3 + 1] = g[p];
            dst[p * 3 + 2] = b[p];
          }
        }
      });
      n += got;
      if (got < want) break;  // end of file
    }
    fclose(f);
    if (n >= max_examples) break;
  }
  return n;
}

// ---------------------------------------------------------------------------
// MNIST idx3 image file (big-endian header: magic, n, rows, cols).
// Returns #examples or -1.
// ---------------------------------------------------------------------------
static uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int64_t decode_mnist_idx(const char* path, uint8_t* out, int64_t max_examples,
                         int64_t buf_capacity, int64_t* rows_out,
                         int64_t* cols_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[16];
  if (fread(hdr, 1, 16, f) != 16) { fclose(f); return -1; }
  uint32_t magic = be32(hdr);
  if (magic != 0x00000803) { fclose(f); return -1; }
  int64_t n = be32(hdr + 4), rows = be32(hdr + 8), cols = be32(hdr + 12);
  if (rows <= 0 || cols <= 0) { fclose(f); return -1; }
  if (n > max_examples) n = max_examples;
  // never trust header dims past the caller's buffer
  if (n * rows * cols > buf_capacity) { fclose(f); return -1; }
  *rows_out = rows;
  *cols_out = cols;
  int64_t want = n * rows * cols;
  int64_t got = (int64_t)fread(out, 1, want, f);
  fclose(f);
  return got == want ? n : -1;
}

int64_t decode_mnist_labels(const char* path, int64_t* out, int64_t max_examples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[8];
  if (fread(hdr, 1, 8, f) != 8) { fclose(f); return -1; }
  if (be32(hdr) != 0x00000801) { fclose(f); return -1; }
  int64_t n = be32(hdr + 4);
  if (n > max_examples) n = max_examples;
  std::vector<uint8_t> tmp(n);
  if ((int64_t)fread(tmp.data(), 1, n, f) != n) { fclose(f); return -1; }
  fclose(f);
  for (int64_t i = 0; i < n; ++i) out[i] = tmp[i];
  return n;
}

// ---------------------------------------------------------------------------
// Threaded row gather: out[i] = data[idx[i]] for row_bytes-sized rows.
// The shard-materialization hot path (partitioner.shard_data) — numpy fancy
// indexing is single-threaded; this saturates memory bandwidth.
// ---------------------------------------------------------------------------
void gather_rows(const uint8_t* data, const int64_t* idx, uint8_t* out,
                 int64_t num_rows, int64_t row_bytes, int num_threads) {
  parallel_rows(num_rows, num_threads, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      memcpy(out + i * row_bytes, data + idx[i] * row_bytes, row_bytes);
  });
}

}  // extern "C"
