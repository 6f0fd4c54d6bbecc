// Baselines for the sampling kernel (csrc/sampling.cu), built only by
// mdgan_tpu_torch/cli/bench_sampling.py and never on the training path.
// Both compute what csrc/sampling.cu computes, bit for bit: idx (rows,) is the
// flat (T, n_workers, b) index array, out is (rows, c, hw) float32, and an
// index outside [0, shard_rows) gives a NaN row.
//
//  - mdgan_sample_scalar_u8: the port's first sampling kernel, one CTA per
//    (row, worker), each thread reading 16 source bytes and making 16 scalar
//    NCHW stores, with the round axis folded into grid.y: grid
//    (b, T * n_workers).  With T = 1 it is that kernel's launch exactly.
//  - mdgan_sample_ring_u8: a persistent grid (up to 4 CTAs per SM, the SM
//    count read once per device) walking the rows with a grid stride; thread
//    0 of a CTA issues a TMA bulk copy (cp.async.bulk, completion on an
//    mbarrier) of each source row into a ring of up to 4 shared-memory row
//    buffers, and the CTA converts one row while the copies of its next rows
//    are in flight, writing float4 NCHW stores as csrc/sampling.cu does.
//    Rows that are not a multiple of 16 B, or an unaligned shard stack, take
//    a plain byte-load path; rings above 48 KB raise the kernel's dynamic
//    shared memory limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float normalize(uint8_t x) {
  return __fmaf_rn((float)x, 2.0f / 255.0f, -1.0f);
}

__global__ void scalar_kernel(const uint8_t* __restrict__ shards, const int32_t* __restrict__ idx,
                           float* __restrict__ out, int n_workers, int64_t shard_rows, int b,
                           int hw, int c) {
  const int row = blockIdx.x;                            // 0..b-1
  const int64_t group = blockIdx.y;                      // t * n_workers + worker
  const int worker = (int)(group % n_workers);
  const int64_t row_bytes = (int64_t)hw * c;
  const int32_t src_row = idx[group * b + row];
  float* dst = out + (group * b + row) * row_bytes;
  if (src_row < 0 || src_row >= shard_rows) {
    for (int64_t o = threadIdx.x; o < row_bytes; o += blockDim.x) dst[o] = __int_as_float(0x7fc00000);
    return;
  }
  const uint8_t* src = shards + ((int64_t)worker * shard_rows + src_row) * row_bytes;
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(shards) % 16 == 0) {
    const uint4* src16 = reinterpret_cast<const uint4*>(src);
    for (int64_t v = threadIdx.x; v < row_bytes / 16; v += blockDim.x) {
      uint4 q = src16[v];
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&q);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int64_t off = v * 16 + j;  // HWC offset
        int64_t pix = off / c;
        int ch = (int)(off - pix * c);
        dst[(int64_t)ch * hw + pix] = normalize(bytes[j]);
      }
    }
  } else {
    for (int64_t off = threadIdx.x; off < row_bytes; off += blockDim.x) {
      int64_t pix = off / c;
      int ch = (int)(off - pix * c);
      dst[(int64_t)ch * hw + pix] = normalize(src[off]);
    }
  }
}

constexpr int kThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kMaxCtasPerSm = 4;
constexpr int kRingBudget = 100 * 1024;    // shared memory the ring aims to stay under
constexpr int kSmemPerSm = 228 * 1024;     // H100: shared memory of one SM
constexpr int kSmemPerCta = 227 * 1024;    // H100: most one CTA may use
constexpr int kSmemReserved = 1024;        // per CTA, kept by the system
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Bulk copy global -> shared; completion is reported to ``bar`` as bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Params {
  const uint8_t* shards;  // (n_workers, shard_rows, row_bytes)
  const int32_t* idx;     // (rows,) = (T, n_workers, b) flat
  float* out;             // (rows, c, hw)
  int64_t rows;           // T * n_workers * b
  int64_t shard_rows;
  int n_workers;
  int b;
  int hw;
  int c;
  int row_bytes;          // hw * c
  int stage_bytes;        // row_bytes rounded up to 16
  int stages;
  bool tma;               // rows and base 16 B aligned: bulk copies
};

// Index of output row r in its worker's shard, or -1 if out of range.
__device__ __forceinline__ int64_t source_row(const Params& p, int64_t r) {
  const int32_t i = p.idx[r];
  return (i < 0 || i >= p.shard_rows) ? -1 : (int64_t)i;
}

__device__ __forceinline__ const uint8_t* source_ptr(const Params& p, int64_t r, int64_t i) {
  const int64_t worker = (r / p.b) % p.n_workers;
  return p.shards + (worker * p.shard_rows + i) * (int64_t)p.row_bytes;
}

// Thread 0: start the copy of output row r into ring stage s.
__device__ __forceinline__ void issue(const Params& p, int64_t r, uint8_t* buf, uint64_t* bar) {
  const int64_t i = source_row(p, r);
  if (i < 0) {
    mbar_arrive(bar);  // completes the phase with no bytes: the row is NaN
    return;
  }
  // order this CTA's earlier generic reads of ``buf`` before the async write
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive_expect_tx(bar, (uint32_t)p.row_bytes);
  bulk_copy_g2s(buf, source_ptr(p, r, i), (uint32_t)p.row_bytes, bar);
}

// All threads: write one row, NCHW, from its bytes in shared memory.
__device__ __forceinline__ void convert(const Params& p, const uint8_t* buf, float* dst,
                                        bool valid) {
  const float nan = __int_as_float(0x7fc00000);
  const int c = p.c, hw = p.hw;
  if (hw % 4 == 0) {
    const int hw4 = hw / 4;
    for (int ch = 0; ch < c; ++ch) {
      float4* plane = reinterpret_cast<float4*>(dst + (int64_t)ch * hw);
      for (int q = threadIdx.x; q < hw4; q += kThreads) {
        float4 v = make_float4(nan, nan, nan, nan);
        if (valid) {
          const uint8_t* src = buf + 4 * q * c + ch;
          v = make_float4(normalize(src[0]), normalize(src[c]), normalize(src[2 * c]),
                          normalize(src[3 * c]));
        }
        plane[q] = v;
      }
    }
  } else {
    for (int ch = 0; ch < c; ++ch) {
      float* plane = dst + (int64_t)ch * hw;
      for (int q = threadIdx.x; q < hw; q += kThreads)
        plane[q] = valid ? normalize(buf[q * c + ch]) : nan;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + 128;  // barriers first, buffers 128 B aligned after them
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t row_floats = (int64_t)p.row_bytes;

  if (!p.tma) {
    // plain load path: bytes -> shared memory, then the same conversion
    for (int64_t r = first; r < p.rows; r += step) {
      const int64_t i = source_row(p, r);
      if (i >= 0) {
        const uint8_t* src = source_ptr(p, r, i);
        for (int o = threadIdx.x; o < p.row_bytes; o += kThreads) ring[o] = src[o];
      }
      __syncthreads();
      convert(p, ring, p.out + r * row_floats, i >= 0);
      __syncthreads();
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // prologue: the CTA's first ``stages`` rows in flight
    for (int s = 0; s < p.stages; ++s) {
      const int64_t r = first + s * step;
      if (r < p.rows) issue(p, r, ring + s * p.stage_bytes, &bars[s]);
    }
  }
  __syncthreads();

  int64_t k = 0;  // rows this CTA has converted
  for (int64_t r = first; r < p.rows; r += step, ++k) {
    const int s = (int)(k % p.stages);
    uint8_t* buf = ring + s * p.stage_bytes;
    mbar_wait(&bars[s], (uint32_t)((k / p.stages) & 1));
    convert(p, buf, p.out + r * row_floats, source_row(p, r) >= 0);
    __syncthreads();  // every thread is done with ``buf``
    if (threadIdx.x == 0) {
      const int64_t next = r + (int64_t)p.stages * step;
      if (next < p.rows) issue(p, next, buf, &bars[s]);
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    cached[dev] = n;
  }
  return cached[dev];
}

// Raise the kernel's dynamic shared memory limit to ``bytes`` on the current
// device, once per device and size.
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

}  // namespace

// Both: the signature of mdgan_sample_normalize_u8 (csrc/sampling.cu).
extern "C" int mdgan_sample_ring_u8(const uint8_t* shards, const int32_t* idx, float* out,
                                    int64_t rows, int n_workers, int b, int64_t shard_rows,
                                    int hw, int c, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_workers <= 0 || b <= 0 || hw <= 0 || c <= 0 || rows % ((int64_t)n_workers * b) != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.shards = shards;
  p.idx = idx;
  p.out = out;
  p.rows = rows;
  p.shard_rows = shard_rows;
  p.n_workers = n_workers;
  p.b = b;
  p.hw = hw;
  p.c = c;
  const int64_t row_bytes = (int64_t)hw * c;
  p.row_bytes = (int)row_bytes;
  p.stage_bytes = (int)((row_bytes + 15) / 16 * 16);
  p.tma = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(shards) % 16 == 0;
  p.stages = 1;
  if (p.tma) {
    const int64_t fit = kRingBudget / (int64_t)p.stage_bytes;
    p.stages = (int)(fit < 1 ? 1 : (fit > kMaxStages ? kMaxStages : fit));
  }
  const int64_t smem = 128 + (int64_t)p.stages * p.stage_bytes;
  if (row_bytes > (int64_t)1 << 30 || smem > kSmemPerCta) return (int)cudaErrorInvalidValue;

  cudaError_t err = allow_smem((int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  int per_sm = (int)(kSmemPerSm / (smem + kSmemReserved));
  per_sm = per_sm < 1 ? 1 : (per_sm > kMaxCtasPerSm ? kMaxCtasPerSm : per_sm);
  const int64_t ctas = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(rows < ctas ? rows : ctas);
  ring_kernel<<<grid, kThreads, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mdgan_sample_scalar_u8(const uint8_t* shards, const int32_t* idx, float* out,
                                   int64_t rows, int n_workers, int b, int64_t shard_rows,
                                   int hw, int c, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_workers <= 0 || b <= 0 || rows % ((int64_t)n_workers * b) != 0 || rows / b > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)b, (unsigned)(rows / b));
  scalar_kernel<<<grid, 256, 0, stream>>>(shards, idx, out, n_workers, shard_rows, b, hw, c);
  return (int)cudaGetLastError();
}
