// Real-batch sampling: uint8 row gather + [-1, 1] normalize + HWC -> CHW.
//
// Replaces the Pallas TPU kernel mdgan_tpu/ops/sampling.py:_sample_kernel
// (launched by sample_normalize, sampling.py:51-94): for each worker, gather
// b rows chosen by an index array from the (N, S, h*w*c) uint8 shard stack
// and write x * (2/255) - 1 once.  Here the output is float32 NCHW,
// (N, b, c, h, w): the layout change the port's models need is folded into
// the kernel instead of costing a separate transpose pass.
//
// What bounds it on an H100: launch latency, not bytes.  The main path
// (N=8, b=10, 32x32x3) reads 245,760 B and writes 983,040 B per round:
// ~1.2 MB, 0.37 us at 3.35 TB/s, far below the few microseconds of a launch.
//
// What the design does about it: one block per (row, worker), which reads its
// own index (what scalar prefetch did on the TPU), then its 3,072 source
// bytes as 16 B per thread, each byte crossing device memory once; the
// float32 image is written once.  The TPU's 128-byte row rule
// (sampling.py:69-70) does not apply; rows whose length is not a multiple of
// 16 take a byte loop.  An index outside [0, S) writes NaN rather than
// reading out of bounds (the engine validates indices on the host).
//
// The affine step is one explicit fused multiply-add, __fmaf_rn(x, 2/255, -1),
// rounded once: that is what XLA computes for the JAX form under jit (and the
// Pallas kernel in interpret mode), and what the plain PyTorch version
// (mdgan_tpu_torch/ops/sampling.py:sample_normalize_plain) computes exactly in
// float64 before its one rounding, so all three are bit-equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float normalize(uint8_t x) {
  return __fmaf_rn((float)x, 2.0f / 255.0f, -1.0f);
}

__global__ void sample_normalize_kernel(const uint8_t* __restrict__ shards,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ out,
                                        int64_t shard_rows, int b, int hw, int c) {
  const int row = blockIdx.x;     // 0..b-1
  const int worker = blockIdx.y;  // 0..N-1
  const int64_t row_bytes = (int64_t)hw * c;
  const int32_t src_row = idx[worker * b + row];
  float* dst = out + ((int64_t)worker * b + row) * row_bytes;
  if (src_row < 0 || src_row >= shard_rows) {
    for (int64_t o = threadIdx.x; o < row_bytes; o += blockDim.x) dst[o] = __int_as_float(0x7fc00000);
    return;
  }
  const uint8_t* src = shards + ((int64_t)worker * shard_rows + src_row) * row_bytes;
  if (row_bytes % 16 == 0) {
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

}  // namespace

// shards: (n_workers, shard_rows, hw*c) uint8, 16-byte aligned base;
// idx: (n_workers, b) int32; out: (n_workers, b, c, hw) float32.
extern "C" int mdgan_sample_normalize_u8(const uint8_t* shards, const int32_t* idx,
                                         float* out, int n_workers, int64_t shard_rows,
                                         int b, int hw, int c, cudaStream_t stream) {
  if (n_workers <= 0 || b <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)b, (unsigned)n_workers);
  sample_normalize_kernel<<<grid, 256, 0, stream>>>(shards, idx, out, shard_rows, b, hw, c);
  return (int)cudaGetLastError();
}
