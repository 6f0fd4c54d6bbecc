// Real-batch sampling: uint8 row gather + [-1, 1] normalize + HWC -> CHW.
//
// Replaces the Pallas TPU kernel mdgan_tpu/ops/sampling.py:_sample_kernel
// (launched by sample_normalize, sampling.py:51-94): for each worker, gather
// b rows chosen by an index array from the (N, S, h*w*c) uint8 shard stack
// and write x * (2/255) - 1 once.  Here one launch covers a whole chunk of T
// rounds, idx (T, N, b), as the JAX engine's lax.scan covers a chunk, and the
// output is float32 NCHW, (T, N, b, c, h, w): the layout change the port's
// models need is folded into the kernel instead of costing a separate pass.
//
// What bounds it on an H100: bytes.  Each output row reads h*w*c bytes and
// writes 4x that; at the main path's chunk (T=100, N=8, b=10, 32x32x3) that
// is 122,912,000 B, 36.7 us at 3.35 TB/s.  The writes set the pace, so they
// are what the layout serves:
//  - one CTA per output row (T*N*b CTAs, 8,000 at the main path's chunk),
//    which reads its own index; an index outside [0, S) writes a NaN row
//    (the engine validates indices on the host);
//  - a thread takes 4 consecutive pixels, reads their h*w*c bytes through
//    the read-only cache (any alignment: the byte loads need none) and
//    writes one float4 per channel plane, so a warp writes 512 contiguous
//    bytes of each plane; planes with h*w % 4 != 0 take scalar stores.
// No shared memory, so a row of any size fits.  A persistent grid feeding a
// shared-memory ring by TMA bulk copies was measured slower than this on an
// H100 (mdgan_tpu_torch/cli/bench_sampling.py; it is kept there as the
// baseline "ring", csrc/baselines/sampling_baselines.cu).
//
// The affine step is one explicit fused multiply-add, __fmaf_rn(x, 2/255, -1),
// rounded once: that is what XLA computes for the JAX form under jit (and the
// Pallas kernel in interpret mode), and what the plain PyTorch version
// (mdgan_tpu_torch/ops/sampling.py:sample_normalize_plain) computes exactly in
// float64 before its one rounding, so all three are bit-equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float normalize(uint8_t x) {
  return __fmaf_rn((float)x, 2.0f / 255.0f, -1.0f);
}

__global__ void __launch_bounds__(kThreads)
    sample_normalize_kernel(const uint8_t* __restrict__ shards, const int32_t* __restrict__ idx,
                            float* __restrict__ out, int n_workers, int64_t shard_rows, int b,
                            int hw, int c) {
  const int64_t r = blockIdx.x;  // flat (t, worker, j)
  const int64_t worker = (r / b) % n_workers;
  const int32_t i = idx[r];
  const bool valid = i >= 0 && i < shard_rows;
  const int64_t row_bytes = (int64_t)hw * c;
  const uint8_t* src = shards + (worker * shard_rows + (valid ? i : 0)) * row_bytes;
  float* dst = out + r * row_bytes;
  const float nan = __int_as_float(0x7fc00000);
  if (hw % 4 == 0) {
    for (int q = threadIdx.x; q < hw / 4; q += kThreads) {
      const uint8_t* px = src + (int64_t)4 * q * c;
      for (int ch = 0; ch < c; ++ch) {
        float4 v = make_float4(nan, nan, nan, nan);
        if (valid)
          v = make_float4(normalize(__ldg(px + ch)), normalize(__ldg(px + c + ch)),
                          normalize(__ldg(px + 2 * c + ch)), normalize(__ldg(px + 3 * c + ch)));
        reinterpret_cast<float4*>(dst + (int64_t)ch * hw)[q] = v;
      }
    }
  } else {
    for (int ch = 0; ch < c; ++ch)
      for (int q = threadIdx.x; q < hw; q += kThreads)
        dst[(int64_t)ch * hw + q] = valid ? normalize(__ldg(src + (int64_t)q * c + ch)) : nan;
  }
}

}  // namespace

// shards: (n_workers, shard_rows, hw*c) uint8; idx: (rows,) int32, the flat
// (T, n_workers, b) indices, rows = T * n_workers * b; out: (rows, c, hw)
// float32, 16-byte aligned.
extern "C" int mdgan_sample_normalize_u8(const uint8_t* shards, const int32_t* idx, float* out,
                                         int64_t rows, int n_workers, int b,
                                         int64_t shard_rows, int hw, int c,
                                         cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_workers <= 0 || b <= 0 || hw <= 0 || c <= 0 ||
      rows % ((int64_t)n_workers * b) != 0 || rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  sample_normalize_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(shards, idx, out, n_workers,
                                                                    shard_rows, b, hw, c);
  return (int)cudaGetLastError();
}
