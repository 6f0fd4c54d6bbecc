// FIR resampling (upfirdn2d): upsample by inserting zeros, pad, a 2-D FIR,
// downsample.
//
// StyleGAN2's resampling (Karras et al., CVPR 2020; NVlabs/stylegan2,
// dnnlib/tflib/ops/upfirdn_2d.py, whose own CUDA op this replaces): every
// plane (one channel of one sample) of an NCHW tensor x of in_h x in_w is
//
//   1. upsampled by `up`: up - 1 zeros after each pixel, in each direction;
//   2. padded by (pad_x0, pad_x1, pad_y0, pad_y1) zeros (a negative pad crops);
//   3. convolved (a true convolution: the filter flipped) with the kh x kw FIR k;
//   4. downsampled by `down`: every down-th pixel, from the first.
//
// So output (oy, ox) is
//
//   sum_{ty, tx} p[oy * down + ty][ox * down + tx] * k[kh - 1 - ty][kw - 1 - tx]
//
// with p the upsampled, padded plane: p[j] = x[(j - pad0) / up] where
// j - pad0 is a non-negative multiple of up inside the plane, else 0.  The
// end pads set the output's size only (the host computes out_h and out_w).
// The gradient is the same operation with the filter flipped and up and
// down swapped (mdgan_tpu_torch/ops/upfirdn2d.py).
//
// A direct kernel: one output element a thread, a grid-stride loop over the
// flat (plane, oy, ox) outputs, so a warp writes 32 consecutive outputs of a
// row and reads the rows above them through the read-only cache.  Inputs and
// outputs are float32 or bfloat16; the sum is float32, rounded once.  The
// filter travels by value in the kernel's parameters.  Only the resamplings
// the models run are compiled, each with its constants: a 4 x 4 filter with
// (up, down) = (1, 1), (2, 1) or (1, 2); any other is refused.  (Blocks of
// 32 x 8 outputs of one plane, the grid's z walking the planes, ran slower
// on an H100 at StyleGAN2 config-f's shapes.)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 4;  // the filter is kTaps x kTaps

struct Filter {
  float k[kTaps * kTaps];  // row-major
};

struct Geometry {
  int64_t total;      // planes * out_h * out_w
  int in_h, in_w, out_h, out_w, pad_x0, pad_y0;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Filter f, const Geometry g) {
  const int64_t plane_in = (int64_t)g.in_h * g.in_w;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < g.total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int ox = (int)(i % g.out_w);
    const int64_t r = i / g.out_w;
    const int oy = (int)(r % g.out_h);
    const T* src = x + (r / g.out_h) * plane_in;
    float acc = 0.0f;
#pragma unroll
    for (int ty = 0; ty < kTaps; ++ty) {
      const int uy = oy * DOWN + ty - g.pad_y0;  // row of the upsampled plane
      if (uy < 0 || uy % UP != 0 || uy / UP >= g.in_h) continue;
      const T* row = src + (int64_t)(uy / UP) * g.in_w;
#pragma unroll
      for (int tx = 0; tx < kTaps; ++tx) {
        const int ux = ox * DOWN + tx - g.pad_x0;
        if (ux < 0 || ux % UP != 0 || ux / UP >= g.in_w) continue;
        acc = fmaf(load(row + ux / UP), f.k[(kTaps - 1 - ty) * kTaps + (kTaps - 1 - tx)], acc);
      }
    }
    store(y + i, acc);
  }
}

template <typename T>
void launch(const void* x, void* y, int up, int down, const Filter& f, const Geometry& g,
            cudaStream_t stream) {
  const int64_t want = (g.total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  if (up == 1 && down == 1)
    upfirdn2d_kernel<T, 1, 1><<<blocks, kThreads, 0, stream>>>(in, out, f, g);
  else if (up == 2)
    upfirdn2d_kernel<T, 2, 1><<<blocks, kThreads, 0, stream>>>(in, out, f, g);
  else
    upfirdn2d_kernel<T, 1, 2><<<blocks, kThreads, 0, stream>>>(in, out, f, g);
}

}  // namespace

// x: (planes, in_h, in_w) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 =
// 1); y: (planes, out_h, out_w) contiguous, same dtype; k: host pointer to
// the kh x kw float32 filter, copied before the launch.  Only kh = kw = 4
// with (up, down) = (1, 1), (2, 1) or (1, 2) is compiled; anything else
// returns cudaErrorInvalidValue.
extern "C" int mdgan_upfirdn2d(const void* x, void* y, int bf16, int64_t planes, int in_h,
                               int in_w, int out_h, int out_w, int up, int down, int pad_x0,
                               int pad_y0, const float* k, int kh, int kw, cudaStream_t stream) {
  const bool compiled = (up == 1 && down == 1) || (up == 2 && down == 1) || (up == 1 && down == 2);
  if (planes < 0 || in_h <= 0 || in_w <= 0 || out_h < 0 || out_w < 0 || !compiled ||
      kh != kTaps || kw != kTaps)
    return (int)cudaErrorInvalidValue;
  Geometry g{planes * out_h * out_w, in_h, in_w, out_h, out_w, pad_x0, pad_y0};
  if (g.total == 0) return (int)cudaSuccess;
  Filter f;
  for (int i = 0; i < kTaps * kTaps; ++i) f.k[i] = k[i];
  if (bf16)
    launch<__nv_bfloat16>(x, y, up, down, f, g, stream);
  else
    launch<float>(x, y, up, down, f, g, stream);
  return (int)cudaGetLastError();
}
