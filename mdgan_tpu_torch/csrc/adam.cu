// Fused torch-semantics Adam over one flat float32 arena, with float32 or
// bfloat16 moments.
//
// Replaces the Pallas TPU kernel mdgan_tpu/ops/adam.py:_adam_kernel
// (launched per parameter leaf by _leaf_update_pallas, adam.py:57-87):
//
//     mu' = b1*mu + (1-b1)*g
//     nu' = b2*nu + (1-b2)*g*g
//     p'  = p - (lr/(1-b1^t)) * mu' / (sqrt(nu' * 1/(1-b2^t)) + eps)
//
// p, mu and nu are updated in place.  The two bias-corrected scalars are
// computed on the host in float32, as adam.py:114-118 does.
//
// What bounds it on an H100: bytes.  Each element reads p, g, mu, nu and
// writes p, mu, nu: 28 B, against ~10 flops.  One MD-GAN round (DCGAN-32,
// N=8) updates 3,448,576 generator and 5,306,368 discriminator parameters:
// 245 MB, 73 us at 3.35 TB/s.
//
// What the design does about it: the engine keeps every parameter, gradient
// and moment of a network in one contiguous arena (the discriminators'
// arenas stack all N copies), so one launch covers a whole network: no
// per-leaf launches, and every thread moves 16 B per array per access
// (float4) in a grid-stride loop that touches each byte once.  The TPU's
// lane-alignment gate (adam.py:132-135) is a TPU layout rule and has no
// counterpart: a scalar tail loop covers any length.
//
// The arithmetic uses explicit round-to-nearest intrinsics, so no multiply
// is contracted into an FMA and the result is bit-equal to the plain PyTorch
// version (mdgan_tpu_torch/ops/adam.py:adam_plain), which rounds after every
// operation.  Built without --use_fast_math: division and sqrt are IEEE.

// The bfloat16-moment variant (mdgan_adam_f32_bf16m, --moment_dtype
// bfloat16) ports no Pallas kernel: the JAX package runs bf16 moments through
// optax (mdgan_tpu/ops/adam.py:20-26, engine/state.py:216-251), so its
// numerics are optax's.  p and g stay float32, mu and nu are bfloat16:
//
//     m = bf16(b1*mu) + (1-b1)*g          (the product rounded to bf16, the sum in f32)
//     v = bf16(b2*nu) + (1-b2)*(g*g)
//     p' = p - lr_c1 * m / (sqrt(v * inv_c2) + eps)   (the unrounded m, v)
//     mu' = bf16(m), nu' = bf16(v)         (round to nearest even)
//
// Each element reads 4+4+2+2 B and writes 4+2+2 B: 20 B against the f32
// kernel's 28, so it is bound by bytes too (DCGAN-32's MD-GAN round: 175 MB,
// 52 us at 3.35 TB/s).  Same grid-stride loop, float4 loads of p and g and
// 8-byte loads of four moments each; _rn intrinsics throughout, so it is
// bit-equal to its plain version (mdgan_tpu_torch/ops/adam.py:adam_plain_bf16m).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct AdamScalars {
  float lr_c1, inv_c2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& mu, float& nu,
                                         const AdamScalars& s) {
  float m = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(s.omb1, g));
  float v = __fadd_rn(__fmul_rn(s.b2, nu), __fmul_rn(__fmul_rn(s.omb2, g), g));
  float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_c2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr_c1, m), denom));
  mu = m;
  nu = v;
}

__global__ void adam_f32_kernel(float* __restrict__ p, const float* __restrict__ g,
                                float* __restrict__ mu, float* __restrict__ nu,
                                int64_t n, AdamScalars s) {
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* mu4 = reinterpret_cast<float4*>(mu);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 pv = p4[i], gv = g4[i], mv = mu4[i], vv = nu4[i];
    adam_one(pv.x, gv.x, mv.x, vv.x, s);
    adam_one(pv.y, gv.y, mv.y, vv.y, s);
    adam_one(pv.z, gv.z, mv.z, vv.z, s);
    adam_one(pv.w, gv.w, mv.w, vv.w, s);
    p4[i] = pv;
    mu4[i] = mv;
    nu4[i] = vv;
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    adam_one(pv, g[i], mv, vv, s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void adam_one_bf16m(float& p, float g, __nv_bfloat16& mu,
                                               __nv_bfloat16& nu, const AdamScalars& s) {
  float m = __fadd_rn(bf16_round(__fmul_rn(s.b1, __bfloat162float(mu))), __fmul_rn(s.omb1, g));
  float v = __fadd_rn(bf16_round(__fmul_rn(s.b2, __bfloat162float(nu))),
                      __fmul_rn(s.omb2, __fmul_rn(g, g)));
  float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_c2)), s.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr_c1, m), denom));
  mu = __float2bfloat16_rn(m);
  nu = __float2bfloat16_rn(v);
}

struct alignas(8) Bf16x4 {
  __nv_bfloat16 v[4];
};

__global__ void adam_f32_bf16m_kernel(float* __restrict__ p, const float* __restrict__ g,
                                      __nv_bfloat16* __restrict__ mu,
                                      __nv_bfloat16* __restrict__ nu, int64_t n,
                                      AdamScalars s) {
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  Bf16x4* mu4 = reinterpret_cast<Bf16x4*>(mu);
  Bf16x4* nu4 = reinterpret_cast<Bf16x4*>(nu);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 pv = p4[i], gv = g4[i];
    Bf16x4 mv = mu4[i], vv = nu4[i];
    adam_one_bf16m(pv.x, gv.x, mv.v[0], vv.v[0], s);
    adam_one_bf16m(pv.y, gv.y, mv.v[1], vv.v[1], s);
    adam_one_bf16m(pv.z, gv.z, mv.v[2], vv.v[2], s);
    adam_one_bf16m(pv.w, gv.w, mv.v[3], vv.v[3], s);
    p4[i] = pv;
    mu4[i] = mv;
    nu4[i] = vv;
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float pv = p[i];
    __nv_bfloat16 mv = mu[i], vv = nu[i];
    adam_one_bf16m(pv, g[i], mv, vv, s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

int64_t grid_for(int64_t n) {
  const int threads = 256;
  int64_t blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident-block waves of 132 SMs
  return blocks;
}

}  // namespace

// All four pointers must be 16-byte aligned (the wrapper checks).
extern "C" int mdgan_adam_f32(float* p, const float* g, float* mu, float* nu,
                              int64_t n, float lr_c1, float inv_c2, float b1,
                              float one_minus_b1, float b2, float one_minus_b2,
                              float eps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  AdamScalars s{lr_c1, inv_c2, b1, one_minus_b1, b2, one_minus_b2, eps};
  adam_f32_kernel<<<(unsigned)grid_for(n), 256, 0, stream>>>(p, g, mu, nu, n, s);
  return (int)cudaGetLastError();
}

// p and g 16-byte aligned, mu and nu (bfloat16) 8-byte aligned (the wrapper checks).
extern "C" int mdgan_adam_f32_bf16m(float* p, const float* g, void* mu, void* nu, int64_t n,
                                    float lr_c1, float inv_c2, float b1, float one_minus_b1,
                                    float b2, float one_minus_b2, float eps,
                                    cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  AdamScalars s{lr_c1, inv_c2, b1, one_minus_b1, b2, one_minus_b2, eps};
  adam_f32_bf16m_kernel<<<(unsigned)grid_for(n), 256, 0, stream>>>(
      p, g, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), n, s);
  return (int)cudaGetLastError();
}

// Name of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* mdgan_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
