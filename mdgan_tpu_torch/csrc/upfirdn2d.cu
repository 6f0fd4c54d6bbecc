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
// What bounds it on an H100: bytes.  Each output takes 16 multiply-adds
// against 2-4 bytes read and written, so the kernel has to read each input
// element from device memory about once and spend few instructions on each.
// At config-f's planes of 64 px and more the NCHW plans read 32-42% of that
// bound in bfloat16, and float32 takes about as long: what is left is the
// instructions (and their latency) a staged element and an output cost.  The
// nhwc plan reads ~60% in bfloat16 and ~80% in float32 there.
//
// The design.  The host (ops/upfirdn2d.py `plan`) picks the blocks from the
// call's shape and layout and passes them in plain ints.  NCHW input:
// `upfirdn2d_rows` (out_w > 32) gives a block tile_h full output rows of one
// plane, `upfirdn2d_planes` (out_w <= 32) packs several whole planes into a
// block, so no warp idles on a 4x4 or 8x8 plane.  A block runs in three
// steps:
//
//   1. It clears a float32 copy of its upsampled, padded input rows in shared
//      memory: the pads, the zeros an upsampling inserts, the columns past
//      the plane.
//   2. It stages the input rows its outputs' taps reach, once: coalesced
//      16-byte loads (8 bfloat16 or 4 float32) from aligned addresses, 4 a
//      thread in flight, single loads at a row's ragged ends (rows of odd
//      width start anywhere in an aligned group), each element written to its
//      upsampled, padded column.  Pads that crop drop elements here.  So the
//      inner loop below has no bounds test, no `% up` and no division.
//   3. Each thread computes a kRY x kXB patch of outputs (8 rows of 4): it
//      reads each staged row it needs once, as float4s, into registers and
//      adds it into the rows of the patch it reaches.  The float32 sum runs
//      over the taps in the order (ty, tx), rounded once to the output's
//      type; 4 outputs are stored at once where aligned.
//
// Channels_last input (NHWC in memory, channels a multiple of 8):
// `upfirdn2d_nhwc` reads it as it lies and writes a channels_last output, so
// a model that keeps its activations channels_last for cuDNN's NHWC
// convolutions pays no transpose around a resampling.  Along the channels
// there is no halo: a block takes a tile_h x tile_w tile of output pixels of
// one sample and a chunk of `vectors` 16-byte channel vectors, and stages
// the (tile - 1) * down + 4 pixels a side its taps reach in shared memory as
// they lie, one 16-byte load a pixel and vector (the pads and inserted zeros
// written as zeros at staging, so again no test in the inner loop).
// Neighbouring threads take neighbouring vectors of one pixel, so the loads,
// the staged reads and the stores are full, coalesced 16-byte vectors, and 8
// threads read 128 contiguous staged bytes at a time (no bank conflict).
// Each thread computes kNhwcRY x kNhwcXB (1 x 4) output pixels of its
// vector, reading each staged pixel of its window once; the float32 sum runs
// over the taps in the same (ty, tx) order as the NCHW plans', so both give
// the same bits.  A block stages, then computes; the launch bounds hold a
// thread to the registers of three blocks a SM, so one block's loads overlap
// another's arithmetic (at 2 x 4 pixels a thread took 255 registers, one
// block a SM, and ran 40% slower).
//
// A plane (nhwc: sample) offset is computed once a block in 64 bits, offsets
// inside a block in 32.  Inputs and outputs are float32 or bfloat16.  Only
// the resamplings the models run are compiled, each with its constants: a 4
// x 4 filter with (up, down) = (1, 1), (2, 1) or (1, 2); any other is
// refused.  One launch a call.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;   // the filter is kTaps x kTaps
constexpr int kXB = 4;     // outputs a thread computes along a row
constexpr int kRY = 8;     // rows of outputs a thread computes
constexpr int kBatch = 4;  // 16-byte loads a thread keeps in flight while staging
constexpr int kMaxThreads = 256;
constexpr int kStaticSmem = 48 * 1024;  // above this a launch opts in
constexpr int kMaxSmem = 232448;        // the H100's per-block limit
constexpr int kNhwcRY = 1;              // output rows an nhwc thread computes
constexpr int kNhwcXB = 4;              // output columns an nhwc thread computes
constexpr int kNhwcMaxVectors = 8;      // 16-byte channel vectors an nhwc block at most
constexpr int kNhwcBatch = 8;           // 16-byte loads an nhwc thread keeps in flight while staging
constexpr int kNhwcMinBlocks = 3;       // nhwc blocks a SM must hold at once (caps registers)

struct Filter {
  float k[kTaps * kTaps];  // row-major
};

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift (d >= 1).
struct Divider {
  uint32_t m, s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

Divider divider(int d) {
  uint32_t s = 0;
  while ((1ull << s) < (uint64_t)d) ++s;
  return {(uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

struct Geometry {
  int planes, in_h, in_w, out_h, out_w, pad_x0, pad_y0;
  int tile_h;            // output rows a block computes of each of its planes
  int planes_per_block;  // 1 for upfirdn2d_rows
  int tiles;             // tiles a plane (upfirdn2d_rows)
  int pitch;             // floats a staged row (a multiple of 4)
  int stage_rows;        // staged rows a plane
  int slots;             // 16-byte loads a staged row: (in_w + vec - 2) / vec + 1
  int col_groups;        // ceil(out_w / kXB)
  int row_groups;        // tile_h / kRY
  Divider by_slots, by_stage_rows, by_col_groups, by_row_groups, by_tiles;
};

// The nhwc plan's geometry: a block computes outputs [ty0, ty0 + tile_h) x
// [tx0, tx0 + tile_w) of sample blockIdx.z for channel vectors [v0, v0 +
// vectors), (tx0 / tile_w, v0 / vectors) from blockIdx.x, ty0 / tile_h =
// blockIdx.y.
struct NhwcGeometry {
  int in_h, in_w, out_h, out_w, pad_x0, pad_y0;
  int channels;          // elements a pixel
  int tile_h, tile_w;    // multiples of kNhwcRY, kNhwcXB
  int stage_h, stage_w;  // staged pixels: (tile - 1) * down + kTaps
  int vectors;           // 16-byte channel vectors a block
  int chunks;            // channel chunks of `vectors` a sample
  int patch_cols;        // tile_w / kNhwcXB
  Divider by_vectors, by_stage_w, by_chunks, by_patch_cols;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
// 16 bytes from a 16-byte-aligned address
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // bfloat16 is float32's top half
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
// 16 staged bytes as floats
__device__ __forceinline__ void unpack(const uint4 t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack(const uint4 t, float (&v)[8]) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
// 16 bytes to a 16-byte-aligned address, rounded once
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* p, const float (&v)[kXB]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kXB]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

// Planes [plane0, plane0 + nplanes), output rows [ty0, ty0 + tile_h).
template <typename T, int UP, int DOWN>
__device__ __forceinline__ void tile(const T* __restrict__ x, T* __restrict__ y, const Filter f,
                                     const Geometry g, int plane0, int nplanes, int ty0) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int plane_floats = g.stage_rows * g.pitch;

  // 1. zeros
  const int n4 = nplanes * plane_floats / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // 2. the input rows, in 16-byte slots: slot j of a row holds its elements
  // vec * j - m .. vec * j - m + vec - 1, m the row's offset in its aligned group
  constexpr int kVec = 16 / sizeof(T);
  constexpr unsigned kFull = (1u << kVec) - 1;
  const T* src = x + (int64_t)plane0 * g.in_h * g.in_w;
  const int slots = nplanes * g.stage_rows * g.slots;
  for (int i0 = threadIdx.x; i0 < slots; i0 += kBatch * blockDim.x) {
    float v[kBatch][kVec];
    int col[kBatch], row_off[kBatch];
    unsigned valid[kBatch];  // bit e: element e of the slot lies in the row
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      valid[b] = 0;
      col[b] = row_off[b] = 0;
      const int i = i0 + b * blockDim.x;
      if (i >= slots) continue;
      const int row = g.by_slots.div(i);
      const int p = g.by_stage_rows.div(row);
      const int r = row - p * g.stage_rows;
      const int uy = ty0 * DOWN + r - g.pad_y0;  // row of the upsampled plane
      if (uy < 0 || uy % UP != 0 || uy / UP >= g.in_h) continue;
      const T* in_row = src + (p * g.in_h + uy / UP) * g.in_w;
      const int m = (int)((reinterpret_cast<uintptr_t>(in_row) / sizeof(T)) & (kVec - 1));
      const int ix = kVec * (i - row * g.slots) - m;
      if (ix >= 0 && ix + kVec - 1 < g.in_w) {
        load16(in_row + ix, v[b]);
        valid[b] = kFull;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[b][e] = 0.f;
          if (ix + e >= 0 && ix + e < g.in_w) {
            v[b][e] = load(in_row + ix + e);
            valid[b] |= 1u << e;
          }
        }
      }
      col[b] = ix * UP + g.pad_x0;
      row_off[b] = p * plane_floats + r * g.pitch;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      float* dst = sm + row_off[b];
      const int c = col[b];
      if (UP == 1 && valid[b] == kFull && c >= 0 && c + kVec - 1 < g.pitch && (c & 1) == 0) {
        if ((c & 3) == 0) {
#pragma unroll
          for (int q = 0; q < kVec; q += 4)
            *reinterpret_cast<float4*>(dst + c + q) =
                make_float4(v[b][q], v[b][q + 1], v[b][q + 2], v[b][q + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < kVec; q += 2)
            *reinterpret_cast<float2*>(dst + c + q) = make_float2(v[b][q], v[b][q + 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int ce = c + e * UP;
          if ((valid[b] >> e & 1) && ce >= 0 && ce < g.pitch) dst[ce] = v[b][e];
        }
      }
    }
  }
  __syncthreads();

  // 3. a kRY x kXB patch of outputs a thread
  constexpr int kReadRows = (kRY - 1) * DOWN + kTaps;                  // staged rows a patch reads
  constexpr int kReadCols = ((kXB - 1) * DOWN + kTaps + 3) / 4 * 4;  // staged columns, in float4s
  T* dst = y + (int64_t)plane0 * g.out_h * g.out_w;
  const int patches = nplanes * g.row_groups * g.col_groups;
  for (int i = threadIdx.x; i < patches; i += blockDim.x) {
    const int prow = g.by_col_groups.div(i);
    const int cgi = i - prow * g.col_groups;
    const int p = g.by_row_groups.div(prow);
    const int rgi = prow - p * g.row_groups;
    const float* s = sm + p * plane_floats + rgi * kRY * DOWN * g.pitch + cgi * kXB * DOWN;
    float acc[kRY][kXB];
#pragma unroll
    for (int j = 0; j < kRY; ++j)
#pragma unroll
      for (int xo = 0; xo < kXB; ++xo) acc[j][xo] = 0.f;
#pragma unroll
    for (int sr = 0; sr < kReadRows; ++sr) {
      float v[kReadCols];
#pragma unroll
      for (int q = 0; q < kReadCols / 4; ++q) {
        const float4 t = reinterpret_cast<const float4*>(s + sr * g.pitch)[q];
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < kRY; ++j) {
        const int ty = sr - j * DOWN;
        if (ty < 0 || ty >= kTaps) continue;
#pragma unroll
        for (int xo = 0; xo < kXB; ++xo)
#pragma unroll
          for (int tx = 0; tx < kTaps; ++tx)
            acc[j][xo] = fmaf(v[xo * DOWN + tx], f.k[(kTaps - 1 - ty) * kTaps + (kTaps - 1 - tx)],
                              acc[j][xo]);
      }
    }
    const int ox = cgi * kXB;
#pragma unroll
    for (int j = 0; j < kRY; ++j) {
      const int oy = ty0 + rgi * kRY + j;
      if (oy >= g.out_h) break;
      T* out = dst + (p * g.out_h + oy) * g.out_w + ox;
      if (ox + kXB <= g.out_w && reinterpret_cast<uintptr_t>(out) % (kXB * sizeof(T)) == 0) {
        store4(out, acc[j]);
      } else {
#pragma unroll
        for (int xo = 0; xo < kXB; ++xo)
          if (ox + xo < g.out_w) store(out + xo, acc[j][xo]);
      }
    }
  }
}

// A tile of tile_h full output rows of one plane a block.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kMaxThreads)
    upfirdn2d_rows(const T* __restrict__ x, T* __restrict__ y, const Filter f, const Geometry g) {
  const int plane = g.by_tiles.div(blockIdx.x);
  tile<T, UP, DOWN>(x, y, f, g, plane, 1, (blockIdx.x - plane * g.tiles) * g.tile_h);
}

// planes_per_block whole planes a block.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kMaxThreads)
    upfirdn2d_planes(const T* __restrict__ x, T* __restrict__ y, const Filter f, const Geometry g) {
  const int plane0 = blockIdx.x * g.planes_per_block;
  const int nplanes = min(g.planes_per_block, g.planes - plane0);
  tile<T, UP, DOWN>(x, y, f, g, plane0, nplanes, 0);
}

// A tile of output pixels of one sample for a chunk of channel vectors.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kMaxThreads, kNhwcMinBlocks)
    upfirdn2d_nhwc(const T* __restrict__ x, T* __restrict__ y, const Filter f,
                   const NhwcGeometry g) {
  extern __shared__ uint4 staged[];  // [stage_h][stage_w][vectors]
  constexpr int kVec = 16 / sizeof(T);
  const int tile_x = g.by_chunks.div(blockIdx.x);
  const int c0 = (blockIdx.x - tile_x * g.chunks) * g.vectors * kVec;
  const int tx0 = tile_x * g.tile_w, ty0 = blockIdx.y * g.tile_h;
  const T* src = x + (int64_t)blockIdx.z * g.in_h * g.in_w * g.channels + c0;

  // 1. the pixels the tile's taps reach, each vector one 16-byte load or zero
  const int slots = g.stage_h * g.stage_w * g.vectors;
  for (int i0 = threadIdx.x; i0 < slots; i0 += kNhwcBatch * blockDim.x) {
    uint4 v[kNhwcBatch];
#pragma unroll
    for (int b = 0; b < kNhwcBatch; ++b) {
      v[b] = make_uint4(0u, 0u, 0u, 0u);
      const int i = i0 + b * blockDim.x;
      if (i >= slots) continue;
      const int pixel = g.by_vectors.div(i);
      const int vec = i - pixel * g.vectors;
      const int sy = g.by_stage_w.div(pixel);
      const int uy = ty0 * DOWN + sy - g.pad_y0;  // in the upsampled plane
      const int ux = tx0 * DOWN + pixel - sy * g.stage_w - g.pad_x0;
      if (uy < 0 || ux < 0 || uy % UP != 0 || ux % UP != 0) continue;
      const int iy = uy / UP, ix = ux / UP;
      if (iy >= g.in_h || ix >= g.in_w) continue;
      v[b] = __ldg(reinterpret_cast<const uint4*>(src + (iy * g.in_w + ix) * g.channels +
                                                   vec * kVec));
    }
#pragma unroll
    for (int b = 0; b < kNhwcBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < slots) staged[i] = v[b];
    }
  }
  __syncthreads();

  // 2. kNhwcRY x kNhwcXB output pixels of one channel vector a thread
  constexpr int kReadRows = (kNhwcRY - 1) * DOWN + kTaps;
  constexpr int kReadCols = (kNhwcXB - 1) * DOWN + kTaps;
  const int patch = g.by_vectors.div(threadIdx.x);
  const int vec = threadIdx.x - patch * g.vectors;
  const int pr = g.by_patch_cols.div(patch);
  const int pc = patch - pr * g.patch_cols;
  const int row = g.stage_w * g.vectors;  // 16-byte slots a staged row
  const uint4* s = staged + (pr * kNhwcRY * DOWN) * row + (pc * kNhwcXB * DOWN) * g.vectors + vec;
  float acc[kNhwcRY][kNhwcXB][kVec];
#pragma unroll
  for (int j = 0; j < kNhwcRY; ++j)
#pragma unroll
    for (int xo = 0; xo < kNhwcXB; ++xo)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][xo][e] = 0.f;
#pragma unroll
  for (int sr = 0; sr < kReadRows; ++sr) {
#pragma unroll
    for (int sc = 0; sc < kReadCols; ++sc) {
      float v[kVec];
      unpack(s[sr * row + sc * g.vectors], v);
#pragma unroll
      for (int j = 0; j < kNhwcRY; ++j) {
        const int ty = sr - j * DOWN;
        if (ty < 0 || ty >= kTaps) continue;
#pragma unroll
        for (int xo = 0; xo < kNhwcXB; ++xo) {
          const int tx = sc - xo * DOWN;
          if (tx < 0 || tx >= kTaps) continue;
          const float w = f.k[(kTaps - 1 - ty) * kTaps + (kTaps - 1 - tx)];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[j][xo][e] = fmaf(v[e], w, acc[j][xo][e]);
        }
      }
    }
  }
  T* dst = y + (int64_t)blockIdx.z * g.out_h * g.out_w * g.channels + c0 + vec * kVec;
#pragma unroll
  for (int j = 0; j < kNhwcRY; ++j) {
    const int oy = ty0 + pr * kNhwcRY + j;
    if (oy >= g.out_h) break;
#pragma unroll
    for (int xo = 0; xo < kNhwcXB; ++xo) {
      const int ox = tx0 + pc * kNhwcXB + xo;
      if (ox >= g.out_w) break;
      store16(dst + (oy * g.out_w + ox) * g.channels, acc[j][xo]);
    }
  }
}

// One launch, opting in to over 48 KB of shared memory where the plan takes it.
template <typename T, typename G>
cudaError_t start(void (*kernel)(const T*, T*, Filter, G), dim3 blocks, int threads, int smem,
                  cudaStream_t stream, const void* x, void* y, const Filter& f, const G& g) {
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), f, g);
  return cudaGetLastError();
}

// kind: 0 upfirdn2d_rows, 1 upfirdn2d_planes, 2 upfirdn2d_nhwc
template <typename T, int UP, int DOWN>
cudaError_t launch(int kind, dim3 blocks, int threads, int smem, cudaStream_t stream,
                   const void* x, void* y, const Filter& f, const Geometry& g,
                   const NhwcGeometry& h) {
  if (kind == 2)
    return start(upfirdn2d_nhwc<T, UP, DOWN>, blocks, threads, smem, stream, x, y, f, h);
  return start(kind == 1 ? upfirdn2d_planes<T, UP, DOWN> : upfirdn2d_rows<T, UP, DOWN>, blocks,
               threads, smem, stream, x, y, f, g);
}

template <typename T>
cudaError_t launch(int up, int down, int kind, dim3 blocks, int threads, int smem,
                   cudaStream_t stream, const void* x, void* y, const Filter& f,
                   const Geometry& g, const NhwcGeometry& h) {
  if (up == 1 && down == 1)
    return launch<T, 1, 1>(kind, blocks, threads, smem, stream, x, y, f, g, h);
  if (up == 2) return launch<T, 2, 1>(kind, blocks, threads, smem, stream, x, y, f, g, h);
  return launch<T, 1, 2>(kind, blocks, threads, smem, stream, x, y, f, g, h);
}

}  // namespace

// x: float32 (bf16 = 0) or bfloat16 (bf16 = 1), planes = N * C planes of
// in_h x in_w, laid out as (N, C, in_h, in_w) for the NCHW plans (kind 0,
// upfirdn2d_rows; kind 1, upfirdn2d_planes) and as (N, in_h, in_w, C), C =
// channels, for the nhwc plan (kind 2, upfirdn2d_nhwc, x and y 16-byte
// aligned); y: the output in the same layout, same dtype; k: host pointer to
// the kh x kw float32 filter, copied before the launch.  Only kh = kw = 4
// with (up, down) = (1, 1), (2, 1) or (1, 2) is compiled.  The plan
// (ops/upfirdn2d.py `plan`): tile_h output rows a block (a multiple of kRY,
// the whole plane for upfirdn2d_planes; of kNhwcRY for upfirdn2d_nhwc);
// group: planes a block (1 for upfirdn2d_rows), or 16-byte channel vectors a
// block for upfirdn2d_nhwc; threads a block; pitch floats a staged row (nhwc:
// staged pixels a row) and stage_rows staged rows a plane (nhwc: a tile);
// tile_w output columns a block (nhwc, a multiple of kNhwcXB; unused by the
// NCHW plans, which take whole rows).  A plan the kernel cannot run, or any
// other resampling, returns cudaErrorInvalidValue.
extern "C" int mdgan_upfirdn2d(const void* x, void* y, int bf16, int64_t planes, int in_h,
                               int in_w, int out_h, int out_w, int up, int down, int pad_x0,
                               int pad_y0, const float* k, int kh, int kw, int kind, int tile_h,
                               int group, int threads, int pitch, int stage_rows, int channels,
                               int tile_w, cudaStream_t stream) {
  const bool compiled = (up == 1 && down == 1) || (up == 2 && down == 1) || (up == 1 && down == 2);
  if (planes < 0 || planes >= (1ll << 31) || in_h <= 0 || in_w <= 0 || out_h < 0 || out_w < 0 ||
      !compiled || kh != kTaps || kw != kTaps || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  if (planes == 0 || out_h == 0 || out_w == 0) return (int)cudaSuccess;
  const int vec = bf16 ? 8 : 4;
  Geometry g{};
  NhwcGeometry h{};
  dim3 blocks;
  int64_t smem;
  if (kind == 2) {
    smem = (int64_t)group * stage_rows * pitch * 16;
    const bool fits =
        channels > 0 && channels % vec == 0 && planes % channels == 0 &&
        planes / channels < 65536 && group >= 1 && group <= kNhwcMaxVectors &&
        (channels / vec) % group == 0 && tile_h > 0 && tile_h % kNhwcRY == 0 && tile_w > 0 &&
        tile_w % kNhwcXB == 0 && threads == group * (tile_h / kNhwcRY) * (tile_w / kNhwcXB) &&
        threads <= kMaxThreads && stage_rows >= (tile_h - 1) * down + kTaps &&
        pitch >= (tile_w - 1) * down + kTaps && smem <= kMaxSmem &&
        (int64_t)in_h * in_w * channels < (1ll << 31) &&
        (int64_t)out_h * out_w * channels < (1ll << 31) &&
        reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    if (!fits) return (int)cudaErrorInvalidValue;
    const int chunks = channels / vec / group;
    const int64_t tiles_x = (out_w + tile_w - 1) / tile_w, tiles_y = (out_h + tile_h - 1) / tile_h;
    if (tiles_x * chunks >= (1ll << 31) || tiles_y >= 65536) return (int)cudaErrorInvalidValue;
    h = NhwcGeometry{in_h, in_w, out_h, out_w, pad_x0, pad_y0, channels, tile_h, tile_w,
                     stage_rows, pitch, group, chunks, tile_w / kNhwcXB, divider(group),
                     divider(pitch), divider(chunks), divider(tile_w / kNhwcXB)};
    blocks = dim3((unsigned)(tiles_x * chunks), (unsigned)tiles_y, (unsigned)(planes / channels));
  } else {
    const bool packed = kind == 1;
    const int col_groups = (out_w + kXB - 1) / kXB;
    const int read_cols = ((kXB - 1) * down + kTaps + 3) / 4 * 4;
    const int64_t ppb = group;
    smem = ppb * stage_rows * pitch * (int64_t)sizeof(float);
    const bool fits =
        tile_h > 0 && tile_h % kRY == 0 && threads > 0 && threads <= kMaxThreads && ppb >= 1 &&
        (packed ? tile_h >= out_h : ppb == 1) && pitch % 4 == 0 &&
        pitch >= (col_groups - 1) * kXB * down + read_cols &&
        stage_rows >= (tile_h - 1) * down + kTaps && smem <= kMaxSmem &&
        ppb * in_h * in_w < (1ll << 31) && ppb * out_h * out_w < (1ll << 31);
    if (!fits) return (int)cudaErrorInvalidValue;
    const int tiles = (out_h + tile_h - 1) / tile_h;
    const int64_t nblocks = packed ? (planes + ppb - 1) / ppb : planes * tiles;
    if (nblocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const int slots = (in_w + vec - 2) / vec + 1;
    const int row_groups = tile_h / kRY;
    g = Geometry{(int)planes, in_h, in_w, out_h, out_w, pad_x0, pad_y0, tile_h, group, tiles,
                 pitch, stage_rows, slots, col_groups, row_groups, divider(slots),
                 divider(stage_rows), divider(col_groups), divider(row_groups), divider(tiles)};
    blocks = dim3((unsigned)nblocks);
  }
  Filter f;
  for (int i = 0; i < kTaps * kTaps; ++i) f.k[i] = k[i];
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(up, down, kind, blocks, threads, (int)smem, stream, x, y, f,
                                   g, h)
           : launch<float>(up, down, kind, blocks, threads, (int)smem, stream, x, y, f, g, h);
  return (int)err;
}
