// Helpers shared by the hand-written Hopper kernels of flashattention_tpu_torch.
//
// Each kernel source is built on its own into a shared library with a plain C
// interface (nvcc -shared, loaded with ctypes; see ops/kernels.py).  Every C
// entry point returns 0 on success, a cudaError_t value when the launch was
// refused, or -1 for a configuration the kernel was not instantiated for.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace fa {

// Finite "minus infinity" for masked scores: -0.7 * float32 max, the value of
// flashattention_tpu/ops/reference.py::DEFAULT_MASK_VALUE.  exp(mask - max)
// never meets exp(-inf - (-inf)).
constexpr float kMaskValue = -0.7f * FLT_MAX;

// dtype codes of the C interface: q/o types, and K/V payload types (8-bit
// payloads come with float32 dequant scales, one per K/V row).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;
constexpr int kFp8E4M3 = 3;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float load_f32(const __nv_fp8_e4m3* p) {
  return static_cast<float>(*p);  // exact: every e4m3 value is a float
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Four neighbouring elements as one float4: one 16-byte (float32) or 8-byte
// (bfloat16) access.  The pointer must be aligned to that width; the Python
// wrappers check it.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// 8-bit payloads: four neighbouring bytes as one 32-bit access, converted
// exactly (Hopper converts e4m3 pairs in hardware).
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  return static_cast<float4>(*reinterpret_cast<const __nv_fp8x4_e4m3*>(p));
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);  // round to nearest even
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Gemma-2's logit softcap, s -> cap * tanh(s / cap) in float32, applied to
// the scaled score before the masks (flash.py:833-835); cap <= 0: none.
__device__ __forceinline__ float softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Attention dropout and block-sparse masks, the options of the kernels'
// kExtra forms (flash_fwd.cu and the three backward kernels).
//
// Dropout keeps pair (row i, column j) of head bh where a counter-based hash
// of the absolute coordinates, flashattention_tpu/ops/flash.py::
// dropout_keep_mask (:577-613) bit for bit, is at or above `threshold`
// (ceil(float32(rate) 2^24), computed on the host): the forward and every
// backward kernel regenerate the same bits, and no mask is stored.  The row
// coordinate is the raw folded row, (r / q_seq_len) * row_stride + r mod
// q_seq_len: the JAX package draws each folded GQA group independently, and
// its attention() pads each group to row_stride rows first.
//
// A block mask is a table over the kernel's own tiles (built once per mask
// on the host, ops/flash.py::BlockMask): for each tile of the axis a block
// walks, [bm_ptr[t], bm_ptr[t + 1]) indexes the live tiles of the other axis
// in bm_idx (ascending) and, in bm_part, each one's slot in bm_bits, or -1
// for a tile whose pairs are all live.  A partial tile's element bits are
// its rows' words of 32 columns each.  Dead tiles appear nowhere: no block
// loads or computes them.
struct Extras {
  const int* bm_ptr;        // null: no block mask
  const int* bm_idx;
  const int* bm_part;
  const unsigned* bm_bits;
  int row_stride;
  unsigned seed;            // the int32 seed, as uint32
  unsigned threshold;       // 0: no dropout
  float inv;                // 1 / (1 - rate), rounded to float32
};

// A block mask's walk for tile `t` of the axis a block walks: the index of
// its first live tile in bm_idx (x), and how many of its live tiles (y) start
// before `end` (kv_len, or the rows): the table covers the mask's padded
// lengths.
__device__ __forceinline__ int2 bm_walk(const Extras& ex, int t, int tile, int end) {
  const int lo = ex.bm_ptr[t];
  int n = ex.bm_ptr[t + 1] - lo;
  while (n > 0 && ex.bm_idx[lo + n - 1] * tile >= end) --n;
  return make_int2(lo, n);
}

// The tensor-core forms' element bits: in the accumulator layout a thread
// holds rows r and r + 8 of a tile at columns 8 j + 2 t + h (h = 0, 1).  Its
// two rows' words of a partial tile (`bits`: slots of kRows rows of kCols
// columns, bit c % 32 of word c / 32), shifted right by 2 t, so that column
// 8 j + 2 t + h is bit 8 (j % 4) + h of word j / 4 (tile_bit): one test a
// score.  All ones for a full tile (slot < 0).
template <int kRows, int kCols>
__device__ __forceinline__ void tile_bits(const unsigned* bits, int slot, int r, int t,
                                          unsigned (&a)[kCols / 32], unsigned (&b)[kCols / 32]) {
#pragma unroll
  for (int w = 0; w < kCols / 32; ++w) a[w] = b[w] = ~0u;
  if (slot < 0) return;
  const unsigned* row = bits + (static_cast<size_t>(slot) * kRows + r) * (kCols / 32);
#pragma unroll
  for (int w = 0; w < kCols / 32; ++w) {
    a[w] = row[w] >> (2 * t);
    b[w] = row[8 * (kCols / 32) + w] >> (2 * t);
  }
}

template <int kWords>
__device__ __forceinline__ bool tile_bit(const unsigned (&w)[kWords], int j, int h) {
  return (w[j / 4] >> (8 * (j % 4) + h)) & 1u;
}

// The three forms of a tensor-core tile's mask loop, picked once a tile so
// that no score pays for a test its tile does not need: kMaskNone, a tile no
// mask reaches; kMaskBits, a partial block-mask tile whose bits are its only
// mask (one test a score); kMaskAll, a tile that crosses a bound or holds
// other segment ids (every test, the bits too).
enum { kMaskNone, kMaskBits, kMaskAll };
template <int kForm>
struct MaskForm {
  static constexpr int value = kForm;
};
template <class Loop>
__device__ __forceinline__ void with_mask_form(bool all, bool bits, Loop&& loop) {
  if (all) loop(MaskForm<kMaskAll>{});
  else if (bits) loop(MaskForm<kMaskBits>{});
  else loop(MaskForm<kMaskNone>{});
}

// The part of a pair's hash that depends on its head and row, once per row.
__device__ __forceinline__ unsigned dropout_row_key(const Extras& ex, int bh, int r,
                                                    int q_seq_len) {
  const unsigned raw = static_cast<unsigned>((r / q_seq_len) * ex.row_stride + r % q_seq_len);
  return (raw * 0xCC9E2D51u) ^ (ex.seed * 0x9E3779B9u + static_cast<unsigned>(bh) * 0x85EBCA6Bu);
}

// Whether the pair (row of `row_key`, column `col`) is kept: murmur3's fmix32
// of the mixed coordinates, top 24 bits against the threshold.
__device__ __forceinline__ bool dropout_kept(unsigned row_key, int col, unsigned threshold) {
  unsigned x = row_key ^ (static_cast<unsigned>(col) * 0x1B873593u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= threshold;
}

}  // namespace fa

// Defined here, not inline: each kernel library is one translation unit, and
// each exports its own copy for the Python wrapper's error messages.
extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
