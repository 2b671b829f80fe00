// Helpers shared by the hand-written Hopper kernels of flashattention_tpu_torch.
//
// Each kernel source is built on its own into a shared library with a plain C
// interface (nvcc -shared, loaded with ctypes; see ops/kernels.py).  Every C
// entry point returns 0 on success, a cudaError_t value when the launch was
// refused, or -1 for a configuration the kernel was not instantiated for.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

// Finite "minus infinity" for masked scores: -0.7 * float32 max, the value of
// flashattention_tpu/ops/reference.py::DEFAULT_MASK_VALUE.  exp(mask - max)
// never meets exp(-inf - (-inf)).
constexpr float kMaskValue = -0.7f * FLT_MAX;

// dtype codes of the C interface.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
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

}  // namespace fa

// Defined here, not inline: each kernel library is one translation unit, and
// each exports its own copy for the Python wrapper's error messages.
extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
