// Hopper tensor-core building blocks shared by the tensor-core kernels
// (flash_fwd_tc.cu, flash_bwd_tc.cu, probe_mma.cu): TMA tile loads described
// by tensor maps, mbarriers, warpgroup matrix multiply (wgmma) on bf16
// operands with float32 sums, and the register layouts they share.
//
// Tiles live in shared memory in 64-column chunks (64 bf16 = 128 bytes a
// row) written by TMA with the 128-byte swizzle: 16-byte unit u of row r sits
// at unit u ^ (r % 8) of its row, in 1024-byte atoms of 8 rows, so that the
// wgmma descriptors read them with no bank conflicts.  Every chunk starts on
// a 1024-byte boundary.
//
// Register layouts (PTX ISA, "wgmma .m64nNk16"): in a warpgroup of 128
// threads, warp w (0-3) owns rows 16w..16w+15 of a 64-row tile, and lane l
// is in quad g = l / 4 at t = l % 4.  A float32 accumulator of N columns
// holds N / 2 values a thread: value 4j + i is row 16w + g + 8 (i / 2),
// column 8j + 2t + i % 2.  A bf16 A operand from registers (64 x 16) is four
// 32-bit words a thread: pairs of columns (2t, 2t + 1) of rows g and g + 8,
// then columns (2t + 8, 2t + 9) of rows g and g + 8; so k-step kk of a
// product that takes an accumulator's values as A (P V, P^T dO) packs
// values 8kk .. 8kk + 7 in order (pack_a2).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tc {

constexpr int kChunk = 64;                // bf16 columns of a swizzled chunk
constexpr int kChunkRowBytes = 128;       // bytes of a chunk row
constexpr int kAtomBytes = 1024;          // 8 swizzled rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor of wgmma (PTX ISA, "matrix-descriptor"):
// start address, leading and stride byte offsets (16-byte units), and the
// 128-byte swizzle mode.  For a K-major operand (rows of K contiguous) the
// stride offset is the step between 8-row groups (one atom, 1024 bytes) and
// the leading offset is unused; a k-step of 16 bf16 moves the start by 32
// bytes inside the swizzled row.  For an MN-major operand (the transposed
// form: rows of M or N contiguous), the leading offset steps from one
// 64-column chunk of M or N to the next and the stride offset between
// 8-row groups of K, so a k-step of 16 moves the start by 2048 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as one bf16x2 word, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// k-step kk's A operand from accumulator values 8kk .. 8kk + 7, as two bf16
// terms: hi = bf16(x) and lo = bf16(x - hi), so that hi + lo holds x to
// about 2^-17 and a product over hi and then lo sees x almost in float32.
__device__ __forceinline__ uint32_t pack_lo(float x0, float x1, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(x0 - h.x, x1 - h.y);
}
template <int R>
__device__ __forceinline__ void pack_a2(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&x)[R],
                                        int kk) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    hi[w] = pack_bf16(x[8 * kk + 2 * w], x[8 * kk + 2 * w + 1]);
    lo[w] = pack_lo(x[8 * kk + 2 * w], x[8 * kk + 2 * w + 1], hi[w]);
  }
}
// Two neighbouring float32 values as kT bf16x2 words, the terms of each:
// x1 = bf16(x), x2 = bf16(x - x1) and, at kT = 3, x3 = bf16(x - x1 - x2),
// each rounded to nearest even (the residuals are exact in float32).
template <int kT>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&w)[kT]) {
  w[0] = pack_bf16(x0, x1);
  float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[0]));
  const float r0 = x0 - h.x, r1 = x1 - h.y;  // exact
  w[1] = pack_bf16(r0, r1);
  if constexpr (kT == 3) {
    h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[1]));
    w[2] = pack_bf16(r0 - h.x, r1 - h.y);
  }
}

// 2^x by the special-function unit (relative error about 2^-22; subnormal
// results flush to 0): the softmax's exponentials, in log2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8-bit payloads to bf16, exactly (every int8 and every e4m3 value is a
// bf16 value): eight payload bytes to eight bf16, the lower byte in the
// lower half of each word.  int8 by the float32 magic number: byte b ^ 0x80
// as the low mantissa byte of 2^23 is 2^23 + 128 + b.  e4m3 by the
// hardware's pair conversion to f16x2 (sm_89 and later), then float32.
template <int kKV>
__device__ __forceinline__ uint4 cvt8_bf16(uint2 x) {
  uint32_t w[2] = {x.x, x.y}, out[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (kKV == 1) {  // int8
      const uint32_t b = w[h] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540u | i)) - 8388736.f;
      out[2 * h] = pack_bf16(f[0], f[1]);
      out[2 * h + 1] = pack_bf16(f[2], f[3]);
    } else {  // e4m3
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t h2;
        const unsigned short pair = static_cast<unsigned short>(w[h] >> (16 * i));
        asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(pair));
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
        out[2 * h + i] = pack_bf16(f.x, f.y);
      }
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// mbarriers (PTX ISA, "mbarrier").
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  } while (!done);
}

// One 3-D TMA tile load (columns, rows, head) into shared memory, counted
// in bytes on `bar`.  Out-of-range rows and columns arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// One 4-D TMA tile load (columns, rows, head, page) into shared memory, as
// tma_load: a box of a page pool (paged_prefill_tc.cu).
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Named barriers among some warps (id 0 is __syncthreads').  named_arrive
// marks this thread's arrival and goes on; the barrier completes when
// `threads` threads have arrived or synced, so a pair of warpgroups can hand
// shared memory from one to the other (the writer arrives, the reader syncs).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Make this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two neighbouring float32 atomic adds into device memory: one vector
// reduction where the toolkit has it.
__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
#if CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma m64nNk16, bf16 x bf16 -> float32 (accumulate unless scale_d is 0):
// wgmma_ss takes A and B from shared memory (descriptors; kTransA / kTransB
// 1 for the MN-major form), wgmma_rs A from registers (pack_a2).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}


// wgmma m64n128k32, s8 x s8 -> s32 (accumulate unless scale_d is 0), both
// operands from shared memory in the K-major form (an 8-bit product takes no
// other), swizzled by 128 bytes: a k-step of 32 moves the start by 32 bytes.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The backward's tensor-core kernels (flash_bwd_tc.cu, flash_bwd_dq_tc.cu)
// over float32 inputs read rows of kTerms bf16 terms ([hi | lo] at kTerms
// 2, [hi] at 1; bf16 inputs, kTerms 0: the row itself) and write their
// gradients in float32.
template <int D, int kTerms>
constexpr int kRowWidth = kTerms == 2 ? 2 * D : D;

template <int kTerms>
using OutT = std::conditional_t<kTerms != 0, float, __nv_bfloat16>;

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// acc = A B^T over d, A a 64-row slice and B a tile of 2 R rows (R the
// accumulator's values a thread: 64 or 32 rows), both K-major in swizzled
// 64-column chunks (a_chunk and b_chunk bytes apart), a term's D / 64
// chunks before the next term's: the first kP of the products (A hi, B hi),
// (A hi, B lo), (A lo, B hi), (A lo, B lo), each k-step's in turn, one
// float32 chain from zero (one term: kP 1).
template <int D, int kP, int R>
__device__ __forceinline__ void term_products(float (&acc)[R], uint32_t a, uint32_t a_chunk,
                                              uint32_t b, uint32_t b_chunk) {
  constexpr int kLC = D / kChunk;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int pr = 0; pr < kP; ++pr) {
      const uint32_t ac = (pr >> 1) * kLC + kk / 4, bc = (pr & 1) * kLC + kk / 4;
      wgmma_ss<0, 0>(acc, make_desc(a + ac * a_chunk + (kk % 4) * 32, 16, 1024),
                     make_desc(b + bc * b_chunk + (kk % 4) * 32, 16, 1024), kk > 0 || pr > 0);
    }
  }
}

#ifdef FA_F32
// The float32 forms' split pass (flash_fwd_tc.cu, flash_bwd_tc.cu): `rows`
// float32 rows of d elements into bf16 rows of terms * d, [hi | lo] (terms
// 2) or [hi] (1), hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even, as the JAX package's _split_bf16 (flash.py:136-140); eight
// elements a thread.
__global__ void split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                             long long rows, int d, int terms) {
  const int units = d / 8;
  const long long n = rows * units;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; u < n;
       u += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = u / units;
    const int c = static_cast<int>(u % units) * 8;
    const float4 a = *reinterpret_cast<const float4*>(x + r * d + c);
    const float4 b = *reinterpret_cast<const float4*>(x + r * d + c + 4);
    const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      hi[w] = pack_bf16(e[2 * w], e[2 * w + 1]);
      lo[w] = pack_lo(e[2 * w], e[2 * w + 1], hi[w]);
    }
    __nv_bfloat16* row = out + r * terms * d;
    *reinterpret_cast<uint4*>(row + c) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (terms == 2) *reinterpret_cast<uint4*>(row + d + c) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

static int split(const void* x, void* out, long long rows, int d, int terms, cudaStream_t stream) {
  const long long n = rows * (d / 8);
  const int blocks = static_cast<int>(n < 132LL * 16 * 256 ? (n + 255) / 256 : 132LL * 16);
  if (blocks > 0)
    split_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(x),
                                             static_cast<__nv_bfloat16*>(out), rows, d, terms);
  return static_cast<int>(cudaGetLastError());
}

// The backward's split pass: q and dO (q_rows rows), k and v (kv_rows).
static int split_bwd(const void* q, const void* k, const void* v, const void* dout, void* q2,
                     void* k2, void* v2, void* do2, long long q_rows, long long kv_rows, int d,
                     int terms, cudaStream_t stream) {
  int status = split(q, q2, q_rows, d, terms, stream);
  if (status == 0) status = split(dout, do2, q_rows, d, terms, stream);
  if (status == 0) status = split(k, k2, kv_rows, d, terms, stream);
  if (status == 0) status = split(v, v2, kv_rows, d, terms, stream);
  return status;
}
#endif

}  // namespace tc

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that
// the library does not link libcuda itself: a tensor of `rank` dimensions
// (`dims`, innermost first; `strides` in elements for dimensions 1 .. rank -
// 1) read as boxes of `box_rows` rows (x 1 in the others): bf16 (elem_bytes
// 2) in boxes of 64 columns swizzled by 128 bytes, the layout wgmma reads;
// float32 (elem_bytes 4) in boxes of 64 columns (256 bytes a row),
// unswizzled, which the consumers split into bf16 terms themselves, or
// with `swizzle` in boxes of 32 columns swizzled by 128 bytes (paged
// decode's float32 form, whose threads read a value's column of 8 rows
// without bank conflicts); 8-bit payloads (elem_bytes 1, int8 or fp8 as
// bytes) in boxes of whole rows, unswizzled (rows of dims[0] bytes, at
// most 256), which the consumers convert to bf16 themselves, or with
// `swizzle` in boxes of 128 columns swizzled by 128 bytes, the layout an
// 8-bit wgmma reads (probe_mma.cu's native int8 products).  What lies past a dimension's end
// reads as zeros.  Returns 0, or kTcMapError + the CUresult (kTcMapError
// alone: no driver entry point).
constexpr int kTcMapError = 10000;

static int tc_encode(CUtensorMap* map, const void* base, int rank, const long long* dims,
                     const long long* strides, int box_rows, int elem_bytes = 2,
                     bool swizzle = false) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return kTcMapError;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) != cudaSuccess)
      return kTcMapError;
#endif
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t d[5], st[4];
  cuuint32_t box[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    const cuuint32_t cols = elem_bytes == 2   ? tc::kChunk
                            : elem_bytes == 4 ? (swizzle ? 32u : tc::kChunk)
                            : swizzle         ? 128u
                                              : static_cast<cuuint32_t>(dims[0]);
    box[i] = i == 0 ? cols : i == 1 ? static_cast<cuuint32_t>(box_rows) : 1;
    elem[i] = 1;
    if (i > 0) st[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * elem_bytes;
  }
  const bool wide = elem_bytes == 2;
  const CUtensorMapDataType type = wide              ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = encode(map, type,
                            rank, const_cast<void*>(base), d, st, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            wide || swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTcMapError + static_cast<int>(r);
}

// `heads` matrices of `rows` x `cols` (row stride `cols`, head stride
// `head_stride` elements); rows past `rows` read as zeros.
static int tc_encode_map(CUtensorMap* map, const void* base, int cols, int rows, int heads,
                         long long head_stride, int box_rows, int elem_bytes = 2,
                         bool swizzle = false) {
  const long long dims[3] = {cols, rows, heads};
  const long long strides[2] = {cols, head_stride};
  return tc_encode(map, base, 3, dims, strides, box_rows, elem_bytes, swizzle);
}
