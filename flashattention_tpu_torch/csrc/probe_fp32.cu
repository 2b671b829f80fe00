// H100 probe of float32 attention as two bf16 terms (BH = 128, S = 1024,
// d = 64, float32 inputs, unscaled, non-causal): the port of
// scripts/probe_small_fp32b.py::build (:45, pallas_call :101), the packed
// float32 path's machine products built up in stages beside a bf16 one.
//
// Inputs as the script's main packs them (pack2 :39): q, k (BH, S, 2d) bf16
// [hi | lo] with hi = bf16(x) and lo = bf16(x - hi); v (BH, S, 2d + 1)
// [v_hi | v_lo | 1], its rows a multiple of 16 bytes apart (a view of a
// wider buffer: TMA takes no other row stride).  Modes (ops/probes.py's
// FP32_MODES):
//   0 skeleton  S = q . k + q . k_swap (all four hi/lo products), P = S;
//   1 exp       P = exp(S - 5);
//   2 full      the softmax: P = exp(S - m), m the row's max over every
//               key, acc / l;
//   3 bf16_skel q, k (BH, S, d) bf16, v (BH, S, d + 1): one bf16 S = q k^T,
//               P = bf16(S) (one term) against v.
// In the packed modes P enters PV as two bf16 terms (ph, plo) against
// [v_hi | v_lo], and acc = out[:, :d] + out[:, d:2d].  O is acc, float32
// (BH, S, d): the TPU probe writes [acc | acc] only so that its timer can
// chain the output into the next call's q (:113-116), so acc is written once.
//
// On Hopper: k_swap needs no copy.  Each 64-column half of a packed row is
// its own 128-byte-swizzled chunk (tc_common.cuh's kChunk), so q . k_swap
// is the same wgmmas as q . k with the two chunks' descriptors of K
// exchanged: 16 k-steps of m64n128k16 a tile for S.  PV's width 2d + 1 =
// 129 is not a multiple of 8: the ones column is not read; l, the product
// of P's two terms with the ones column, is summed from the terms in
// registers (sum of ph + plo, float32), and PV is N = 128 over [v_hi | v_lo].
// `full` is a whole-row max: the kernel streams K and V, so it rescales
// online (running max per 128-key tile), the same function up to rounding.
// Block: 128 query rows of one head (two consumer warpgroups of 64) and a
// two-stage TMA ring of 128-key K and V tiles; grid (S / 128, BH).
// Bound on this card: operations.  The logical work is 4 d flops a pair;
// the machine work on bf16 tensor cores is four times that (QK^T twice and
// PV once a term, each over a 2d-wide row).
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kN = 128, kM = 128, kStages = 2, kProducerRegs = 24, kRegs = 240;
constexpr int kHalf = 128 * tc::kChunkRowBytes;  // a 64-column chunk of 128 rows: 16 KB
constexpr int kThreads = 384, kCThreads = 256;

enum Mode { kSkeleton, kExp, kFull, kBf16Skel };

template <int kMode>
struct Cfg {
  static constexpr bool kPacked = kMode != kBf16Skel;
  static constexpr int kChunks = kPacked ? 2 : 1;  // 64-column chunks of q, k and v rows
  static constexpr int kTile = kChunks * kHalf;
  static constexpr int kK = kTile, kV = kK + kStages * kTile, kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;
};

// k-step kk's A operand as one bf16 term.
__device__ __forceinline__ void pack_a1(uint32_t (&a)[4], const float (&x)[64], int kk) {
#pragma unroll
  for (int w = 0; w < 4; ++w) a[w] = tc::pack_bf16(x[8 * kk + 2 * w], x[8 * kk + 2 * w + 1]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
probe_fp32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int s_kv) {
  using C = Cfg<kMode>;
  constexpr int kD = 64;  // the logical head_dim
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  const int r0 = blockIdx.x * kM, bh = blockIdx.y, n_tiles = s_kv / kN;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      tc::mbar_init(&full[st], 1);
      tc::mbar_init(&empty[st], kCThreads);
    }
    tc::mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread issues every load
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    tc::mbar_arrive_tx(q_bar, C::kTile);
    for (int c = 0; c < C::kChunks; ++c)
      tc::tma_load(smem + c * kHalf, &tm_q, q_bar, c * tc::kChunk, r0, bh);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[st], (i / kStages - 1) & 1);
      tc::mbar_arrive_tx(&full[st], 2 * C::kTile);
      for (int c = 0; c < C::kChunks; ++c) {
        tc::tma_load(smem + C::kK + st * C::kTile + c * kHalf, &tm_k, &full[st], c * tc::kChunk,
                     i * kN, bh);
        tc::tma_load(smem + C::kV + st * C::kTile + c * kHalf, &tm_v, &full[st], c * tc::kChunk,
                     i * kN, bh);
      }
    }
    return;
  }

  tc::setmaxnreg_inc<kRegs>();
  const int tid = threadIdx.x - 128, cw = tid / 128, warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int ra = r0 + 64 * cw + 16 * warp + g, rb = ra + 8;
  constexpr int kOut = C::kPacked ? 64 : 32;  // PV's accumulator: 128 or 64 columns
  float out[kOut];
#pragma unroll
  for (int x = 0; x < kOut; ++x) out[x] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint32_t q_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  tc::mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    tc::mbar_wait(&full[st], (i / kStages) & 1);
    const uint32_t k_base = tc::smem_u32(smem + C::kK + st * C::kTile);
    const uint32_t v_base = tc::smem_u32(smem + C::kV + st * C::kTile);
    float sc[64];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * C::kChunks; ++kk) {
      const uint64_t da = tc::make_desc(q_base + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024);
      tc::wgmma_ss<0, 0>(sc, da, tc::make_desc(k_base + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024),
                         kk > 0);
      if constexpr (C::kPacked)  // q . k_swap: q's hi chunk against k's lo chunk, and back
        tc::wgmma_ss<0, 0>(
            sc, da, tc::make_desc(k_base + (1 - kk / 4) * kHalf + (kk % 4) * 32, 16, 1024), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);

    if constexpr (kMode == kExp) {
#pragma unroll
      for (int x = 0; x < 64; ++x) sc[x] = tc::ex2((sc[x] - 5.f) * tc::kLog2e);
    } else if constexpr (kMode == kFull) {
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        if (x % 4 < 2) mx_a = fmaxf(mx_a, sc[x]);
        else mx_b = fmaxf(mx_b, sc[x]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = tc::ex2((m_a - mx_a) * tc::kLog2e);
      const float alpha_b = tc::ex2((m_b - mx_b) * tc::kLog2e);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;  // the ones column: sum of both terms of p
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const float p = tc::ex2((sc[x] - (x % 4 < 2 ? mx_a : mx_b)) * tc::kLog2e);
        const float hi = bf16_round(p), terms = hi + bf16_round(p - hi);
        if (x % 4 < 2) sum_a += terms;
        else sum_b += terms;
        sc[x] = p;
      }
      l_a = alpha_a * l_a + sum_a;
      l_b = alpha_b * l_b + sum_b;
#pragma unroll
      for (int x = 0; x < kOut; ++x) out[x] *= x % 4 < 2 ? alpha_a : alpha_b;
    }

    // out += P [v_hi | v_lo] (P's two terms), or P v (one term): V in its
    // MN-major form, N = 128 (two chunks) or 64.
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t db = tc::make_desc(v_base + kk * 16 * tc::kChunkRowBytes, kHalf, 1024);
      uint32_t hi[4];
      if constexpr (C::kPacked) {
        uint32_t lo[4];
        tc::pack_a2(hi, lo, sc, kk);
        tc::wgmma_rs<1>(out, hi, db, 1);
        tc::wgmma_rs<1>(out, lo, db, 1);
#pragma unroll
        for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(lo[w])::"memory");
      } else {
        pack_a1(hi, sc, kk);
        tc::wgmma_rs<1>(out, hi, db, 1);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(hi[w])::"memory");
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(out);
    tc::mbar_arrive(&empty[st]);
  }

  float inv_a = 1.f, inv_b = 1.f;
  if constexpr (kMode == kFull) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    inv_a = l_a == 0.f ? 1.f : 1.f / l_a;
    inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
  }
  float* o_head = o + static_cast<size_t>(bh) * s_kv * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    // acc: columns 8j + 2t (+ 1) of v_hi, plus the same of v_lo (value j + 8).
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (C::kPacked) x[e] = out[4 * j + e] + out[4 * (j + kD / 8) + e];
      else x[e] = out[4 * j + e];
    }
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(o_head + static_cast<size_t>(ra) * kD + c) =
        make_float2(x[0] * inv_a, x[1] * inv_a);
    *reinterpret_cast<float2*>(o_head + static_cast<size_t>(rb) * kD + c) =
        make_float2(x[2] * inv_b, x[3] * inv_b);
  }
}

template <int kMode>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s_kv, int v_stride,
           cudaStream_t stream) {
  using C = Cfg<kMode>;
  const int w = C::kChunks * tc::kChunk;  // the q, k rows and the part of v's rows read
  if (s_kv <= 0 || s_kv % kN || v_stride % 8 || v_stride < w + 1) return -1;
  CUtensorMap mq, mk, mv;
  const long long head = static_cast<long long>(s_kv) * w;
  int st = tc_encode_map(&mq, q, w, s_kv, bh, head, kM);
  if (st == 0) st = tc_encode_map(&mk, k, w, s_kv, bh, head, kN);
  if (st == 0) {
    const long long dims[3] = {w, s_kv, bh};
    const long long strides[2] = {v_stride, static_cast<long long>(s_kv) * v_stride};
    st = tc_encode(&mv, v, 3, dims, strides, kN);
  }
  if (st != 0) return st;
  auto kernel = probe_fp32_kernel<kMode>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(s_kv / kM, bh), kThreads, C::kBytes, stream>>>(mq, mk, mv, static_cast<float*>(o),
                                                              s_kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: (bh, s, 128) bf16 packed [hi | lo] (mode 3: (bh, s, 64) bf16); v:
// (bh, s, 129) [v_hi | v_lo | 1] (mode 3: (bh, s, 65) [v | 1]) with rows
// v_stride elements apart (a multiple of 8), heads s * v_stride; o: (bh, s,
// 64) float32; s a multiple of 128.  Modes as above; -1 for another.
extern "C" int fa_probe_fp32(int mode, const void* q, const void* k, const void* v, void* o, int bh,
                             int s, int v_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<kSkeleton>(q, k, v, o, bh, s, v_stride, st);
    case 1: return launch<kExp>(q, k, v, o, bh, s, v_stride, st);
    case 2: return launch<kFull>(q, k, v, o, bh, s, v_stride, st);
    case 3: return launch<kBf16Skel>(q, k, v, o, bh, s, v_stride, st);
    default: return -1;
  }
}
