// H100 probes of the d = 128 forward at the Llama-7B shape (BH = 128, S =
// 2048, bf16, non-causal): the ports of scripts/probe_d128.py's
// pipeline_decomposition (:69, pallas_call :178), probe_d128b.py's build
// (:38, :73), probe_d128c.py's build (:45, :92) and probe_d128f.py's build
// (:35, :56), on flash_fwd_tc.cuh's producer/consumer structure: one
// producer warp keeps a two-stage TMA ring of 128-row K and V tiles in
// flight, consumer warpgroups of 64 query rows each take S = Q K^T by wgmma
// with both operands in shared memory and O += P V with P from registers.
// No mask, no window or softcap: S_kv a multiple of 128; every row sees
// every key.
//
// The TPU probes hold a whole 2048-key row in VMEM and take each product
// whole; here K and V stream through the ring, so each variant is the
// nearest streaming stage (ops/probes.py names them and holds each against
// its plain version):
//
// item 1 (probe_d128.py:74-81), 128 query rows a block:
//   skeleton  S = scale Q K^T, O += S V, S entering PV as two bf16 terms
//             (the kernel's nearest rendition of the TPU's float32 S);
//   exp       P = exp(S - 5);
//   maxexp    P = exp(S - m), m the running row max over the tiles seen so
//             far, with no rescale and no sums;
//   full/scratch are the kernel itself (probe_mma.cu mode 0), split2 its two
//   chains (probe_mma.cu mode 4).
// item 2 (probe_d128b.py):
//   pcast     S as one bf16 term: its gap to skeleton is the price of the
//             second PV product;
//   qk_heavy / pv_heavy are probe_mma.cu modes 1 and 2;
//   bq64 / bq192: the skeleton at 64 and 192 query rows a block (one and
//             three consumer warpgroups; three leave 160 registers a
//             thread), the TPU's block_q sweep;
//   bh2       two (head, query-block) tiles a block, one after the other
//             through the same ring (the TPU's two heads a step);
//   pcast_bq192, pcast_bh2: the same with one term.
// item 3 (probe_d128c.py):
//   pv_split2 / pv_split4: each 64-column part of a tile's PV dealt by
//             k-step to 2 / 4 independent accumulators, issued together and
//             summed in the part's epilogue into O;
//   vt        V stored (BH, d, S), so PV's B operand is K-major;
//   vt_split2 both;
//   qk_nn     K stored (BH, d, S): QK^T's B operand MN-major;
//   ones      (no mode of its own) the skeleton over an all-ones V.
// item 6 (probe_d128f.py): the whole kernel at 128 / 192 query rows a
//   block x PV split 1 / 2: full_bq128_split1, full_bq128_split2,
//   full_bq192_split1, full_bq192_split2; beside probe_mma.cu mode 0, the
//   kernel itself (flash_fwd_tc.cuh, with its masks, segment ids and
//   dropout paths), which computes what full_bq128_split1 computes.
//
// items 4 and 5's normal orientation (probe_d128d.py::build :45, pallas_call
// :75; probe_d128e.py::build :41, :71), unscaled, O float32 (BH, S, d):
//   base       O = sum exp(S - m) V unnormalized, m the max over the whole
//              key row: streaming, O is rescaled whenever the running max
//              moves (the other orientation is csrc/probe_d128t.cu);
//   pv_bf16out P = exp(S - 5), O = P V rounded once to bf16 and stored as
//              float32: wgmma with bf16 operands sums only in float32, so
//              the counterpart of the TPU product that emits bf16 is the
//              bf16 rounding and store of the float32 accumulator.
//
// Built three times (FA_PROBE_HALF 0, 1 and 2), each library holding part
// of the modes, so that none lengthens the build.
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int D = 128, kN = 128, kStages = 2, kChunks = D / tc::kChunk;
constexpr int kHalf = kN * tc::kChunkRowBytes;  // one 64-column chunk of a tile, either layout
constexpr int kTile = kChunks * kHalf;          // a K or V tile: 32 KB
constexpr int kProducerRegs = 24;

enum Var { kSkeleton, kExp, kMaxExp, kFull, kRescale };
// O as stored: bf16; float32; float32 of O rounded once to bf16.
enum Out { kOutBf16, kOutF32, kOutF32ViaBf16 };

template <int kCons, int kTiles>
struct Layout {
  static constexpr int kBlockM = 64 * kCons;
  static constexpr int kThreads = 128 * (kCons + 1);
  // Three consumer warpgroups and the producer share 64 K registers.
  static constexpr int kRegs = kCons == 3 ? 160 : 240;
  static constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;
  // Q of each tile | K stages | V stages | barriers
  static constexpr int kK = kTiles * kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + kTiles) + tc::kAtomBytes;
};

// k-step kk's A operand as one bf16 term (values 8kk .. 8kk + 7).
template <int R>
__device__ __forceinline__ void pack_a1(uint32_t (&hi)[4], const float (&x)[R], int kk) {
#pragma unroll
  for (int w = 0; w < 4; ++w) hi[w] = tc::pack_bf16(x[8 * kk + 2 * w], x[8 * kk + 2 * w + 1]);
}

template <int kVar, int kTerms, int kCons, int kTiles, int kSplit, bool kVT, bool kKT,
          int kOut = kOutBf16>
__global__ void __launch_bounds__(Layout<kCons, kTiles>::kThreads, 1)
probe_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, void* __restrict__ o, int rows, int s_kv,
             float scale) {
  using L = Layout<kCons, kTiles>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;  // one per tile
  const int r0 = (gridDim.x - 1 - blockIdx.x) * L::kBlockM;
  const int n_tiles = s_kv / kN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 128 * kCons);
    }
    for (int t = 0; t < kTiles; ++t) tc::mbar_init(&q_bar[t], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      for (int t = 0; t < kTiles; ++t) {
        tc::mbar_arrive_tx(&q_bar[t], kChunks * L::kQChunk);
        for (int c = 0; c < kChunks; ++c)
          tc::tma_load(smem + (t * kChunks + c) * L::kQChunk, &tm_q, &q_bar[t], c * tc::kChunk, r0,
                       blockIdx.y * kTiles + t);
      }
    }
    for (int i = 0; i < kTiles * n_tiles; ++i) {
      const int s = i % kStages, bh = blockIdx.y * kTiles + i / n_tiles, t0 = (i % n_tiles) * kN;
      if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * kTile);
        for (int c = 0; c < kChunks; ++c) {
          unsigned char* kd = smem + L::kK + s * kTile + c * kHalf;
          unsigned char* vd = smem + L::kV + s * kTile + c * kHalf;
          // (BH, S, d): the chunk of d columns c; (BH, d, S): keys t0 + 64 c.
          if (kKT) tc::tma_load(kd, &tm_k, &full[s], t0 + c * tc::kChunk, 0, bh);
          else tc::tma_load(kd, &tm_k, &full[s], c * tc::kChunk, t0, bh);
          if (kVT) tc::tma_load(vd, &tm_v, &full[s], t0 + c * tc::kChunk, 0, bh);
          else tc::tma_load(vd, &tm_v, &full[s], c * tc::kChunk, t0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  tc::setmaxnreg_inc<L::kRegs>();
  const int cw = wg - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int ra = r0 + 64 * cw + 16 * warp + g, rb = ra + 8;
  for (int tt = 0; tt < kTiles; ++tt) {
    const int bh = blockIdx.y * kTiles + tt;
    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    const uint32_t q_base =
        tc::smem_u32(smem + tt * kChunks * L::kQChunk) + cw * 64 * tc::kChunkRowBytes;
    tc::mbar_wait(&q_bar[tt], 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int i = tt * n_tiles + j, s = i % kStages;
      tc::mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t k_base = tc::smem_u32(smem + L::kK + s * kTile);
      const uint32_t v_base = tc::smem_u32(smem + L::kV + s * kTile);
      float sc[kN / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = tc::make_desc(q_base + (kk / 4) * L::kQChunk + (kk % 4) * 32, 16, 1024);
        if constexpr (kKT) {  // K^T rows are d (the contraction), keys contiguous
          const uint64_t db = tc::make_desc(k_base + kk * 16 * tc::kChunkRowBytes, kHalf, 1024);
          tc::wgmma_ss<0, 1>(sc, da, db, kk > 0);
        } else {
          const uint64_t db = tc::make_desc(k_base + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024);
          tc::wgmma_ss<0, 0>(sc, da, db, kk > 0);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(sc);

      if constexpr (kVar == kSkeleton) {
#pragma unroll
        for (int x = 0; x < kN / 2; ++x) sc[x] *= scale;
      } else if constexpr (kVar == kExp) {
#pragma unroll
        for (int x = 0; x < kN / 2; ++x) sc[x] = tc::ex2((sc[x] * scale - 5.f) * tc::kLog2e);
      } else {  // the running row max (kFull, kRescale: and the rescale of O)
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int x = 0; x < kN / 2; ++x) {
          sc[x] *= scale;
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
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int x = 0; x < kN / 2; ++x) {
          const float p = tc::ex2((sc[x] - (x % 4 < 2 ? mx_a : mx_b)) * tc::kLog2e);
          if (x % 4 < 2) sum_a += p;
          else sum_b += p;
          sc[x] = p;
        }
        if constexpr (kVar == kFull) {
          l_a = alpha_a * l_a + sum_a;
          l_b = alpha_b * l_b + sum_b;
        }
        if constexpr (kVar == kFull || kVar == kRescale) {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) acc[x] *= x % 4 < 2 ? alpha_a : alpha_b;
        }
      }

      // O += P V: each 64-column part of d summed afresh over the tile's
      // kN / 16 k-steps, dealt to kSplit accumulators, then added to O.
      uint32_t pa[kN / 16][4], pl[kTerms == 2 ? kN / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        if constexpr (kTerms == 2) tc::pack_a2(pa[kk], pl[kk], sc, kk);
        else pack_a1(pa[kk], sc, kk);
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float part[kSplit][32];
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          const int a = kk % kSplit;
          if constexpr (kVT) {  // V^T rows are d, keys (the contraction) contiguous
            const uint64_t db = tc::make_desc(
                v_base + (kk / 4) * kHalf + c * 64 * tc::kChunkRowBytes + (kk % 4) * 32, 16, 1024);
            tc::wgmma_rs<0>(part[a], pa[kk], db, kk >= kSplit);
            if constexpr (kTerms == 2) tc::wgmma_rs<0>(part[a], pl[kk], db, 1);
          } else {
            const uint64_t db =
                tc::make_desc(v_base + c * kHalf + kk * 16 * tc::kChunkRowBytes, kHalf, 1024);
            tc::wgmma_rs<1>(part[a], pa[kk], db, kk >= kSplit);
            if constexpr (kTerms == 2) tc::wgmma_rs<1>(part[a], pl[kk], db, 1);
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < kSplit; ++a) tc::fence_regs(part[a]);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          float y = part[0][x];
#pragma unroll
          for (int a = 1; a < kSplit; ++a) y += part[a][x];
          acc[32 * c + x] += y;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          asm volatile("" : "+r"(pa[kk][w])::"memory");
          if constexpr (kTerms == 2) asm volatile("" : "+r"(pl[kk][w])::"memory");
        }
      tc::mbar_arrive(&empty[s]);
    }

    float inv_a = 1.f, inv_b = 1.f;
    if constexpr (kVar == kFull) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      inv_a = l_a == 0.f ? 1.f : 1.f / l_a;
      inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = 8 * jj + 2 * t;
      float2 xa = make_float2(acc[4 * jj] * inv_a, acc[4 * jj + 1] * inv_a);
      float2 xb = make_float2(acc[4 * jj + 2] * inv_b, acc[4 * jj + 3] * inv_b);
      if constexpr (kOut == kOutBf16) {
        __nv_bfloat16* o_head = static_cast<__nv_bfloat16*>(o) + static_cast<size_t>(bh) * rows * D;
        if (ra < rows)
          *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(ra) * D + c) =
              tc::pack_bf16(xa.x, xa.y);
        if (rb < rows)
          *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(rb) * D + c) =
              tc::pack_bf16(xb.x, xb.y);
      } else {
        if constexpr (kOut == kOutF32ViaBf16) {
          xa = make_float2(__bfloat162float(__float2bfloat16(xa.x)),
                           __bfloat162float(__float2bfloat16(xa.y)));
          xb = make_float2(__bfloat162float(__float2bfloat16(xb.x)),
                           __bfloat162float(__float2bfloat16(xb.y)));
        }
        float* o_head = static_cast<float*>(o) + static_cast<size_t>(bh) * rows * D;
        if (ra < rows) *reinterpret_cast<float2*>(o_head + static_cast<size_t>(ra) * D + c) = xa;
        if (rb < rows) *reinterpret_cast<float2*>(o_head + static_cast<size_t>(rb) * D + c) = xb;
      }
    }
  }
}

template <int kVar, int kTerms, int kCons, int kTiles, int kSplit, bool kVT, bool kKT,
          int kOut = kOutBf16>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int rows, int s_kv,
           float scale, cudaStream_t stream) {
  using L = Layout<kCons, kTiles>;
  if (s_kv <= 0 || s_kv % kN || bh % kTiles) return -1;
  CUtensorMap mq, mk, mv;
  const long long head = static_cast<long long>(s_kv) * D;
  int st = tc_encode_map(&mq, q, D, rows, bh, static_cast<long long>(rows) * D, L::kBlockM);
  // (BH, d, S) as `d` rows of S columns, a tile's 64-key chunks as boxes of all d rows.
  if (st == 0)
    st = kKT ? tc_encode_map(&mk, k, s_kv, D, bh, head, D)
             : tc_encode_map(&mk, k, D, s_kv, bh, head, kN);
  if (st == 0)
    st = kVT ? tc_encode_map(&mv, v, s_kv, D, bh, head, D)
             : tc_encode_map(&mv, v, D, s_kv, bh, head, kN);
  if (st != 0) return st;
  auto kernel = probe_kernel<kVar, kTerms, kCons, kTiles, kSplit, kVT, kKT, kOut>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + L::kBlockM - 1) / L::kBlockM, bh / kTiles);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(mq, mk, mv, o, rows, s_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

#ifndef FA_PROBE_HALF
#define FA_PROBE_HALF 0
#endif

}  // namespace

// q: (bh, rows, 128) bf16; o: (bh, rows, 128), bf16 (modes 0-17) or
// float32 (18, 19); k, v: (bh, s_kv, 128) bf16, or (bh, 128, s_kv) where
// the mode stores them transposed (qk_nn: k; vt, vt_split2: v); s_kv a
// multiple of 128, bh even for the two-tile modes.  Modes (the names of
// ops/probes.py's D128_MODES, then D128DE_MODES): 0 skeleton, 1 exp, 2
// maxexp, 3 pcast, 4 bq64, 5 bq192, 6 bh2, 7 pcast_bq192, 8 pcast_bh2
// (FA_PROBE_HALF 0); 9 pv_split2, 10 pv_split4, 11 vt, 12 vt_split2, 13
// qk_nn, 14 full_bq128_split2, 15 full_bq192_split1, 16 full_bq192_split2,
// 17 full_bq128_split1 (FA_PROBE_HALF 1); 18 base, 19 pv_bf16out
// (FA_PROBE_HALF 2).  -1 for a mode the library does not hold.
extern "C" int fa_probe_d128(int mode, const void* q, const void* k, const void* v, void* o,
                             int bh, int rows, int s_kv, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_PROBE_OUT(var, terms, cons, tiles, split, vt, kt, out) \
  launch<var, terms, cons, tiles, split, vt, kt, out>(q, k, v, o, bh, rows, s_kv, scale, st)
#define FA_PROBE(var, terms, cons, tiles, split, vt, kt) \
  FA_PROBE_OUT(var, terms, cons, tiles, split, vt, kt, kOutBf16)
#if FA_PROBE_HALF == 0
  switch (mode) {
    case 0: return FA_PROBE(kSkeleton, 2, 2, 1, 1, false, false);
    case 1: return FA_PROBE(kExp, 2, 2, 1, 1, false, false);
    case 2: return FA_PROBE(kMaxExp, 2, 2, 1, 1, false, false);
    case 3: return FA_PROBE(kSkeleton, 1, 2, 1, 1, false, false);
    case 4: return FA_PROBE(kSkeleton, 2, 1, 1, 1, false, false);
    case 5: return FA_PROBE(kSkeleton, 2, 3, 1, 1, false, false);
    case 6: return FA_PROBE(kSkeleton, 2, 2, 2, 1, false, false);
    case 7: return FA_PROBE(kSkeleton, 1, 3, 1, 1, false, false);
    case 8: return FA_PROBE(kSkeleton, 1, 2, 2, 1, false, false);
    default: return -1;
  }
#elif FA_PROBE_HALF == 1
  switch (mode) {
    case 9: return FA_PROBE(kSkeleton, 2, 2, 1, 2, false, false);
    case 10: return FA_PROBE(kSkeleton, 2, 2, 1, 4, false, false);
    case 11: return FA_PROBE(kSkeleton, 2, 2, 1, 1, true, false);
    case 12: return FA_PROBE(kSkeleton, 2, 2, 1, 2, true, false);
    case 13: return FA_PROBE(kSkeleton, 2, 2, 1, 1, false, true);
    case 14: return FA_PROBE(kFull, 2, 2, 1, 2, false, false);
    case 15: return FA_PROBE(kFull, 2, 3, 1, 1, false, false);
    case 16: return FA_PROBE(kFull, 2, 3, 1, 2, false, false);
    case 17: return FA_PROBE(kFull, 2, 2, 1, 1, false, false);
    default: return -1;
  }
#else
  switch (mode) {
    case 18: return FA_PROBE_OUT(kRescale, 2, 2, 1, 1, false, false, kOutF32);
    case 19: return FA_PROBE_OUT(kExp, 2, 2, 1, 1, false, false, kOutF32ViaBf16);
    default: return -1;
  }
#endif
#undef FA_PROBE
#undef FA_PROBE_OUT
}
