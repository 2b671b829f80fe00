// H100 probes of the transposed schedule at d = 128 (BH = 128, S = 2048,
// bf16 in, float32 out, unscaled, non-causal): the ports of
// scripts/probe_d128d.py::build (:45, pallas_call :75: t_vt, t_vtk, t_full,
// t_o_norm) and scripts/probe_d128e.py::build (:41, :71: t_qk_heavy,
// t_pv_heavy).  Their normal-orientation modes (base, pv_bf16out) are modes
// of probe_d128.cu.
//
// The TPU schedule flips both products so that each has a wide output:
// S^T = K Q^T (keys x queries), a per-query max along the keys, P^T =
// exp(S^T - m), O^T = V^T P^T (d x queries).  Here the same two products run
// on wgmma, and their costs on this card are the finding, kept as they are:
// - wgmma gives each warpgroup 64 rows of its output.  In S^T the rows are
//   keys, so a query's max spans the four warps of a warpgroup and both
//   consumer warpgroups of the block: every tile's column maxima go through
//   shared memory (quad shuffles, a table of 8 warps x 128 queries, one
//   thread a query for the running max and its step, two named barriers).
// - wgmma reads B only from shared memory, so every tile's P^T is written
//   there, as two bf16 terms (hi = bf16(p), lo = bf16(p - hi), as the other
//   probes feed P), in the MN-major (query-contiguous) swizzled layout,
//   before O^T = V^T P^T reads it (a proxy fence and a third barrier).
// - V^T is the A operand: K-major when V is stored (BH, d, S) (t_vt, t_full,
//   t_o_norm, t_qk_heavy, t_pv_heavy), MN-major when V is stored (BH, S, d)
//   (t_vtk), which is the descriptor's transpose bit on the same TMA tile,
//   not a copy.
// - The O^T accumulator is d x queries: each warpgroup owns 64 rows of d
//   for all 128 queries of the block (64 registers a thread), and is
//   rescaled per query column whenever that query's running max moves.
//
// Block: 128 queries of one head, a producer warpgroup (one thread issues
// TMA) and two consumer warpgroups, each taking 64 keys of a 128-key tile
// in S^T and 64 rows of d in O^T.  Shared memory: Q (32 KB), a two-stage K
// ring (64 KB), one V tile (32 KB; the next loads while the consumers run
// S^T and the softmax), P^T's two terms (64 KB).  Grid (S / 128, BH).
//
// Modes (ops/probes.py's D128DE_MODES):
//   0 t_vt      V (BH, d, S); O^T = sum exp(S^T - m) V^T, unnormalized,
//               stored (BH, d, S);
//   1 t_vtk     the same with V stored (BH, S, d);
//   2 t_full    t_vt with l (the column sums of p) and the divide;
//   3 t_o_norm  t_vt with O stored (BH, S, d);
//   4 t_qk_heavy S^T = K Q^T over every tile; O^T = V^T[:, :128] S^T[:128]:
//               PV over the first 128 keys only, no exp (S^T as two terms);
//   5 t_pv_heavy S_small = K[:128] Q^T once, tiled down the keys: O^T = sum
//               over every V tile of V^T S_small (written to shared memory
//               once).
// Bound on this card: operations (4 d flops a pair; the two heavy modes 2 d
// and a 128-key sliver of the other product).
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int D = 128, kN = 128, kBQ = 128, kChunks = D / tc::kChunk;
constexpr int kHalf = 128 * tc::kChunkRowBytes;  // a 64-column chunk of 128 rows
constexpr int kTile = kChunks * kHalf;           // Q, a K or V tile, or one term of P^T: 32 KB
constexpr int kKStages = 2, kCons = 2, kWarps = 4 * kCons;
constexpr int kThreads = 128 * (kCons + 1), kCThreads = 128 * kCons;
constexpr int kRegs = 240, kProducerRegs = 24;
// Q | K stages | V | P^T hi, lo | column table (kWarps x kBQ) | m | alpha | barriers
constexpr int kK = kTile, kV = kK + kKStages * kTile, kP = kV + kTile, kRed = kP + 2 * kTile;
constexpr int kM = kRed + kWarps * kBQ * 4, kAlpha = kM + kBQ * 4, kBar = kAlpha + kBQ * 4;
constexpr int kBytes = kBar + 8 * (2 * kKStages + 3) + tc::kAtomBytes;

enum Var { kSoftmax, kFull, kQkHeavy, kPvHeavy };

// Values 4j + 2rr, 4j + 2rr + 1 of an S^T accumulator (key row r of the
// tile, queries 8j + 2t, + 1) as P^T's two bf16 terms, into the MN-major
// swizzled layout: chunk j / 8 of 64 queries, 128-byte rows of keys, 16-byte
// unit j % 8 of row r at unit (j % 8) ^ (r % 8).
__device__ __forceinline__ void store_p(unsigned char* p, const float (&x)[64], int r, int t) {
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r + 8 * rr;
      const int off = (j / 8) * kHalf + row * tc::kChunkRowBytes + (((j % 8) ^ (row % 8)) << 4) + 4 * t;
      const uint32_t hi = tc::pack_bf16(x[4 * j + 2 * rr], x[4 * j + 2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(p + off) = hi;
      *reinterpret_cast<uint32_t*>(p + kTile + off) =
          tc::pack_lo(x[4 * j + 2 * rr], x[4 * j + 2 * rr + 1], hi);
    }
}

// Per query column of this thread (8j + 2t + ii, value index 2j + ii): the
// sum or max of its two rows, over the 8 quads of the warp, into the
// column table's row `wid` (lanes of quad 0 write).
template <bool kMax>
__device__ __forceinline__ void columns_to_table(float* red, const float (&x)[64], int wid, int g,
                                                 int t) {
  float c[32];
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      c[2 * j + ii] = kMax ? fmaxf(x[4 * j + ii], x[4 * j + 2 + ii]) : x[4 * j + ii] + x[4 * j + 2 + ii];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int y = 0; y < 32; ++y) {
      const float o = __shfl_xor_sync(0xffffffffu, c[y], off);
      c[y] = kMax ? fmaxf(c[y], o) : c[y] + o;
    }
  if (g == 0)
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) red[wid * kBQ + 8 * j + 2 * t + ii] = c[2 * j + ii];
}

template <int kVar, bool kVT, bool kONorm>
__global__ void __launch_bounds__(kThreads, 1)
probe_t_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int s_kv) {
  constexpr bool kSoft = kVar == kSoftmax || kVar == kFull;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* k_empty = k_full + kKStages;
  uint64_t* v_full = k_empty + kKStages;
  uint64_t* v_empty = v_full + 1;
  uint64_t* q_bar = v_empty + 1;
  float* red = reinterpret_cast<float*>(smem + kRed);
  float* m_sm = reinterpret_cast<float*>(smem + kM);
  float* alpha_sm = reinterpret_cast<float*>(smem + kAlpha);
  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y;
  const int n_tiles = s_kv / kN;
  // S^T over tiles [0, k_tiles), O^T over V tiles [0, v_tiles).
  const int k_tiles = kVar == kPvHeavy ? 1 : n_tiles;
  const int v_tiles = kVar == kQkHeavy ? 1 : n_tiles;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kKStages; ++st) {
      tc::mbar_init(&k_full[st], 1);
      tc::mbar_init(&k_empty[st], kCThreads);
    }
    tc::mbar_init(v_full, 1);
    tc::mbar_init(v_empty, kCThreads);
    tc::mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread issues every load
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    tc::mbar_arrive_tx(q_bar, kTile);
    for (int c = 0; c < kChunks; ++c)
      tc::tma_load(smem + c * kHalf, &tm_q, q_bar, c * tc::kChunk, q0, bh);
    for (int i = 0; i < n_tiles; ++i) {
      if (i < k_tiles) {
        const int st = i % kKStages;
        if (i >= kKStages) tc::mbar_wait(&k_empty[st], (i / kKStages - 1) & 1);
        tc::mbar_arrive_tx(&k_full[st], kTile);
        for (int c = 0; c < kChunks; ++c)
          tc::tma_load(smem + kK + st * kTile + c * kHalf, &tm_k, &k_full[st], c * tc::kChunk,
                       i * kN, bh);
      }
      if (i < v_tiles) {
        if (i > 0) tc::mbar_wait(v_empty, (i - 1) & 1);
        tc::mbar_arrive_tx(v_full, kTile);
        for (int c = 0; c < kChunks; ++c) {
          // (BH, d, S): keys i kN + 64 c of all d rows; (BH, S, d): d columns 64 c of the tile.
          if (kVT) tc::tma_load(smem + kV + c * kHalf, &tm_v, v_full, i * kN + c * tc::kChunk, 0, bh);
          else tc::tma_load(smem + kV + c * kHalf, &tm_v, v_full, c * tc::kChunk, i * kN, bh);
        }
      }
    }
    return;
  }

  tc::setmaxnreg_inc<kRegs>();
  const int tid = threadIdx.x - 128, cw = tid / 128, warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4, t = tid % 4, wid = 4 * cw + warp;
  const int r = 64 * cw + 16 * warp + g;  // this thread's rows (+ 8): keys of S^T, d of O^T
  if (tid < kBQ) m_sm[tid] = -INFINITY;
  float oacc[64], l_part[kVar == kFull ? 32 : 1];
#pragma unroll
  for (int x = 0; x < 64; ++x) oacc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < (kVar == kFull ? 32 : 1); ++x) l_part[x] = 0.f;
  const uint32_t q_base = tc::smem_u32(smem), v_base = tc::smem_u32(smem + kV);
  const uint32_t p_base = tc::smem_u32(smem + kP);
  tc::mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    float sc[64];
    if (i < k_tiles) {  // S^T = K Q^T: this warpgroup's 64 keys x 128 queries
      const int st = i % kKStages;
      tc::mbar_wait(&k_full[st], (i / kKStages) & 1);
      const uint32_t k_base = tc::smem_u32(smem + kK + st * kTile);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = tc::make_desc(
            k_base + (kk / 4) * kHalf + cw * 64 * tc::kChunkRowBytes + (kk % 4) * 32, 16, 1024);
        const uint64_t db = tc::make_desc(q_base + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024);
        tc::wgmma_ss<0, 0>(sc, da, db, kk > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(sc);
      tc::mbar_arrive(&k_empty[st]);
    }
    if constexpr (kSoft) {
      // The running max of each query over the keys: column maxima through
      // the table, one thread a query for m and its step alpha.
      columns_to_table<true>(red, sc, wid, g, t);
      tc::named_sync(1, kCThreads);
      if (tid < kBQ) {
        float mx = red[tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * kBQ + tid]);
        const float mo = m_sm[tid], mn = fmaxf(mo, mx);
        alpha_sm[tid] = tc::ex2((mo - mn) * tc::kLog2e);
        m_sm[tid] = mn;
      }
      tc::named_sync(1, kCThreads);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int c = 8 * j + 2 * t + ii;
          const float m = m_sm[c], a = alpha_sm[c];
          const float p0 = tc::ex2((sc[4 * j + ii] - m) * tc::kLog2e);
          const float p1 = tc::ex2((sc[4 * j + 2 + ii] - m) * tc::kLog2e);
          sc[4 * j + ii] = p0;
          sc[4 * j + 2 + ii] = p1;
          oacc[4 * j + ii] *= a;
          oacc[4 * j + 2 + ii] *= a;
          if constexpr (kVar == kFull) l_part[2 * j + ii] = a * l_part[2 * j + ii] + p0 + p1;
        }
    }
    if (kSoft || i == 0) {  // P^T (the heavy modes: S^T itself, once) to shared memory
      store_p(smem + kP, sc, r, t);
      tc::fence_async_smem();
      tc::named_sync(1, kCThreads);
    }
    if (i < v_tiles) {  // O^T += V^T P^T: this warpgroup's 64 rows of d x 128 queries
      tc::mbar_wait(v_full, i & 1);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const uint64_t da =
            kVT ? tc::make_desc(
                      v_base + (kk / 4) * kHalf + cw * 64 * tc::kChunkRowBytes + (kk % 4) * 32, 16,
                      1024)
                : tc::make_desc(v_base + cw * kHalf + kk * 16 * tc::kChunkRowBytes, kHalf, 1024);
        const uint32_t pk = p_base + kk * 16 * tc::kChunkRowBytes;
        tc::wgmma_ss<kVT ? 0 : 1, 1>(oacc, da, tc::make_desc(pk, kHalf, 1024), 1);
        tc::wgmma_ss<kVT ? 0 : 1, 1>(oacc, da, tc::make_desc(pk + kTile, kHalf, 1024), 1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(oacc);
      tc::mbar_arrive(v_empty);
    }
  }

  if constexpr (kVar == kFull) {  // l per query: the column sums through the table, then O / l
    float lp[64];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        lp[4 * j + ii] = l_part[2 * j + ii];
        lp[4 * j + 2 + ii] = 0.f;
      }
    columns_to_table<false>(red, lp, wid, g, t);
    tc::named_sync(1, kCThreads);
    if (tid < kBQ) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += red[w * kBQ + tid];
      alpha_sm[tid] = l == 0.f ? 1.f : 1.f / l;
    }
    tc::named_sync(1, kCThreads);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float inv = alpha_sm[8 * j + 2 * t + ii];
        oacc[4 * j + ii] *= inv;
        oacc[4 * j + 2 + ii] *= inv;
      }
  }
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int dd = r + 8 * rr, q = q0 + 8 * j + 2 * t;
      if constexpr (kONorm) {  // (BH, S, d)
        float* oq = o + (static_cast<size_t>(bh) * s_kv + q) * D + dd;
        oq[0] = oacc[4 * j + 2 * rr];
        oq[D] = oacc[4 * j + 2 * rr + 1];
      } else {  // (BH, d, S)
        *reinterpret_cast<float2*>(o + (static_cast<size_t>(bh) * D + dd) * s_kv + q) =
            make_float2(oacc[4 * j + 2 * rr], oacc[4 * j + 2 * rr + 1]);
      }
    }
}

template <int kVar, bool kVT, bool kONorm>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int s_kv,
           cudaStream_t stream) {
  if (s_kv <= 0 || s_kv % kN) return -1;
  CUtensorMap mq, mk, mv;
  const long long head = static_cast<long long>(s_kv) * D;
  int st = tc_encode_map(&mq, q, D, s_kv, bh, head, kBQ);
  if (st == 0) st = tc_encode_map(&mk, k, D, s_kv, bh, head, kN);
  // (BH, d, S) as d rows of S columns, a tile's 64-key chunks as boxes of all d rows.
  if (st == 0) st = kVT ? tc_encode_map(&mv, v, s_kv, D, bh, head, D)
                        : tc_encode_map(&mv, v, D, s_kv, bh, head, kN);
  if (st != 0) return st;
  auto kernel = probe_t_kernel<kVar, kVT, kONorm>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(s_kv / kBQ, bh), kThreads, kBytes, stream>>>(mq, mk, mv, static_cast<float*>(o),
                                                            s_kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k: (bh, s, 128) bf16; v: (bh, 128, s) bf16, or (bh, s, 128) for mode
// 1 (t_vtk); o: float32 (bh, 128, s), or (bh, s, 128) for mode 3
// (t_o_norm); s a multiple of 128.  Modes as above; -1 for another.
extern "C" int fa_probe_d128t(int mode, const void* q, const void* k, const void* v, void* o,
                              int bh, int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<kSoftmax, true, false>(q, k, v, o, bh, s, st);
    case 1: return launch<kSoftmax, false, false>(q, k, v, o, bh, s, st);
    case 2: return launch<kFull, true, false>(q, k, v, o, bh, s, st);
    case 3: return launch<kSoftmax, true, true>(q, k, v, o, bh, s, st);
    case 4: return launch<kQkHeavy, true, false>(q, k, v, o, bh, s, st);
    case 5: return launch<kPvHeavy, true, false>(q, k, v, o, bh, s, st);
    default: return -1;
  }
}
