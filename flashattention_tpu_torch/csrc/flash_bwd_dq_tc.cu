// Flash-attention backward, the two-pass pair's dQ pass, on Hopper's tensor
// cores (sm_90a).  The pair's dK/dV pass is flash_bwd_tc.cu built with
// FA_PAIR (flash_bwd_dkv_tc).
//
// Replaces flashattention_tpu/ops/backward.py::_dq_kernel (the pallas_call at
// backward.py:858) for bf16 q/k/v/dO at head_dim 64, 128 and 256: for each
// query row i, dQ_i = sum_j dS_ij k_j over the key columns it sees, with
// causal masking at position q_offset + (i mod q_seq_len) (the GQA row fold),
// kv_len, the score scale, segment ids (row i sees column j only where their
// ids are equal), a sliding window and a logit softcap with its derivative on
// dS (the compile-time form kWindowCap), and attention dropout in the
// compile-time form kExtra (built with FA_EXTRA; the keep bits of common.cuh,
// bit for bit).  See bwd_common.cuh for the formulas.  Block masks stay on
// the scalar csrc/flash_bwd_dq.cu.
//
// Bound on this card: operations, 6 d flops a live pair (S = q.k, dP = do.v,
// dQ += dS k) against q, do, k, v read once.  All three run as wgmma (bf16 x
// bf16 -> float32); dS k runs once per bf16 term of dS (see Rounding): 8 d
// tensor flops a pair.
//
// Design: the forward's shape (flash_fwd_tc.cuh) with one product more.  One
// block per (bh, 128 query rows), 384 threads.  Warpgroup 0 is the producer:
// one warp loads the block's Q and dO once by TMA, then streams K and V tiles
// of 64 key rows, with the key rows' segment ids, through a ring of stages
// (full/empty mbarriers).  Warpgroups 1 and 2 each own 64 query rows, with
// each row's lse, di, first and last visible column, segment id and dropout
// row key in registers, and keep dQ (64 x d float32) in registers for the
// whole loop.  Per key tile:
//   S = Q K^T and dP = dO V^T by wgmma, both operands from shared memory;
//   P = exp(S - lse) on the capped score, 0 where masked (causal, window,
//   kv_len, segment ids); with dropout dP <- keep dP / (1 - rate);
//   dS = P (dP - di) scale c, c the softcap's derivative, split into two
//   bf16 terms in registers;
//   dQ += dS K with A from registers and K read in its MN-major form, as the
//   forward's PV product reads V, 64 columns of d at a time, each tile's part
//   summed afresh and added to dQ in float32 (see flash_fwd_tc.cuh).
// dQ is written once, in bf16: no atomics, so the pair's dQ is the same from
// run to run (the fused form's is not).
//
// The key loop covers only the block's live band: from the first tile the
// window of its smallest position reaches to its causal end and kv_len.
// With segment ids the wrapper gives each head's [min, max] id of every 64
// rows (fa_bwd::Segs); the producer skips a key tile whose range is disjoint
// from the block's, and a consumer, beside the band, one disjoint from its
// own 64 rows' (it waits for the tile and frees it).  Disjoint ranges share
// no id, whatever the order of the ids, so the skip is exact.  Only tiles
// that cross a bound, or whose ids are not one id on both sides, are masked
// element by element.  K/V rows past kv_len and query rows past the end
// arrive from TMA as zeros.
//
// head_dim 256: Q and dO of 128 rows take 128 KB of shared memory and a K/V
// stage of 64 keys another 64 KB, so the ring has one stage there (two below,
// 128 KB at d = 128): the producer loads the next tile only once both
// consumers are done with this one.  The other way, 64 query rows a block,
// leaves one consumer warpgroup on each SM.
//
// Rounding: dS enters its product as two bf16 terms, hi = bf16(x) and lo =
// bf16(x - hi), as in the fused form; ops/backward.py's plain version mirrors
// it (form="tc").
#include "bwd_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int kN = 64;        // key rows per tile
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
static_assert(kN == fa_bwd::kSegTile, "a key tile is one entry of the segment range table");

template <int D>
struct Cfg {
  static constexpr int kStages = D >= 256 ? 1 : 2;
  static constexpr int kChunks = D / tc::kChunk;
  static constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;  // one chunk of Q or dO
  static constexpr int kKVChunk = kN * tc::kChunkRowBytes;      // one chunk of a K or V tile
  static constexpr int kTile = kChunks * kKVChunk;              // a K or V tile
  // Q | dO | K stages | V stages | key segment ids by stage | barriers
  static constexpr int kDo = kChunks * kQChunk;
  static constexpr int kK = kDo + kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kSeg = kV + kStages * kTile;
  static constexpr int kBar = kSeg + kStages * kN * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;  // + alignment
  static_assert(kBytes <= 232448, "over Hopper's shared memory a block");
};

// The key columns [begin, end) the query rows [r0, r0 + kBlockM) may see,
// begin a multiple of the tile (flash_fwd_tc.cuh's kv_range).
struct Range {
  int begin, end;
};
template <bool kWindowCap>
__device__ __forceinline__ Range kv_range(int r0, int rows, int kv_len, int q_offset,
                                          int q_seq_len, int causal, int window) {
  const int r1 = min(rows, r0 + kBlockM) - 1;
  const bool one_segment = r0 / q_seq_len == r1 / q_seq_len;
  Range r{0, kv_len};
  if (causal) r.end = min(r.end, q_offset + (one_segment ? r1 % q_seq_len : q_seq_len - 1) + 1);
  if (kWindowCap && window > 0) {
    const int first = max(0, q_offset + (one_segment ? r0 % q_seq_len : 0) - window + 1);
    r.begin = first - first % kN;
  }
  return r;
}

template <int D, bool kWindowCap, bool kExtra>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ di, const fa_bwd::Segs sg,
                       __nv_bfloat16* __restrict__ dq, int rows, int s_kv, int kv_len,
                       int q_offset, int q_seq_len, int causal, float scale, int window,
                       float softcap, const fa::Extras ex) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  int* seg_t = reinterpret_cast<int*>(smem + C::kSeg);

  const int bh = blockIdx.y;
  // The longest query tiles (causal: the last) first, for a shorter tail.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const bool has_seg = sg.q != nullptr;
  const int n_qt = (rows + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int n_kt = (s_kv + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int* q_rng = has_seg ? sg.q_rng + static_cast<size_t>(bh) * n_qt * 2 : nullptr;
  const int* kv_rng = has_seg ? sg.kv_rng + static_cast<size_t>(bh) * n_kt * 2 : nullptr;
  const Range kv = kv_range<kWindowCap>(r0, rows, kv_len, q_offset, q_seq_len, causal, win);
  const int n_tiles = kv.end > kv.begin ? (kv.end - kv.begin + kN - 1) / kN : 0;
  // The block's ids: a key tile whose range is disjoint from them is skipped.
  const int2 block_ids = has_seg ? fa_bwd::seg_range(q_rng, n_qt, r0, kBlockM) : make_int2(0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);   // the producer warp's lanes
      tc::mbar_init(&empty[s], 256);  // every consumer thread
    }
    tc::mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tc::mbar_arrive_tx(q_bar, 2 * C::kChunks * C::kQChunk);
      for (int c = 0; c < C::kChunks; ++c) {
        tc::tma_load(smem + c * C::kQChunk, &tm_q, q_bar, c * tc::kChunk, r0, bh);
        tc::tma_load(smem + C::kDo + c * C::kQChunk, &tm_do, q_bar, c * tc::kChunk, r0, bh);
      }
    }
    for (int i = 0, j = 0; i < n_tiles; ++i) {
      const int t0 = kv.begin + i * kN;
      if (has_seg && !fa_bwd::seg_meet(block_ids, fa_bwd::seg_range(kv_rng, n_kt, t0, kN)))
        continue;
      const int s = j % kStages;
      if (j >= kStages) tc::mbar_wait(&empty[s], (j / kStages - 1) & 1);
      if (has_seg)
        for (int x = lane; x < kN; x += 32)
          seg_t[s * kN + x] = t0 + x < kv_len ? sg.kv[static_cast<size_t>(bh) * s_kv + t0 + x] : 0;
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * C::kTile);
        for (int c = 0; c < C::kChunks; ++c) {
          tc::tma_load(smem + C::kK + s * C::kTile + c * C::kKVChunk, &tm_k, &full[s],
                       c * tc::kChunk, t0, bh);
          tc::tma_load(smem + C::kV + s * C::kTile + c * C::kKVChunk, &tm_v, &full[s],
                       c * tc::kChunk, t0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
      ++j;
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows rw0 .. rw0 + 63.
  tc::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int rw0 = r0 + 64 * cw;
  const int ra = rw0 + 16 * warp + g;  // this thread's rows: ra and ra + 8
  const int rb = ra + 8;
  // The positions this warpgroup's rows span (a GQA segment crossing: all).
  const bool wg_live = rw0 < rows;
  const int rw1 = min(rows, rw0 + 64) - 1;
  const bool wg_one = rw0 / q_seq_len == rw1 / q_seq_len;
  const int pmin = q_offset + (wg_one ? rw0 % q_seq_len : 0);
  const int pmax = q_offset + (wg_one ? rw1 % q_seq_len : q_seq_len - 1);
  const int2 wg_ids = has_seg && wg_live ? fa_bwd::seg_range(q_rng, n_qt, rw0, 64) : make_int2(0, 0);
  // Each row's statistics, visible columns, segment id and dropout key.
  const size_t head = static_cast<size_t>(bh) * rows;
  const bool in_a = ra < rows, in_b = rb < rows;
  const float lse_a = in_a ? lse[head + ra] : 0.f, lse_b = in_b ? lse[head + rb] : 0.f;
  const float di_a = in_a ? di[head + ra] : 0.f, di_b = in_b ? di[head + rb] : 0.f;
  const int first_a = fa_bwd::row_first(ra, q_offset, q_seq_len, win);
  const int first_b = fa_bwd::row_first(rb, q_offset, q_seq_len, win);
  const int last_a = fa_bwd::row_limit(ra, rows, kv_len, q_offset, q_seq_len, causal);
  const int last_b = fa_bwd::row_limit(rb, rows, kv_len, q_offset, q_seq_len, causal);
  const int seg_a = has_seg && in_a ? sg.q[head + ra] : 0;
  const int seg_b = has_seg && in_b ? sg.q[head + rb] : 0;
  unsigned key_a = 0, key_b = 0;
  if (dropout) {
    key_a = fa::dropout_row_key(ex, bh, ra, q_seq_len);
    key_b = fa::dropout_row_key(ex, bh, rb, q_seq_len);
  }

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  const uint32_t q_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  const uint32_t do_base = tc::smem_u32(smem + C::kDo) + cw * 64 * tc::kChunkRowBytes;
  tc::mbar_wait(q_bar, 0);

  for (int i = 0, j = 0; i < n_tiles; ++i) {
    const int t0 = kv.begin + i * kN;
    int2 tile_ids = make_int2(0, 0);
    if (has_seg) {
      tile_ids = fa_bwd::seg_range(kv_rng, n_kt, t0, kN);
      if (!fa_bwd::seg_meet(block_ids, tile_ids)) continue;
    }
    const int s = j % kStages;
    tc::mbar_wait(&full[s], (j / kStages) & 1);
    ++j;
    const bool skip = !wg_live || (causal && t0 > pmax) || (win > 0 && t0 + kN - 1 <= pmin - win) ||
                      (has_seg && !fa_bwd::seg_meet(wg_ids, tile_ids));
    if (skip) {
      tc::mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t k_base = tc::smem_u32(smem + C::kK + s * C::kTile);
    const uint32_t v_base = tc::smem_u32(smem + C::kV + s * C::kTile);
    const int* seg_s = seg_t + s * kN;

    float st[kN / 2], dpt[kN / 2];  // S and dP: query rows x key columns
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // a k-step inside the swizzled row
      tc::wgmma_ss<0, 0>(st, tc::make_desc(q_base + (kk / 4) * C::kQChunk + off, 16, 1024),
                         tc::make_desc(k_base + (kk / 4) * C::kKVChunk + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      tc::wgmma_ss<0, 0>(dpt, tc::make_desc(do_base + (kk / 4) * C::kQChunk + off, 16, 1024),
                         tc::make_desc(v_base + (kk / 4) * C::kKVChunk + off, 16, 1024), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    const bool mixed_ids = has_seg && !(wg_ids.x == wg_ids.y && tile_ids.x == tile_ids.y &&
                                        wg_ids.x == tile_ids.x);
    const bool need_mask = mixed_ids || rw0 + 64 > rows || t0 + kN > kv_len ||
                           (causal && t0 + kN - 1 > pmin) || (win > 0 && t0 <= pmax - win);
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool a = e < 2;
        const int x = 8 * jj + 2 * t + (e & 1);  // key column in the tile
        const int col = t0 + x;
        float sc = st[4 * jj + e] * scale;
        float c_fac = 1.f;  // the softcap's derivative at the capped score
        if constexpr (kWindowCap) {
          if (cap > 0.f) {
            sc = fa::softcap(sc, cap);
            const float th = sc / cap;
            c_fac = 1.f - th * th;
          }
        }
        const bool live = !need_mask || (col <= (a ? last_a : last_b) &&
                                         col >= (a ? first_a : first_b) &&
                                         (!has_seg || seg_s[x] == (a ? seg_a : seg_b)));
        const float p = live ? tc::ex2((sc - (a ? lse_a : lse_b)) * tc::kLog2e) : 0.f;
        float dp = dpt[4 * jj + e];
        if (dropout) dp = fa::dropout_kept(a ? key_a : key_b, col, ex.threshold) ? dp * ex.inv : 0.f;
        st[4 * jj + e] = p * (dp - (a ? di_a : di_b)) * scale * c_fac;
      }
    }
    // dS as two bf16 terms (tc_common.cuh, pack_a2).
    uint32_t dsa[kN / 16][4], dsl[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) tc::pack_a2(dsa[kk], dsl[kk], st, kk);
    // dQ += dS K, 64 columns of d at a time, each part added in float32.
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      float part[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        const uint64_t db = tc::make_desc(
            k_base + c * C::kKVChunk + kk * 16 * tc::kChunkRowBytes, C::kKVChunk, 1024);
        tc::wgmma_rs<1>(part, dsa[kk], db, kk > 0);
        tc::wgmma_rs<1>(part, dsl[kk], db, 1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(part);
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[32 * c + x] += part[x];
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(dsa[kk][w]), "+r"(dsl[kk][w])::"memory");
    tc::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dq_head = dq + head * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (in_a)
      *reinterpret_cast<uint32_t*>(dq_head + static_cast<size_t>(ra) * D + c) =
          tc::pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
    if (in_b)
      *reinterpret_cast<uint32_t*>(dq_head + static_cast<size_t>(rb) * D + c) =
          tc::pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  fa_bwd::Segs sg;
  void* dq;
  int bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal;
  float scale;
  int window;
  float softcap;
  fa::Extras ex;
  cudaStream_t stream;
};

template <int D, bool kWindowCap, bool kExtra>
int launch(const Args& a) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv, mdo;
  // K/V rows past kv_len read as zeros (dP there would meet V's garbage).
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  const long long q_stride = static_cast<long long>(a.rows) * D;
  const long long kv_stride = static_cast<long long>(a.s_kv) * D;
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, q_stride, kBlockM);
  if (st == 0) st = tc_encode_map(&mdo, a.dout, D, a.rows, a.bh, q_stride, kBlockM);
  if (st == 0) st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, kv_stride, kN);
  if (st == 0) st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, kv_stride, kN);
  if (st != 0) return st;
  auto kernel = flash_bwd_dq_tc_kernel<D, kWindowCap, kExtra>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + kBlockM - 1) / kBlockM, a.bh);
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.di, a.sg, static_cast<__nv_bfloat16*>(a.dq), a.rows, a.s_kv,
      a.kv_len, a.q_offset, a.q_seq_len, a.causal, a.scale, a.window, a.softcap, a.ex);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kWindowCap>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return launch<D, kWindowCap, true>(a);
#else
  if (a.ex.threshold != 0) return -1;
  return launch<D, kWindowCap, false>(a);
#endif
}

template <int D>
int launch_w(const Args& a) {
  return a.window > 0 || a.softcap > 0.f ? launch_x<D, true>(a) : launch_x<D, false>(a);
}

}  // namespace

// q, do, dq: (bh, rows, d); k, v: (bh, s_kv, d); all bf16, contiguous,
// 16-byte aligned (TMA); lse, di: (bh, rows) float32.  q_seg (bh, rows) and
// kv_seg (bh, s_kv) int32 with their tile tables q_rng (bh, ceil(rows / 64),
// 2) and kv_rng (bh, ceil(s_kv / 64), 2), each 64 rows' [min, max] id, all
// four or none null.  window <= 0: no sliding window (else it requires
// causal); softcap <= 0: none; dropout as in fa_flash_fwd (FA_EXTRA only).
extern "C" int fa_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* di, const void* q_seg,
                                  const void* kv_seg, const void* q_rng, const void* kv_rng,
                                  void* dq, int bh, int rows, int s_kv, int d, int kv_len,
                                  int q_offset, int q_seq_len, int causal, float scale,
                                  int window, float softcap, int row_stride, int dropout_seed,
                                  int dropout_threshold, float dropout_inv, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const fa_bwd::Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                        static_cast<const int*>(q_rng), static_cast<const int*>(kv_rng)};
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di), sg,
               dq, bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale, window, softcap,
               ex, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 64: return launch_w<64>(a);
    case 128: return launch_w<128>(a);
    case 256: return launch_w<256>(a);
    default: return -1;
  }
}
