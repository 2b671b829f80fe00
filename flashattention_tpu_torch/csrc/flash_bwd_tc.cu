// Flash-attention backward, fused one-pass kernel, on Hopper's tensor cores
// (sm_90a): dQ, dK and dV from one recomputation of each (query, key) pair.
//
// Replaces flashattention_tpu/ops/backward.py::_fused_bwd_kernel (the
// pallas_call at backward.py:798) for bf16 q/k/v/dO at head_dim 64, 128 and
// 256: causal masking at position q_offset + (i mod q_seq_len) (the GQA row
// fold: dK/dV of a KV head sum over the rows of all G query groups), kv_len, the
// score scale, a sliding window and a logit softcap with its derivative on
// dS (the compile-time form kWindowCap), and attention dropout in the
// compile-time form kExtra (built with FA_EXTRA).  See bwd_common.cuh for
// the formulas.  Segment ids and block masks go to the two-pass pair (in
// bf16 its tensor-core form, kPair below), as in the JAX package.
//
// Bound on this card: operations, 10 d flops a live pair (five products:
// S = q.k, dP = do.v, dV += P do, dK += dS q, dQ += dS k) against q, do, k, v
// read once.  All five run as wgmma (bf16 x bf16 -> float32); the three that
// take Z or dS run once per bf16 term (see Rounding): 16 d tensor flops a
// pair.
//
// Design: one block per (bh, 128 key rows), 384 threads, parallel over key
// tiles as the scalar kernel (one block per head would give 64 blocks for
// 132 SMs at the training shape); dQ is summed with float32 atomics into the
// zeroed dq_acc.  Warpgroup 0 is the producer: one warp loads the block's K
// and V once by TMA, then, for each live query tile of 64 rows, the Q and dO
// tiles into a 2-stage ring (full/empty mbarriers), with the tile's lse, di,
// each row's first and last visible column and its dropout row key in
// shared memory beside them.  Warpgroups 1 and 2 each own 64 key rows and
// keep their dK and dV accumulators (64 x d float32) in registers for the
// whole loop.  Per query tile, with the key rows as M:
//   S^T = K Q^T and dP^T = V dO^T (both operands from shared memory), so that
//   P^T lands in accumulator layout;
//   P^T = exp(S^T - lse) (capped score, masks), Z^T = keep P^T / (1 - rate)
//   and dS^T = P^T (dP^T - di) scale c on the accumulator, each split into
//   two bf16 terms (hi and lo, see Rounding);
//   dV += Z^T dO and dK += dS^T Q with A from registers and B (dO, Q) read
//   in their MN-major form, 64 columns at a time, each tile's part summed
//   afresh and added to the accumulators in float32;
//   dS^T's two terms to shared memory (swizzled by hand, double-buffered) and,
//   after a barrier of the two consumer warpgroups, dQ = dS K over the
//   block's 128 key rows with A read as the transposed (MN-major) dS: at
//   d = 128 each warpgroup takes 64 of the columns, at d = 64 the first all;
//   the 64 x 64 dQ part goes to dq_acc by vector float32 atomics.
// At d = 256 the dK and dV accumulators of 64 key rows are 256 float32
// registers a thread, and K, V and a 2-stage ring of Q and dO tiles take
// 192 KB: see flash_bwd_tc_wide_kernel below for the design there.
// Query tiles outside the band are skipped as in flash_bwd.cu (above the
// diagonal of the block's first key row within each GQA segment, and past
// the last tile whose window still reaches its key rows); only tiles that
// cross a bound are masked element by element.  K/V rows past kv_len and
// query rows past the end arrive from TMA as zeros and are masked.
//
// Rounding: Z and dS enter their products as two bf16 terms, hi = bf16(x)
// and lo = bf16(x - hi), each with its own wgmma, so that the products see
// them to about 2^-17 where the Pallas kernels' bf16 mode rounds them once
// (see flash_fwd_tc.cuh); ops/backward.py's plain version mirrors this
// form.  The atomics make dQ's summation order vary from run to run.
//
// kPair (built with FA_PAIR into flash_bwd_dkv_tc[_extra]): the two-pass
// pair's dK/dV pass, which replaces flashattention_tpu/ops/backward.py::
// _dkv_kernel (the pallas_call at backward.py:912) for the same calls plus
// segment ids; its dQ pass is flash_bwd_dq_tc.cu.  The form drops what only dQ
// needs: the dS^T buffers, the barrier between the consumer warpgroups, the
// dQ product and its atomics (at d = 256 the dS^T hand-off and dq_half; the
// dS side frees X once it has read Y^T).  It adds segment ids: each consumer
// thread reads its two key rows' ids once, with K/V, and each query row's id
// is the sixth word of the stage table; the pair's ids must be equal for it to
// be live.  With segment ids the wrapper also gives each head's [min, max] id
// of every 64 rows (fa_bwd::Segs): the producer and the consumers skip a query
// tile whose range is disjoint from the block's key rows', as they skip one
// outside the band (disjoint ranges share no id, so the skip is exact), and a
// d <= 128 consumer warpgroup one disjoint from its own 64 key rows' (it
// waits for the tile and frees it).  The GQA fold, kv_len, the causal and
// window skips, the softcap and dropout are the fused form's.  And it takes
// block masks (kExtra; backward.py:123-137, :224): the transposed table over
// its (64, kKeys) tiles by key tile (ops/flash.py::BlockMask, tc_by_kv),
// kKeys = 128 at d <= 128 and 64 at d = 256.  Producer and consumers walk the
// block's key tile's live query tiles from bm_idx in place of every query
// tile, beside the band and segment-range skips, so a dead tile is never
// loaded; a partial tile's element bits, stored by key row (the transposed
// bits, so that a thread reads its two key rows' words once a tile), join
// the masks, and P, so Z and dS, is exactly 0 where they are clear.
// In both forms (fused and kPair) the mask loop takes one of three forms a
// tile (fa::with_mask_form): no test, the bits alone, or every test.
//
// kTerms (built with FA_F32 into flash_bwd_tc_f32[_extra]): the fused form
// over float32 q, k, v and dO at head_dim 64, 128 and 256, as _fused_bwd_kernel
// computes them in the JAX package's precision modes (backward.py:573, its
// _dot_g, flash.py:149-181).  A split pass (tc_common.cuh, tc::split) writes
// each row as bf16 terms: kTerms 2 ("bf16_3x") [hi | lo], hi = bf16(x), lo =
// bf16(x - hi), the same bytes as float32 read as a bf16 row of width 2 d;
// kTerms 1 ("bf16") [hi] alone, and the kernel is the bf16 form.  With two
// terms each of the five products is hi hi + hi lo + lo hi, three wgmma
// chains into one float32 accumulator: S^T and dP^T over the terms of K and
// Q (V and dO) picked by chunk descriptor; dV, dK and dQ over Z's or dS's two
// register or shared-memory terms against dO's, Q's or K's hi and their hi
// against its lo.  So a live pair costs 30 d tensor flops (15 products of
// 2 d) where the bf16 form's costs 16 d.  dK and dV are written in float32.
// Room: with rows of 2 d the d <= 128 layout at d = 64 is the bf16 one at
// 128 (192 KB); at d = 128 it would take 320 KB, so the d = 128 two-term
// form is the d = 256 kernel's (64 key rows a block, dV and dK split
// between the consumer warpgroups): its rows of 256 bf16 are d = 256's.  At
// d = 256 one term is the bf16 d = 256 layout, and two terms (rows of 512
// bf16) take the wide kernel's 32-row query tiles, with dQ turned over
// (dq_half_t, see there).
//
// kPair with kTerms (built with FA_PAIR and FA_F32 into
// flash_bwd_dkv_tc_f32[_extra]): the pair's dK/dV pass over float32, as
// _dkv_kernel computes it in those modes, at d = 64, 128 and 256.  At d =
// 128 and 256 each of its four products is the three above (d = 256 on the
// wide kernel over 32-row query tiles: see there); at d = 64 the JAX pair
// is lane-packed (backward.py:713-729: 2 d <= 128 lanes, q, k, v and dO
// streamed as [hi | lo] rows), and its products (_packed_nt for S and dP, _packed_fold for dV
// and dK, backward.py:57-93) keep lo lo too: four a matmul (kProducts), so a
// live pair costs 32 d tensor flops (24 d at d = 128).  Segment ids and
// their tile skip are the bf16 pair's; no block mask.  The split pass runs
// in the pair's dQ pass (flash_bwd_dq_tc.cu), which this one follows on the
// same buffers, or here when it runs alone (`split`).
#include "bwd_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kBlockN = 128;  // key rows per block: two consumer warpgroups of 64
constexpr int kBlockM = 64;   // query rows per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

// Words of a stage's table per query row: lse, di, first and last visible
// column, dropout row key, segment id (kPair).
constexpr int kTabRows = 6;

// The products of each matmul over its operands' bf16 terms: (A term, B
// term) pairs (0, 0), (0, 1), (1, 0), (1, 1), the first kProducts; one
// term: (0, 0) alone.  Two terms: three, JAX's _dot_g at "bf16_3x", but in
// the pair at d = 64 four, JAX's lane-packed pair (see kPair with kTerms).
template <int D, bool kPair, int kTerms>
constexpr int kProducts = kTerms == 2 ? (kPair && D == 64 ? 4 : 3) : 1;

// The rows the ring carries (a float32 row's bf16 terms), dK and dV as
// written (float32 for float32 inputs), and the products of S^T and dP^T
// (tc_common.cuh).
using tc::OutT;
using tc::store2;
using tc::term_products;

template <int D, bool kPair, int kTerms = 0>
struct Cfg {
  static constexpr int kChunks = tc::kRowWidth<D, kTerms> / tc::kChunk;  // of a stored row
  static constexpr int kLC = D / tc::kChunk;                           // of one term
  static constexpr int kKVChunk = kBlockN * tc::kChunkRowBytes;
  static constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;
  static constexpr int kQTile = kChunks * kQChunk;
  static constexpr int kDsBytes = kBlockN * tc::kChunkRowBytes;  // dS^T: 128 key rows x 64 bf16
  // dQ: split over the two consumer warpgroups by 64 columns where d allows.
  static constexpr int kDqSplit = D >= 128 ? 2 : 1;
  static constexpr int kDqN = D / kDqSplit;
  static_assert(kDqN == 64, "dQ parts are 64 columns");
  // K | V | Q stages | dO stages | dS buffers | tables | barriers
  static constexpr int kV = kChunks * kKVChunk;
  static constexpr int kQ = kV + kChunks * kKVChunk;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kDs = kDo + kStages * kQTile;
  static constexpr int kTab = kDs + (kPair ? 0 : 4 * kDsBytes);  // hi and lo terms, double-buffered
  static constexpr int kTabWords = kTabRows * kBlockM;
  static constexpr int kBar = kTab + kStages * kTabWords * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;
};

// Whether the block of key rows [c0, c0 + kKeys) has any live pair with
// the query tile [r0, r0 + kRows): the scalar kernel's skips.
template <bool kWindowCap, int kKeys, int kRows = kBlockM>
__device__ __forceinline__ bool live_tile(int r0, int c0, int rows, int q_offset, int q_seq_len,
                                          int causal, int window) {
  if (causal && q_offset + fa_bwd::tile_last_pos(r0, kRows, rows, q_seq_len) < c0) return false;
  if (kWindowCap && window > 0 &&
      q_offset + fa_bwd::tile_first_pos(r0, kRows, rows, q_seq_len) - window + 1 >
          c0 + kKeys - 1)
    return false;
  return true;
}

// With segment ids (kPair), whether the query tile [r0, r0 + kRows) and key
// ids `keys` may meet: their id ranges overlap.  No segment ids: true.
template <bool kPair, int kRows = kBlockM>
__device__ __forceinline__ bool ids_meet(const int* q_rng, int n_qt, int r0, int2 keys,
                                         int2* q_ids) {
  if (!kPair || q_rng == nullptr) return true;
  *q_ids = fa_bwd::seg_range(q_rng, n_qt, r0, kRows);
  return fa_bwd::seg_meet(*q_ids, keys);
}

// The query tile of step `it` of a block's walk: the it-th, or under a block
// mask (bm.x: the block's first entry in bm_idx) the it-th live one.
template <int kRows = kBlockM>
__device__ __forceinline__ int walk_tile(const fa::Extras& ex, bool use_bm, int2 bm, int it) {
  return (use_bm ? ex.bm_idx[bm.x + it] : it) * kRows;
}

// A block's walk: how many steps it takes (the query tiles, or under a block
// mask the key tile's live ones that hold rows) and, under one, where its
// entries start in bm_idx; none past kv_len.
template <int kRows = kBlockM>
__device__ __forceinline__ int2 walk(const fa::Extras& ex, bool use_bm, int kt, int c0, int rows,
                                     int kv_len) {
  if (c0 >= kv_len) return make_int2(0, 0);
  if (use_bm) return fa::bm_walk(ex, kt, kRows, rows);
  return make_int2(0, (rows + kRows - 1) / kRows);
}

// The producer warp of both kernels: K and V of the block's kKeys key rows
// once, then for each live query tile of kRows rows its Q and dO tiles into
// the ring of kSt stages, with the tile's lse, di, each row's first and
// last visible column, its dropout row key and (kPair) its segment id in
// the stage's table (kTabRows kRows words).  kPair: a tile whose ids do not
// meet the block's key ids `keys` is skipped (ids_meet).  It takes the wk.y
// steps of the block's walk.
template <bool kWindowCap, bool kExtra, bool kPair, int kKeys, int kChunks, int kRows = kBlockM,
          int kSt = kStages>
__device__ __forceinline__ void produce(unsigned char* smem, int v_off, int q_off, int do_off,
                                        int tab_off, uint64_t* full, uint64_t* empty,
                                        uint64_t* kv_bar, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_do, const float* lse,
                                        const float* di, int bh, int c0, int2 wk, int rows,
                                        int kv_len, int q_offset, int q_seq_len, int causal,
                                        int win, const fa::Extras& ex, const fa_bwd::Segs& sg,
                                        const int* q_rng, int n_qt, int2 keys) {
  constexpr int kKVChunk = kKeys * tc::kChunkRowBytes;
  constexpr int kQChunk = kRows * tc::kChunkRowBytes;
  constexpr int kQTile = kChunks * kQChunk;
  constexpr int kTabWords = kTabRows * kRows;
  const int lane = threadIdx.x;
  const bool dropout = kExtra && ex.threshold != 0;
  if (lane == 0) {
    tc::mbar_arrive_tx(kv_bar, 2 * kChunks * kKVChunk);
    for (int c = 0; c < kChunks; ++c) {
      tc::tma_load(smem + c * kKVChunk, tm_k, kv_bar, c * tc::kChunk, c0, bh);
      tc::tma_load(smem + v_off + c * kKVChunk, tm_v, kv_bar, c * tc::kChunk, c0, bh);
    }
  }
  float* tab_f = reinterpret_cast<float*>(smem + tab_off);
  int* tab_i = reinterpret_cast<int*>(smem + tab_off);
  const size_t head = static_cast<size_t>(bh) * rows;
  const bool use_bm = kExtra && ex.bm_ptr != nullptr;
  for (int it = 0, i = 0; it < wk.y; ++it) {
    const int r0 = walk_tile<kRows>(ex, use_bm, wk, it);
    if (!live_tile<kWindowCap, kKeys, kRows>(r0, c0, rows, q_offset, q_seq_len, causal, win))
      continue;
    int2 q_ids;
    if (!ids_meet<kPair, kRows>(q_rng, n_qt, r0, keys, &q_ids)) continue;
    const int s = i % kSt;
    if (i >= kSt) tc::mbar_wait(&empty[s], (i / kSt - 1) & 1);
    float* tf = tab_f + s * kTabWords;
    int* ti = tab_i + s * kTabWords;
    for (int x = lane; x < kRows; x += 32) {
      const int r = r0 + x;
      const bool in = r < rows;
      tf[x] = in ? lse[head + r] : 0.f;
      tf[kRows + x] = in ? di[head + r] : 0.f;
      ti[2 * kRows + x] = fa_bwd::row_first(r, q_offset, q_seq_len, win);
      ti[3 * kRows + x] = fa_bwd::row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);
      ti[4 * kRows + x] =
          dropout ? static_cast<int>(fa::dropout_row_key(ex, bh, r, q_seq_len)) : 0;
      ti[5 * kRows + x] = kPair && in && sg.q != nullptr ? sg.q[head + r] : 0;
    }
    if (lane == 0) {
      tc::mbar_arrive_tx(&full[s], 2 * kQTile);
      for (int c = 0; c < kChunks; ++c) {
        tc::tma_load(smem + q_off + s * kQTile + c * kQChunk, tm_q, &full[s], c * tc::kChunk, r0,
                     bh);
        tc::tma_load(smem + do_off + s * kQTile + c * kQChunk, tm_do, &full[s], c * tc::kChunk,
                     r0, bh);
      }
    } else {
      tc::mbar_arrive(&full[s]);
    }
    ++i;
  }
}

template <int D, bool kWindowCap, bool kExtra, bool kPair, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq_acc,
                    OutT<kTerms>* __restrict__ dk, OutT<kTerms>* __restrict__ dv, int rows,
                    int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                    int window, float softcap, const fa::Extras ex, const fa_bwd::Segs sg) {
  using C = Cfg<D, kPair, kTerms>;
  constexpr int kP = kProducts<D, kPair, kTerms>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  // Per stage: lse, di, first and last visible column, dropout row key, segment id.
  float* tab_f = reinterpret_cast<float*>(smem + C::kTab);
  int* tab_i = reinterpret_cast<int*>(smem + C::kTab);

  const int bh = blockIdx.y;
  const bool use_bm = kExtra && ex.bm_ptr != nullptr;
  const int kt = blockIdx.x;
  const int c0 = kt * kBlockN;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const int2 wk = walk(ex, use_bm, kt, c0, rows, kv_len);  // the query tiles to walk
  // kPair, segment ids: each head's id ranges, and the block's key rows'.
  const bool has_seg = kPair && sg.q != nullptr;
  const int n_qt = (rows + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int n_kt = (s_kv + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int* q_rng = has_seg ? sg.q_rng + static_cast<size_t>(bh) * n_qt * 2 : nullptr;
  const int* kv_rng = has_seg ? sg.kv_rng + static_cast<size_t>(bh) * n_kt * 2 : nullptr;
  const int2 keys = has_seg ? fa_bwd::seg_range(kv_rng, n_kt, c0, kBlockN) : make_int2(0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 256);
    }
    tc::mbar_init(kv_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    produce<kWindowCap, kExtra, kPair, kBlockN, C::kChunks>(
        smem, C::kV, C::kQ, C::kDo, C::kTab, full, empty, kv_bar, &tm_q, &tm_k, &tm_v, &tm_do,
        lse, di, bh, c0, wk, rows, kv_len, q_offset, q_seq_len, causal, win, ex, sg, q_rng, n_qt,
        keys);
    return;
  }

  // Consumers: warpgroup cw owns key rows kw0 .. kw0 + 63.
  tc::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int kw0 = c0 + 64 * cw;
  const int kl_a = 64 * cw + 16 * warp + g;  // this thread's key rows in the block
  const int key_a = c0 + kl_a, key_b = key_a + 8;
  // kPair: this thread's key rows' segment ids, and this warpgroup's range.
  const size_t kv_head = static_cast<size_t>(bh) * s_kv;
  const int seg_ka = has_seg && key_a < s_kv ? sg.kv[kv_head + key_a] : 0;
  const int seg_kb = has_seg && key_b < s_kv ? sg.kv[kv_head + key_b] : 0;
  const int2 wg_keys = has_seg ? fa_bwd::seg_range(kv_rng, n_kt, kw0, 64) : make_int2(0, 0);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  const uint32_t k_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  const uint32_t v_base = tc::smem_u32(smem + C::kV) + cw * 64 * tc::kChunkRowBytes;
  tc::mbar_wait(kv_bar, 0);

  for (int it = 0, i = 0; it < wk.y; ++it) {
    const int r0 = walk_tile(ex, use_bm, wk, it);
    const int slot = use_bm ? ex.bm_part[wk.x + it] : -1;  // a partial tile's element bits
    if (!live_tile<kWindowCap, kBlockN>(r0, c0, rows, q_offset, q_seq_len, causal, win)) continue;
    int2 q_ids = make_int2(0, 0);
    if (!ids_meet<kPair>(q_rng, n_qt, r0, keys, &q_ids)) continue;
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    if (has_seg && !fa_bwd::seg_meet(q_ids, wg_keys)) {  // none of this warpgroup's key rows
      tc::mbar_arrive(&empty[s]);
      ++i;
      continue;
    }
    const uint32_t q_tile = tc::smem_u32(smem + C::kQ + s * C::kQTile);
    const uint32_t do_tile = tc::smem_u32(smem + C::kDo + s * C::kQTile);
    const float* tf = tab_f + s * C::kTabWords;
    const int* ti = tab_i + s * C::kTabWords;

    float st[kBlockM / 2], dpt[kBlockM / 2];
    tc::wgmma_fence();
    term_products<D, kP>(st, k_base, C::kKVChunk, q_tile, C::kQChunk);  // S^T = K Q^T
    term_products<D, kP>(dpt, v_base, C::kKVChunk, do_tile, C::kQChunk);  // dP^T = V dO^T
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);
    tc::fence_regs(dpt);
    // A partial tile's element bits of key rows kl_a and kl_a + 8 (over the
    // tile's query rows).
    unsigned bits_a[kBlockM / 32], bits_b[kBlockM / 32];
    fa::tile_bits<kBlockN, kBlockM>(ex.bm_bits, slot, kl_a, t, bits_a, bits_b);

    // Whether any pair of this warpgroup's key rows and the tile is masked
    // by the bounds or segment ids, or by a partial tile's bits alone
    // (fa::with_mask_form).
    const int pmin = q_offset + fa_bwd::tile_first_pos(r0, kBlockM, rows, q_seq_len);
    const int pmax = q_offset + fa_bwd::tile_last_pos(r0, kBlockM, rows, q_seq_len);
    const bool mixed_ids = has_seg && !(q_ids.x == q_ids.y && wg_keys.x == wg_keys.y &&
                                        q_ids.x == wg_keys.x);
    const bool need_mask = mixed_ids || r0 + kBlockM > rows || kw0 + 63 >= kv_len ||
                           (causal && kw0 + 63 > pmin) || (win > 0 && kw0 <= pmax - win);
    fa::with_mask_form(need_mask, slot >= 0, [&](auto form) {
      constexpr int kForm = decltype(form)::value;
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * j + 2 * t + (e & 1);  // query row in the tile
          const int key = e < 2 ? key_a : key_b;
          float sc = st[4 * j + e] * scale;
          float c_fac = 1.f;  // the softcap's derivative at the capped score
          if constexpr (kWindowCap) {
            if (cap > 0.f) {
              sc = fa::softcap(sc, cap);
              const float th = sc / cap;
              c_fac = 1.f - th * th;
            }
          }
          bool live = true;
          if constexpr (kForm != fa::kMaskNone)
            live = e < 2 ? fa::tile_bit(bits_a, j, e & 1) : fa::tile_bit(bits_b, j, e & 1);
          if constexpr (kForm == fa::kMaskAll)
            live = live && key <= ti[3 * kBlockM + x] && key >= ti[2 * kBlockM + x] &&
                   (!has_seg || ti[5 * kBlockM + x] == (e < 2 ? seg_ka : seg_kb));
          const float p = live ? tc::ex2((sc - tf[x]) * tc::kLog2e) : 0.f;
          float dp = dpt[4 * j + e];
          float z = 1.f;  // dropout: the pair's 1 / (1 - rate) or 0
          if (dropout) {
            z = fa::dropout_kept(static_cast<unsigned>(ti[4 * kBlockM + x]), key, ex.threshold)
                    ? ex.inv
                    : 0.f;
            dp *= z;
          }
          st[4 * j + e] = dropout ? p * z : p;  // dV sums Z = z P
          dpt[4 * j + e] = p * (dp - tf[kBlockM + x]) * scale * c_fac;
        }
      }
    });
    // Z and dS as two bf16 terms each (tc_common.cuh, pack_a2).
    uint32_t za[kBlockM / 16][4], zl[kBlockM / 16][4], dsa[kBlockM / 16][4], dsl[kBlockM / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      tc::pack_a2(za[kk], zl[kk], st, kk);
      tc::pack_a2(dsa[kk], dsl[kk], dpt, kk);
    }
    // dV += Z^T dO and dK += dS^T Q, 64 columns of d at a time: each part is
    // summed afresh on the tensor cores (16 products a k-step over the
    // tile's 64 rows) and then added to the float32 accumulators here.
    // Adding every tile into one wgmma accumulator instead chains all the
    // query rows' products (32768 at Mistral's layer) through the tensor
    // cores' float32 addition, whose truncation drifts the small gradients
    // by about 1e-5.
    // With two terms (kTerms 2) B's lo chunk is kLC chunks on, and the
    // third product is the hi term of Z or dS against it (the fourth, kP
    // 4, its lo term).
#pragma unroll
    for (int pass = 0; pass < 2 * C::kLC; ++pass) {
      const int c = pass % C::kLC;
      const bool dv_pass = pass < C::kLC;
      const uint32_t b_tile = (dv_pass ? do_tile : q_tile) + c * C::kQChunk;
      float part[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        const uint64_t db = tc::make_desc(b_tile + kk * 2048, C::kQChunk, 1024);
        if (dv_pass) {
          tc::wgmma_rs<1>(part, za[kk], db, kk > 0);
          tc::wgmma_rs<1>(part, zl[kk], db, 1);
        } else {
          tc::wgmma_rs<1>(part, dsa[kk], db, kk > 0);
          tc::wgmma_rs<1>(part, dsl[kk], db, 1);
        }
        if constexpr (kTerms == 2) {  // Z's or dS's hi against dO's or Q's lo
          const uint64_t db_lo =
              tc::make_desc(b_tile + C::kLC * C::kQChunk + kk * 2048, C::kQChunk, 1024);
          if (dv_pass) tc::wgmma_rs<1>(part, za[kk], db_lo, 1);
          else tc::wgmma_rs<1>(part, dsa[kk], db_lo, 1);
          if constexpr (kP == 4) {
            if (dv_pass) tc::wgmma_rs<1>(part, zl[kk], db_lo, 1);
            else tc::wgmma_rs<1>(part, dsl[kk], db_lo, 1);
          }
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(part);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        if (dv_pass) dv_acc[32 * c + x] += part[x];
        else dk_acc[32 * c + x] += part[x];
      }
    }

    if constexpr (!kPair) {  // the fused form: dQ = dS K, added by atomics
      // dS^T (128 key rows x 64 query rows, its hi and lo bf16 terms) into this
      // tile's buffers, 16-byte unit u of key row r at u ^ (r % 8), as TMA
      // would swizzle it.
      unsigned char* ds_hi = smem + C::kDs + (i % 2) * 2 * C::kDsBytes;
      unsigned char* ds_lo = ds_hi + C::kDsBytes;
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // query columns 16kk + 8h + 2t, +1
          const int u = 2 * kk + h;
          const int ra = kl_a, rb = kl_a + 8;
          const int oa = ra * 128 + ((u ^ (ra & 7)) * 16) + 4 * t;
          const int ob = rb * 128 + ((u ^ (rb & 7)) * 16) + 4 * t;
          *reinterpret_cast<uint32_t*>(ds_hi + oa) = dsa[kk][2 * h];
          *reinterpret_cast<uint32_t*>(ds_hi + ob) = dsa[kk][2 * h + 1];
          *reinterpret_cast<uint32_t*>(ds_lo + oa) = dsl[kk][2 * h];
          *reinterpret_cast<uint32_t*>(ds_lo + ob) = dsl[kk][2 * h + 1];
        }
      }
      tc::fence_async_smem();
      tc::named_sync(1, 256);  // both warpgroups' dS^T rows are in

      if (cw < C::kDqSplit) {
        float dq[C::kDqN / 2];
        const uint32_t hi_base = tc::smem_u32(ds_hi), lo_base = tc::smem_u32(ds_lo);
        const uint32_t kc_base = tc::smem_u32(smem) + cw * C::kKVChunk;  // K columns 64cw..
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          const uint64_t db = tc::make_desc(kc_base + kk * 2048, C::kKVChunk, 1024);
          const uint64_t dh = tc::make_desc(hi_base + kk * 2048, C::kDsBytes, 1024);
          tc::wgmma_ss<1, 1>(dq, dh, db, kk > 0);
          tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, C::kDsBytes, 1024), db, 1);
          if constexpr (kTerms == 2)  // dS's hi term against K's lo
            tc::wgmma_ss<1, 1>(dq, dh, tc::make_desc(kc_base + C::kLC * C::kKVChunk + kk * 2048,
                                                     C::kKVChunk, 1024), 1);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(dq);
        float* dst = dq_acc + (static_cast<size_t>(bh) * rows + r0) * D + cw * C::kDqN;
#pragma unroll
        for (int j = 0; j < C::kDqN / 8; ++j) {
          const int ra = 16 * warp + g, c = 8 * j + 2 * t;
          if (r0 + ra < rows)
            tc::atomic_add2(dst + static_cast<size_t>(ra) * D + c, dq[4 * j], dq[4 * j + 1]);
          if (r0 + ra + 8 < rows)
            tc::atomic_add2(dst + static_cast<size_t>(ra + 8) * D + c, dq[4 * j + 2], dq[4 * j + 3]);
        }
      } else {
        tc::wgmma_wait<0>();
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        asm volatile("" : "+r"(za[kk][w]), "+r"(zl[kk][w]), "+r"(dsa[kk][w]), "+r"(dsl[kk][w])::"memory");
    tc::mbar_arrive(&empty[s]);
    ++i;
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (key_a < s_kv) {
      const size_t off = (static_cast<size_t>(bh) * s_kv + key_a) * D + c;
      store2(dk + off, dk_acc[4 * j], dk_acc[4 * j + 1]);
      store2(dv + off, dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (key_b < s_kv) {
      const size_t off = (static_cast<size_t>(bh) * s_kv + key_b) * D + c;
      store2(dk + off, dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      store2(dv + off, dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// head_dim 256, and 128 over two float32 terms (kTerms 2: rows of 256 bf16,
// as d = 256's; the products as in the d <= 128 kernel, three each, in the
// fused form and the pair alike).  The d <= 128 kernel's split (each consumer warpgroup its own
// 64 key rows, dK and dV of them in registers) needs 256 accumulator
// registers a thread here, and its K/V of 128 key rows plus a 2-stage ring
// of 64-row Q and dO tiles (128 KB) leave no room for dS.  So a block owns 64
// key rows and both consumer warpgroups work on all of them, dV in one and dK
// in the other (128 accumulator registers each):
//   warpgroup 1 (P side): S^T = K Q^T, P^T = exp(S^T - lse) with the masks
//   and the softcap, Z^T = keep P^T / (1 - rate), and Y^T = P^T c (the
//   softcap's derivative) handed to warpgroup 2 through shared memory;
//   dV += Z^T dO;
//   warpgroup 2 (dS side): dP^T = V dO^T, then, with Y^T, dS^T = Y^T (keep
//   dP^T / (1 - rate) - di) scale; dK += dS^T Q; dS^T's two bf16 terms to
//   shared memory;
//   both: dQ = dS K over the block's 64 key rows, columns 0-127 in
//   warpgroup 1 and 128-255 in warpgroup 2, by float32 atomics.
// Y^T and dS^T take turns in one 16 KB region X (Y^T as each thread's 32
// floats, word j of thread t at j 128 + t; dS^T swizzled as TMA would), so
// that K and V (64 KB), the ring (128 KB) and X fit in 227 KB.  Named
// barriers hand X over: 1, Y^T written (warpgroup 1 arrives, 2 syncs); 4,
// warpgroup 2 has read all of Y^T (among its own threads) before it writes
// dS^T over it; 2, dS^T written (2 arrives, 1 syncs); 3, warpgroup 2's dQ
// products have read dS^T (2 arrives, 1 syncs before writing the next Y^T;
// one arrival ahead, consumed after the loop).  Each barrier has at most one
// arrival pending, since each side's next arrival waits on the other's.
// kPair: no dS^T and no dQ, so barriers 2 and 4 go; the dS side arrives on 3
// as soon as it has read Y^T.
// Rows of 512 bf16 (d = 256 over two float32 terms, kTerms 2, the fused
// form and the pair): K and V of the block's 64 key rows take 128 KB, and a
// stage of 64-row Q and dO tiles another 128 KB.  So there the query tiles
// are 32 rows (kRows: S^T, dP^T and Y^T 64 x 32, dV and dK over two k-steps
// a chunk) and the ring one stage (64 KB): 210 KB with X, and no room for a
// second stage.  The producer loads the next tile once both warpgroups are
// done with this one.  wgmma's M is 64, so the fused form's dQ = dS K cannot
// take the tile's 32 rows as M: it computes dQ^T = K^T dS^T instead
// (dq_half_t), with dS written to X by query row (8 KB for both terms, where
// Y^T takes 8 KB of float32; the hand-offs are the 64-row tiles').
namespace wide {

constexpr int kKeys = 64;  // key rows per block, shared by both warpgroups
constexpr int kKVChunk = kKeys * tc::kChunkRowBytes;
constexpr int kDsBytes = kKeys * tc::kChunkRowBytes;  // one bf16 term of dS^T
static_assert(2 * kDsBytes == 4 * kKeys * kBlockM, "X holds Y^T in float32 and dS^T's two terms");

template <int D, int kTerms>
struct Cfg {
  static constexpr int kChunks = tc::kRowWidth<D, kTerms> / tc::kChunk;  // of a stored row
  static constexpr int kLC = D / tc::kChunk;                           // of one term
  static constexpr int kRows = kChunks > 4 ? 32 : kBlockM;  // query rows per tile
  static constexpr int kSt = kChunks > 4 ? 1 : kStages;     // stages of the ring
  // Under 64 rows wgmma cannot take the tile's rows as M: dQ's product is
  // turned over (dq_half_t), and X holds dS by query row, kDsTerm bytes a
  // term (else dS^T by key row).
  static constexpr bool kDqT = kRows < 64;
  static constexpr int kDsTerm = kDqT ? kRows * tc::kChunkRowBytes : kDsBytes;
  static constexpr int kQChunk = kRows * tc::kChunkRowBytes;
  static constexpr int kQTile = kChunks * kQChunk;
  // K | V | Q stages | dO stages | X | tables | barriers
  static constexpr int kV = kChunks * kKVChunk;
  static constexpr int kQ = kV + kChunks * kKVChunk;
  static constexpr int kDo = kQ + kSt * kQTile;
  static constexpr int kX = kDo + kSt * kQTile;
  static constexpr int kTab = kX + 2 * kDsBytes;
  static constexpr int kTabWords = kTabRows * kRows;
  static constexpr int kBar = kTab + kSt * kTabWords * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kSt + 1) + tc::kAtomBytes;
  static_assert(kChunks == 4 || kChunks == 8, "rows of 256 or 512 bf16");
  static_assert(kBytes <= 232448, "over Hopper's shared memory a block");
};

// dX += A^T B over the tile's kRows query rows, 64 columns of B (its
// MN-major tile `b_tile`) at a time, A^T from registers as two bf16 terms
// (with two terms of B also A's hi against B's lo, kLC chunks on); each part
// summed afresh and added to acc in float32 (see the d <= 128 kernel).
template <int D, int kTerms, int kRows = Cfg<D, kTerms>::kRows>
__device__ __forceinline__ void add_products(float (&acc)[D / 2],
                                             const uint32_t (&ah)[kRows / 16][4],
                                             const uint32_t (&al)[kRows / 16][4], uint32_t b_tile) {
  constexpr int kLC = Cfg<D, kTerms>::kLC, kQChunk = Cfg<D, kTerms>::kQChunk;
#pragma unroll
  for (int c = 0; c < kLC; ++c) {
    float part[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = tc::make_desc(b_tile + c * kQChunk + kk * 2048, kQChunk, 1024);
      tc::wgmma_rs<1>(part, ah[kk], db, kk > 0);
      tc::wgmma_rs<1>(part, al[kk], db, 1);
      if constexpr (kTerms == 2)
        tc::wgmma_rs<1>(part, ah[kk],
                        tc::make_desc(b_tile + (kLC + c) * kQChunk + kk * 2048, kQChunk, 1024), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * c + x] += part[x];
  }
}

// dQ's half at 32-row query tiles (kDqT), turned over: dQ^T = K^T dS^T, a
// 64-column chunk of d at a time, with M the chunk's columns (K's chunk read
// as the transposed A), N the tile's query rows (dS, stored by query row in
// X, read K-major as B) and K the block's 64 key rows; with two terms of K
// also K's lo against dS's hi.  Value 4j + i of the accumulator is column
// 16 warp + g + 8 (i / 2) of the chunk and query row 8j + 2t + i % 2, added
// to dq_acc there by scalar atomics.
template <int D, int kTerms>
__device__ __forceinline__ void dq_half_t(unsigned char* smem, float* dq_acc, int bh, int rows,
                                          int r0, int c0, int warp, int g, int t) {
  using C = Cfg<D, kTerms>;
  const uint32_t hi_base = tc::smem_u32(smem + C::kX), lo_base = hi_base + C::kDsTerm;
#pragma unroll
  for (int c = c0; c < c0 + C::kLC / 2; ++c) {
    float dqt[C::kRows / 2];
    const uint32_t kc_base = tc::smem_u32(smem) + c * kKVChunk;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t da = tc::make_desc(kc_base + kk * 2048, kKVChunk, 1024);
      const uint64_t dh = tc::make_desc(hi_base + kk * 32, 16, 1024);
      tc::wgmma_ss<1, 0>(dqt, da, dh, kk > 0);
      tc::wgmma_ss<1, 0>(dqt, da, tc::make_desc(lo_base + kk * 32, 16, 1024), 1);
      if constexpr (kTerms == 2)  // K's lo against dS's hi
        tc::wgmma_ss<1, 0>(dqt, tc::make_desc(kc_base + C::kLC * kKVChunk + kk * 2048, kKVChunk,
                                              1024), dh, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dqt);
    float* dst =
        dq_acc + (static_cast<size_t>(bh) * rows + r0) * D + c * tc::kChunk + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < C::kRows / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * j + 2 * t + (i & 1);
        if (r0 + r < rows)
          atomicAdd(dst + static_cast<size_t>(r) * D + 8 * (i >> 1), dqt[4 * j + i]);
      }
    }
  }
}

// dQ's half of the tile's columns from chunk c0 on (kLC / 2 chunks of 64):
// dS (its two terms in X, read as the transposed A) times K (with two terms
// of K also dS's hi against K's lo), added to dq_acc by atomics (32-row
// tiles: dq_half_t).
template <int D, int kTerms>
__device__ __forceinline__ void dq_half(unsigned char* smem, float* dq_acc, int bh, int rows,
                                        int r0, int c0, int warp, int g, int t) {
  using C = Cfg<D, kTerms>;
  static_assert(C::kRows == 64, "dQ's products take 64-row query tiles");
  const uint32_t hi_base = tc::smem_u32(smem + C::kX), lo_base = hi_base + kDsBytes;
#pragma unroll
  for (int c = c0; c < c0 + C::kLC / 2; ++c) {
    float dq[32];
    const uint32_t kc_base = tc::smem_u32(smem) + c * kKVChunk;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = tc::make_desc(kc_base + kk * 2048, kKVChunk, 1024);
      const uint64_t dh = tc::make_desc(hi_base + kk * 2048, kDsBytes, 1024);
      tc::wgmma_ss<1, 1>(dq, dh, db, kk > 0);
      tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, kDsBytes, 1024), db, 1);
      if constexpr (kTerms == 2)
        tc::wgmma_ss<1, 1>(dq, dh, tc::make_desc(kc_base + C::kLC * kKVChunk + kk * 2048,
                                                 kKVChunk, 1024), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dq);
    float* dst = dq_acc + (static_cast<size_t>(bh) * rows + r0) * D + c * tc::kChunk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ra = 16 * warp + g, col = 8 * j + 2 * t;
      if (r0 + ra < rows)
        tc::atomic_add2(dst + static_cast<size_t>(ra) * D + col, dq[4 * j], dq[4 * j + 1]);
      if (r0 + ra + 8 < rows)
        tc::atomic_add2(dst + static_cast<size_t>(ra + 8) * D + col, dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

template <int D, bool kWindowCap, bool kExtra, bool kPair, int kTerms>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq_acc,
                         OutT<kTerms>* __restrict__ dk, OutT<kTerms>* __restrict__ dv, int rows,
                         int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
                         float scale, int window, float softcap, const fa::Extras ex,
                         const fa_bwd::Segs sg) {
  using C = Cfg<D, kTerms>;
  static_assert(kProducts<D, kPair, kTerms> == (kTerms == 2 ? 3 : 1), "add_products' count");
  constexpr int kQ = C::kQ, kDo = C::kDo, kX = C::kX, kTab = C::kTab, kTabWords = C::kTabWords;
  constexpr int kQTile = C::kQTile, kQChunk = C::kQChunk, kRows = C::kRows, kSt = C::kSt;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kSt;
  uint64_t* kv_bar = empty + kSt;
  const float* tab_f = reinterpret_cast<const float*>(smem + kTab);
  const int* tab_i = reinterpret_cast<const int*>(smem + kTab);

  const int bh = blockIdx.y;
  const bool use_bm = kExtra && ex.bm_ptr != nullptr;
  const int kt = blockIdx.x;
  const int c0 = kt * kKeys;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const int2 wk = walk<kRows>(ex, use_bm, kt, c0, rows, kv_len);  // the query tiles, as above
  // kPair, segment ids: each head's id ranges, and the block's key rows'.
  const bool has_seg = kPair && sg.q != nullptr;
  const int n_qt = (rows + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int n_kt = (s_kv + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int* q_rng = has_seg ? sg.q_rng + static_cast<size_t>(bh) * n_qt * 2 : nullptr;
  const int* kv_rng = has_seg ? sg.kv_rng + static_cast<size_t>(bh) * n_kt * 2 : nullptr;
  const int2 keys = has_seg ? fa_bwd::seg_range(kv_rng, n_kt, c0, kKeys) : make_int2(0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 256);
    }
    tc::mbar_init(kv_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    produce<kWindowCap, kExtra, kPair, kKeys, C::kChunks, kRows, kSt>(
        smem, C::kV, kQ, kDo, kTab, full, empty, kv_bar, &tm_q, &tm_k, &tm_v, &tm_do, lse, di, bh, c0,
        wk, rows, kv_len, q_offset, q_seq_len, causal, win, ex, sg, q_rng, n_qt, keys);
    return;
  }

  tc::setmaxnreg_inc<kConsumerRegs>();
  const bool p_side = wg == 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int kl_a = 16 * warp + g;  // this thread's key rows in the block: kl_a, kl_a + 8
  const int key_a = c0 + kl_a, key_b = key_a + 8;
  // kPair: this thread's key rows' segment ids.
  const size_t kv_head = static_cast<size_t>(bh) * s_kv;
  const int seg_ka = has_seg && key_a < s_kv ? sg.kv[kv_head + key_a] : 0;
  const int seg_kb = has_seg && key_b < s_kv ? sg.kv[kv_head + key_b] : 0;
  float* x_f = reinterpret_cast<float*>(smem + kX);  // Y^T: word j of thread tid at j 128 + tid
  unsigned char* ds_hi = smem + kX;
  unsigned char* ds_lo = ds_hi + C::kDsTerm;

  float acc[D / 2];  // dV (P side) or dK (dS side) of the key rows kl_a, kl_a + 8
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  // S^T from K, dP^T from V; the other operand (Q^T, dO^T) from the stage.
  const uint32_t a_base = tc::smem_u32(smem + (p_side ? 0 : C::kV));
  if (!p_side) tc::named_arrive(3, 256);  // X starts free
  tc::mbar_wait(kv_bar, 0);

  for (int it = 0, i = 0; it < wk.y; ++it) {
    const int r0 = walk_tile<kRows>(ex, use_bm, wk, it);
    const int slot = use_bm ? ex.bm_part[wk.x + it] : -1;  // a partial tile's element bits
    if (!live_tile<kWindowCap, kKeys, kRows>(r0, c0, rows, q_offset, q_seq_len, causal, win))
      continue;
    int2 q_ids = make_int2(0, 0);
    if (!ids_meet<kPair, kRows>(q_rng, n_qt, r0, keys, &q_ids)) continue;
    const int s = i % kSt;
    tc::mbar_wait(&full[s], (i / kSt) & 1);
    const uint32_t q_tile = tc::smem_u32(smem + kQ + s * kQTile);
    const uint32_t do_tile = tc::smem_u32(smem + kDo + s * kQTile);
    const float* tf = tab_f + s * kTabWords;
    const int* ti = tab_i + s * kTabWords;

    float st[kRows / 2];  // S^T (P side) or dP^T (dS side), key rows x query rows
    const uint32_t b_base = p_side ? q_tile : do_tile;
    tc::wgmma_fence();
    term_products<D, kProducts<D, kPair, kTerms>>(st, a_base, kKVChunk, b_base, kQChunk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);

    uint32_t ah[kRows / 16][4], al[kRows / 16][4];
    if (p_side) {
      // A partial tile's element bits of key rows kl_a and kl_a + 8 (over
      // the tile's query rows).
      unsigned bits_a[kRows / 32], bits_b[kRows / 32];
      fa::tile_bits<kKeys, kRows>(ex.bm_bits, slot, kl_a, t, bits_a, bits_b);
      const int pmin = q_offset + fa_bwd::tile_first_pos(r0, kRows, rows, q_seq_len);
      const int pmax = q_offset + fa_bwd::tile_last_pos(r0, kRows, rows, q_seq_len);
      const bool mixed_ids =
          has_seg && !(q_ids.x == q_ids.y && keys.x == keys.y && q_ids.x == keys.x);
      const bool need_mask = mixed_ids || r0 + kRows > rows || c0 + kKeys - 1 >= kv_len ||
                             (causal && c0 + kKeys - 1 > pmin) || (win > 0 && c0 <= pmax - win);
      float y[kRows / 2];
      fa::with_mask_form(need_mask, slot >= 0, [&](auto form) {  // as the d <= 128 kernel's
        constexpr int kForm = decltype(form)::value;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * j + 2 * t + (e & 1);  // query row in the tile
            const int key = e < 2 ? key_a : key_b;
            float sc = st[4 * j + e] * scale;
            float c_fac = 1.f;  // the softcap's derivative at the capped score
            if constexpr (kWindowCap) {
              if (cap > 0.f) {
                sc = fa::softcap(sc, cap);
                const float th = sc / cap;
                c_fac = 1.f - th * th;
              }
            }
            bool live = true;
            if constexpr (kForm != fa::kMaskNone)
              live = e < 2 ? fa::tile_bit(bits_a, j, e & 1) : fa::tile_bit(bits_b, j, e & 1);
            if constexpr (kForm == fa::kMaskAll)
              live = live && key <= ti[3 * kRows + x] && key >= ti[2 * kRows + x] &&
                     (!has_seg || ti[5 * kRows + x] == (e < 2 ? seg_ka : seg_kb));
            const float p = live ? tc::ex2((sc - tf[x]) * tc::kLog2e) : 0.f;
            y[4 * j + e] = p * c_fac;
            float z = p;  // Z = keep P / (1 - rate)
            if (dropout && !fa::dropout_kept(static_cast<unsigned>(ti[4 * kRows + x]), key,
                                             ex.threshold))
              z = 0.f;
            st[4 * j + e] = dropout ? z * ex.inv : z;
          }
        }
      });
      tc::named_sync(3, 256);  // the dS side's dQ products are done with X
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) x_f[j * 128 + tid] = y[j];
      tc::named_arrive(1, 256);  // Y^T written
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) tc::pack_a2(ah[kk], al[kk], st, kk);
      add_products<D, kTerms>(acc, ah, al, do_tile);  // dV += Z^T dO
      if constexpr (!kPair) {
        tc::named_sync(2, 256);  // dS^T written
        if constexpr (C::kDqT) dq_half_t<D, kTerms>(smem, dq_acc, bh, rows, r0, 0, warp, g, t);
        else dq_half<D, kTerms>(smem, dq_acc, bh, rows, r0, 0, warp, g, t);
      }
    } else {
      tc::named_sync(1, 256);  // Y^T written
      float y[kRows / 2];
#pragma unroll
      for (int j = 0; j < kRows / 2; ++j) y[j] = x_f[j * 128 + tid];
      if constexpr (kPair) tc::named_arrive(3, 256);  // done with X
      else tc::named_sync(4, 128);  // every thread of this side has read its Y^T
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * j + 2 * t + (e & 1);
          float dp = st[4 * j + e];
          if (dropout)
            dp = fa::dropout_kept(static_cast<unsigned>(ti[4 * kRows + x]),
                                  e < 2 ? key_a : key_b, ex.threshold) ? dp * ex.inv : 0.f;
          st[4 * j + e] = y[4 * j + e] * (dp - tf[kRows + x]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) tc::pack_a2(ah[kk], al[kk], st, kk);
      if constexpr (!kPair && C::kDqT) {
        // dS (32 query rows x 64 key rows, hi and lo) into X by query row,
        // 16-byte unit u of row q at u ^ (q % 8), as TMA would swizzle it:
        // word w of k-step kk holds key row kl_a + 8 (w % 2) at query rows
        // 16 kk + 8 (w / 2) + 2t and the next, one bf16 each.
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int key = kl_a + 8 * (w & 1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 16 * kk + 8 * (w >> 1) + 2 * t + h;
              const int off = q * 128 + (((key >> 3) ^ (q & 7)) << 4) + 2 * (key & 7);
              *reinterpret_cast<uint16_t*>(ds_hi + off) = ah[kk][w] >> (16 * h);
              *reinterpret_cast<uint16_t*>(ds_lo + off) = al[kk][w] >> (16 * h);
            }
          }
        }
        tc::fence_async_smem();
        tc::named_arrive(2, 256);  // dS written
      } else if constexpr (!kPair) {
        // dS^T (64 key rows x 64 query rows, hi and lo) into X, 16-byte unit
        // u of key row r at u ^ (r % 8), as TMA would swizzle it.
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // query columns 16kk + 8h + 2t, +1
            const int u = 2 * kk + h;
            const int ra = kl_a, rb = kl_a + 8;
            const int oa = ra * 128 + ((u ^ (ra & 7)) * 16) + 4 * t;
            const int ob = rb * 128 + ((u ^ (rb & 7)) * 16) + 4 * t;
            *reinterpret_cast<uint32_t*>(ds_hi + oa) = ah[kk][2 * h];
            *reinterpret_cast<uint32_t*>(ds_hi + ob) = ah[kk][2 * h + 1];
            *reinterpret_cast<uint32_t*>(ds_lo + oa) = al[kk][2 * h];
            *reinterpret_cast<uint32_t*>(ds_lo + ob) = al[kk][2 * h + 1];
          }
        }
        tc::fence_async_smem();
        tc::named_arrive(2, 256);  // dS^T written
      }
      add_products<D, kTerms>(acc, ah, al, q_tile);  // dK += dS^T Q
      if constexpr (!kPair) {
        constexpr int kHalf = C::kLC / 2;
        if constexpr (C::kDqT) dq_half_t<D, kTerms>(smem, dq_acc, bh, rows, r0, kHalf, warp, g, t);
        else dq_half<D, kTerms>(smem, dq_acc, bh, rows, r0, kHalf, warp, g, t);
        tc::named_arrive(3, 256);  // done with X
      }
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(ah[kk][w]), "+r"(al[kk][w])::"memory");
    tc::mbar_arrive(&empty[s]);
    ++i;
  }
  if (p_side) tc::named_sync(3, 256);  // the dS side's last arrival

  OutT<kTerms>* out = p_side ? dv : dk;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (key_a < s_kv)
      store2(out + (static_cast<size_t>(bh) * s_kv + key_a) * D + c, acc[4 * j], acc[4 * j + 1]);
    if (key_b < s_kv)
      store2(out + (static_cast<size_t>(bh) * s_kv + key_b) * D + c, acc[4 * j + 2],
             acc[4 * j + 3]);
  }
}

}  // namespace wide

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  float* dq_acc;
  void* dk;
  void* dv;
  int bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal;
  float scale;
  int window;
  float softcap;
  fa::Extras ex;
  cudaStream_t stream;
  fa_bwd::Segs sg;  // kPair only
};

// The library's form: the fused backward, or (FA_PAIR) the pair's dK/dV pass.
#ifdef FA_PAIR
constexpr bool kPairLib = true;
#else
constexpr bool kPairLib = false;
#endif

// q, k, v, dout: bf16 rows of tc::kRowWidth<D, kTerms> (kTerms 2: [hi | lo]).
template <int D, bool kWindowCap, bool kExtra, int kTerms>
int launch(const Args& a) {
  constexpr bool kPair = kPairLib;
  // The d = 256 kernel's arrangement: d = 256, and d = 128 over two terms.
  constexpr bool kWide = D == 256 || (D == 128 && kTerms == 2);
  constexpr int W = tc::kRowWidth<D, kTerms>;
  constexpr int kKeys = kWide ? wide::kKeys : kBlockN;  // key rows per block
  constexpr int kRows = [] {  // query rows per tile
    if constexpr (kWide) return wide::Cfg<D, kTerms>::kRows;
    else return kBlockM;
  }();
  constexpr int kBytes = [] {
    if constexpr (kWide) return wide::Cfg<D, kTerms>::kBytes;
    else return Cfg<D, kPair, kTerms>::kBytes;
  }();
  CUtensorMap mq, mk, mv, mdo;
  // K/V rows past kv_len read as zeros (dP there would meet V's garbage).
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  const long long q_stride = static_cast<long long>(a.rows) * W;
  const long long kv_stride = static_cast<long long>(a.s_kv) * W;
  int st = tc_encode_map(&mq, a.q, W, a.rows, a.bh, q_stride, kRows);
  if (st == 0) st = tc_encode_map(&mdo, a.dout, W, a.rows, a.bh, q_stride, kRows);
  if (st == 0) st = tc_encode_map(&mk, a.k, W, kv_rows, a.bh, kv_stride, kKeys);
  if (st == 0) st = tc_encode_map(&mv, a.v, W, kv_rows, a.bh, kv_stride, kKeys);
  if (st != 0) return st;
  auto kernel = [] {
    if constexpr (kWide) return wide::flash_bwd_tc_wide_kernel<D, kWindowCap, kExtra, kPair, kTerms>;
    else return flash_bwd_tc_kernel<D, kWindowCap, kExtra, kPair, kTerms>;
  }();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s_kv + kKeys - 1) / kKeys, a.bh);
  kernel<<<grid, kThreads, kBytes, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.di, a.dq_acc, static_cast<OutT<kTerms>*>(a.dk),
      static_cast<OutT<kTerms>*>(a.dv), a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len,
      a.causal, a.scale, a.window, a.softcap, a.ex, a.sg);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kWindowCap, int kTerms>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return launch<D, kWindowCap, true, kTerms>(a);
#else
  if (a.ex.threshold != 0 || a.ex.bm_ptr != nullptr) return -1;
  return launch<D, kWindowCap, false, kTerms>(a);
#endif
}

template <int D, int kTerms = 0>
int launch_w(const Args& a) {
  return a.window > 0 || a.softcap > 0.f ? launch_x<D, true, kTerms>(a)
                                         : launch_x<D, false, kTerms>(a);
}

}  // namespace

#ifndef FA_F32
namespace {

int launch_d(const Args& a, int d) {
  switch (d) {
    case 64: return launch_w<64>(a);
    case 128: return launch_w<128>(a);
    case 256: return launch_w<256>(a);
    default: return -1;
  }
}

}  // namespace
#endif

#if defined(FA_F32) && defined(FA_PAIR)
// The pair's dK/dV pass over float32: q, k, v, dout float32 as in
// fa_flash_bwd_tc_f32, d 64, 128 or 256; q2, k2, v2, do2 their bf16 split rows
// (terms 2, "bf16_3x": [hi | lo]; 1, "bf16": [hi]), which the split pass
// fills first when `split` is nonzero, else the pair's dQ pass already
// filled them from the same inputs; segment ids and their range tables as
// fa_flash_bwd_dkv_tc's; dk, dv float32; no block mask (dropout in the
// FA_EXTRA library only).
extern "C" int fa_flash_bwd_dkv_tc_f32(int terms, int split, const void* q, const void* k,
                                       const void* v, const void* dout, void* q2, void* k2,
                                       void* v2, void* do2, const void* lse, const void* di,
                                       const void* q_seg, const void* kv_seg, const void* q_rng,
                                       const void* kv_rng, void* dk, void* dv, int bh, int rows,
                                       int s_kv, int d, int kv_len, int q_offset, int q_seq_len,
                                       int causal, float scale, int window, float softcap,
                                       int row_stride, int dropout_seed, int dropout_threshold,
                                       float dropout_inv, void* stream) {
  if ((terms != 1 && terms != 2) || (d != 64 && d != 128 && d != 256)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = split ? tc::split_bwd(q, k, v, dout, q2, k2, v2, do2,
                                            static_cast<long long>(bh) * rows,
                                            static_cast<long long>(bh) * s_kv, d, terms, st)
                           : 0;
  if (status != 0) return status;
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const fa_bwd::Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                        static_cast<const int*>(q_rng), static_cast<const int*>(kv_rng)};
  const Args a{q2, k2, v2, do2, static_cast<const float*>(lse), static_cast<const float*>(di),
               nullptr, dk, dv, bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale,
               window, softcap, ex, st, sg};
  if (d == 64) return terms == 2 ? launch_w<64, 2>(a) : launch_w<64, 1>(a);
  if (d == 128) return terms == 2 ? launch_w<128, 2>(a) : launch_w<128, 1>(a);
  return terms == 2 ? launch_w<256, 2>(a) : launch_w<256, 1>(a);
}
#elif defined(FA_F32)
// The float32 form.  q, k, v, dout: float32 (bh, rows, d) / (bh, s_kv, d),
// contiguous, 16-byte aligned, d 64, 128 or 256; q2, k2, v2, do2: bf16 buffers of
// the same rows and terms * d columns, which the split pass fills before
// the kernel reads them; terms 2 is the JAX mode "bf16_3x" ([hi | lo], three
// products each), 1 "bf16" (bf16(x), one product each); dk, dv: float32 like
// k and v; lse, di, dq_acc and the options as in fa_flash_bwd_tc (dropout
// in the FA_EXTRA library only).
extern "C" int fa_flash_bwd_tc_f32(int terms, const void* q, const void* k, const void* v,
                                   const void* dout, void* q2, void* k2, void* v2, void* do2,
                                   const void* lse, const void* di, void* dq_acc, void* dk,
                                   void* dv, int bh, int rows, int s_kv, int d, int kv_len,
                                   int q_offset, int q_seq_len, int causal, float scale,
                                   int window, float softcap, int row_stride, int dropout_seed,
                                   int dropout_threshold, float dropout_inv, void* stream) {
  if ((terms != 1 && terms != 2) || (d != 64 && d != 128 && d != 256)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = tc::split_bwd(q, k, v, dout, q2, k2, v2, do2,
                                   static_cast<long long>(bh) * rows,
                                   static_cast<long long>(bh) * s_kv, d, terms, st);
  if (status != 0) return status;
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q2, k2, v2, do2, static_cast<const float*>(lse), static_cast<const float*>(di),
               static_cast<float*>(dq_acc), dk, dv, bh, rows, s_kv, kv_len, q_offset,
               q_seq_len, causal, scale, window, softcap, ex, st,
               fa_bwd::Segs{nullptr, nullptr, nullptr, nullptr}};
  if (d == 64) return terms == 2 ? launch_w<64, 2>(a) : launch_w<64, 1>(a);
  if (d == 128) return terms == 2 ? launch_w<128, 2>(a) : launch_w<128, 1>(a);
  return terms == 2 ? launch_w<256, 2>(a) : launch_w<256, 1>(a);
}
#elif defined(FA_PAIR)
// The pair's dK/dV pass.  q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d);
// all bf16, contiguous, 16-byte aligned (TMA); lse, di: (bh, rows) float32;
// q_seg (bh, rows) and kv_seg (bh, s_kv) int32 with their tile tables q_rng
// (bh, ceil(rows / 64), 2) and kv_rng (bh, ceil(s_kv / 64), 2), each 64
// rows' [min, max] id, all four or none null.  Options as fa_flash_bwd_tc's.
// bm_ptr null: no block mask; else (FA_EXTRA only) its table over (64, 128)
// tiles (d = 256: (64, 64)) by key tile (common.cuh, Extras), bm_bits by key
// row (each slot's 128 (64) key rows' words over its 64 query rows).
extern "C" int fa_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* di,
                                   const void* q_seg, const void* kv_seg, const void* q_rng,
                                   const void* kv_rng, void* dk, void* dv, const void* bm_ptr,
                                   const void* bm_idx, const void* bm_part, const void* bm_bits,
                                   int bh, int rows, int s_kv, int d, int kv_len, int q_offset,
                                   int q_seq_len, int causal, float scale, int window,
                                   float softcap, int row_stride, int dropout_seed,
                                   int dropout_threshold, float dropout_inv, void* stream) {
  const fa::Extras ex{static_cast<const int*>(bm_ptr), static_cast<const int*>(bm_idx),
                      static_cast<const int*>(bm_part), static_cast<const unsigned*>(bm_bits),
                      row_stride, static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const fa_bwd::Segs sg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                        static_cast<const int*>(q_rng), static_cast<const int*>(kv_rng)};
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di),
               nullptr, dk, dv, bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale,
               window, softcap, ex, static_cast<cudaStream_t>(stream), sg};
  return launch_d(a, d);
}
#else
// q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d); all bf16, contiguous,
// 16-byte aligned (TMA); lse, di: (bh, rows) float32; dq_acc: (bh, rows, d)
// float32, zeroed by the caller, to which dQ is added.  window <= 0: no
// sliding window (else it requires causal); softcap <= 0: none; dropout as
// in fa_flash_fwd (FA_EXTRA only).
extern "C" int fa_flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq_acc, void* dk,
                               void* dv, int bh, int rows, int s_kv, int d, int kv_len,
                               int q_offset, int q_seq_len, int causal, float scale, int window,
                               float softcap, int row_stride, int dropout_seed,
                               int dropout_threshold, float dropout_inv, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di),
               static_cast<float*>(dq_acc), dk, dv, bh, rows, s_kv, kv_len, q_offset,
               q_seq_len, causal, scale, window, softcap, ex, static_cast<cudaStream_t>(stream),
               fa_bwd::Segs{nullptr, nullptr, nullptr, nullptr}};
  return launch_d(a, d);
}
#endif
