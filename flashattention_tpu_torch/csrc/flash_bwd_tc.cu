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
// the formulas.  Segment ids and block masks stay on the scalar two-pass
// pair, as in the JAX package.
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
// 192 KB: see flash_bwd_tc_d256_kernel below for the design there.
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
// window skips, the softcap and dropout are the fused form's.
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

template <int D, bool kPair>
struct Cfg {
  static constexpr int kChunks = D / tc::kChunk;
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
// the query tile [r0, r0 + kBlockM): the scalar kernel's skips.
template <bool kWindowCap, int kKeys>
__device__ __forceinline__ bool live_tile(int r0, int c0, int rows, int q_offset, int q_seq_len,
                                          int causal, int window) {
  if (causal && q_offset + fa_bwd::tile_last_pos(r0, kBlockM, rows, q_seq_len) < c0) return false;
  if (kWindowCap && window > 0 &&
      q_offset + fa_bwd::tile_first_pos(r0, kBlockM, rows, q_seq_len) - window + 1 >
          c0 + kKeys - 1)
    return false;
  return true;
}

// With segment ids (kPair), whether the query tile [r0, r0 + kBlockM) and key
// ids `keys` may meet: their id ranges overlap.  No segment ids: true.
template <bool kPair>
__device__ __forceinline__ bool ids_meet(const int* q_rng, int n_qt, int r0, int2 keys,
                                         int2* q_ids) {
  if (!kPair || q_rng == nullptr) return true;
  *q_ids = fa_bwd::seg_range(q_rng, n_qt, r0, kBlockM);
  return fa_bwd::seg_meet(*q_ids, keys);
}

// The producer warp of both kernels: K and V of the block's kKeys key rows
// once, then for each live query tile its Q and dO tiles into the ring,
// with the tile's lse, di, each row's first and last visible column, its
// dropout row key and (kPair) its segment id in the stage's table (kTabRows
// kBlockM words).  kPair: a tile whose ids do not meet the block's key ids
// `keys` is skipped (ids_meet).
template <bool kWindowCap, bool kExtra, bool kPair, int kKeys, int kChunks>
__device__ __forceinline__ void produce(unsigned char* smem, int v_off, int q_off, int do_off,
                                        int tab_off, uint64_t* full, uint64_t* empty,
                                        uint64_t* kv_bar, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_do, const float* lse,
                                        const float* di, int bh, int c0, int n_r, int rows,
                                        int kv_len, int q_offset, int q_seq_len, int causal,
                                        int win, const fa::Extras& ex, const fa_bwd::Segs& sg,
                                        const int* q_rng, int n_qt, int2 keys) {
  constexpr int kKVChunk = kKeys * tc::kChunkRowBytes;
  constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;
  constexpr int kQTile = kChunks * kQChunk;
  constexpr int kTabWords = kTabRows * kBlockM;
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
  for (int it = 0, i = 0; it < n_r; ++it) {
    const int r0 = it * kBlockM;
    if (!live_tile<kWindowCap, kKeys>(r0, c0, rows, q_offset, q_seq_len, causal, win)) continue;
    int2 q_ids;
    if (!ids_meet<kPair>(q_rng, n_qt, r0, keys, &q_ids)) continue;
    const int s = i % kStages;
    if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
    float* tf = tab_f + s * kTabWords;
    int* ti = tab_i + s * kTabWords;
    for (int x = lane; x < kBlockM; x += 32) {
      const int r = r0 + x;
      const bool in = r < rows;
      tf[x] = in ? lse[head + r] : 0.f;
      tf[kBlockM + x] = in ? di[head + r] : 0.f;
      ti[2 * kBlockM + x] = fa_bwd::row_first(r, q_offset, q_seq_len, win);
      ti[3 * kBlockM + x] = fa_bwd::row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);
      ti[4 * kBlockM + x] =
          dropout ? static_cast<int>(fa::dropout_row_key(ex, bh, r, q_seq_len)) : 0;
      ti[5 * kBlockM + x] = kPair && in && sg.q != nullptr ? sg.q[head + r] : 0;
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

template <int D, bool kWindowCap, bool kExtra, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq_acc,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int rows,
                    int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                    int window, float softcap, const fa::Extras ex, const fa_bwd::Segs sg) {
  using C = Cfg<D, kPair>;
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
  const int c0 = blockIdx.x * kBlockN;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const int n_r = c0 < kv_len ? (rows + kBlockM - 1) / kBlockM : 0;  // query tiles to walk
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
        lse, di, bh, c0, n_r, rows, kv_len, q_offset, q_seq_len, causal, win, ex, sg, q_rng, n_qt,
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

  for (int it = 0, i = 0; it < n_r; ++it) {
    const int r0 = it * kBlockM;
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
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::kKVChunk + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * C::kQChunk + (kk % 4) * 32;
      tc::wgmma_ss<0, 0>(st, tc::make_desc(k_base + off, 16, 1024),
                         tc::make_desc(q_tile + qoff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::kKVChunk + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * C::kQChunk + (kk % 4) * 32;
      tc::wgmma_ss<0, 0>(dpt, tc::make_desc(v_base + off, 16, 1024),
                         tc::make_desc(do_tile + qoff, 16, 1024), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);
    tc::fence_regs(dpt);

    // Whether any pair of this warpgroup's key rows and the tile is masked.
    const int pmin = q_offset + fa_bwd::tile_first_pos(r0, kBlockM, rows, q_seq_len);
    const int pmax = q_offset + fa_bwd::tile_last_pos(r0, kBlockM, rows, q_seq_len);
    const bool mixed_ids = has_seg && !(q_ids.x == q_ids.y && wg_keys.x == wg_keys.y &&
                                        q_ids.x == wg_keys.x);
    const bool need_mask = mixed_ids || r0 + kBlockM > rows || kw0 + 63 >= kv_len ||
                           (causal && kw0 + 63 > pmin) || (win > 0 && kw0 <= pmax - win);
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
        const bool live = !need_mask ||
                          (key <= ti[3 * kBlockM + x] && key >= ti[2 * kBlockM + x] &&
                           (!has_seg || ti[5 * kBlockM + x] == (e < 2 ? seg_ka : seg_kb)));
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
#pragma unroll
    for (int pass = 0; pass < 2 * C::kChunks; ++pass) {
      const int c = pass % C::kChunks;
      const bool dv_pass = pass < C::kChunks;
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
          tc::wgmma_ss<1, 1>(dq, tc::make_desc(hi_base + kk * 2048, C::kDsBytes, 1024), db, kk > 0);
          tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, C::kDsBytes, 1024), db, 1);
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
      *reinterpret_cast<uint32_t*>(dk + off) = tc::pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) = tc::pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (key_b < s_kv) {
      const size_t off = (static_cast<size_t>(bh) * s_kv + key_b) * D + c;
      *reinterpret_cast<uint32_t*>(dk + off) =
          tc::pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          tc::pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// head_dim 256.  The d <= 128 kernel's split (each consumer warpgroup its own
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
namespace d256 {

constexpr int D = 256;
constexpr int kKeys = 64;  // key rows per block, shared by both warpgroups
constexpr int kChunks = D / tc::kChunk;
constexpr int kKVChunk = kKeys * tc::kChunkRowBytes;
constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;
constexpr int kQTile = kChunks * kQChunk;
constexpr int kDsBytes = kKeys * tc::kChunkRowBytes;  // one bf16 term of dS^T
// K | V | Q stages | dO stages | X | tables | barriers
constexpr int kV = kChunks * kKVChunk;
constexpr int kQ = kV + kChunks * kKVChunk;
constexpr int kDo = kQ + kStages * kQTile;
constexpr int kX = kDo + kStages * kQTile;
constexpr int kTab = kX + 2 * kDsBytes;
constexpr int kTabWords = kTabRows * kBlockM;
constexpr int kBar = kTab + kStages * kTabWords * 4;
constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;
static_assert(2 * kDsBytes == 4 * kKeys * kBlockM, "X holds Y^T in float32 and dS^T's two terms");
static_assert(kBytes <= 232448, "over Hopper's shared memory a block");

// dX += A^T B over the tile's 64 query rows, 64 columns of B (its MN-major
// tile `b_tile`) at a time, A^T from registers as two bf16 terms; each part
// summed afresh and added to acc in float32 (see the d <= 128 kernel).
__device__ __forceinline__ void add_products(float (&acc)[D / 2], const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4], uint32_t b_tile) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float part[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint64_t db = tc::make_desc(b_tile + c * kQChunk + kk * 2048, kQChunk, 1024);
      tc::wgmma_rs<1>(part, ah[kk], db, kk > 0);
      tc::wgmma_rs<1>(part, al[kk], db, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * c + x] += part[x];
  }
}

// dQ's columns [64 c0, 64 c0 + 128) of the tile: dS (its two terms in X,
// read as the transposed A) times K, added to dq_acc by atomics.
__device__ __forceinline__ void dq_half(unsigned char* smem, float* dq_acc, int bh, int rows,
                                        int r0, int c0, int warp, int g, int t) {
  const uint32_t hi_base = tc::smem_u32(smem + kX), lo_base = hi_base + kDsBytes;
#pragma unroll
  for (int c = c0; c < c0 + 2; ++c) {
    float dq[32];
    const uint32_t kc_base = tc::smem_u32(smem) + c * kKVChunk;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = tc::make_desc(kc_base + kk * 2048, kKVChunk, 1024);
      tc::wgmma_ss<1, 1>(dq, tc::make_desc(hi_base + kk * 2048, kDsBytes, 1024), db, kk > 0);
      tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, kDsBytes, 1024), db, 1);
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

template <bool kWindowCap, bool kExtra, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq_acc,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int rows,
                         int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
                         float scale, int window, float softcap, const fa::Extras ex,
                         const fa_bwd::Segs sg) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  const float* tab_f = reinterpret_cast<const float*>(smem + kTab);
  const int* tab_i = reinterpret_cast<const int*>(smem + kTab);

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kKeys;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const int n_q = c0 < kv_len ? (rows + kBlockM - 1) / kBlockM : 0;  // query tiles to walk
  // kPair, segment ids: each head's id ranges, and the block's key rows'.
  const bool has_seg = kPair && sg.q != nullptr;
  const int n_qt = (rows + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int n_kt = (s_kv + fa_bwd::kSegTile - 1) / fa_bwd::kSegTile;
  const int* q_rng = has_seg ? sg.q_rng + static_cast<size_t>(bh) * n_qt * 2 : nullptr;
  const int* kv_rng = has_seg ? sg.kv_rng + static_cast<size_t>(bh) * n_kt * 2 : nullptr;
  const int2 keys = has_seg ? fa_bwd::seg_range(kv_rng, n_kt, c0, kKeys) : make_int2(0, 0);

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
    produce<kWindowCap, kExtra, kPair, kKeys, kChunks>(
        smem, kV, kQ, kDo, kTab, full, empty, kv_bar, &tm_q, &tm_k, &tm_v, &tm_do, lse, di, bh, c0,
        n_q, rows, kv_len, q_offset, q_seq_len, causal, win, ex, sg, q_rng, n_qt, keys);
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
  unsigned char* ds_lo = ds_hi + kDsBytes;

  float acc[D / 2];  // dV (P side) or dK (dS side) of the key rows kl_a, kl_a + 8
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  // S^T from K, dP^T from V; the other operand (Q^T, dO^T) from the stage.
  const uint32_t a_base = tc::smem_u32(smem + (p_side ? 0 : kV));
  if (!p_side) tc::named_arrive(3, 256);  // X starts free
  tc::mbar_wait(kv_bar, 0);

  for (int it = 0, i = 0; it < n_q; ++it) {
    const int r0 = it * kBlockM;
    if (!live_tile<kWindowCap, kKeys>(r0, c0, rows, q_offset, q_seq_len, causal, win)) continue;
    int2 q_ids = make_int2(0, 0);
    if (!ids_meet<kPair>(q_rng, n_qt, r0, keys, &q_ids)) continue;
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t q_tile = tc::smem_u32(smem + kQ + s * kQTile);
    const uint32_t do_tile = tc::smem_u32(smem + kDo + s * kQTile);
    const float* tf = tab_f + s * kTabWords;
    const int* ti = tab_i + s * kTabWords;

    float st[kBlockM / 2];  // S^T (P side) or dP^T (dS side), key rows x query rows
    const uint32_t b_base = p_side ? q_tile : do_tile;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kKVChunk + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kQChunk + (kk % 4) * 32;
      tc::wgmma_ss<0, 0>(st, tc::make_desc(a_base + off, 16, 1024),
                         tc::make_desc(b_base + qoff, 16, 1024), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(st);

    uint32_t ah[kBlockM / 16][4], al[kBlockM / 16][4];
    if (p_side) {
      const int pmin = q_offset + fa_bwd::tile_first_pos(r0, kBlockM, rows, q_seq_len);
      const int pmax = q_offset + fa_bwd::tile_last_pos(r0, kBlockM, rows, q_seq_len);
      const bool mixed_ids =
          has_seg && !(q_ids.x == q_ids.y && keys.x == keys.y && q_ids.x == keys.x);
      const bool need_mask = mixed_ids || r0 + kBlockM > rows || c0 + kKeys - 1 >= kv_len ||
                             (causal && c0 + kKeys - 1 > pmin) || (win > 0 && c0 <= pmax - win);
      float y[kBlockM / 2];
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
          const bool live =
              !need_mask || (key <= ti[3 * kBlockM + x] && key >= ti[2 * kBlockM + x] &&
                             (!has_seg || ti[5 * kBlockM + x] == (e < 2 ? seg_ka : seg_kb)));
          const float p = live ? tc::ex2((sc - tf[x]) * tc::kLog2e) : 0.f;
          y[4 * j + e] = p * c_fac;
          float z = p;  // Z = keep P / (1 - rate)
          if (dropout && !fa::dropout_kept(static_cast<unsigned>(ti[4 * kBlockM + x]), key,
                                           ex.threshold))
            z = 0.f;
          st[4 * j + e] = dropout ? z * ex.inv : z;
        }
      }
      tc::named_sync(3, 256);  // the dS side's dQ products are done with X
#pragma unroll
      for (int j = 0; j < kBlockM / 2; ++j) x_f[j * 128 + tid] = y[j];
      tc::named_arrive(1, 256);  // Y^T written
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) tc::pack_a2(ah[kk], al[kk], st, kk);
      add_products(acc, ah, al, do_tile);  // dV += Z^T dO
      if constexpr (!kPair) {
        tc::named_sync(2, 256);  // dS^T written
        dq_half(smem, dq_acc, bh, rows, r0, 0, warp, g, t);
      }
    } else {
      tc::named_sync(1, 256);  // Y^T written
      float y[kBlockM / 2];
#pragma unroll
      for (int j = 0; j < kBlockM / 2; ++j) y[j] = x_f[j * 128 + tid];
      if constexpr (kPair) tc::named_arrive(3, 256);  // done with X
      else tc::named_sync(4, 128);  // every thread of this side has read its Y^T
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * j + 2 * t + (e & 1);
          float dp = st[4 * j + e];
          if (dropout)
            dp = fa::dropout_kept(static_cast<unsigned>(ti[4 * kBlockM + x]),
                                  e < 2 ? key_a : key_b, ex.threshold) ? dp * ex.inv : 0.f;
          st[4 * j + e] = y[4 * j + e] * (dp - tf[kBlockM + x]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) tc::pack_a2(ah[kk], al[kk], st, kk);
      if constexpr (!kPair) {
        // dS^T (64 key rows x 64 query rows, hi and lo) into X, 16-byte unit
        // u of key row r at u ^ (r % 8), as TMA would swizzle it.
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {
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
      add_products(acc, ah, al, q_tile);  // dK += dS^T Q
      if constexpr (!kPair) {
        dq_half(smem, dq_acc, bh, rows, r0, 2, warp, g, t);
        tc::named_arrive(3, 256);  // done with X
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(ah[kk][w]), "+r"(al[kk][w])::"memory");
    tc::mbar_arrive(&empty[s]);
    ++i;
  }
  if (p_side) tc::named_sync(3, 256);  // the dS side's last arrival

  __nv_bfloat16* out = p_side ? dv : dk;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (key_a < s_kv)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(bh) * s_kv + key_a) * D + c) =
          tc::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (key_b < s_kv)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(bh) * s_kv + key_b) * D + c) =
          tc::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace d256

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

template <int D, bool kWindowCap, bool kExtra>
int launch(const Args& a) {
  constexpr bool kPair = kPairLib;
  constexpr int kKeys = D == 256 ? d256::kKeys : kBlockN;  // key rows per block
  constexpr int kBytes = D == 256 ? d256::kBytes : Cfg<D == 256 ? 128 : D, kPair>::kBytes;
  CUtensorMap mq, mk, mv, mdo;
  // K/V rows past kv_len read as zeros (dP there would meet V's garbage).
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  const long long q_stride = static_cast<long long>(a.rows) * D;
  const long long kv_stride = static_cast<long long>(a.s_kv) * D;
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, q_stride, kBlockM);
  if (st == 0) st = tc_encode_map(&mdo, a.dout, D, a.rows, a.bh, q_stride, kBlockM);
  if (st == 0) st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, kv_stride, kKeys);
  if (st == 0) st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, kv_stride, kKeys);
  if (st != 0) return st;
  auto kernel = [] {
    if constexpr (D == 256) return d256::flash_bwd_tc_d256_kernel<kWindowCap, kExtra, kPair>;
    else return flash_bwd_tc_kernel<D, kWindowCap, kExtra, kPair>;
  }();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s_kv + kKeys - 1) / kKeys, a.bh);
  kernel<<<grid, kThreads, kBytes, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.di, a.dq_acc, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len,
      a.causal, a.scale, a.window, a.softcap, a.ex, a.sg);
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

#ifdef FA_PAIR
// The pair's dK/dV pass.  q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d);
// all bf16, contiguous, 16-byte aligned (TMA); lse, di: (bh, rows) float32;
// q_seg (bh, rows) and kv_seg (bh, s_kv) int32 with their tile tables q_rng
// (bh, ceil(rows / 64), 2) and kv_rng (bh, ceil(s_kv / 64), 2), each 64
// rows' [min, max] id, all four or none null.  Options as fa_flash_bwd_tc's.
extern "C" int fa_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* di,
                                   const void* q_seg, const void* kv_seg, const void* q_rng,
                                   const void* kv_rng, void* dk, void* dv, int bh, int rows,
                                   int s_kv, int d, int kv_len, int q_offset, int q_seq_len,
                                   int causal, float scale, int window, float softcap,
                                   int row_stride, int dropout_seed, int dropout_threshold,
                                   float dropout_inv, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
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
