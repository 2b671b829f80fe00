// Flash-attention backward, fused one-pass kernel, on Hopper's tensor cores
// (sm_90a): dQ, dK and dV from one recomputation of each (query, key) pair.
//
// Replaces flashattention_tpu/ops/backward.py::_fused_bwd_kernel (the
// pallas_call at backward.py:798) for bf16 q/k/v/dO at head_dim 64 and 128:
// causal masking at position q_offset + (i mod q_seq_len) (the GQA row fold:
// dK/dV of a KV head sum over the rows of all G query groups), kv_len, the
// score scale, a sliding window and a logit softcap with its derivative on
// dS (the compile-time form kWindowCap), and attention dropout in the
// compile-time form kExtra (built with FA_EXTRA).  See bwd_common.cuh for
// the formulas.  head_dim 256, segment ids and block masks stay on the
// scalar kernels (flash_bwd.cu, and the two-pass pair as in the JAX
// package): at d = 256 the dK and dV accumulators of 64 key rows alone are
// 256 float32 registers a thread.
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
#include "bwd_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kBlockN = 128;  // key rows per block: two consumer warpgroups of 64
constexpr int kBlockM = 64;   // query rows per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
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
  static constexpr int kTab = kDs + 4 * kDsBytes;  // hi and lo terms, double-buffered
  static constexpr int kTabWords = 5 * kBlockM;  // lse, di, first, last, dropout key
  static constexpr int kBar = kTab + kStages * kTabWords * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;
};

// Whether the block of key rows [c0, c0 + kBlockN) has any live pair with
// the query tile [r0, r0 + kBlockM): the scalar kernel's skips.
template <bool kWindowCap>
__device__ __forceinline__ bool live_tile(int r0, int c0, int rows, int q_offset, int q_seq_len,
                                          int causal, int window) {
  if (causal && q_offset + fa_bwd::tile_last_pos(r0, kBlockM, rows, q_seq_len) < c0) return false;
  if (kWindowCap && window > 0 &&
      q_offset + fa_bwd::tile_first_pos(r0, kBlockM, rows, q_seq_len) - window + 1 >
          c0 + kBlockN - 1)
    return false;
  return true;
}

template <int D, bool kWindowCap, bool kExtra>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq_acc,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int rows,
                    int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                    int window, float softcap, const fa::Extras ex) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  // Per stage: lse, di, first and last visible column, dropout row key.
  float* tab_f = reinterpret_cast<float*>(smem + C::kTab);
  int* tab_i = reinterpret_cast<int*>(smem + C::kTab);

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kBlockN;
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const bool dropout = kExtra && ex.threshold != 0;
  const int n_r = c0 < kv_len ? (rows + kBlockM - 1) / kBlockM : 0;  // query tiles to walk

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
    const int lane = threadIdx.x;
    if (lane == 0) {
      tc::mbar_arrive_tx(kv_bar, 2 * C::kChunks * C::kKVChunk);
      for (int c = 0; c < C::kChunks; ++c) {
        tc::tma_load(smem + c * C::kKVChunk, &tm_k, kv_bar, c * tc::kChunk, c0, bh);
        tc::tma_load(smem + C::kV + c * C::kKVChunk, &tm_v, kv_bar, c * tc::kChunk, c0, bh);
      }
    }
    const size_t head = static_cast<size_t>(bh) * rows;
    for (int it = 0, i = 0; it < n_r; ++it) {
      const int r0 = it * kBlockM;
      if (!live_tile<kWindowCap>(r0, c0, rows, q_offset, q_seq_len, causal, win)) continue;
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      float* tf = tab_f + s * C::kTabWords;
      int* ti = tab_i + s * C::kTabWords;
      for (int x = lane; x < kBlockM; x += 32) {
        const int r = r0 + x;
        const bool in = r < rows;
        tf[x] = in ? lse[head + r] : 0.f;
        tf[kBlockM + x] = in ? di[head + r] : 0.f;
        ti[2 * kBlockM + x] = fa_bwd::row_first(r, q_offset, q_seq_len, win);
        ti[3 * kBlockM + x] = fa_bwd::row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);
        ti[4 * kBlockM + x] =
            dropout ? static_cast<int>(fa::dropout_row_key(ex, bh, r, q_seq_len)) : 0;
      }
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * C::kQTile);
        for (int c = 0; c < C::kChunks; ++c) {
          tc::tma_load(smem + C::kQ + s * C::kQTile + c * C::kQChunk, &tm_q, &full[s],
                       c * tc::kChunk, r0, bh);
          tc::tma_load(smem + C::kDo + s * C::kQTile + c * C::kQChunk, &tm_do, &full[s],
                       c * tc::kChunk, r0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
      ++i;
    }
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

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
  const uint32_t k_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  const uint32_t v_base = tc::smem_u32(smem + C::kV) + cw * 64 * tc::kChunkRowBytes;
  tc::mbar_wait(kv_bar, 0);

  for (int it = 0, i = 0; it < n_r; ++it) {
    const int r0 = it * kBlockM;
    if (!live_tile<kWindowCap>(r0, c0, rows, q_offset, q_seq_len, causal, win)) continue;
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
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
    const bool need_mask = r0 + kBlockM > rows || kw0 + 63 >= kv_len ||
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
        const bool live = !need_mask || (key <= ti[3 * kBlockM + x] && key >= ti[2 * kBlockM + x]);
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
  if (st == 0) st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, kv_stride, kBlockN);
  if (st == 0) st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, kv_stride, kBlockN);
  if (st != 0) return st;
  auto kernel = flash_bwd_tc_kernel<D, kWindowCap, kExtra>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s_kv + kBlockN - 1) / kBlockN, a.bh);
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.di, a.dq_acc, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len,
      a.causal, a.scale, a.window, a.softcap, a.ex);
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
               q_seq_len, causal, scale, window, softcap, ex, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 64: return launch_w<64>(a);
    case 128: return launch_w<128>(a);
    default: return -1;
  }
}
