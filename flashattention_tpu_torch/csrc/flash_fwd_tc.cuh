// Flash-attention forward on Hopper's tensor cores (sm_90a): the kernel
// template of flash_fwd_tc.cu, of chunked-prefill attention over a paged KV
// cache (the paged form, paged_prefill_tc.cu) and of the probes in
// probe_mma.cu.
//
// Replaces flashattention_tpu/ops/flash.py::_kernel (the Pallas forward,
// pallas_call in _flash_attention) for bf16 q/k/v at head_dim 64, 128 and
// 256: causal masking at position q_offset + (r mod q_seq_len) (the GQA row
// fold), kv_len, the score scale and a ragged S, a sliding window and a
// logit softcap (the compile-time form kWindowCap), segment ids, the softmax
// statistics (l, m) in float32, and attention dropout and block-sparse
// masks in the compile-time form kExtra (built with FA_EXTRA), with the hash
// of common.cuh bit for bit.
//
// Bound on this card: at the prefill and training shapes (S >= 1024, d >=
// 64) attention is bound by operations: 4 d flops a live (row, column) pair
// against 2 d bytes of K/V per query tile.  So the two products run on the
// tensor cores, bf16 x bf16 -> float32 (989 TFLOP/s dense, 15x the CUDA
// cores' float32 rate), and the softmax around them is kept to what each
// thread owns of the accumulator.
//
// Design: one block per (bh, 128 query rows), 384 threads.  Warpgroup 0 is
// the producer: after setmaxnreg gives up its registers, one warp loads Q
// once by TMA and keeps the K/V tiles (kBlockN rows) of a 2-stage ring in
// shared memory in flight, each stage guarded by a full and an empty
// mbarrier.  Warpgroups 1 and 2 are the consumers, 64 query rows each, with
// 240 registers a thread.  Per KV tile: S = Q K^T by wgmma m64nNk16 with both
// operands read from the swizzled tiles; the online softmax on the
// accumulator itself (each thread owns two rows of each 16-row slab, so a
// row's max needs two quad shuffles, and l stays a per-thread partial sum
// until the end); masks, softcap and the dropout hash from each element's
// (row, column); P split into two bf16 terms in registers and fed as the
// register A operand of O += P V, V read from shared memory in its MN-major
// (transposed) form, 64 columns of d at a time, each tile's part added to
// O in float32.  The KV loop skips what the scalar kernel skips: it
// starts at the first tile the window of the block's smallest position
// reaches and stops at the causal diagonal of its largest and at kv_len; a
// consumer whose own rows see none of a tile only waits for it and frees
// it, and only tiles that cross a bound are masked element by element: the
// scale-and-mask loop is built in three forms (fa::with_mask_form) and each
// tile takes one, so a tile no mask reaches runs a loop with no test in it
// (the per-score test of a runtime flag cost the unmasked tiles about 1.7x
// on this card, PERF.md PR 20).  Rows past the end and K/V rows past kv_len
// arrive from TMA as zeros.
//
// Block masks (kExtra; ops/flash.py::BlockMask, the Pallas kernel's
// pair-table grid, flash.py:445-466 and :845-858): the host classifies the
// mask over this kernel's (128, kN) tiles once and caches the table on the
// device (common.cuh, Extras).  The Pallas grid over the live (q block, kv
// block) pairs becomes a loop inside the block over its query tile's row of
// the table: producer and consumers both take KV tile i from bm_idx, so a
// dead tile is never loaded by TMA and never computed, and a partial tile's
// element bits (each consumer thread its two rows' words, read once a
// tile) mask S where the segment ids and the causal bound do, before the
// online max: a tile whose bits are its only mask takes one test a score
// (kMaskBits), a full tile none.  At d = 256 the 64 x 256 float32 O is 128
// registers a thread, so the KV tile is 64 rows there (128 below), and Q
// (64 KB) plus two stages of K and V (128 KB) fill 192 KB of shared memory.
//
// Rounding: P (against the running max of the tiles seen so far) enters the
// PV product as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each
// with its own wgmma, so that the product sees p to about 2^-17 where the
// Pallas kernel's bf16 mode rounds it once (flash.py:149); l sums the
// float32 p.  A single rounding moves an output row whose weight sits on a
// few keys by a unit of bf16 whenever the kernel's and any other sum of the
// same scores round one p apart, which no element-wise check can hold;
// the second term costs a second PV product (probe_mma.cu measures it).
// ops/flash.py::flash_attention_plain mirrors this form (TC_KV_TILE).
//
// kPaged (paged_prefill_tc.cu): K and V come from a page pool through each
// request's page table, the request's context length and the position of its
// chunk's first row are read on the device (Paged), and rows that see no
// column are written as zeros; see paged_prefill_tc.cu.
//
// kKV (1 int8, 2 fp8 e4m3; 0 bf16): 8-bit K/V payloads with float32
// per-row scales, flat (BH, S_kv) or, paged, scale pools (P, KVH, ps) read
// through the page table.  Replaces the Pallas kernels' quantized path
// (flash.py:816-828, 968-978; decode.py:453, 481) in its order: the payload
// converted to bf16 (exact), the bf16 QK^T product on wgmma, score column j
// times k_scale[j], then the scale, softcap and masks; v_scale[j] folded
// into P's column j before its two-term split for PV.  The TMA ring carries
// the 8-bit tiles (whole rows of d bytes, unswizzled: half the bytes of a
// bf16 ring), and one bf16 K tile and one bf16 V tile take the converted
// stage: both consumer warpgroups convert it into the swizzled layout wgmma
// reads (rows outside [first, end) as zeros, so stale bytes, an fp8 NaN
// among them, never reach a product) and stage its scales (0 outside), then
// fence.proxy.async and a named barrier; the 8-bit stage is freed at once.
// The price: two barriers a tile (before the conversion, so that neither
// warpgroup still reads the last tile's bf16 copy, and after it), which put
// the two warpgroups in lockstep.  Shared memory at d = 256: Q 64 KB, the
// 8-bit ring 64 KB, the bf16 K and V 64 KB (192 KB, as the bf16 form's);
// 160 KB at d = 128.
//
// kTerms (1, 3 or 4; 0 for bf16 inputs): float32 q, k and v as two bf16 terms,
// the JAX package's "bf16_3x" precision (flash.py:136-181; its lane-packed
// form at d <= 64, :783-797, :955-967), built with FA_F32.  A split pass
// (flash_fwd_tc.cu) writes each row as [hi | lo], hi = bf16(x) and lo =
// bf16(x - hi): the same bytes as float32, stored and loaded as a bf16 row
// of width 2 D.  So the ring, the tensor maps and the shared-memory layout
// are the bf16 form's at width 2 D (Cfg<2 D>: 128-row KV tiles at D = 64,
// 64-row ones at D = 128, where Q's two terms take 64 KB and two stages of K
// and V 128 KB), and the products pick their terms by chunk descriptor: S
// sums q_hi k_hi + q_hi k_lo + q_lo k_hi (+ q_lo k_lo at kTerms 4, JAX's
// packed form at d = 64), each a chain of wgmmas into the one float32
// accumulator; P, float32 after the online softmax, enters PV as its two
// bf16 terms against V's: p_hi v_hi + p_lo v_hi + p_hi v_lo (+ p_lo v_lo at
// kTerms 4), each V chunk's part summed afresh and added to O in float32.
// l sums the float32 p; O is stored in float32 (Paged::o32, also set in
// the flat form).  JAX's "bf16" mode for float32 inputs is kTerms 1: the
// bf16 form over a one-term split (bf16(x)), with O in float32.  With
// kExtra (flash_fwd_tc_f32_extra) the float32 forms take attention dropout
// as the bf16 form does, and as the Pallas kernel orders it (flash.py:931-
// 967): p dropped with 1 / (1 - rate) before its two-term split, l the
// undropped sum; not block masks (their tables are built over the bf16
// form's tiles, and the float32 KV tile differs at d = 128).
//
// kProbe (probe_mma.cu only): 1 runs the QK^T products and the softmax
// without the PV products, 2 the PV products on a constant P without the
// rest; 3 the "local" softmax (each tile's p against the tile's own max,
// its PV part and its sum then rescaled by exp(m_tile - m_next)); 4 and 5
// the tiles dealt round-robin to 2 and 4 independent (m, l, O) chains,
// merged in the epilogue; 0 is the kernel.
#pragma once

#include "common.cuh"
#include "tc_common.cuh"

namespace fwd_tc {

constexpr int kBlockM = 128;  // query rows per block
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D, int kKV = 0>
struct Cfg {
  static constexpr bool kQuant = kKV != 0;
  static constexpr int kN = D >= 256 ? 64 : 128;            // KV rows per tile
  static constexpr int kChunks = D / tc::kChunk;
  static constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;   // one chunk of Q
  static constexpr int kKVChunk = kN * tc::kChunkRowBytes;       // one chunk of a K/V tile
  static constexpr int kTileBytes = kChunks * kKVChunk;          // a bf16 K or V tile
  // A ring stage's K or V tile, and how TMA loads it: bf16 in kChunks boxes
  // of 128-byte rows; 8-bit in one box of D-byte rows.
  static constexpr int kStageBytes = kQuant ? kN * D : kTileBytes;
  static constexpr int kLoads = kQuant ? 1 : kChunks;
  static constexpr int kRowBytes = kQuant ? D : tc::kChunkRowBytes;
  // Q | K stages | V stages | (8-bit: bf16 K | bf16 V | K, V scales) | kv
  // segment ids by stage | barriers
  static constexpr int kK = kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kStageBytes;
  static constexpr int kKb = kV + kStages * kStageBytes;
  static constexpr int kVb = kKb + (kQuant ? kTileBytes : 0);
  static constexpr int kScales = kVb + (kQuant ? kTileBytes : 0);
  static constexpr int kSeg = kScales + (kQuant ? 2 * kN * 4 : 0);
  static constexpr int kBar = kSeg + kStages * kN * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;  // + alignment
};

// The 8-bit form's conversion of one staged K or V tile (kN rows of D
// payload bytes) into the bf16 tile wgmma reads (D / 64 chunks of kN rows x
// 128 bytes, 16-byte unit u of row r at u ^ (r % 8)), by the 256 consumer
// threads (ct): each takes 8 payload bytes of a row, neighbouring threads
// neighbouring bytes, and writes one 16-byte unit.  Rows outside [lo, hi)
// are written as zeros without being read.
template <int D, int kKV, int kN>
__device__ __forceinline__ void convert_tile(const unsigned char* src, unsigned char* dst, int lo,
                                             int hi, int ct) {
  constexpr int kGroups = D / 8;  // 8-byte groups of a payload row
#pragma unroll 4
  for (int u = ct; u < kN * kGroups; u += 256) {
    const int row = u / kGroups, grp = u % kGroups;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row >= lo && row < hi)
      out = tc::cvt8_bf16<kKV>(*reinterpret_cast<const uint2*>(src + row * D + grp * 8));
    const int unit = grp % 8;
    *reinterpret_cast<uint4*>(dst + (grp / 8) * kN * tc::kChunkRowBytes +
                              row * tc::kChunkRowBytes + ((unit ^ (row % 8)) * 16)) = out;
  }
}

// The KV columns [kv_begin, kv_end) the query rows [r0, r0 + kRows) may
// see, kv_begin a multiple of the tile: the same in producer and consumers.
struct Range {
  int begin, end, first;  // first: begin before its rounding to the tile
};
template <int kN, bool kWindowCap, int kRows = kBlockM>
__device__ __forceinline__ Range kv_range(int r0, int rows, int kv_len, int q_offset,
                                          int q_seq_len, int causal, int window) {
  const int r1 = min(rows, r0 + kRows) - 1;
  const bool one_segment = r0 / q_seq_len == r1 / q_seq_len;
  Range r{0, kv_len, 0};
  if (causal) r.end = min(r.end, q_offset + (one_segment ? r1 % q_seq_len : q_seq_len - 1) + 1);
  if (kWindowCap && window > 0) {
    r.first = max(0, q_offset + (one_segment ? r0 % q_seq_len : 0) - window + 1);
    r.begin = r.first - r.first % kN;
  }
  return r;
}

// The paged form's arguments: per request b = blockIdx.z, its table row
// page_indices[b] (pages_per_seq entries) and its context ctx_lens[b]; row r
// of the chunk sits at ctx_lens[b] - chunk + r % q_seq_len.  With o32, O
// is written there in float32, straight from the float32 sums (float32 q over
// bf16 or 8-bit pages, taken in bf16 as the Pallas kernel takes it,
// decode.py:440-445, whose output is q's type), and `o` is not written; the
// flat form reads o32 alone, in its float32 forms (kTerms) and its 8-bit
// forms (kKV: float32 q taken in bf16, flash.py:825).
struct Paged {
  const int* page_indices;
  const int* ctx_lens;
  int pages_per_seq, page_size, chunk;
  float* o32;
};

// The width of the rows the ring carries: two bf16 terms of a float32 row.
template <int D, int kTerms>
constexpr int kStoredWidth = kTerms >= 3 ? 2 * D : D;

template <int D, bool kWindowCap, bool kExtra, int kProbe, bool kPaged, int kKV = 0,
          int kTerms = 0>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out, float* __restrict__ m_out,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int rows,
                    int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                    int window, float softcap, const fa::Extras ex, const Paged pg,
                    const float* __restrict__ k_scales, const float* __restrict__ v_scales) {
  static_assert(kTerms == 0 || ((kTerms == 1 || kTerms == 3 || kTerms == 4) && kKV == 0 &&
                                 !kPaged && kProbe == 0),
                "float32 inputs: the flat form only (with kExtra: dropout, no block mask)");
  using C = Cfg<kStoredWidth<D, kTerms>, kKV>;
  constexpr int kN = C::kN;
  // Chunks of one term of a row, and the products of S: (q term, k term)
  // pairs (0, 0), (0, 1), (1, 0), (1, 1), the first kQK of them.
  constexpr int kLC = D / tc::kChunk;
  constexpr int kQK = kTerms >= 3 ? kTerms : 1;
  constexpr bool kLocal = kProbe == 3;
  constexpr int kChains = kProbe == 4 ? 2 : kProbe == 5 ? 4 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  int* seg_t = reinterpret_cast<int*>(smem + C::kSeg);

  // Paged: grid (row tiles, KV heads, requests); q and o are (B, KVH, rows, d).
  const int bh = kPaged ? blockIdx.z * gridDim.y + blockIdx.y : blockIdx.y;
  if constexpr (kPaged) {
    const int ctx = pg.ctx_lens[blockIdx.z];
    kv_len = min(ctx, pg.pages_per_seq * pg.page_size);
    q_offset = ctx - pg.chunk;
  }
  // The longest query tiles (causal: the last) first, for a shorter tail.
  const bool use_bm = kExtra && ex.bm_ptr != nullptr;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int r0 = qt * kBlockM;
  const bool has_seg = q_seg != nullptr;
  const Range kv = kv_range<kN, kWindowCap>(r0, rows, kv_len, q_offset, q_seq_len, causal, window);
  int n_tiles = kv.end > kv.begin ? (kv.end - kv.begin + kN - 1) / kN : 0;
  // A block mask walks the query tile's live KV tiles instead, bm_idx[bm.x
  // + i] for i < n_tiles (those below kv_len): a dead tile is never loaded.
  int2 bm = make_int2(0, 0);
  if (use_bm) {
    bm = fa::bm_walk(ex, qt, kN, kv.end);
    n_tiles = bm.y;
  }

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
      tc::mbar_arrive_tx(q_bar, C::kChunks * C::kQChunk);
      for (int c = 0; c < C::kChunks; ++c)
        tc::tma_load(smem + c * C::kQChunk, &tm_q, q_bar, c * tc::kChunk, r0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      const int t0 = use_bm ? ex.bm_idx[bm.x + i] * kN : kv.begin + i * kN;
      if constexpr (kPaged) {
        // The tile in boxes of min(kN, page_size) rows, each inside one
        // page: only those that hold a column in [kv.first, kv.end), so no
        // table entry outside the pages the block needs is read.
        if (lane == 0) {
          const int box = min(kN, pg.page_size);
          const int* table = pg.page_indices + static_cast<size_t>(blockIdx.z) * pg.pages_per_seq;
          int n_box = 0;
          for (int j = 0; j < kN; j += box) n_box += t0 + j + box > kv.first && t0 + j < kv.end;
          tc::mbar_arrive_tx(&full[s], 2 * C::kLoads * n_box * box * C::kRowBytes);
          for (int j = 0; j < kN; j += box) {
            const int t = t0 + j;
            if (t + box <= kv.first || t >= kv.end) continue;
            const int page = table[t / pg.page_size];
            for (int c = 0; c < C::kLoads; ++c) {
              const int off = s * C::kStageBytes + c * C::kKVChunk + j * C::kRowBytes;
              tc::tma_load4(smem + C::kK + off, &tm_k, &full[s], c * tc::kChunk, t % pg.page_size,
                            blockIdx.y, page);
              tc::tma_load4(smem + C::kV + off, &tm_v, &full[s], c * tc::kChunk, t % pg.page_size,
                            blockIdx.y, page);
            }
          }
        } else {
          tc::mbar_arrive(&full[s]);
        }
        continue;
      }
      if (has_seg)
        for (int j = lane; j < kN; j += 32)
          seg_t[s * kN + j] = t0 + j < kv_len ? kv_seg[static_cast<size_t>(bh) * s_kv + t0 + j] : 0;
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * C::kStageBytes);
        for (int c = 0; c < C::kLoads; ++c) {
          tc::tma_load(smem + C::kK + s * C::kStageBytes + c * C::kKVChunk, &tm_k, &full[s],
                       c * tc::kChunk, t0, bh);
          tc::tma_load(smem + C::kV + s * C::kStageBytes + c * C::kKVChunk, &tm_v, &full[s],
                       c * tc::kChunk, t0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
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
  const int pos_a = q_offset + ra % q_seq_len, pos_b = q_offset + rb % q_seq_len;
  // The positions this warpgroup's rows span (a GQA segment crossing: all).
  const bool wg_live = rw0 < rows;
  const int rw1 = min(rows, rw0 + 64) - 1;
  const bool wg_one = rw0 / q_seq_len == rw1 / q_seq_len;
  const int pmin = q_offset + (wg_one ? rw0 % q_seq_len : 0);
  const int pmax = q_offset + (wg_one ? rw1 % q_seq_len : q_seq_len - 1);
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const int seg_a = has_seg && ra < rows ? q_seg[static_cast<size_t>(bh) * rows + ra] : 0;
  const int seg_b = has_seg && rb < rows ? q_seg[static_cast<size_t>(bh) * rows + rb] : 0;
  unsigned key_a = 0, key_b = 0;
  const bool dropout = kExtra && ex.threshold != 0;
  if (dropout) {
    key_a = fa::dropout_row_key(ex, bh, ra, q_seq_len);
    key_b = fa::dropout_row_key(ex, bh, rb, q_seq_len);
  }

  // One (m, l, O) chain, or kChains of them (probe modes 4 and 5).
  float acc[kChains][D / 2];
  float m_a[kChains], m_b[kChains], l_a[kChains], l_b[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[c][i] = 0.f;
    m_a[c] = m_b[c] = -INFINITY;
    l_a[c] = l_b[c] = 0.f;
  }
  const uint32_t q_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  // The 8-bit form frees a stage once it is converted, unless the masks
  // still read its segment ids.
  const bool early_free = C::kQuant && !has_seg;
  tc::mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int t0 = use_bm ? ex.bm_idx[bm.x + i] * kN : kv.begin + i * kN;
    const int slot = use_bm ? ex.bm_part[bm.x + i] : -1;  // a partial tile's element bits
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    if constexpr (C::kQuant) {
      // The 8-bit stage into the bf16 K and V tiles and the scales, once
      // neither warpgroup reads the last tile's (rows outside [kv.first,
      // kv.end) as zeros: unloaded boxes, pages past ctx_len, stale bytes).
      const int lo = kv.first - t0, hi = kv.end - t0, ct = threadIdx.x - 128;
      tc::named_sync(1, 256);
      convert_tile<D, kKV, kN>(smem + C::kK + s * C::kStageBytes, smem + C::kKb, lo, hi, ct);
      convert_tile<D, kKV, kN>(smem + C::kV + s * C::kStageBytes, smem + C::kVb, lo, hi, ct);
      if (ct < 2 * kN) {
        const int row = ct % kN, col = t0 + row;
        const float* scales = ct < kN ? k_scales : v_scales;
        float x = 0.f;
        if (row >= lo && row < hi) {
          size_t at = static_cast<size_t>(bh) * s_kv + col;
          if constexpr (kPaged) {
            const int page = pg.page_indices[static_cast<size_t>(blockIdx.z) * pg.pages_per_seq +
                                             col / pg.page_size];
            at = (static_cast<size_t>(page) * gridDim.y + blockIdx.y) * pg.page_size +
                 col % pg.page_size;
          }
          x = __ldg(scales + at);
        }
        reinterpret_cast<float*>(smem + C::kScales)[ct] = x;
      }
      tc::fence_async_smem();
      tc::named_sync(1, 256);
      if (early_free) tc::mbar_arrive(&empty[s]);
    } else if constexpr (kPaged) {
      // V rows outside [kv.first, kv.end) (boxes not loaded, the last live
      // page past ctx_len) may hold anything, NaN too, and P = 0 times NaN
      // is NaN: both consumer warpgroups zero them before either reads V.
      if (t0 < kv.first || t0 + kN > kv.end) {
        const int lo = kv.first - t0, hi = kv.end - t0;
        uint4* vt = reinterpret_cast<uint4*>(smem + C::kV + s * C::kTileBytes);
        for (int u = threadIdx.x - 128; u < C::kChunks * kN * 8; u += 256) {
          const int row = (u / 8) % kN;  // 16-byte unit u of row `row` of its chunk
          if (row < lo || row >= hi) vt[u] = make_uint4(0u, 0u, 0u, 0u);
        }
        tc::fence_async_smem();
        tc::named_sync(1, 256);
      }
    }
    const bool skip = !wg_live || (causal && t0 > pmax) || (win > 0 && t0 + kN - 1 <= pmin - win);
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      if (skip || i % kChains != ch) continue;
      const uint32_t k_base =
          tc::smem_u32(smem + (C::kQuant ? C::kKb : C::kK + s * C::kTileBytes));
      const uint32_t v_base =
          tc::smem_u32(smem + (C::kQuant ? C::kVb : C::kV + s * C::kTileBytes));
      const float* ks_t = reinterpret_cast<const float*>(smem + C::kScales);  // 8-bit: k, v scales
      const float* vs_t = ks_t + kN;
      float sc[kN / 2];
      float beta_a = 1.f, beta_b = 1.f;  // the tile's factor (the local softmax's)
      if constexpr (kProbe != 2) {
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // a k-step inside the swizzled row
#pragma unroll
          for (int pr = 0; pr < kQK; ++pr) {  // the chunk of q's term pr / 2, k's pr % 2
            const int qc = (pr / 2) * kLC + kk / 4, kc = (pr % 2) * kLC + kk / 4;
            const uint64_t da = tc::make_desc(q_base + qc * C::kQChunk + off, 16, 1024);
            const uint64_t db = tc::make_desc(k_base + kc * C::kKVChunk + off, 16, 1024);
            tc::wgmma_ss<0, 0>(sc, da, db, kk > 0 || pr > 0);
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(sc);
        // A partial tile's element bits of rows ra and rb.
        unsigned bits_a[kN / 32], bits_b[kN / 32];
        fa::tile_bits<kBlockM, kN>(ex.bm_bits, slot, ra - r0, t, bits_a, bits_b);

        // The bounds' and segment ids' masks, or a partial tile's bits alone
        // (fa::with_mask_form).
        const bool need_mask = has_seg || t0 + kN > kv_len || t0 + kN > kv.end ||
                               (causal && t0 + kN - 1 > pmin) || (win > 0 && t0 <= pmax - win);
        float mx_a = kLocal ? -INFINITY : m_a[ch], mx_b = kLocal ? -INFINITY : m_b[ch];
        fa::with_mask_form(need_mask, slot >= 0, [&](auto form) {
          constexpr int kForm = decltype(form)::value;
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = sc[4 * j + e];
              if constexpr (C::kQuant) x *= ks_t[8 * j + 2 * t + (e & 1)];
              x *= scale;
              if (kWindowCap && cap > 0.f) x = fa::softcap(x, cap);
              if constexpr (kForm != fa::kMaskNone) {
                const bool bit =
                    e < 2 ? fa::tile_bit(bits_a, j, e & 1) : fa::tile_bit(bits_b, j, e & 1);
                bool keep = bit;
                if constexpr (kForm == fa::kMaskAll) {
                  const int col = t0 + 8 * j + 2 * t + (e & 1);
                  const int pos = e < 2 ? pos_a : pos_b;
                  keep = keep && col < kv_len && (!causal || col <= pos) &&
                         (win <= 0 || col > pos - win) &&
                         (!has_seg || seg_t[s * kN + col - t0] == (e < 2 ? seg_a : seg_b));
                }
                if (!keep) x = fa::kMaskValue;
              }
              sc[4 * j + e] = x;
              if (e < 2) mx_a = fmaxf(mx_a, x);
              else mx_b = fmaxf(mx_b, x);
            }
          }
        });
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        // exp(s - m) as 2^((s - m) log2 e), the difference taken first.
        float alpha_a, alpha_b;
        if constexpr (kLocal) {  // p against the tile's max mx, then scaled by beta
          const float mn_a = fmaxf(m_a[ch], mx_a), mn_b = fmaxf(m_b[ch], mx_b);
          alpha_a = tc::ex2((m_a[ch] - mn_a) * tc::kLog2e);
          alpha_b = tc::ex2((m_b[ch] - mn_b) * tc::kLog2e);
          beta_a = tc::ex2((mx_a - mn_a) * tc::kLog2e);
          beta_b = tc::ex2((mx_b - mn_b) * tc::kLog2e);
          m_a[ch] = mn_a;
          m_b[ch] = mn_b;
        } else {
          alpha_a = tc::ex2((m_a[ch] - mx_a) * tc::kLog2e);
          alpha_b = tc::ex2((m_b[ch] - mx_b) * tc::kLog2e);
          m_a[ch] = mx_a;
          m_b[ch] = mx_b;
        }
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = tc::ex2((sc[4 * j + e] - (e < 2 ? mx_a : mx_b)) * tc::kLog2e);
            if (e < 2) sum_a += p;
            else sum_b += p;
            if constexpr (C::kQuant) p *= vs_t[8 * j + 2 * t + (e & 1)];  // v_scale into P
            if (dropout) {  // l keeps the undropped sum; the PV product takes the kept p
              const int col = t0 + 8 * j + 2 * t + (e & 1);
              p = fa::dropout_kept(e < 2 ? key_a : key_b, col, ex.threshold) ? p * ex.inv : 0.f;
            }
            sc[4 * j + e] = p;
          }
        }
        l_a[ch] = alpha_a * l_a[ch] + beta_a * sum_a;
        l_b[ch] = alpha_b * l_b[ch] + beta_b * sum_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[ch][4 * j + 0] *= alpha_a;
          acc[ch][4 * j + 1] *= alpha_a;
          acc[ch][4 * j + 2] *= alpha_b;
          acc[ch][4 * j + 3] *= alpha_b;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) sc[j] = 1.f / kN;
      }
      if constexpr (kProbe != 1) {  // O += P V, P as two bf16 terms
        uint32_t pa[kN / 16][4], pl[kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) tc::pack_a2(pa[kk], pl[kk], sc, kk);
        // 64 columns of d at a time: each tile's part is summed afresh on
        // the tensor cores and added to O here in float32.  Adding every
        // tile into O on the tensor cores instead chains 2 kN / 16 k-steps
        // a tile through their truncating float32 addition, which moves the
        // small outputs of a peaked softmax (q x 8, S = 5000) by about 1e-5.
        // Two-term V (kTerms): chunk c holds columns c % kLC of V's term
        // c / kLC, and both terms' parts go to the same columns of O; p_lo
        // meets v_lo only at kTerms 4.
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const bool p_lo = kTerms != 3 || c < kLC;
          float part[32];
          tc::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            const uint64_t db = tc::make_desc(
                v_base + c * C::kKVChunk + kk * 16 * tc::kChunkRowBytes, C::kKVChunk, 1024);
            tc::wgmma_rs<1>(part, pa[kk], db, kk > 0);
            if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(part);
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int at = 32 * (c % kLC) + x;
            if constexpr (kLocal) acc[ch][at] += part[x] * (x % 4 < 2 ? beta_a : beta_b);
            else acc[ch][at] += part[x];
          }
        }
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(pa[kk][w]), "+r"(pl[kk][w])::"memory");
      }
    }
    if (!early_free) tc::mbar_arrive(&empty[s]);
  }

  if constexpr (kChains > 1) {  // merge the chains into chain 0
    float mm_a = m_a[0], mm_b = m_b[0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) {
      mm_a = fmaxf(mm_a, m_a[c]);
      mm_b = fmaxf(mm_b, m_b[c]);
    }
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float fa_ = mm_a == -INFINITY ? 1.f : tc::ex2((m_a[c] - mm_a) * tc::kLog2e);
      const float fb_ = mm_b == -INFINITY ? 1.f : tc::ex2((m_b[c] - mm_b) * tc::kLog2e);
      la += fa_ * l_a[c];
      lb += fb_ * l_b[c];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float a0 = acc[c][4 * j] * fa_, a1 = acc[c][4 * j + 1] * fa_;
        const float b0 = acc[c][4 * j + 2] * fb_, b1 = acc[c][4 * j + 3] * fb_;
        acc[0][4 * j] = c == 0 ? a0 : acc[0][4 * j] + a0;
        acc[0][4 * j + 1] = c == 0 ? a1 : acc[0][4 * j + 1] + a1;
        acc[0][4 * j + 2] = c == 0 ? b0 : acc[0][4 * j + 2] + b0;
        acc[0][4 * j + 3] = c == 0 ? b1 : acc[0][4 * j + 3] + b1;
      }
    }
    m_a[0] = mm_a;
    m_b[0] = mm_b;
    l_a[0] = la;
    l_b[0] = lb;
  }
  float la = l_a[0], lb = l_b[0];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  // The l == 0 guard of the Pallas epilogue (flash.py:1118).
  const float inv_a = la == 0.f ? 1.f : 1.f / la;
  const float inv_b = lb == 0.f ? 1.f : 1.f / lb;
  // Paged: a row that sees no column (a ctx_len == 0 request, a pad row
  // whose window lies past the context) is written as zeros.
  bool seen_a = true, seen_b = true;
  if constexpr (kPaged) {
    seen_a = min(pos_a, kv_len - 1) >= (win > 0 ? max(0, pos_a - win + 1) : 0);
    seen_b = min(pos_b, kv_len - 1) >= (win > 0 ? max(0, pos_b - win + 1) : 0);
  }
  __nv_bfloat16* o_head = o + static_cast<size_t>(bh) * rows * D;
  float* o32_head = nullptr;
  if constexpr (kPaged || kKV != 0 || kTerms != 0) {
    if (pg.o32 != nullptr) o32_head = pg.o32 + static_cast<size_t>(bh) * rows * D;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 xa = seen_a ? make_float2(acc[0][4 * j] * inv_a, acc[0][4 * j + 1] * inv_a)
                             : make_float2(0.f, 0.f);
    const float2 xb = seen_b ? make_float2(acc[0][4 * j + 2] * inv_b, acc[0][4 * j + 3] * inv_b)
                             : make_float2(0.f, 0.f);
    if (o32_head != nullptr) {
      if (ra < rows) *reinterpret_cast<float2*>(o32_head + static_cast<size_t>(ra) * D + c) = xa;
      if (rb < rows) *reinterpret_cast<float2*>(o32_head + static_cast<size_t>(rb) * D + c) = xb;
    } else {
      if (ra < rows)
        *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(ra) * D + c) =
            tc::pack_bf16(xa.x, xa.y);
      if (rb < rows)
        *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(rb) * D + c) =
            tc::pack_bf16(xb.x, xb.y);
    }
  }
  if (l_out != nullptr && t == 0) {
    const size_t head = static_cast<size_t>(bh) * rows;
    if (ra < rows) {
      l_out[head + ra] = la;
      m_out[head + ra] = m_a[0];
    }
    if (rb < rows) {
      l_out[head + rb] = lb;
      m_out[head + rb] = m_b[0];
    }
  }
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;
  float* m;
  const int* q_seg;
  const int* kv_seg;
  int bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal;
  float scale;
  int window;
  float softcap;
  fa::Extras ex;
  cudaStream_t stream;
  const float* k_scales = nullptr;  // 8-bit K/V: (bh, s_kv) or, paged, (P, KVH, ps)
  const float* v_scales = nullptr;
  float* o32 = nullptr;  // float32 O in place of o (float32 inputs)
};

// q, k, v: bf16 rows of kStoredWidth<D, kTerms> (kTerms: [hi | lo]).
template <int D, bool kWindowCap, bool kExtra, int kProbe, int kKV = 0, int kTerms = 0>
int launch(const Args& a) {
  constexpr int W = kStoredWidth<D, kTerms>;
  using C = Cfg<W, kKV>;
  CUtensorMap mq, mk, mv;
  // K/V rows past kv_len read as zeros: V's there may be anything.
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  const int eb = C::kQuant ? 1 : 2;  // K/V element bytes
  int st = tc_encode_map(&mq, a.q, W, a.rows, a.bh, static_cast<long long>(a.rows) * W, kBlockM);
  if (st == 0)
    st = tc_encode_map(&mk, a.k, W, kv_rows, a.bh, static_cast<long long>(a.s_kv) * W, C::kN, eb);
  if (st == 0)
    st = tc_encode_map(&mv, a.v, W, kv_rows, a.bh, static_cast<long long>(a.s_kv) * W, C::kN, eb);
  if (st != 0) return st;
  auto kernel = flash_fwd_tc_kernel<D, kWindowCap, kExtra, kProbe, false, kKV, kTerms>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + kBlockM - 1) / kBlockM, a.bh);
  Paged pg{};
  pg.o32 = a.o32;
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.l, a.m, a.q_seg, a.kv_seg, a.rows, a.s_kv,
      a.kv_len, a.q_offset, a.q_seq_len, a.causal, a.scale, a.window, a.softcap, a.ex, pg,
      a.k_scales, a.v_scales);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd_tc
