// Pieces shared by the flash-attention backward kernels (flash_bwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu, and the row helpers and segment tables
// of the tensor-core forms flash_bwd_tc.cu and flash_bwd_dq_tc.cu).
//
// Every backward kernel recomputes, for each live (query row i, key column j)
// pair, the forward's probability and the score gradient from the saved
// statistics (flashattention_tpu/ops/backward.py:8-13, :216-249):
//   s_ij  = scale * q_i . k_j, capped to cap * tanh(s_ij / cap) with a softcap
//   P_ij  = exp(s_ij - lse_i)                      (0 where masked, exactly)
//   dP_ij = do_i . v_j
//   dS_ij = P_ij * (dP_ij - di_i) * scale * c_ij,  di_i = do_i . o_i
// where c_ij = 1 - (s_ij / cap)^2 is the softcap's derivative, taken at the
// capped score (1 without a cap), and sums dV_j += P_ij do_i,
// dK_j += dS_ij q_i, dQ_i += dS_ij k_j.  A pair is live where the key column
// is below kv_len, at or before the row's causal position and, with a
// sliding window (causal only), after position - window.
//
// Layout common to the three: a block of 256 threads owns Layout<D>::kTile
// rows (query rows or key rows, by kernel); Layout<D>::kTpr threads share a
// row and keep their part of each of its d-vectors in registers as
// interleaved float4 chunks (chunk c of thread `part` is float4 number
// part + kTpr c), so the threads of a row read neighbouring float4 of a
// staged row and every row of a warp reads the same ones (a broadcast).  The
// threads per row grow with D so that a thread keeps at most four chunks of
// each vector (64 floats of k, v, dK, dV plus 32 of q, do in the key-row
// kernels): 4 at d = 16 (64-row tiles), 8 at d = 32-128 (32-row tiles), 16 at
// d = 256 (16-row tiles).  Dot products meet through log2(kTpr) shuffles.
// Everything is float32 on the CUDA cores.
//
// Dropout and block masks are a compile-time form of each kernel (kExtra;
// common.cuh, Extras), beside the window/softcap form (kWindowCap).  With
// Z_ij = keep_ij P_ij / (1 - rate) the dropout backward is
// (backward.py:238-246, :353-378, :487-498)
//   dV_j = sum_i Z_ij do_i,   dP_ij = keep_ij (do_i . v_j) / (1 - rate),
// dS from that dP as above, and di = do_i . o_i unchanged (o is the dropped
// output).  Each tile pair's keep bits are hashed once, into shared memory
// (stage_kept), from the same absolute coordinates as the forward's.  A
// block mask gives the dQ kernel each query tile's live key tiles and the
// key-row kernel each key tile's live query tiles (the transposed table), so
// dead tiles are skipped outright, not masked.
#pragma once

#include "common.cuh"

namespace fa_bwd {

constexpr int kThreads = 256;

template <int D>
struct Layout {
  static constexpr int kTpr = D >= 256 ? 16 : D <= 16 ? 4 : 8;  // threads per row
  static constexpr int kTile = kThreads / kTpr;                 // rows per block and tile
  static constexpr int kVec = D / 4;                            // float4 per row
  static constexpr int kChunks = kVec / kTpr;                   // float4 per thread
  // Words per row of a partial block-mask tile's element bits: pair (i, j)
  // is bit i * 32 kMaskWords + j of its slot.
  static constexpr int kMaskWords = (kTile + 31) / 32;
  static_assert(kChunks >= 1 && kVec % kTpr == 0, "head_dim must be 16, 32, 64, 128 or 256");
};

// Sum of a value over the kTpr threads of a row (all of them get the sum).
template <int kTpr>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kTpr; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// This thread's part of the dot product of two d-vectors, one in registers
// (its chunks) and one staged in shared memory (the whole row).
template <int D>
__device__ __forceinline__ float part_dot(const float4 (&a)[Layout<D>::kChunks],
                                          const float4* row, int part) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c) s += fa::dot4(a[c], row[part + Layout<D>::kTpr * c]);
  return s;
}

// The last key column query row r may see: kv_len - 1, and with causal
// masking at most its position q_offset + (r mod q_seq_len) (the GQA row
// fold).  -1 for a row past the end, so that it sees nothing.
__device__ __forceinline__ int row_limit(int r, int rows, int kv_len, int q_offset,
                                         int q_seq_len, int causal) {
  if (r >= rows) return -1;
  int lim = kv_len - 1;
  if (causal) lim = min(lim, q_offset + r % q_seq_len);
  return lim;
}

// The first key column query row r may see: with a sliding window (window
// > 0, causal only) the first after position - window, else 0.
__device__ __forceinline__ int row_first(int r, int q_offset, int q_seq_len, int window) {
  return window > 0 ? max(0, q_offset + r % q_seq_len - window + 1) : 0;
}

// The largest and the smallest position of the query rows [r0, r0 + tile):
// the last and the first row's, or, for a tile that crosses a GQA segment
// boundary, the segment's last and the next segment's first (0).
__device__ __forceinline__ int tile_last_pos(int r0, int tile, int rows, int q_seq_len) {
  const int r1 = min(rows, r0 + tile) - 1;
  return (r0 / q_seq_len == r1 / q_seq_len) ? r1 % q_seq_len : q_seq_len - 1;
}

__device__ __forceinline__ int tile_first_pos(int r0, int tile, int rows, int q_seq_len) {
  const int r1 = min(rows, r0 + tile) - 1;
  return (r0 / q_seq_len == r1 / q_seq_len) ? r0 % q_seq_len : 0;
}

// P_ij and dS_ij of one pair (.x, .y) from its scaled score s = scale q.k,
// dP_ij = do.v and its row's lse and di; 0 for a pair that is not `live`.
// With kWindowCap and a cap > 0 the score is capped first, and dS takes the
// cap's derivative at the capped score s_c: d(cap tanh(s / cap))/ds =
// 1 - tanh^2(s / cap) = 1 - (s_c / cap)^2 (backward.py:219-221, :248-249).
template <bool kWindowCap>
__device__ __forceinline__ float2 p_ds(float s, float dp, float lse, float di, bool live,
                                       float scale, float cap) {
  if constexpr (kWindowCap) {
    if (cap > 0.f) {
      const float s_c = fa::softcap(s, cap);
      const float t = s_c / cap;
      const float p = live ? expf(s_c - lse) : 0.f;
      return make_float2(p, p * (dp - di) * scale * (1.f - t * t));
    }
  }
  const float p = live ? expf(s - lse) : 0.f;
  return make_float2(p, p * (dp - di) * scale);
}

// Segment ids of the two-pass pair's tensor-core forms (flash_bwd_dq_tc.cu,
// flash_bwd_tc.cu with FA_PAIR): the folded ids of the query rows (bh, rows)
// and key rows (bh, s_kv), and for each head the [min, max] id of every
// kSegTile rows (the last tile's existing rows; ops/backward.py builds them),
// so that a pair of tiles whose ranges are disjoint, and so share no id, is
// skipped.  All null: no segment ids.
constexpr int kSegTile = 64;
struct Segs {
  const int* q;
  const int* kv;
  const int* q_rng;   // (bh, ceil(rows / kSegTile), 2)
  const int* kv_rng;  // (bh, ceil(s_kv / kSegTile), 2)
};

// The [min, max] id of rows [r0, r0 + n) (r0 and n multiples of kSegTile)
// from one head's table of `tiles` entries; an empty range past the end.
__device__ __forceinline__ int2 seg_range(const int* rng, int tiles, int r0, int n) {
  int2 r = make_int2(INT_MAX, INT_MIN);
  for (int t = r0 / kSegTile; t < min(tiles, (r0 + n) / kSegTile); ++t) {
    r.x = min(r.x, rng[2 * t]);
    r.y = max(r.y, rng[2 * t + 1]);
  }
  return r;
}

// Whether two id ranges overlap: disjoint ones share no id.
__device__ __forceinline__ bool seg_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// Bit n of a bit array held in 32-bit words.
__device__ __forceinline__ bool bit(const unsigned* words, int n) {
  return (words[n >> 5] >> (n & 31)) & 1u;
}

// The dropout keep bits of the tile pair (query rows [r0, r0 + kTile), key
// columns [c0, c0 + kTile)), row-major, 32 to a word: pair (i, j) is bit
// i * kTile + j.  Each warp hashes 32 pairs at a time and a ballot packs
// them.  Called by every thread of the block.
template <int D>
__device__ __forceinline__ void stage_kept(const fa::Extras& ex, int bh, int r0, int c0,
                                           int q_seq_len, unsigned* kept_t) {
  constexpr int kTile = Layout<D>::kTile;
  const int lane = threadIdx.x % 32;
  for (int w = threadIdx.x / 32; w < kTile * kTile / 32; w += kThreads / 32) {
    const int p = w * 32 + lane;
    const bool kept = fa::dropout_kept(fa::dropout_row_key(ex, bh, r0 + p / kTile, q_seq_len),
                                       c0 + p % kTile, ex.threshold);
    const unsigned word = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) kept_t[w] = word;
  }
}

// Copy partial tile `slot`'s element bits to shared memory.
template <int D>
__device__ __forceinline__ void stage_mask(const fa::Extras& ex, int slot, unsigned* mask_t) {
  constexpr int kWords = Layout<D>::kTile * Layout<D>::kMaskWords;
  for (int i = threadIdx.x; i < kWords; i += kThreads)
    mask_t[i] = ex.bm_bits[static_cast<size_t>(slot) * kWords + i];
}

// Load the d-vector chunks of one row that this thread keeps.
template <typename T, int D>
__device__ __forceinline__ void load_chunks(float4 (&dst)[Layout<D>::kChunks], const T* row,
                                            int part) {
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c)
    dst[c] = fa::load4(row + 4 * (part + Layout<D>::kTpr * c));
}

template <typename T, int D>
__device__ __forceinline__ void store_chunks(T* row, const float4 (&src)[Layout<D>::kChunks],
                                             int part) {
#pragma unroll
  for (int c = 0; c < Layout<D>::kChunks; ++c)
    fa::store4(row + 4 * (part + Layout<D>::kTpr * c), src[c]);
}

// Stage the query-side rows [r0, r0 + kTile) of one head: q and do as
// float32, lse, di, each row's first and last visible column (row_first,
// row_limit) and its segment id.  Rows past the end are zeros with limit -1.
template <typename T, int D>
__device__ __forceinline__ void stage_q_rows(
    const T* q_head, const T* do_head, const float* lse_head, const float* di_head,
    const int* qseg_head, int r0, int rows, int kv_len, int q_offset, int q_seq_len,
    int causal, int window, float4 (*q_t)[D / 4], float4 (*do_t)[D / 4], float* lse_t,
    float* di_t, int* first_t, int* lim_t, int* seg_t) {
  using L = Layout<D>;
  for (int idx = threadIdx.x; idx < L::kTile * L::kVec; idx += kThreads) {
    const int i = idx / L::kVec;
    const int c = idx % L::kVec;
    const int r = r0 + i;
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
    if (r < rows) {
      const size_t off = static_cast<size_t>(r) * D + 4 * c;
      qx = fa::load4(q_head + off);
      dx = fa::load4(do_head + off);
    }
    q_t[i][c] = qx;
    do_t[i][c] = dx;
  }
  if (threadIdx.x < L::kTile) {
    const int i = threadIdx.x;
    const int r = r0 + i;
    const bool in = r < rows;
    lse_t[i] = in ? lse_head[r] : 0.f;
    di_t[i] = in ? di_head[r] : 0.f;
    first_t[i] = row_first(r, q_offset, q_seq_len, window);
    lim_t[i] = row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);
    seg_t[i] = (in && qseg_head != nullptr) ? qseg_head[r] : 0;
  }
}

}  // namespace fa_bwd
