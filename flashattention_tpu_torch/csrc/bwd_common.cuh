// Pieces shared by the three flash-attention backward kernels
// (flash_bwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Every backward kernel recomputes, for each live (query row i, key column j)
// pair, the forward's probability and the score gradient from the saved
// statistics (flashattention_tpu/ops/backward.py:8-13):
//   P_ij  = exp(scale * q_i . k_j - lse_i)        (0 where masked, exactly)
//   dP_ij = do_i . v_j
//   dS_ij = P_ij * (dP_ij - di_i) * scale,         di_i = do_i . o_i
// and sums dV_j += P_ij do_i, dK_j += dS_ij q_i, dQ_i += dS_ij k_j.
//
// Layout common to the three: a block owns 32 rows (query rows or key rows,
// by kernel); eight threads share a row and keep an eighth of each of its
// d-vectors in registers as interleaved float4 chunks (chunk c of thread
// `part` is float4 number part + 8 c), so the eight threads of a row read
// eight neighbouring float4 of a staged row and the four rows of a warp read
// the same ones (a broadcast).  Dot products meet through three shuffles.
// Everything is float32 on the CUDA cores.
#pragma once

#include "common.cuh"

namespace fa_bwd {

constexpr int kThreadsPerRow = 8;
constexpr int kTile = 32;                         // rows per block and per staged tile
constexpr int kThreads = kTile * kThreadsPerRow;  // 256

// Sum of a value over the eight threads of a row (all eight get the sum).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// This thread's part of the dot product of two d-vectors, one in registers
// (its chunks) and one staged in shared memory (the whole row).
template <int kChunks>
__device__ __forceinline__ float part_dot(const float4 (&a)[kChunks], const float4* row,
                                          int part) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) s += fa::dot4(a[c], row[part + kThreadsPerRow * c]);
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

// The largest position of the query rows [r0, r0 + kTile): the last row's,
// or, for a tile that crosses a GQA segment boundary, the segment's last.
__device__ __forceinline__ int tile_last_pos(int r0, int rows, int q_seq_len) {
  const int r1 = min(rows, r0 + kTile) - 1;
  return (r0 / q_seq_len == r1 / q_seq_len) ? r1 % q_seq_len : q_seq_len - 1;
}

// Load the d-vector chunks of one row that this thread keeps.
template <typename T, int kChunks>
__device__ __forceinline__ void load_chunks(float4 (&dst)[kChunks], const T* row, int part) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) dst[c] = fa::load4(row + 4 * (part + kThreadsPerRow * c));
}

template <typename T, int kChunks>
__device__ __forceinline__ void store_chunks(T* row, const float4 (&src)[kChunks], int part) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fa::store4(row + 4 * (part + kThreadsPerRow * c), src[c]);
}

// Stage the query-side rows [r0, r0 + kTile) of one head: q and do as
// float32, lse, di, each row's last visible column (row_limit) and its
// segment id.  Rows past the end are zeros with limit -1.
template <typename T, int D>
__device__ __forceinline__ void stage_q_rows(
    const T* q_head, const T* do_head, const float* lse_head, const float* di_head,
    const int* qseg_head, int r0, int rows, int kv_len, int q_offset, int q_seq_len,
    int causal, float4 (*q_t)[D / 4], float4 (*do_t)[D / 4], float* lse_t, float* di_t,
    int* lim_t, int* seg_t) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int i = idx / kVec;
    const int c = idx % kVec;
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
  if (threadIdx.x < kTile) {
    const int i = threadIdx.x;
    const int r = r0 + i;
    const bool in = r < rows;
    lse_t[i] = in ? lse_head[r] : 0.f;
    di_t[i] = in ? di_head[r] : 0.f;
    lim_t[i] = row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);
    seg_t[i] = (in && qseg_head != nullptr) ? qseg_head[r] : 0;
  }
}

}  // namespace fa_bwd
