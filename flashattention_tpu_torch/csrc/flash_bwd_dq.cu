// Flash-attention backward, dQ pass, for Hopper (sm_90a): the first of the
// two-pass backward's kernels (the second is csrc/flash_bwd_dkv.cu).
//
// Replaces flashattention_tpu/ops/backward.py::_dq_kernel (the pallas_call
// at backward.py:858).  It computes what that kernel computes on the
// training path: for each query row i, dQ_i = sum_j dS_ij k_j over the key
// columns it sees, with causal masking at position q_offset + (i mod
// q_seq_len) (the GQA row fold), a live KV length kv_len, a score scale and
// segment ids (row i sees column j only where their ids are equal).  See
// bwd_common.cuh for the formulas.  The two-pass scheme is the one the JAX
// package runs with segment ids (backward.py:610-615): the packed training
// step's path.
//
// Bound on this card: operations, 6 d flops per live pair (q.k, do.v and
// dS k) against q, do, k, v read once.  This first version does them in
// float32 on the CUDA cores.  What the design keeps from a fast kernel: the
// dQ accumulator stays in registers over the whole KV loop, and the loop
// stops at kv_len and at the tile's last causal column (the clamp of
// dq_kv_index, backward.py:735-743; a tile that crosses a GQA segment
// boundary takes the segment's last position).
//
// Layout: one block per (bh, 32 query rows); eight threads per row, each
// keeping an eighth of q_i, do_i and dQ_i in registers.  K and V are staged
// in shared memory 32 columns at a time as float32 (32 KB at d = 128), with
// the columns' segment ids.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::kThreadsPerRow;
using fa_bwd::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    T* __restrict__ dq, int rows, int s_kv, int kv_len, int q_offset,
                    int q_seq_len, int causal, float scale) {
  constexpr int kVec = D / 4;
  constexpr int kChunks = kVec / kThreadsPerRow;
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0, "head_dim must be a multiple of 32");
  __shared__ float4 k_t[kTile][kVec];
  __shared__ float4 v_t[kTile][kVec];
  __shared__ int seg_t[kTile];

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int part = threadIdx.x % kThreadsPerRow;
  const int row = r0 + threadIdx.x / kThreadsPerRow;
  const bool live = row < rows;  // the last query tile may be ragged
  const size_t q_row = static_cast<size_t>(bh) * rows + (live ? row : r0);

  float4 qr[kChunks], dor[kChunks], acc[kChunks];
  fa_bwd::load_chunks<T, kChunks>(qr, q + q_row * D, part);
  fa_bwd::load_chunks<T, kChunks>(dor, dout + q_row * D, part);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse_r = lse[q_row];
  const float di_r = di[q_row];
  const int lim = fa_bwd::row_limit(row, rows, kv_len, q_offset, q_seq_len, causal);
  const bool has_seg = q_seg != nullptr;
  const int my_seg = has_seg ? q_seg[q_row] : 0;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + fa_bwd::tile_last_pos(r0, rows, q_seq_len) + 1);

  const T* k_head = k + static_cast<size_t>(bh) * s_kv * D;
  const T* v_head = v + static_cast<size_t>(bh) * s_kv * D;
  const int* seg_head = has_seg ? kv_seg + static_cast<size_t>(bh) * s_kv : nullptr;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous key tile
    for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
      const int j = idx / kVec;
      const int c = idx % kVec;
      const int col = t0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (col < kv_end) {
        const size_t off = static_cast<size_t>(col) * D + 4 * c;
        kx = fa::load4(k_head + off);
        vx = fa::load4(v_head + off);
      }
      k_t[j][c] = kx;
      v_t[j][c] = vx;
    }
    if (threadIdx.x < kTile) {
      const int col = t0 + threadIdx.x;
      seg_t[threadIdx.x] = (has_seg && col < kv_end) ? seg_head[col] : 0;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float s = fa_bwd::row_sum(fa_bwd::part_dot<kChunks>(qr, k_t[j], part));
      const float dp = fa_bwd::row_sum(fa_bwd::part_dot<kChunks>(dor, v_t[j], part));
      const int col = t0 + j;
      const bool keep = col <= lim && (!has_seg || seg_t[j] == my_seg);
      const float p = keep ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - di_r) * scale;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fa::fma4(acc[c], ds, k_t[j][part + kThreadsPerRow * c]);
    }
  }

  if (!live) return;
  fa_bwd::store_chunks<T, kChunks>(dq + q_row * D, acc, part);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* di, const int* q_seg, const int* kv_seg, void* dq, int bh, int rows,
           int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((rows + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, q_seg, kv_seg, static_cast<T*>(dq), rows, s_kv,
      kv_len, q_offset, q_seq_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* di, const int* q_seg, const int* kv_seg, void* dq,
             int bh, int rows, int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
             float scale, cudaStream_t stream) {
#define FA_CASE(D)                                                                       \
  case D:                                                                                \
    return launch<T, D>(q, k, v, dout, lse, di, q_seg, kv_seg, dq, bh, rows, s_kv, kv_len, \
                        q_offset, q_seq_len, causal, scale, stream);
  switch (d) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default:
      return -1;
  }
#undef FA_CASE
}

}  // namespace

// q, do, dq: (bh, rows, d); k, v: (bh, s_kv, d); lse, di: (bh, rows)
// float32; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither
// null.  All contiguous, on the device; q, k, v, do, dq of one dtype code.
extern "C" int fa_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* di,
                               const void* q_seg, const void* kv_seg, void* dq, int bh,
                               int rows, int s_kv, int d, int kv_len, int q_offset,
                               int q_seq_len, int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lf = static_cast<const float*>(lse);
  auto df = static_cast<const float*>(di);
  auto qs = static_cast<const int*>(q_seg);
  auto ks = static_cast<const int*>(kv_seg);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k, v, dout, lf, df, qs, ks, dq, bh, rows, s_kv, kv_len,
                           q_offset, q_seq_len, causal, scale, st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, dout, lf, df, qs, ks, dq, bh, rows, s_kv,
                                   kv_len, q_offset, q_seq_len, causal, scale, st);
  return -1;
}
