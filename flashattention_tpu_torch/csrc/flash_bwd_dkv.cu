// Flash-attention backward, dK/dV pass, for Hopper (sm_90a): the second of
// the two-pass backward's kernels (the first is csrc/flash_bwd_dq.cu).
//
// Replaces flashattention_tpu/ops/backward.py::_dkv_kernel (the pallas_call
// at backward.py:912).  It computes what that kernel computes on the
// training path: for each key row j, dV_j = sum_i P_ij do_i and
// dK_j = sum_i dS_ij q_i over every query row i of its head, with causal
// masking at position q_offset + (i mod q_seq_len), so that the rows of all
// G folded query groups (GQA) sum into their one KV head; a live KV length
// kv_len; a score scale; and segment ids (row i sees column j only where
// their ids are equal).  See bwd_common.cuh for the formulas.
//
// Bound on this card: operations, 8 d flops per live pair (the products
// q.k, do.v, P do and dS q) against q, do, k, v read once.  This first
// version does them in float32 on the CUDA cores, not on the tensor cores.
// What the design keeps from a fast kernel: the dK/dV accumulators stay in
// registers for the whole loop over query rows, and a query tile that lies
// wholly above the diagonal for this key tile is skipped (the clamp of
// dkv_q_index, backward.py:745-763, within each GQA segment: a tile that
// crosses a segment boundary takes the segment's last position).
//
// Layout: one block per (bh, 32 key rows); eight threads per key row, each
// keeping an eighth of k_j, v_j, dK_j and dV_j in registers.  Query rows
// (q, do, lse, di, limit, segment id) are staged in shared memory 32 at a
// time as float32: 2 x 32 x d x 4 bytes = 32 KB at d = 128.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::kThreadsPerRow;
using fa_bwd::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     T* __restrict__ dk, T* __restrict__ dv, int rows, int s_kv,
                     int kv_len, int q_offset, int q_seq_len, int causal, float scale) {
  constexpr int kVec = D / 4;
  constexpr int kChunks = kVec / kThreadsPerRow;
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0, "head_dim must be a multiple of 32");
  __shared__ float4 q_t[kTile][kVec];
  __shared__ float4 do_t[kTile][kVec];
  __shared__ float lse_t[kTile], di_t[kTile];
  __shared__ int lim_t[kTile], seg_t[kTile];

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int part = threadIdx.x % kThreadsPerRow;
  const int col = c0 + threadIdx.x / kThreadsPerRow;
  const bool live = col < s_kv;  // the last key tile may be ragged
  const size_t kv_row = static_cast<size_t>(bh) * s_kv + (live ? col : c0);

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  fa_bwd::load_chunks<T, kChunks>(kr, k + kv_row * D, part);
  fa_bwd::load_chunks<T, kChunks>(vr, v + kv_row * D, part);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[c] = dk_acc[c];
  }
  const bool has_seg = kv_seg != nullptr;
  const int my_seg = has_seg ? kv_seg[kv_row] : 0;

  const size_t head = static_cast<size_t>(bh) * rows;
  // A key tile at or past kv_len is seen by no row: dK = dV = 0.
  for (int r0 = 0; c0 < kv_len && r0 < rows; r0 += kTile) {
    if (causal && q_offset + fa_bwd::tile_last_pos(r0, rows, q_seq_len) < c0) continue;
    __syncthreads();  // every thread is done with the previous query tile
    fa_bwd::stage_q_rows<T, D>(q + head * D, dout + head * D, lse + head, di + head,
                               has_seg ? q_seg + head : nullptr, r0, rows, kv_len,
                               q_offset, q_seq_len, causal, q_t, do_t, lse_t, di_t,
                               lim_t, seg_t);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float4 qi[kChunks], doi[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        qi[c] = q_t[i][part + kThreadsPerRow * c];
        doi[c] = do_t[i][part + kThreadsPerRow * c];
      }
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s += fa::dot4(qi[c], kr[c]);
        dp += fa::dot4(doi[c], vr[c]);
      }
      s = fa_bwd::row_sum(s);
      dp = fa_bwd::row_sum(dp);
      const bool keep = col <= lim_t[i] && (!has_seg || seg_t[i] == my_seg);
      const float p = keep ? expf(s * scale - lse_t[i]) : 0.f;
      const float ds = p * (dp - di_t[i]) * scale;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fa::fma4(dv_acc[c], p, doi[c]);
        fa::fma4(dk_acc[c], ds, qi[c]);
      }
    }
  }

  if (!live) return;
  fa_bwd::store_chunks<T, kChunks>(dk + kv_row * D, dk_acc, part);
  fa_bwd::store_chunks<T, kChunks>(dv + kv_row * D, dv_acc, part);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* di, const int* q_seg, const int* kv_seg, void* dk, void* dv, int bh,
           int rows, int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
           float scale, cudaStream_t stream) {
  const dim3 grid((s_kv + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, q_seg, kv_seg, static_cast<T*>(dk),
      static_cast<T*>(dv), rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* di, const int* q_seg, const int* kv_seg,
             void* dk, void* dv, int bh, int rows, int s_kv, int kv_len, int q_offset,
             int q_seq_len, int causal, float scale, cudaStream_t stream) {
#define FA_CASE(D)                                                                     \
  case D:                                                                              \
    return launch<T, D>(q, k, v, dout, lse, di, q_seg, kv_seg, dk, dv, bh, rows, s_kv, \
                        kv_len, q_offset, q_seq_len, causal, scale, stream);
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

// q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d); lse, di: (bh, rows)
// float32; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither
// null.  All contiguous, on the device; q, k, v, do, dk, dv of one dtype code.
extern "C" int fa_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* di,
                                const void* q_seg, const void* kv_seg, void* dk, void* dv,
                                int bh, int rows, int s_kv, int d, int kv_len, int q_offset,
                                int q_seq_len, int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lf = static_cast<const float*>(lse);
  auto df = static_cast<const float*>(di);
  auto qs = static_cast<const int*>(q_seg);
  auto ks = static_cast<const int*>(kv_seg);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k, v, dout, lf, df, qs, ks, dk, dv, bh, rows, s_kv, kv_len,
                           q_offset, q_seq_len, causal, scale, st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, dout, lf, df, qs, ks, dk, dv, bh, rows, s_kv,
                                   kv_len, q_offset, q_seq_len, causal, scale, st);
  return -1;
}
