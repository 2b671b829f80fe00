// Flash-attention backward, dQ pass, for Hopper (sm_90a): the first of the
// two-pass backward's kernels (the second is csrc/flash_bwd_dkv.cu).
//
// Replaces flashattention_tpu/ops/backward.py::_dq_kernel (the pallas_call
// at backward.py:858).  It computes what that kernel computes on the
// training path: for each query row i, dQ_i = sum_j dS_ij k_j over the key
// columns it sees, with causal masking at position q_offset + (i mod
// q_seq_len) (the GQA row fold), a sliding window (backward.py:122-130), a
// logit softcap with its derivative on dS (backward.py:219-221, :248-249),
// a live KV length kv_len, a score scale and segment ids (row i sees column
// j only where their ids are equal).  See bwd_common.cuh for the formulas.
// The two-pass scheme is the one the JAX package runs with segment ids
// (backward.py:610-615): the packed training step's path.
//
// Bound on this card: operations, 6 d flops per live pair (q.k, do.v and
// dS k) against q, do, k, v read once.  This first version does them in
// float32 on the CUDA cores.  What the design keeps from a fast kernel: the
// dQ accumulator stays in registers over the whole KV loop, and the loop
// runs only over the tile's live band: it stops at kv_len and at the tile's
// last causal column, and with a window starts at the tile holding the
// first column its smallest position still sees (the clamps of
// dq_kv_index, backward.py:735-743; a tile that crosses a GQA segment
// boundary spans the segment's last position and the next one's first).
// Window and softcap are a compile-time choice (kWindowCap), and so are
// dropout and block masks (kExtra; backward.py:238-246 and the liveness
// table of :196-199, :224): with a block mask the KV loop walks the query
// tile's live key tiles only, and applies element bits in partial ones.
//
// Layout: one block per (bh, kTile query rows); Layout<D>::kTpr threads per
// row, each keeping its chunks of q_i, do_i and dQ_i in registers.  K and V
// are staged in shared memory kTile columns at a time as float32 (32 KB at
// d = 128 and at d = 256), with the columns' segment ids.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::Layout;

template <typename T, int D, bool kWindowCap, bool kExtra>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    T* __restrict__ dq, int rows, int s_kv, int kv_len, int q_offset,
                    int q_seq_len, int causal, float scale, int window, float softcap,
                    const fa::Extras ex) {
  using L = Layout<D>;
  constexpr int kTile = L::kTile;
  constexpr int kTpr = L::kTpr;
  constexpr int kVec = L::kVec;
  constexpr int kChunks = L::kChunks;
  __shared__ float4 k_t[kTile][kVec];
  __shared__ float4 v_t[kTile][kVec];
  __shared__ int seg_t[kTile];
  constexpr int kMaskWords = L::kMaskWords;
  __shared__ unsigned kept_t[kExtra ? kTile * kTile / 32 : 1];
  __shared__ unsigned mask_t[kExtra ? kTile * kMaskWords : 1];

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int part = threadIdx.x % kTpr;
  const int ri = threadIdx.x / kTpr;  // this thread's row in the tile
  const int row = r0 + ri;
  const bool live = row < rows;  // the last query tile may be ragged
  const size_t q_row = static_cast<size_t>(bh) * rows + (live ? row : r0);
  const int win = kWindowCap ? window : 0;  // > 0: windowed
  const float cap = kWindowCap ? softcap : 0.f;

  float4 qr[kChunks], dor[kChunks], acc[kChunks];
  fa_bwd::load_chunks<T, D>(qr, q + q_row * D, part);
  fa_bwd::load_chunks<T, D>(dor, dout + q_row * D, part);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse_r = lse[q_row];
  const float di_r = di[q_row];
  const int lim = fa_bwd::row_limit(row, rows, kv_len, q_offset, q_seq_len, causal);
  const int first = fa_bwd::row_first(row, q_offset, q_seq_len, win);
  const bool has_seg = q_seg != nullptr;
  const int my_seg = has_seg ? q_seg[q_row] : 0;

  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + fa_bwd::tile_last_pos(r0, kTile, rows, q_seq_len) + 1);
  int kv_begin = 0;
  if (win > 0) {
    kv_begin = max(0, q_offset + fa_bwd::tile_first_pos(r0, kTile, rows, q_seq_len) - win + 1);
    kv_begin -= kv_begin % kTile;
  }

  const T* k_head = k + static_cast<size_t>(bh) * s_kv * D;
  const T* v_head = v + static_cast<size_t>(bh) * s_kv * D;
  const int* seg_head = has_seg ? kv_seg + static_cast<size_t>(bh) * s_kv : nullptr;
  const bool dropout = kExtra && ex.threshold != 0;
  int it = 0, it_end = 0;  // a block mask's live key tiles of this query tile
  if constexpr (kExtra) {
    if (ex.bm_ptr != nullptr) {
      it = ex.bm_ptr[blockIdx.x];
      it_end = ex.bm_ptr[blockIdx.x + 1];
    }
  }
  for (int t0 = kv_begin; t0 < kv_end; t0 += kTile) {
    int slot = -1;  // a partial block-mask tile's element bits
    if constexpr (kExtra) {
      if (ex.bm_ptr != nullptr) {
        if (it == it_end) break;
        t0 = ex.bm_idx[it] * kTile;
        if (t0 >= kv_end) break;
        slot = ex.bm_part[it++];
      }
    }
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
    if constexpr (kExtra) {
      if (slot >= 0) fa_bwd::stage_mask<D>(ex, slot, mask_t);
      if (dropout) fa_bwd::stage_kept<D>(ex, bh, r0, t0, q_seq_len, kept_t);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float s = fa_bwd::row_sum<kTpr>(fa_bwd::part_dot<D>(qr, k_t[j], part)) * scale;
      float dp = fa_bwd::row_sum<kTpr>(fa_bwd::part_dot<D>(dor, v_t[j], part));
      const int col = t0 + j;
      bool live_pair = col <= lim && (!kWindowCap || col >= first) &&
                       (!has_seg || seg_t[j] == my_seg);
      if constexpr (kExtra) {
        if (slot >= 0) live_pair = live_pair && fa_bwd::bit(mask_t, ri * 32 * kMaskWords + j);
        if (dropout) dp = fa_bwd::bit(kept_t, ri * kTile + j) ? dp * ex.inv : 0.f;
      }
      const float ds = fa_bwd::p_ds<kWindowCap>(s, dp, lse_r, di_r, live_pair, scale, cap).y;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fa::fma4(acc[c], ds, k_t[j][part + kTpr * c]);
    }
  }

  if (!live) return;
  fa_bwd::store_chunks<T, D>(dq + q_row * D, acc, part);
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  const int* q_seg;
  const int* kv_seg;
  void* dq;
  int bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal;
  float scale;
  int window;
  float softcap;
  fa::Extras ex;
  cudaStream_t stream;
};

template <typename T, int D, bool kWindowCap, bool kExtra>
int launch(const Args& a) {
  constexpr int kTile = Layout<D>::kTile;
  const dim3 grid((a.rows + kTile - 1) / kTile, a.bh);
  flash_bwd_dq_kernel<T, D, kWindowCap, kExtra><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, a.q_seg, a.kv_seg, static_cast<T*>(a.dq),
      a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len, a.causal, a.scale, a.window,
      a.softcap, a.ex);
  return static_cast<int>(cudaGetLastError());
}

// The dropout / block-mask form is built with FA_EXTRA into a library of its
// own (ops/kernels.py), so the two forms compile in parallel.
template <typename T, int D, bool kWindowCap>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return launch<T, D, kWindowCap, true>(a);
#else
  if (a.ex.bm_ptr != nullptr || a.ex.threshold != 0) return -1;
  return launch<T, D, kWindowCap, false>(a);
#endif
}

template <typename T, int D>
int launch_w(const Args& a) {
  return a.window > 0 || a.softcap > 0.f ? launch_x<T, D, true>(a) : launch_x<T, D, false>(a);
}

template <typename T>
int launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_w<T, 16>(a);
    case 32: return launch_w<T, 32>(a);
    case 64: return launch_w<T, 64>(a);
    case 128: return launch_w<T, 128>(a);
    case 256: return launch_w<T, 256>(a);
    default: return -1;
  }
}

}  // namespace

// q, do, dq: (bh, rows, d); k, v: (bh, s_kv, d); lse, di: (bh, rows)
// float32; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither
// null.  All contiguous, on the device; q, k, v, do, dq of one dtype code.
// window <= 0: no sliding window (else it requires causal); softcap <= 0:
// no logit softcap.  bm_*: a block mask's table over (kTile, kTile) tiles by
// query tile, or all null; dropout as in fa_flash_fwd.
extern "C" int fa_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* di,
                               const void* q_seg, const void* kv_seg, void* dq,
                               const void* bm_ptr, const void* bm_idx, const void* bm_part,
                               const void* bm_bits, int bh, int rows, int s_kv, int d,
                               int kv_len, int q_offset, int q_seq_len, int causal,
                               float scale, int window, float softcap, int row_stride,
                               int dropout_seed, int dropout_threshold, float dropout_inv,
                               void* stream) {
  const fa::Extras ex{static_cast<const int*>(bm_ptr), static_cast<const int*>(bm_idx),
                      static_cast<const int*>(bm_part), static_cast<const unsigned*>(bm_bits),
                      row_stride, static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di),
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), dq, bh, rows,
               s_kv, kv_len, q_offset, q_seq_len, causal, scale, window, softcap, ex,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_d<float>(d, a);
  if (dtype == fa::kBFloat16) return launch_d<__nv_bfloat16>(d, a);
  return -1;
}
