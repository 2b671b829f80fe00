// Flash-attention backward, dK/dV pass, for Hopper (sm_90a): the second of
// the two-pass backward's kernels (the first is csrc/flash_bwd_dq.cu).
//
// Replaces flashattention_tpu/ops/backward.py::_dkv_kernel (the pallas_call
// at backward.py:912).  It computes what that kernel computes on the
// training path: for each key row j, dV_j = sum_i P_ij do_i and
// dK_j = sum_i dS_ij q_i over every query row i of its head, with causal
// masking at position q_offset + (i mod q_seq_len), so that the rows of all
// G folded query groups (GQA) sum into their one KV head; a sliding window
// (backward.py:122-130); a logit softcap with its derivative on dS
// (backward.py:337-339, :381-382); a live KV length kv_len; a score scale;
// and segment ids (row i sees column j only where their ids are equal; a
// packed Gemma-2 step has them and the window together).  See
// bwd_common.cuh for the formulas.
//
// Bound on this card: operations, 8 d flops per live pair (the products
// q.k, do.v, P do and dS q) against q, do, k, v read once.  This first
// version does them in float32 on the CUDA cores, not on the tensor cores.
// What the design keeps from a fast kernel: the dK/dV accumulators stay in
// registers for the whole loop over query rows, and a query tile outside
// this key tile's band is skipped: wholly above the diagonal (the clamp of
// dkv_q_index, backward.py:745-763) or, with a window, past the last tile
// whose window still reaches the key tile (the last_pos bound, :754), each
// within its GQA segment (a tile that crosses a segment boundary takes the
// segment's last position and the next one's first).  Window and softcap
// are a compile-time choice (kWindowCap), and so are dropout and block
// masks (kExtra; backward.py:353-378 and the liveness table of :315-317,
// :342): with a block mask the loop walks the key tile's live query tiles
// (the table transposed on the host), and applies element bits in partial
// ones.
//
// Layout: one block per (bh, kTile key rows); Layout<D>::kTpr threads per
// key row, each keeping its chunks of k_j, v_j, dK_j and dV_j in registers.
// Query rows (q, do, lse, di, first and last column, segment id) are staged
// in shared memory kTile at a time as float32: 2 x kTile x d x 4 bytes =
// 32 KB at d = 128 and at d = 256.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::Layout;

template <typename T, int D, bool kWindowCap, bool kExtra>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     T* __restrict__ dk, T* __restrict__ dv, int rows, int s_kv,
                     int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                     int window, float softcap, const fa::Extras ex) {
  using L = Layout<D>;
  constexpr int kTile = L::kTile;
  constexpr int kTpr = L::kTpr;
  constexpr int kVec = L::kVec;
  constexpr int kChunks = L::kChunks;
  __shared__ float4 q_t[kTile][kVec];
  __shared__ float4 do_t[kTile][kVec];
  __shared__ float lse_t[kTile], di_t[kTile];
  __shared__ int first_t[kTile], lim_t[kTile], seg_t[kTile];
  constexpr int kMaskWords = L::kMaskWords;
  __shared__ unsigned kept_t[kExtra ? kTile * kTile / 32 : 1];
  __shared__ unsigned mask_t[kExtra ? kTile * kMaskWords : 1];

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int part = threadIdx.x % kTpr;
  const int jr = threadIdx.x / kTpr;  // this thread's key row in the tile
  const int col = c0 + jr;
  const bool live = col < s_kv;  // the last key tile may be ragged
  const size_t kv_row = static_cast<size_t>(bh) * s_kv + (live ? col : c0);
  const int win = kWindowCap ? window : 0;  // > 0: windowed
  const float cap = kWindowCap ? softcap : 0.f;

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  fa_bwd::load_chunks<T, D>(kr, k + kv_row * D, part);
  fa_bwd::load_chunks<T, D>(vr, v + kv_row * D, part);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[c] = dk_acc[c];
  }
  const bool has_seg = kv_seg != nullptr;
  const int my_seg = has_seg ? kv_seg[kv_row] : 0;

  const size_t head = static_cast<size_t>(bh) * rows;
  const bool dropout = kExtra && ex.threshold != 0;
  int it = 0, it_end = 0;  // a block mask's live query tiles of this key tile
  if constexpr (kExtra) {
    if (ex.bm_ptr != nullptr) {
      it = ex.bm_ptr[blockIdx.x];
      it_end = ex.bm_ptr[blockIdx.x + 1];
    }
  }
  // A key tile at or past kv_len is seen by no row: dK = dV = 0.
  for (int r0 = 0; c0 < kv_len && r0 < rows; r0 += kTile) {
    int slot = -1;  // a partial block-mask tile's element bits
    if constexpr (kExtra) {
      if (ex.bm_ptr != nullptr) {
        if (it == it_end) break;
        r0 = ex.bm_idx[it] * kTile;
        if (r0 >= rows) break;
        slot = ex.bm_part[it++];
      }
    }
    if (causal && q_offset + fa_bwd::tile_last_pos(r0, kTile, rows, q_seq_len) < c0) continue;
    if (win > 0) {  // the tile's first window column lies past this key tile
      const int win_start =
          q_offset + fa_bwd::tile_first_pos(r0, kTile, rows, q_seq_len) - win + 1;
      if (win_start > c0 + kTile - 1) continue;
    }
    __syncthreads();  // every thread is done with the previous query tile
    fa_bwd::stage_q_rows<T, D>(q + head * D, dout + head * D, lse + head, di + head,
                               has_seg ? q_seg + head : nullptr, r0, rows, kv_len,
                               q_offset, q_seq_len, causal, win, q_t, do_t, lse_t, di_t,
                               first_t, lim_t, seg_t);
    if constexpr (kExtra) {
      if (slot >= 0) fa_bwd::stage_mask<D>(ex, slot, mask_t);
      if (dropout) fa_bwd::stage_kept<D>(ex, bh, r0, c0, q_seq_len, kept_t);
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float4 qi[kChunks], doi[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        qi[c] = q_t[i][part + kTpr * c];
        doi[c] = do_t[i][part + kTpr * c];
      }
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s += fa::dot4(qi[c], kr[c]);
        dp += fa::dot4(doi[c], vr[c]);
      }
      s = fa_bwd::row_sum<kTpr>(s) * scale;
      dp = fa_bwd::row_sum<kTpr>(dp);
      bool live_pair = col <= lim_t[i] && (!kWindowCap || col >= first_t[i]) &&
                       (!has_seg || seg_t[i] == my_seg);
      float z = 1.f;  // dropout: the pair's 1 / (1 - rate) or 0
      if constexpr (kExtra) {
        if (slot >= 0) live_pair = live_pair && fa_bwd::bit(mask_t, i * 32 * kMaskWords + jr);
        if (dropout) {
          z = fa_bwd::bit(kept_t, i * kTile + jr) ? ex.inv : 0.f;
          dp *= z;
        }
      }
      const float2 pd = fa_bwd::p_ds<kWindowCap>(s, dp, lse_t[i], di_t[i], live_pair, scale, cap);
      const float p = kExtra ? pd.x * z : pd.x, ds = pd.y;  // dV sums Z = z P
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fa::fma4(dv_acc[c], p, doi[c]);
        fa::fma4(dk_acc[c], ds, qi[c]);
      }
    }
  }

  if (!live) return;
  fa_bwd::store_chunks<T, D>(dk + kv_row * D, dk_acc, part);
  fa_bwd::store_chunks<T, D>(dv + kv_row * D, dv_acc, part);
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
  void* dk;
  void* dv;
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
  const dim3 grid((a.s_kv + kTile - 1) / kTile, a.bh);
  flash_bwd_dkv_kernel<T, D, kWindowCap, kExtra><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, a.q_seg, a.kv_seg, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len, a.causal,
      a.scale, a.window, a.softcap, a.ex);
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

// q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d); lse, di: (bh, rows)
// float32; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither
// null.  All contiguous, on the device; q, k, v, do, dk, dv of one dtype
// code.  window <= 0: no sliding window (else it requires causal); softcap
// <= 0: no logit softcap.  bm_*: a block mask's table over (kTile, kTile)
// tiles by key tile, or all null; dropout as in fa_flash_fwd.
extern "C" int fa_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* di,
                                const void* q_seg, const void* kv_seg, void* dk, void* dv,
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
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), dk, dv, bh,
               rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale, window, softcap, ex,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_d<float>(d, a);
  if (dtype == fa::kBFloat16) return launch_d<__nv_bfloat16>(d, a);
  return -1;
}
