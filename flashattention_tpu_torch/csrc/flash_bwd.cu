// Flash-attention backward, fused one-pass kernel, for Hopper (sm_90a): dQ,
// dK and dV from one recomputation of each (query, key) pair.
//
// Replaces flashattention_tpu/ops/backward.py::_fused_bwd_kernel (the
// pallas_call at backward.py:798), the JAX package's default backward when
// there are no segment ids (backward.py:610-615): the plain training step's
// path.  It computes what that kernel computes there: causal masking at
// position q_offset + (i mod q_seq_len) (the GQA row fold: dK/dV of a KV
// head sum over the rows of all G query groups), a sliding window (row i
// sees column j only where j > position - window, backward.py:122-130), a
// logit softcap with its derivative on dS (backward.py:474-477, :501-502),
// a live KV length kv_len and a score scale.  See bwd_common.cuh for the
// formulas.
//
// The TPU kernel walks the KV axis in order on one core and keeps dQ for a
// whole head in one VMEM scratch (backward.py:412, :504, :822).  Here the
// key tiles of a head run as parallel blocks, so no block owns a query
// row's dQ.  Each block sums its key rows' share of dQ_i for a query tile in
// shared memory (a kTile x kTile dS tile against the block's staged K) and
// adds it with float32 atomics into a zeroed (BH, rows, d) float32 buffer,
// which the wrapper casts to the input dtype.  The other design, one block
// per head walking its key tiles in order, gives 64 blocks for 132 SMs at
// the training shape.  The atomics make dQ's summation order vary from run
// to run: results agree to rounding, not bit for bit.
//
// Bound on this card: operations, 10 d flops per live pair (five products:
// q.k, do.v, P do, dS q, dS k) against q, do, k, v read once.  This first
// version does them in float32 on the CUDA cores.  What the design keeps
// from a fast kernel: dK/dV accumulators in registers for the whole loop,
// query tiles outside the band skipped (within each GQA segment: above the
// diagonal, and with a window below the last tile whose window still
// reaches the block's key rows, the bound of backward.py:754), and one
// atomic per (query row, element) per key tile, not per pair.  Window and
// softcap are a compile-time choice (kWindowCap): a model with neither runs
// the pair loop without their selects.  Attention dropout (backward.py:
// 487-498) is another (kExtra): dV sums the kept P / (1 - rate) and dS takes
// the kept dP, from each tile pair's keep bits, hashed once into shared
// memory.  Block masks go to the two-pass pair, as in the JAX package
// (backward.py:781).
//
// Layout: one block per (bh, kTile key rows); Layout<D>::kTpr threads per
// key row, as in csrc/flash_bwd_dkv.cu.  Shared memory: the query tile's q
// and do, the block's K rows and the dS tile, all float32, plus five ints or
// floats per query row: 54,016 bytes at d = 128 (32-row tiles) and 50,560 at
// d = 256 (16-row tiles), above the 48 KB default, so the launch raises the
// block's dynamic shared-memory limit first.  Two blocks fit an SM's 228 KB
// at every head_dim, as __launch_bounds__ asks.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::Layout;

template <int D>
constexpr size_t smem_bytes() {
  constexpr int kTile = Layout<D>::kTile;
  return 3 * sizeof(float4) * kTile * (D / 4) +
         sizeof(float) * (kTile * (kTile + 1) + 5 * kTile);
}

template <typename T, int D, bool kWindowCap, bool kExtra>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int rows, int s_kv, int kv_len,
                 int q_offset, int q_seq_len, int causal, float scale, int window,
                 float softcap, const fa::Extras ex) {
  using L = Layout<D>;
  constexpr int kTile = L::kTile;
  constexpr int kTpr = L::kTpr;
  constexpr int kVec = L::kVec;
  constexpr int kChunks = L::kChunks;
  constexpr int kDsStride = kTile + 1;  // padded dS rows: no bank conflicts
  extern __shared__ float4 smem[];
  auto q_t = reinterpret_cast<float4(*)[kVec]>(smem);
  auto do_t = q_t + kTile;
  auto k_s = do_t + kTile;
  float* ds_t = reinterpret_cast<float*>(k_s + kTile);
  float* lse_t = ds_t + kTile * kDsStride;
  float* di_t = lse_t + kTile;
  int* first_t = reinterpret_cast<int*>(di_t + kTile);
  int* lim_t = first_t + kTile;
  int* seg_t = lim_t + kTile;  // written by the staging helper, unused here
  __shared__ unsigned kept_t[kExtra ? kTile * kTile / 32 : 1];  // dropout keep bits

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int jr = threadIdx.x / kTpr;  // this thread's row in the tiles
  const int part = threadIdx.x % kTpr;
  const int col = c0 + jr;
  const bool live = col < s_kv;  // the last key tile may be ragged
  const size_t kv_head = static_cast<size_t>(bh) * s_kv;
  const size_t kv_row = kv_head + (live ? col : c0);
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
  // The block's key rows, whole, for the dQ products (zeros past s_kv).
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int j = idx / kVec;
    const int c = idx % kVec;
    k_s[j][c] = c0 + j < s_kv ? fa::load4(k + (kv_head + c0 + j) * D + 4 * c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const size_t head = static_cast<size_t>(bh) * rows;
  for (int r0 = 0; c0 < kv_len && r0 < rows; r0 += kTile) {
    if (causal && q_offset + fa_bwd::tile_last_pos(r0, kTile, rows, q_seq_len) < c0) continue;
    if (win > 0) {  // the tile's first window column lies past this key tile
      const int win_start =
          q_offset + fa_bwd::tile_first_pos(r0, kTile, rows, q_seq_len) - win + 1;
      if (win_start > c0 + kTile - 1) continue;
    }
    __syncthreads();  // every thread is done with the previous query tile
    fa_bwd::stage_q_rows<T, D>(q + head * D, dout + head * D, lse + head, di + head, nullptr,
                               r0, rows, kv_len, q_offset, q_seq_len, causal, win, q_t, do_t,
                               lse_t, di_t, first_t, lim_t, seg_t);
    if constexpr (kExtra) fa_bwd::stage_kept<D>(ex, bh, r0, c0, q_seq_len, kept_t);
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
      const bool live_pair = col <= lim_t[i] && (!kWindowCap || col >= first_t[i]);
      float z = 1.f;  // dropout: the pair's 1 / (1 - rate) or 0
      if constexpr (kExtra) {
        z = fa_bwd::bit(kept_t, i * kTile + jr) ? ex.inv : 0.f;
        dp *= z;
      }
      const float2 pd = fa_bwd::p_ds<kWindowCap>(s, dp, lse_t[i], di_t[i], live_pair, scale, cap);
      const float p = kExtra ? pd.x * z : pd.x, ds = pd.y;  // dV sums Z = z P
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fa::fma4(dv_acc[c], p, doi[c]);
        fa::fma4(dk_acc[c], ds, qi[c]);
      }
      if (part == 0) ds_t[i * kDsStride + jr] = ds;
    }
    __syncthreads();  // the dS tile is complete
    // dQ_i += sum_j dS_ij k_j for query row i = r0 + jr of the tile; a row
    // that sees no column of this key tile adds nothing and is skipped.
    const int r = r0 + jr;
    if (r < rows && lim_t[jr] >= c0 && (!kWindowCap || first_t[jr] < c0 + kTile)) {
      float4 acc[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float a = ds_t[jr * kDsStride + j];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) fa::fma4(acc[c], a, k_s[j][part + kTpr * c]);
      }
      float* dst = dq_acc + (head + r) * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float* p4 = dst + 4 * (part + kTpr * c);
        atomicAdd(p4, acc[c].x);
        atomicAdd(p4 + 1, acc[c].y);
        atomicAdd(p4 + 2, acc[c].z);
        atomicAdd(p4 + 3, acc[c].w);
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

template <typename T, int D, bool kWindowCap, bool kExtra>
int launch(const Args& a) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = flash_bwd_kernel<T, D, kWindowCap, kExtra>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kTile = Layout<D>::kTile;
  const dim3 grid((a.s_kv + kTile - 1) / kTile, a.bh);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, a.dq_acc, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.rows, a.s_kv, a.kv_len, a.q_offset, a.q_seq_len, a.causal,
      a.scale, a.window, a.softcap, a.ex);
  return static_cast<int>(cudaGetLastError());
}

// The dropout form is built with FA_EXTRA into a library of its own
// (ops/kernels.py), so the two forms compile in parallel.
template <typename T, int D, bool kWindowCap>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return launch<T, D, kWindowCap, true>(a);
#else
  if (a.ex.threshold != 0) return -1;
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
// float32; dq_acc: (bh, rows, d) float32, zeroed by the caller, to which
// dQ is added.  All contiguous, on the device; q, k, v, do, dk, dv of one
// dtype code.  window <= 0: no sliding window (else it requires causal);
// softcap <= 0: no logit softcap.  dropout as in fa_flash_fwd (no block
// masks here: the two-pass pair takes them).
extern "C" int fa_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di, void* dq_acc,
                            void* dk, void* dv, int bh, int rows, int s_kv, int d, int kv_len,
                            int q_offset, int q_seq_len, int causal, float scale, int window,
                            float softcap, int row_stride, int dropout_seed,
                            int dropout_threshold, float dropout_inv, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di),
               static_cast<float*>(dq_acc), dk, dv, bh, rows, s_kv, kv_len, q_offset,
               q_seq_len, causal, scale, window, softcap, ex, static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_d<float>(d, a);
  if (dtype == fa::kBFloat16) return launch_d<__nv_bfloat16>(d, a);
  return -1;
}
