// Flash-attention backward, fused one-pass kernel, for Hopper (sm_90a): dQ,
// dK and dV from one recomputation of each (query, key) pair.
//
// Replaces flashattention_tpu/ops/backward.py::_fused_bwd_kernel (the
// pallas_call at backward.py:798), the JAX package's default backward when
// there are no segment ids (backward.py:610-615): the plain training step's
// path.  It computes what that kernel computes there: causal masking at
// position q_offset + (i mod q_seq_len) (the GQA row fold: dK/dV of a KV
// head sum over the rows of all G query groups), a live KV length kv_len
// and a score scale.  See bwd_common.cuh for the formulas.
//
// The TPU kernel walks the KV axis in order on one core and keeps dQ for a
// whole head in one VMEM scratch (backward.py:412, :504, :822).  Here the
// key tiles of a head run as parallel blocks, so no block owns a query
// row's dQ.  Each block sums its 32 key rows' share of dQ_i for a query tile
// in shared memory (a 32 x 32 dS tile against the block's staged K) and adds
// it with float32 atomics into a zeroed (BH, rows, d) float32 buffer, which
// the wrapper casts to the input dtype.  The other design, one block per
// head walking its key tiles in order, gives 64 blocks for 132 SMs at the
// training shape.  The atomics make dQ's summation order vary from run to
// run: results agree to rounding, not bit for bit.
//
// Bound on this card: operations, 10 d flops per live pair (five products:
// q.k, do.v, P do, dS q, dS k) against q, do, k, v read once.  This first
// version does them in float32 on the CUDA cores.  What the design keeps
// from a fast kernel: dK/dV accumulators in registers for the whole loop,
// query tiles above the diagonal skipped (within each GQA segment), and one
// atomic per (query row, element) per key tile, not per pair.
//
// Layout: one block per (bh, 32 key rows); eight threads per key row, as in
// csrc/flash_bwd_dkv.cu.  Shared memory: the query tile's q and do, the
// block's K rows and the dS tile, all float32: 53,888 bytes at d = 128,
// above the 48 KB default, so the launch raises the block's dynamic
// shared-memory limit first.
#include "bwd_common.cuh"

namespace {

using fa_bwd::kThreads;
using fa_bwd::kThreadsPerRow;
using fa_bwd::kTile;

constexpr int kDsStride = kTile + 1;  // padded dS rows: no bank conflicts

template <int D>
constexpr size_t smem_bytes() {
  return 3 * sizeof(float4) * kTile * (D / 4) + sizeof(float) * (kTile * kDsStride + 4 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int rows, int s_kv, int kv_len,
                 int q_offset, int q_seq_len, int causal, float scale) {
  constexpr int kVec = D / 4;
  constexpr int kChunks = kVec / kThreadsPerRow;
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem[];
  auto q_t = reinterpret_cast<float4(*)[kVec]>(smem);
  auto do_t = q_t + kTile;
  auto k_s = do_t + kTile;
  float* ds_t = reinterpret_cast<float*>(k_s + kTile);
  float* lse_t = ds_t + kTile * kDsStride;
  float* di_t = lse_t + kTile;
  int* lim_t = reinterpret_cast<int*>(di_t + kTile);
  int* seg_t = lim_t + kTile;  // written by the staging helper, unused here

  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int jr = threadIdx.x / kThreadsPerRow;  // this thread's row in the tiles
  const int part = threadIdx.x % kThreadsPerRow;
  const int col = c0 + jr;
  const bool live = col < s_kv;  // the last key tile may be ragged
  const size_t kv_head = static_cast<size_t>(bh) * s_kv;
  const size_t kv_row = kv_head + (live ? col : c0);

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
  fa_bwd::load_chunks<T, kChunks>(kr, k + kv_row * D, part);
  fa_bwd::load_chunks<T, kChunks>(vr, v + kv_row * D, part);
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
    if (causal && q_offset + fa_bwd::tile_last_pos(r0, rows, q_seq_len) < c0) continue;
    __syncthreads();  // every thread is done with the previous query tile
    fa_bwd::stage_q_rows<T, D>(q + head * D, dout + head * D, lse + head, di + head, nullptr,
                               r0, rows, kv_len, q_offset, q_seq_len, causal, q_t, do_t,
                               lse_t, di_t, lim_t, seg_t);
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
      const float p = col <= lim_t[i] ? expf(s * scale - lse_t[i]) : 0.f;
      const float ds = p * (dp - di_t[i]) * scale;
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
    if (r < rows && lim_t[jr] >= c0) {
      float4 acc[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        const float a = ds_t[jr * kDsStride + j];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) fa::fma4(acc[c], a, k_s[j][part + kThreadsPerRow * c]);
      }
      float* dst = dq_acc + (head + r) * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float* p4 = dst + 4 * (part + kThreadsPerRow * c);
        atomicAdd(p4, acc[c].x);
        atomicAdd(p4 + 1, acc[c].y);
        atomicAdd(p4 + 2, acc[c].z);
        atomicAdd(p4 + 3, acc[c].w);
      }
    }
  }

  if (!live) return;
  fa_bwd::store_chunks<T, kChunks>(dk + kv_row * D, dk_acc, part);
  fa_bwd::store_chunks<T, kChunks>(dv + kv_row * D, dv_acc, part);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* di, float* dq_acc, void* dk, void* dv, int bh, int rows, int s_kv,
           int kv_len, int q_offset, int q_seq_len, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((s_kv + kTile - 1) / kTile, bh);
  flash_bwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv),
      rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* di, float* dq_acc, void* dk, void* dv, int bh,
             int rows, int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
             float scale, cudaStream_t stream) {
#define FA_CASE(D)                                                                      \
  case D:                                                                               \
    return launch<T, D>(q, k, v, dout, lse, di, dq_acc, dk, dv, bh, rows, s_kv, kv_len, \
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

// q, do: (bh, rows, d); k, v, dk, dv: (bh, s_kv, d); lse, di: (bh, rows)
// float32; dq_acc: (bh, rows, d) float32, zeroed by the caller, to which
// dQ is added.  All contiguous, on the device; q, k, v, do, dk, dv of one
// dtype code.
extern "C" int fa_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di, void* dq_acc,
                            void* dk, void* dv, int bh, int rows, int s_kv, int d, int kv_len,
                            int q_offset, int q_seq_len, int causal, float scale,
                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lf = static_cast<const float*>(lse);
  auto df = static_cast<const float*>(di);
  auto acc = static_cast<float*>(dq_acc);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k, v, dout, lf, df, acc, dk, dv, bh, rows, s_kv, kv_len,
                           q_offset, q_seq_len, causal, scale, st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, dout, lf, df, acc, dk, dv, bh, rows, s_kv,
                                   kv_len, q_offset, q_seq_len, causal, scale, st);
  return -1;
}
