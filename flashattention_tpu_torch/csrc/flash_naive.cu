// Naive dense-softmax attention for Hopper (sm_90a): every query row takes
// the exact maximum of its scores over the whole KV stripe, then sums
// exp(s - max) and exp(s - max) * V, and divides once.  float32 throughout.
//
// Replaces flashattention_tpu/ops/flash.py::_naive_kernel (the pallas_call in
// flash_attention_naive), the simple, obviously-correct kernel the JAX package
// holds its tuned flash kernel against.  It computes the same function as
// csrc/flash_fwd.cu by another route: no running maximum and no rescaling of
// the accumulator, so agreement of the two is a check of the online softmax.
// Shapes as there: q (BH, S_q, d), k, v (BH, S_kv, d); query row r sits at
// position q_offset + r; columns at or past kv_len are masked.
//
// Bound on this card: operations (4*d flops per live (query, key) pair
// against K/V read once).  The Pallas kernel keeps a (block_q, S_kv) float32
// score stripe in VMEM; here that stripe would not fit in 227 KB of shared
// memory at S_kv = 1024, so the scores are computed twice instead, once per
// pass over KV: pass 1 the row maximum, pass 2 the sum and the weighted
// values.  That costs one more QK^T than flash_fwd, on the CUDA cores.  What
// the design keeps: both passes stop at kv_len and at the tile's last causal
// column.
//
// Layout: one block per (bh, 32-row query tile); eight threads share a row
// and keep an eighth of its q and of its accumulator in registers as
// interleaved float4 chunks (as in csrc/paged_prefill.cu).  K (pass 1) and
// K, V (pass 2) are staged in shared memory in 32-row tiles as float32.
// Masked columns are left out exactly (p = 0), so a row that sees no column
// writes zeros.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 32;
constexpr int kTile = 32;
constexpr int kThreadsPerRow = 8;
constexpr int kThreads = kBlockQ * kThreadsPerRow;  // 256

template <typename T, int D, bool kWithV>
__device__ __forceinline__ void stage(const T* k_head, const T* v_head, int t0,
                                      int kv_end, float4 (*k_tile)[D / 4],
                                      float4 (*v_tile)[D / 4]) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int j = idx / kVec;
    const int c = idx % kVec;
    const int col = t0 + j;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (col < kv_end) {
      const size_t off = static_cast<size_t>(col) * D + 4 * c;
      kx = fa::load4(k_head + off);
      if (kWithV) vx = fa::load4(v_head + off);
    }
    k_tile[j][c] = kx;
    if (kWithV) v_tile[j][c] = vx;
  }
}

// The full dot product of a row's q with one staged K row: each of the
// row's eight threads sums its chunks, three shuffles add the eight parts.
// Both passes call it on the same operands, so pass 2's scores are bitwise
// pass 1's and never exceed the maximum.
template <int D>
__device__ __forceinline__ float row_dot(const float4 (&qr)[D / 4 / kThreadsPerRow],
                                         const float4* k_row, int part) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4 / kThreadsPerRow; ++i)
    dot += fa::dot4(qr[i], k_row[part + kThreadsPerRow * i]);
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  dot += __shfl_xor_sync(0xffffffffu, dot, 4);
  return dot;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_naive_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int s_q,
                   int s_kv, int kv_len, int q_offset, int causal,
                   float scale) {
  constexpr int kVec = D / 4;
  constexpr int kChunks = kVec / kThreadsPerRow;
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0,
                "head_dim must be a multiple of 32");
  __shared__ float4 k_tile[kTile][kVec];
  __shared__ float4 v_tile[kTile][kVec];

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = r0 + tid / kThreadsPerRow;
  const bool live = row < s_q;
  const int pos = q_offset + (live ? row : r0);

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + min(s_q, r0 + kBlockQ));
  kv_end = max(kv_end, 0);

  const T* q_row = q + (static_cast<size_t>(bh) * s_q + (live ? row : r0)) * D;
  const T* k_head = k + static_cast<size_t>(bh) * s_kv * D;
  const T* v_head = v + static_cast<size_t>(bh) * s_kv * D;
  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    qr[i] = fa::load4(q_row + 4 * (part + kThreadsPerRow * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Pass 1: the row maximum.
  float m = -INFINITY;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();
    stage<T, D, false>(k_head, v_head, t0, kv_end, k_tile, v_tile);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float dot = row_dot<D>(qr, k_tile[j], part);
      const int col = t0 + j;
      if (col < kv_end && (!causal || col <= pos)) m = fmaxf(m, dot * scale);
    }
  }

  // Pass 2: l = sum exp(s - m), acc = sum exp(s - m) * v.
  float l = 0.f;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();
    stage<T, D, true>(k_head, v_head, t0, kv_end, k_tile, v_tile);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float dot = row_dot<D>(qr, k_tile[j], part);
      const int col = t0 + j;
      const bool keep = col < kv_end && (!causal || col <= pos);
      const float p = keep ? expf(dot * scale - m) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        fa::fma4(acc[i], p, v_tile[j][part + kThreadsPerRow * i]);
    }
  }

  if (!live) return;
  const float inv = l == 0.f ? 0.f : 1.f / l;
  T* o_row = o + (static_cast<size_t>(bh) * s_q + row) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 a = acc[i];
    fa::store4(o_row + 4 * (part + kThreadsPerRow * i),
               make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_q, int s_kv, int kv_len, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  const dim3 grid((s_q + kBlockQ - 1) / kBlockQ, bh);
  flash_naive_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_q, s_kv, kv_len,
      q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int s_q, int s_kv, int kv_len, int q_offset, int causal,
             float scale, cudaStream_t stream) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<T, D>(q, k, v, o, bh, s_q, s_kv, kv_len, q_offset, causal, \
                        scale, stream);
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

// q: (bh, s_q, d); k, v: (bh, s_kv, d); o like q.  All contiguous, on the
// device, of one dtype code; 0 <= kv_len <= s_kv.
extern "C" int fa_flash_naive(int dtype, const void* q, const void* k,
                              const void* v, void* o, int bh, int s_q,
                              int s_kv, int d, int kv_len, int q_offset,
                              int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k, v, o, bh, s_q, s_kv, kv_len, q_offset,
                           causal, scale, st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, bh, s_q, s_kv, kv_len,
                                   q_offset, causal, scale, st);
  return -1;
}
