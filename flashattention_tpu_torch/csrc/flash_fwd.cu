// Flash-attention forward for Hopper (sm_90a): QK^T -> online softmax -> PV,
// fused, with the (m, l, acc) state kept in registers across KV tiles.
//
// Replaces flashattention_tpu/ops/flash.py::_kernel (the Pallas forward,
// pallas_call in _flash_attention).  It computes what that kernel computes on
// the serving path: causal masking at query position q_offset + (r mod
// q_seq_len) (the GQA row fold), a sliding window (a row at position pos sees
// column c only where c > pos - window, flash.py:882-906), a logit softcap
// (s -> cap * tanh(s / cap) after the scale and before the masks,
// flash.py:833-835), a live KV length kv_len, a score scale, segment ids (row
// r sees column c only where their int32 ids are equal, the packed training
// step's mask, flash.py:682-688 and :837-843), and optionally the softmax
// statistics (l, m) in float32.
//
// Bound on this card: at the prefill shapes (S >= 1024, d >= 128) attention is
// bound by operations, not bytes (4*S*d flops per query row against 2*S*d
// bytes of K/V read once per query tile).  This first version does all its
// arithmetic in float32 on the CUDA cores, not on the tensor cores, so it
// sits far from that bound; wgmma, TMA and warp specialisation come later.
// What the design does keep from a fast kernel: the KV loop starts at the
// first tile the window of the block's smallest position reaches
// (flash.py:764-768) and stops at the causal diagonal of its largest and at
// kv_len, so no tile outside the live band is read or computed.
//
// Layout: one block of 256 threads per (bh, query tile); kThreadsPerRow(D)
// threads per query row: 4 up to d = 128 (64-row tiles), 8 at d = 256 (32-row
// tiles), so a thread always keeps at most 32 floats of q and 32 of the output
// accumulator in registers (as interleaved float4 chunks) beside its 32
// scores.  ptxas fits d = 128 and d = 256 in 128 registers with a 24-byte
// spill, so two blocks share an SM; that measured faster than 161 registers
// and no spill (one block per SM), and than scoring each tile in two halves
// of 16 columns (see PERF.md).  The threads of a row read neighbouring
// float4 of a shared-memory K/V row and every row of the warp reads the same
// ones (a broadcast, no bank conflict); the partial dot products meet through
// log2(kThreadsPerRow) shuffles.  K/V tiles are staged in dynamic shared
// memory as float32, 2 x 32 x d x 4 bytes (32 KB at d = 128, 64 KB at
// d = 256, above the 48 KB default, so the launch raises
// cudaFuncAttributeMaxDynamicSharedMemorySize), with the tile's segment ids
// when there are any.  A query tile that crosses a GQA segment takes the
// segment's first position for its window start and its last for its causal
// end: correct, just no skip on that side.
#include "common.cuh"

namespace {

constexpr int kBlockKV = 32;  // KV rows per shared-memory tile
constexpr int kThreads = 256;

// Threads per query row, and so query rows per block, by head_dim.
template <int D>
__host__ __device__ constexpr int threads_per_row() { return D >= 256 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr int block_q() { return kThreads / threads_per_row<D>(); }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * sizeof(float4) * kBlockKV * (D / 4) + sizeof(int) * kBlockKV;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int rows,
                 int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
                 float scale, int window, float softcap) {
  constexpr int kThreadsPerRow = threads_per_row<D>();
  constexpr int kBlockQ = block_q<D>();
  constexpr int kVec = D / 4;                     // float4 chunks per row
  constexpr int kChunks = kVec / kThreadsPerRow;  // chunks per thread
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0,
                "head_dim must be a multiple of 4 * kThreadsPerRow");
  // [kBlockKV][kVec] K, then V, then kBlockKV segment ids.
  extern __shared__ float4 smem[];
  float4* k_tile = smem;
  float4* v_tile = smem + kBlockKV * kVec;
  int* seg_tile = reinterpret_cast<int*>(smem + 2 * kBlockKV * kVec);

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = r0 + tid / kThreadsPerRow;
  const bool live = row < rows;  // the last tile may be ragged
  // Causal position of this row: GQA folds G query heads into the rows of
  // one KV head, each a q_seq_len-row segment at the same positions.
  const int pos = q_offset + (live ? row % q_seq_len : 0);
  // Columns at or before win_lo lie outside this row's window.
  const int win_lo = window > 0 ? pos - window : INT_MIN;
  const bool has_seg = q_seg != nullptr;
  const int my_seg =
      has_seg ? q_seg[static_cast<size_t>(bh) * rows + (live ? row : r0)] : 0;
  const int* seg_head = has_seg ? kv_seg + static_cast<size_t>(bh) * s_kv : nullptr;

  const T* q_row = q + (static_cast<size_t>(bh) * rows + (live ? row : r0)) * D;
  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * (part + kThreadsPerRow * i);
    qr[i] = make_float4(fa::load_f32(q_row + c), fa::load_f32(q_row + c + 1),
                        fa::load_f32(q_row + c + 2), fa::load_f32(q_row + c + 3));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Stop the KV loop at kv_len and, when causal, at the block's last
  // diagonal column (the whole-tile skip of flash.py:761 and :771-775); with
  // a window, start it at the tile holding the first column the block's
  // smallest position sees (flash.py:764-768).  A tile that crosses a GQA
  // segment spans the segment's first to last position.
  const int r1 = min(rows, r0 + kBlockQ) - 1;
  const bool one_segment = r0 / q_seq_len == r1 / q_seq_len;
  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + (one_segment ? r1 % q_seq_len : q_seq_len - 1) + 1);
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, q_offset + (one_segment ? r0 % q_seq_len : 0) - window + 1);
    kv_begin -= kv_begin % kBlockKV;
  }

  const T* k_head = k + static_cast<size_t>(bh) * s_kv * D;
  const T* v_head = v + static_cast<size_t>(bh) * s_kv * D;
  float m_run = -INFINITY;  // flash.py:752 initialises m to -inf
  float l_run = 0.f;
  for (int t0 = kv_begin; t0 < kv_end; t0 += kBlockKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBlockKV * D; idx += kThreads) {
      const int col = t0 + idx / D;
      float kx = 0.f, vx = 0.f;
      if (col < kv_end) {
        const size_t off = static_cast<size_t>(col) * D + idx % D;
        kx = fa::load_f32(k_head + off);
        vx = fa::load_f32(v_head + off);
      }
      reinterpret_cast<float*>(k_tile)[idx] = kx;
      reinterpret_cast<float*>(v_tile)[idx] = vx;
    }
    if (has_seg && tid < kBlockKV)
      seg_tile[tid] = t0 + tid < kv_end ? seg_head[t0 + tid] : 0;
    __syncthreads();

    float s[kBlockKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = k_tile[j * kVec + part + kThreadsPerRow * i];
        dot += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z + qr[i].w * kk.w;
      }
#pragma unroll
      for (int off = 1; off < kThreadsPerRow; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = t0 + j;
      const bool keep = col < kv_len && (!causal || col <= pos) && col > win_lo &&
                        (!has_seg || seg_tile[j] == my_seg);
      s[j] = keep ? fa::softcap(dot * scale, softcap) : fa::kMaskValue;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_next = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_next);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      s[j] = expf(s[j] - m_next);
      p_sum += s[j];
    }
    l_run = alpha * l_run + p_sum;
    m_run = m_next;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = v_tile[j * kVec + part + kThreadsPerRow * i];
        acc[i].x += s[j] * vv.x;
        acc[i].y += s[j] * vv.y;
        acc[i].z += s[j] * vv.z;
        acc[i].w += s[j] * vv.w;
      }
    }
  }

  if (!live) return;
  // The l == 0 guard of the Pallas epilogue (flash.py:1118).
  const float inv = l_run == 0.f ? 1.f : 1.f / l_run;
  T* o_row = o + (static_cast<size_t>(bh) * rows + row) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * (part + kThreadsPerRow * i);
    fa::store_f32(o_row + c, acc[i].x * inv);
    fa::store_f32(o_row + c + 1, acc[i].y * inv);
    fa::store_f32(o_row + c + 2, acc[i].z * inv);
    fa::store_f32(o_row + c + 3, acc[i].w * inv);
  }
  if (l_out != nullptr && part == 0) {
    l_out[static_cast<size_t>(bh) * rows + row] = l_run;
    m_out[static_cast<size_t>(bh) * rows + row] = m_run;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* l,
           float* m, const int* q_seg, const int* kv_seg, int bh, int rows,
           int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
           float scale, int window, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + block_q<D>() - 1) / block_q<D>(), bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), l, m, q_seg, kv_seg, rows,
      s_kv, kv_len, q_offset, q_seq_len, causal, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* l, float* m, const int* q_seg, const int* kv_seg, int bh,
             int rows, int s_kv, int kv_len, int q_offset, int q_seq_len,
             int causal, float scale, int window, float softcap,
             cudaStream_t stream) {
#define FA_CASE(D)                                                            \
  case D:                                                                     \
    return launch<T, D>(q, k, v, o, l, m, q_seg, kv_seg, bh, rows, s_kv,     \
                        kv_len, q_offset, q_seq_len, causal, scale, window,  \
                        softcap, stream);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return -1;
  }
#undef FA_CASE
}

}  // namespace

// q: (bh, rows, d); k, v: (bh, s_kv, d); o like q; l, m: (bh, rows) float32
// or both null; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or
// neither null.  All contiguous, on the device, q/k/v/o of one dtype code.
// window <= 0: no sliding window (else it requires causal); softcap <= 0: no
// logit softcap.
extern "C" int fa_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, void* o, void* l, void* m,
                            const void* q_seg, const void* kv_seg, int bh,
                            int rows, int s_kv, int d, int kv_len, int q_offset,
                            int q_seq_len, int causal, float scale, int window,
                            float softcap, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto lf = static_cast<float*>(l);
  auto mf = static_cast<float*>(m);
  auto qs = static_cast<const int*>(q_seg);
  auto ks = static_cast<const int*>(kv_seg);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k, v, o, lf, mf, qs, ks, bh, rows, s_kv, kv_len,
                           q_offset, q_seq_len, causal, scale, window, softcap,
                           st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, lf, mf, qs, ks, bh, rows, s_kv,
                                   kv_len, q_offset, q_seq_len, causal, scale,
                                   window, softcap, st);
  return -1;
}
