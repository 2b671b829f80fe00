// Chunked-prefill attention over a paged KV cache for Hopper (sm_90a): a
// chunk of query rows per request attends its cached context, read page by
// page from a head-major pool through the request's page table, with an
// online softmax over KV tiles.
//
// Replaces flashattention_tpu/ops/decode.py::_paged_prefill_kernel (the
// pallas_calls in paged_prefill_attention and paged_prefill_attention_batched).
// Shapes as there: q (B, KVH, R, d) with the G query heads of a KV head folded
// into the rows, G segments of `seg` rows each; k_pages, v_pages
// (P, KVH, page_size, d); page_indices (B, pages_per_seq); ctx_lens (B,).
// Row r sits at segment position r % seg and absolute position
// ctx_len - chunk + r % seg; it attends the columns col <= pos, col < ctx_len.
//
// Bound on this card: operations at the serving shapes.  A 512-row chunk
// reads each live K/V row once per 32-row query tile, and every (row, column)
// pair costs 4*d flops: at chunk 512 and contexts of 0.5-2k tokens that is far
// above the card's ~295 flops per byte.  This first version does its
// arithmetic in float32 on the CUDA cores, not on the tensor cores, so it
// sits far from that bound; wgmma comes later.  What the design keeps from a
// fast kernel: the KV loop of a query tile stops at its last causal column and
// at ctx_len, so no page past either is read, and a block reads its own page
// table entries (the TPU kernel's scalar prefetch).
//
// Layout: one block per (32-row query tile, KV head, request).  Eight threads
// share a query row; each keeps an eighth of the row's q and of its output
// accumulator in registers as interleaved float4 chunks, so a row's eight
// threads read eight neighbouring float4 of a shared-memory K/V row and the
// four rows of a warp read the same ones (a broadcast).  At d = 128 that is
// 32 + 32 floats a thread plus 32 scores, small enough for two 256-thread
// blocks per SM.  K/V are staged in 32-row sub-tiles of the pages as float32
// (2 x 32 x d x 4 bytes = 32 KB at d = 128), whatever the page size: a page of
// 256 rows would need 128 KB per head in float32.  Each tile first resolves
// its 32 columns to pool offsets; a column whose page-table entry lies outside
// the pool is masked and never read, and no table entry at or past
// pages_per_seq is read.  Offsets are 64-bit: one layer's pool can exceed
// 2^31 elements.
//
// Masked columns are left out of the softmax exactly (p = 0), so a row that
// sees no column (ctx_len == 0, the engine's dummy batch rows) writes zeros;
// the Pallas kernel leaves such a row unwritten.  p stays in float32 for PV.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 32;  // query rows per block
constexpr int kTile = 32;    // KV rows per shared-memory tile
constexpr int kThreadsPerRow = 8;
constexpr int kThreads = kBlockQ * kThreadsPerRow;  // 256

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ page_indices,
                     const int* __restrict__ ctx_lens, T* __restrict__ o,
                     int rows, int num_pages, int page_size, int pages_per_seq,
                     int chunk, int seg, float scale) {
  constexpr int kVec = D / 4;                     // float4 chunks per row
  constexpr int kChunks = kVec / kThreadsPerRow;  // chunks per thread
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0,
                "head_dim must be a multiple of 32");
  __shared__ float4 k_tile[kTile][kVec];
  __shared__ float4 v_tile[kTile][kVec];
  __shared__ long long col_off[kTile];  // pool offset of each column, -1: masked

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = gridDim.y;
  const int r0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = r0 + tid / kThreadsPerRow;
  const bool live = row < rows;  // the last tile may be ragged
  const int ctx_len = ctx_lens[b];
  const int anchor = ctx_len - chunk;  // position of segment row 0
  const int pos = anchor + (live ? row % seg : 0);

  // Last column any row of this tile attends: its largest segment position
  // (a tile may cross a segment boundary when 32 does not divide seg), then
  // ctx_len and the table's capacity.
  const int r1 = min(rows, r0 + kBlockQ) - 1;
  const int last = (r0 / seg == r1 / seg) ? r1 % seg : seg - 1;
  const int kv_end =
      max(0, min(min(ctx_len, anchor + last + 1), pages_per_seq * page_size));

  const size_t head = static_cast<size_t>(b) * kvh + h;
  const T* q_row = q + (head * rows + (live ? row : r0)) * D;
  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    qr[i] = fa::load4(q_row + 4 * (part + kThreadsPerRow * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* table = page_indices + static_cast<size_t>(b) * pages_per_seq;

  float m_run = -INFINITY;
  float l_run = 0.f;
  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    if (tid < kTile) {
      const int col = t0 + tid;
      long long off = -1;
      if (col < kv_end) {
        const int page = table[col / page_size];
        if (page >= 0 && page < num_pages)
          off = ((static_cast<long long>(page) * kvh + h) * page_size +
                 col % page_size) * D;
      }
      col_off[tid] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < kTile * kVec; idx += kThreads) {
      const int j = idx / kVec;
      const int c = idx % kVec;
      const long long off = col_off[j];
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (off >= 0) {
        kx = fa::load4(k_pages + off + 4 * c);
        vx = fa::load4(v_pages + off + 4 * c);
      }
      k_tile[j][c] = kx;
      v_tile[j][c] = vx;
    }
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        dot += fa::dot4(qr[i], k_tile[j][part + kThreadsPerRow * i]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const int col = t0 + j;
      const bool keep = col < kv_end && col <= pos && col_off[j] >= 0;
      s[j] = keep ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_next = fmaxf(m_run, tile_max);
    if (m_next == -INFINITY) continue;  // nothing seen yet; no shuffles below
    const float alpha = expf(m_run - m_next);  // 0 while m_run is -inf
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m_next);  // masked: exp(-inf) = 0
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
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        fa::fma4(acc[i], s[j], v_tile[j][part + kThreadsPerRow * i]);
    }
  }

  if (!live) return;
  const float inv = l_run == 0.f ? 0.f : 1.f / l_run;  // no column seen: zeros
  T* o_row = o + (head * rows + row) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 a = acc[i];
    fa::store4(o_row + 4 * (part + kThreadsPerRow * i),
               make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_indices, const int* ctx_lens, void* o, int b,
           int kvh, int rows, int num_pages, int page_size, int pages_per_seq,
           int chunk, int seg, float scale, cudaStream_t stream) {
  const dim3 grid((rows + kBlockQ - 1) / kBlockQ, kvh, b);
  paged_prefill_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_indices, ctx_lens,
      static_cast<T*>(o), rows, num_pages, page_size, pages_per_seq, chunk, seg,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k_pages, const void* v_pages,
             const int* page_indices, const int* ctx_lens, void* o, int b,
             int kvh, int rows, int num_pages, int page_size,
             int pages_per_seq, int chunk, int seg, float scale,
             cudaStream_t stream) {
#define FA_CASE(D)                                                            \
  case D:                                                                     \
    return launch<T, D>(q, k_pages, v_pages, page_indices, ctx_lens, o, b,    \
                        kvh, rows, num_pages, page_size, pages_per_seq, chunk, \
                        seg, scale, stream);
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

// q: (b, kvh, rows, d); k_pages, v_pages: (num_pages, kvh, page_size, d);
// page_indices: (b, pages_per_seq) int32; ctx_lens: (b,) int32; o like q.
// All contiguous, on the device; q, pages and o of one dtype code.
extern "C" int fa_paged_prefill(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const void* page_indices,
                                const void* ctx_lens, void* o, int b, int kvh,
                                int rows, int d, int num_pages, int page_size,
                                int pages_per_seq, int chunk, int seg,
                                float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const int*>(page_indices);
  auto ctx = static_cast<const int*>(ctx_lens);
  if (dtype == fa::kFloat32)
    return launch_d<float>(d, q, k_pages, v_pages, tab, ctx, o, b, kvh, rows,
                           num_pages, page_size, pages_per_seq, chunk, seg,
                           scale, st);
  if (dtype == fa::kBFloat16)
    return launch_d<__nv_bfloat16>(d, q, k_pages, v_pages, tab, ctx, o, b, kvh,
                                   rows, num_pages, page_size, pages_per_seq,
                                   chunk, seg, scale, st);
  return -1;
}
