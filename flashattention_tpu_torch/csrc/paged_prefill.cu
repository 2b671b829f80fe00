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
// ctx_len - chunk + r % seg; it attends the columns col <= pos, col < ctx_len
// and, with a sliding window, col > pos - window (decode.py:462-463).  A logit
// softcap maps each scaled score s to cap * tanh(s / cap) before the masks
// (decode.py:456-457).
//
// Bound on this card: operations at the serving shapes.  A 512-row chunk
// reads each live K/V row once per 32-row query tile, and every (row, column)
// pair costs 4*d flops: at chunk 512 and contexts of 0.5-2k tokens that is far
// above the card's ~295 flops per byte.  This first version does its
// arithmetic in float32 on the CUDA cores, not on the tensor cores, so it
// sits far from that bound; wgmma comes later.  What the design keeps from a
// fast kernel: the KV loop of a query tile stops at its last causal column and
// at ctx_len, so no page past either is read; with a window it starts at the
// 32-column tile holding the first column the tile's smallest position sees
// (decode.py:422-426), so pages wholly before the window are never read, nor
// their table entries; and a block reads its own page table entries (the TPU
// kernel's scalar prefetch).
//
// Layout: one block of 256 threads per (query tile, KV head, request).
// kThreadsPerRow(D) threads share a query row: 8 up to d = 128 (32-row tiles),
// 16 at d = 256 (16-row tiles).  Each keeps its share of the row's q and of
// its output accumulator in registers as interleaved float4 chunks, so a
// row's threads read neighbouring float4 of a shared-memory K/V row and the
// rows of a warp read the same ones (a broadcast).  That is at most 32 + 32
// floats a thread plus 32 scores at every d, small enough for two blocks per
// SM (128 registers) with no spill.  K/V are staged in 32-row sub-tiles of
// the pages as float32 in dynamic shared memory (2 x 32 x d x 4 bytes: 32 KB
// at d = 128, 64 KB at d = 256, where the launch raises the 48 KB default),
// whatever the page size: a page of 256 rows would need 128 KB per head in
// float32.  Each tile first resolves
// its 32 columns to pool offsets; a column whose page-table entry lies outside
// the pool is masked and never read, and no table entry at or past
// pages_per_seq is read.  Offsets are 64-bit: one layer's pool can exceed
// 2^31 elements.
//
// Masked columns are left out of the softmax exactly (p = 0), so a row that
// sees no column (ctx_len == 0, the engine's dummy batch rows) writes zeros;
// the Pallas kernel leaves such a row unwritten.  p stays in float32 for PV.
//
// 8-bit pages (int8 or fp8 e4m3 payloads P with a float32 dequant scale per
// K/V row, pools (P, KVH, page_size)): the Pallas kernel folds the K scale
// into the score columns and the V scale into p (decode.py:452-453, 480);
// here each row is dequantized as its tile is staged (payload x its row's
// scale, into the float32 shared-memory tiles), one rounding fewer.  A
// column's scale sits at its pool offset / d, read once per tile with the
// offset.  These forms are built into their own library (FA_QUANT, see
// ops/kernels.py).
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kTile = 32;  // KV rows per shared-memory tile
constexpr int kThreads = 256;

// Threads per query row, and so query rows per block, by head_dim.
template <int D>
__host__ __device__ constexpr int threads_per_row() { return D >= 256 ? 16 : 8; }
template <int D>
__host__ __device__ constexpr int block_q() { return kThreads / threads_per_row<D>(); }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * sizeof(float4) * kTile * (D / 4) + (sizeof(long long) + 2 * sizeof(float)) * kTile;
}

// T: q and o; P: the K/V payload (T itself, or int8 / fp8 with scales).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                     const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ page_indices,
                     const int* __restrict__ ctx_lens, T* __restrict__ o,
                     int rows, int num_pages, int page_size, int pages_per_seq,
                     int chunk, int seg, float scale, int window, float softcap) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  constexpr int kThreadsPerRow = threads_per_row<D>();
  constexpr int kBlockQ = block_q<D>();
  constexpr int kVec = D / 4;                     // float4 chunks per row
  constexpr int kChunks = kVec / kThreadsPerRow;  // chunks per thread
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0,
                "head_dim must be a multiple of 4 * kThreadsPerRow");
  // [kTile][kVec] K, then V, then the pool offset of each column (-1: masked)
  // and, for 8-bit payloads, its K and V scales.
  extern __shared__ float4 smem[];
  float4* k_tile = smem;
  float4* v_tile = smem + kTile * kVec;
  long long* col_off = reinterpret_cast<long long*>(smem + 2 * kTile * kVec);
  float* col_ks = reinterpret_cast<float*>(col_off + kTile);
  float* col_vs = col_ks + kTile;

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
  // Columns at or before win_lo lie outside this row's window.
  const int win_lo = window > 0 ? pos - window : INT_MIN;

  // Last column any row of this tile attends: its largest segment position
  // (a tile may cross a segment boundary when kBlockQ does not divide seg),
  // then ctx_len and the table's capacity.  With a window, the first column
  // is that of its smallest segment position (a tile crossing a boundary
  // takes the segment's first), rounded down to a KV tile.
  const int r1 = min(rows, r0 + kBlockQ) - 1;
  const bool one_segment = r0 / seg == r1 / seg;
  const int last = one_segment ? r1 % seg : seg - 1;
  const int kv_end =
      max(0, min(min(ctx_len, anchor + last + 1), pages_per_seq * page_size));
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, anchor + (one_segment ? r0 % seg : 0) - window + 1);
    kv_begin -= kv_begin % kTile;
  }

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
  for (int t0 = kv_begin; t0 < kv_end; t0 += kTile) {
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
      if constexpr (kQuant) {  // the row's scale sits at its offset / D
        col_ks[tid] = off >= 0 ? k_scales[off / D] : 0.f;
        col_vs[tid] = off >= 0 ? v_scales[off / D] : 0.f;
      }
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
        if constexpr (kQuant) {
          kx = fa::scale4(kx, col_ks[j]);
          vx = fa::scale4(vx, col_vs[j]);
        }
      }
      k_tile[idx] = kx;  // idx = j * kVec + c
      v_tile[idx] = vx;
    }
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
        dot += fa::dot4(qr[i], k_tile[j * kVec + part + kThreadsPerRow * i]);
#pragma unroll
      for (int off = 1; off < kThreadsPerRow; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = t0 + j;
      const bool keep = col < kv_end && col <= pos && col > win_lo && col_off[j] >= 0;
      s[j] = keep ? fa::softcap(dot * scale, softcap) : -INFINITY;
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
        fa::fma4(acc[i], s[j], v_tile[j * kVec + part + kThreadsPerRow * i]);
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

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_indices;
  const int* ctx_lens;
  void* o;
  int b, kvh, rows, num_pages, page_size, pages_per_seq, chunk, seg;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, typename P, int D>
int launch(const Args& a) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = paged_prefill_kernel<T, P, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.rows + block_q<D>() - 1) / block_q<D>(), a.kvh, a.b);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
      static_cast<const P*>(a.v_pages), a.k_scales, a.v_scales, a.page_indices,
      a.ctx_lens, static_cast<T*>(a.o), a.rows, a.num_pages, a.page_size,
      a.pages_per_seq, a.chunk, a.seg, a.scale, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_d(int d, const Args& a) {
  switch (d) {
    case 32: return launch<T, P, 32>(a);
    case 64: return launch<T, P, 64>(a);
    case 128: return launch<T, P, 128>(a);
    case 256: return launch<T, P, 256>(a);
    default: return -1;
  }
}

#ifdef FA_QUANT
template <typename T>
int launch_kv(int kv_dtype, int d, const Args& a) {
  if (kv_dtype == fa::kInt8) return launch_d<T, int8_t>(d, a);
  if (kv_dtype == fa::kFp8E4M3) return launch_d<T, __nv_fp8_e4m3>(d, a);
  return -1;
}
#else
template <typename T>
int launch_kv(int kv_dtype, int d, const Args& a) {
  if (kv_dtype != (std::is_same<T, float>::value ? fa::kFloat32 : fa::kBFloat16)) return -1;
  return launch_d<T, T>(d, a);
}
#endif

}  // namespace

// q: (b, kvh, rows, d); k_pages, v_pages: (num_pages, kvh, page_size, d);
// page_indices: (b, pages_per_seq) int32; ctx_lens: (b,) int32; o like q.
// All contiguous, on the device; q and o of dtype code `dtype`, the pages of
// `kv_dtype`: the same code (k_scales, v_scales null), or with FA_QUANT int8
// / fp8 with float32 scales (num_pages, kvh, page_size).  window <= 0: no
// sliding window; softcap <= 0: no logit softcap.
extern "C" int fa_paged_prefill(int dtype, int kv_dtype, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scales, const void* v_scales,
                                const void* page_indices, const void* ctx_lens,
                                void* o, int b, int kvh, int rows, int d,
                                int num_pages, int page_size, int pages_per_seq,
                                int chunk, int seg, float scale, int window,
                                float softcap, void* stream) {
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(page_indices),
               static_cast<const int*>(ctx_lens), o, b, kvh, rows, num_pages, page_size,
               pages_per_seq, chunk, seg, scale, window, softcap,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_kv<float>(kv_dtype, d, a);
  if (dtype == fa::kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, d, a);
  return -1;
}
