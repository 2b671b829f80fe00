// Paged decode attention for Hopper (sm_90a): one new query token per
// request attends to its cached K/V, read page by page from a head-major pool
// through the request's page table, with an online softmax over pages.
//
// Replaces flashattention_tpu/ops/decode.py::_paged_kernel (pallas_call in
// paged_attention).  Shapes as there: q (B, KVH, G, d); k_pages, v_pages
// (P, KVH, page_size, d); lengths (B,); page_indices (B, pages_per_seq).  With
// a sliding window the query at position length - 1 sees the columns
// col > length - 1 - window (decode.py:171-175), and a logit softcap maps each
// scaled score s to cap * tanh(s / cap) before the masks (decode.py:162-163).
//
// Bound on this card: bytes.  Every live K/V row is read once and used for
// 4*G*d flops, far below the card's ~295 flops per byte.  The design reads
// only the pages a request uses (ceil(len / page_size) of its table row, not
// the whole padded row) and only the live rows of its last page; with a
// window the page loop starts at the page of the first column in the window,
// (length - window) / page_size (decode.py:124-125), so pages wholly before it
// are never read, nor their table entries.  Each warp reads whole K/V rows, so
// a load instruction covers one contiguous row.
// This first version has one 256-thread block per (b, kvh), which leaves
// much of the card's memory parallelism unused at small batch; splitting
// long sequences over several blocks comes later.
//
// Layout: the block holds all G query rows of its KV head.  Lane l of a warp
// owns elements [l*E, l*E + E) of d (E = d / 32: 8 at d = 256, so a lane
// holds 8 G floats of q, 8 G of its accumulator and 8 kUnroll of K/V).  Per
// page: each warp scores its share of the page's tokens (a warp-wide dot
// product per row), one warp per query row takes the page max and turns
// scores into probabilities, then each warp accumulates p * V over its share
// of tokens into a private accumulator.  The warps' accumulators are summed
// once at the end, through kWarps x G x d floats of shared memory (16 KB at
// G = 2, d = 256; the launch raises the dynamic limit where it passes 48 KB).
// Window and softcap are a compile-time choice (kWindowCap): a model with
// neither runs the scoring loop without their selects.
//
// 8-bit pages (int8 or fp8 e4m3 payloads P, with a float32 dequant scale per
// K/V row in pools (P, KVH, page_size)): the Pallas kernel multiplies each
// score column by its K scale and folds the V scale into p
// (decode.py:158-159, 199-202); here each K/V row is dequantized as it is
// loaded (payload x its row's scale, in float32), the same product with one
// rounding fewer.  A lane loads its E payload bytes of a row with 32-bit
// loads.  The bytes read halve against bfloat16 (d + 4 bytes per row and
// head), so the bound halves too.  These forms are built for every
// (head_dim, G) pair the unquantized form takes, into libraries of their own
// (FA_QUANT), one head_dim (FA_HEAD_DIM) each, so that the four build in
// parallel beside the others (see ops/kernels.py).
//
// The draft form (speculative verification, draft_k = k > 1; the Pallas
// kernel's draft_k, decode.py:171-183): q holds R = G * k rows per KV head,
// k-minor, row r at draft position dp = r % k, and lengths count all k fed
// tokens.  Row dp sees the columns c <= length - k + dp, and with a window
// also c > length - k + dp - window; the page loop starts at the page of the
// first column of row 0's window, (length - k - window + 1) / page_size
// (decode.py:117-125).  So the last page needs a per-row mask, and each
// row's window starts at its own column.  A row that sees no column of the
// pages visited so far keeps the finite kMaskValue as its running max; the
// first real score rescales what it summed by exp(kMaskValue - m) = 0, as
// in the Pallas kernel.  R reaches 32 (G = 8 at k = 4), and R rows of q and
// of the accumulator do not fit in registers at d = 128-256, so the grid
// has a third dimension over tiles of RT <= 8 rows (the largest of 8, 4, 2,
// 1 dividing R): each tile reads the live K/V rows once, R / RT reads in
// all.  Window and softcap are runtime values in this form (the per-row
// mask is a select per score anyway), and it is built into libraries of
// its own (FA_DRAFT), so that draft_k = 1 keeps the code above unchanged.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // K/V rows each warp has in flight

// E neighbouring elements of a K/V row as float32; an 8-bit row is scaled by
// its dequant scale `sc`.
template <int E, bool kQuant, typename P>
__device__ __forceinline__ void load_row(const P* p, float sc, float (&out)[E]) {
  if constexpr (kQuant && E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = fa::scale4(fa::load4(p + e), sc);
      out[e] = x.x;
      out[e + 1] = x.y;
      out[e + 2] = x.z;
      out[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = kQuant ? fa::load_f32(p + e) * sc : fa::load_f32(p + e);
  }
}

// T: q and o; P: the K/V payload (T itself, or int8 / fp8 with scales).
// G: the query rows of a block (all of a KV head's, or a draft form's tile
// of the head's `rows`, at blockIdx.z).
template <typename T, typename P, int D, int G, bool kWindowCap, bool kDraft>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, T* __restrict__ o,
                    int page_size, int pages_per_seq, float scale, int window,
                    float softcap, int draft_k, int draft_rows) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  constexpr int E = D / 32;
  static_assert(E >= 1 && D % 32 == 0, "head_dim must be a multiple of 32");
  // scores[G][page_size] during the page loop; reused for the final sum of
  // the warps' accumulators, [kWarps][G][D].
  extern __shared__ float smem[];
  __shared__ float m_run[G], l_run[G], alpha[G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = gridDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[b];
  const int n_pages =
      min((length + page_size - 1) / page_size, pages_per_seq);
  // Columns at or before win_lo lie outside the window of the query at
  // position length - 1; the loop starts at the page of the first column
  // inside the window of the earliest query, at length - kq.
  const int kq = kDraft ? draft_k : 1;
  const bool windowed = (kWindowCap || kDraft) && window > 0;
  const int win_lo = windowed ? length - 1 - window : -1;
  const int first_page = windowed ? max(0, (length - kq - window + 1) / page_size) : 0;

  const size_t head = static_cast<size_t>(b) * kvh + h;
  // This block's rows of q and o: (head, row0 .. row0 + G).
  const int rows = kDraft ? draft_rows : G;
  const int row0 = kDraft ? blockIdx.z * G : 0;
  const size_t qo = (head * rows + row0) * D;
  float qv[G][E], acc[G][E];
  // The draft form's row g sees columns (lo[g], lim[g]].
  int lim[kDraft ? G : 1], lo[kDraft ? G : 1];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[g][e] = fa::load_f32(q + qo + g * D + lane * E + e);
      acc[g][e] = 0.f;
    }
    if constexpr (kDraft) {
      const int dp = (row0 + g) % draft_k;  // k-minor rows
      lim[g] = length - draft_k + dp;
      lo[g] = windowed ? lim[g] - window : -1;
    }
  }
  if (threadIdx.x < G) {
    m_run[threadIdx.x] = -INFINITY;
    l_run[threadIdx.x] = 0.f;
  }
  float* scores = smem;
  const size_t page_stride = static_cast<size_t>(kvh) * page_size * D;

  for (int i = first_page; i < n_pages; ++i) {
    const size_t page = page_indices[static_cast<size_t>(b) * pages_per_seq + i];
    const int valid = min(page_size, length - i * page_size);
    const P* kp = k_pages + page * page_stride + static_cast<size_t>(h) * page_size * D;
    const P* vp = v_pages + page * page_stride + static_cast<size_t>(h) * page_size * D;
    // This page's row scales (8-bit payloads): (page, h, 0..page_size).
    const size_t scale_row = (page * kvh + h) * page_size;
    const float* ks = kQuant ? k_scales + scale_row : nullptr;
    const float* vs = kQuant ? v_scales + scale_row : nullptr;
    __syncthreads();  // m_run/l_run initialised; last page's scores consumed

    // 1. Scores of this page's live tokens; warp w takes groups of kUnroll.
    for (int j0 = warp * kUnroll; j0 < valid; j0 += kWarps * kUnroll) {
      float kr[kUnroll][E];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j < valid) {
          load_row<E, kQuant>(kp + static_cast<size_t>(j) * D + lane * E, kQuant ? ks[j] : 1.f, kr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot += qv[g][e] * kr[u][e];
          dot = fa::warp_sum(dot);
          if (lane == 0 && j0 + u < valid) {
            float s = dot * scale;
            const int col = i * page_size + j0 + u;
            if constexpr (kDraft)
              s = col <= lim[g] && col > lo[g] ? fa::softcap(s, softcap) : fa::kMaskValue;
            else if constexpr (kWindowCap)
              s = col > win_lo ? fa::softcap(s, softcap) : fa::kMaskValue;
            scores[g * page_size + j0 + u] = s;
          }
        }
      }
    }
    __syncthreads();

    // 2. Online-softmax update, one warp per query row.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, scores[g * page_size + j]);
      const float m_next = fmaxf(m_run[g], fa::warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < valid; j += 32) {
        const float p = expf(scores[g * page_size + j] - m_next);
        scores[g * page_size + j] = p;
        sum += p;
      }
      sum = fa::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_run[g] - m_next);
        alpha[g] = a;
        l_run[g] = a * l_run[g] + sum;
        m_run[g] = m_next;
      }
    }
    __syncthreads();

    // 3. acc = alpha * acc + p @ V over this warp's tokens.
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha[g];
    }
    for (int j0 = warp * kUnroll; j0 < valid; j0 += kWarps * kUnroll) {
      float vr[kUnroll][E];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j < valid) {
          load_row<E, kQuant>(vp + static_cast<size_t>(j) * D + lane * E, kQuant ? vs[j] : 1.f, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) vr[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= valid) break;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = scores[g * page_size + j0 + u];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * vr[u][e];
        }
      }
    }
  }
  __syncthreads();  // the last page's scores are consumed

  // Sum the warps' accumulators and normalise.  A request of length 0 reads
  // no page, keeps l == 0 and writes zeros (decode.py:216's l == 0 guard).
  float* red = smem;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[(warp * G + g) * D + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * G * D + idx];
    const float l = l_run[idx / D];
    fa::store_f32(o + qo + idx, sum * (l == 0.f ? 1.f : 1.f / l));
  }
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* lengths;
  const int* page_indices;
  void* o;
  int b, kvh, page_size, pages_per_seq;
  float scale;
  int window;
  float softcap;
  int draft_k, rows;  // rows: q rows per KV head (G, or G * draft_k)
  cudaStream_t stream;
};

template <typename T, typename P, int D, int G, bool kWindowCap, bool kDraft = false>
int launch(const Args& a) {
  const size_t floats = max(static_cast<size_t>(G) * a.page_size,
                            static_cast<size_t>(kWarps) * G * D);
  const size_t bytes = floats * sizeof(float);
  auto kernel = paged_decode_kernel<T, P, D, G, kWindowCap, kDraft>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.kvh, a.b, kDraft ? a.rows / G : 1), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
      static_cast<const P*>(a.v_pages), a.k_scales, a.v_scales, a.lengths,
      a.page_indices, static_cast<T*>(a.o), a.page_size, a.pages_per_seq, a.scale,
      a.window, a.softcap, a.draft_k, a.rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int D, int G>
int launch_w(const Args& a) {
#ifdef FA_DRAFT
  return launch<T, P, D, G, false, true>(a);  // window and softcap at run time
#else
  return a.window > 0 || a.softcap > 0.f ? launch<T, P, D, G, true>(a)
                                         : launch<T, P, D, G, false>(a);
#endif
}

// g: the rows of a block.  The draft form tiles the head's a.rows rows by
// the largest of 8, 4, 2, 1 that divides them.
template <typename T, typename P, int D>
int launch_g(int g, const Args& a) {
#ifdef FA_DRAFT
  if (a.draft_k < 2 || a.rows % a.draft_k || a.rows / g > 65535) return -1;
#endif
  switch (g) {
    case 1: return launch_w<T, P, D, 1>(a);
    case 2: return launch_w<T, P, D, 2>(a);
    case 4: return launch_w<T, P, D, 4>(a);
    case 8: return launch_w<T, P, D, 8>(a);
    default: return -1;
  }
}

#ifdef FA_QUANT
// 8-bit pages: this library's head_dim, every G.
template <typename T, typename P>
int launch_d(int d, int g, const Args& a) {
  return d == FA_HEAD_DIM ? launch_g<T, P, FA_HEAD_DIM>(g, a) : -1;
}

template <typename T>
int launch_kv(int kv_dtype, int d, int g, const Args& a) {
  if (kv_dtype == fa::kInt8) return launch_d<T, int8_t>(d, g, a);
  if (kv_dtype == fa::kFp8E4M3) return launch_d<T, __nv_fp8_e4m3>(d, g, a);
  return -1;
}
#else
template <typename T>
int launch_kv(int kv_dtype, int d, int g, const Args& a) {
  if (kv_dtype != (std::is_same<T, float>::value ? fa::kFloat32 : fa::kBFloat16)) return -1;
  switch (d) {
    case 32: return launch_g<T, T, 32>(g, a);
    case 64: return launch_g<T, T, 64>(g, a);
    case 128: return launch_g<T, T, 128>(g, a);
    case 256: return launch_g<T, T, 256>(g, a);
    default: return -1;
  }
}
#endif

}  // namespace

// q: (b, kvh, g, d); k_pages, v_pages: (P, kvh, page_size, d); lengths: (b,)
// int32; page_indices: (b, pages_per_seq) int32; o like q.  All contiguous,
// on the device; q and o of dtype code `dtype`, the pages of `kv_dtype`:
// the same code (k_scales, v_scales null), or with FA_QUANT int8 / fp8 with
// float32 scales (P, kvh, page_size).  window <= 0: no sliding window;
// softcap <= 0: no logit softcap.  draft_k: 1, or with FA_DRAFT k >= 2, g
// then holding the G * k rows of each KV head, k-minor.
extern "C" int fa_paged_decode(int dtype, int kv_dtype, const void* q,
                               const void* k_pages, const void* v_pages,
                               const void* k_scales, const void* v_scales,
                               const void* lengths, const void* page_indices,
                               void* o, int b, int kvh, int g, int d,
                               int page_size, int pages_per_seq, int draft_k,
                               float scale, int window, float softcap, void* stream) {
#ifdef FA_DRAFT
  const int tile = g % 8 == 0 ? 8 : g % 4 == 0 ? 4 : g % 2 == 0 ? 2 : 1;
#else
  if (draft_k != 1) return -1;
  const int tile = g;
#endif
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), o, b, kvh, page_size,
               pages_per_seq, scale, window, softcap, draft_k, g,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_kv<float>(kv_dtype, d, tile, a);
  if (dtype == fa::kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, d, tile, a);
  return -1;
}
