// Chunked-prefill attention over a paged KV cache on Hopper's tensor cores
// (sm_90a): the paged form of the forward kernel in flash_fwd_tc.cuh.
//
// Replaces flashattention_tpu/ops/decode.py::_paged_prefill_kernel (the
// pallas_calls in paged_prefill_attention and paged_prefill_attention_batched)
// for bf16 q and bf16 pages at head_dim 64, 128 and 256, the function of the
// scalar paged_prefill.cu: q (B, KVH, R, d) with the G query heads of a KV
// head folded into the rows, G segments of `seg` rows; k_pages, v_pages
// (P, KVH, page_size, d); page_indices (B, pages_per_seq); ctx_lens (B,).
// Row r sits at ctx_len - chunk + r % seg and sees the columns col <= pos,
// col < ctx_len and, with a sliding window, col > pos - window; the logit
// softcap bends each scaled score before the masks; a row that sees no
// column (a ctx_len == 0 request, a pad row whose window lies past the
// context) gets zeros.  Built with FA_QUANT (paged_prefill_tc_quant): over
// int8 or fp8 e4m3 pages with float32 scale pools (P, KVH, ps), the
// template's 8-bit form (kKV): 8-bit boxes of whole d-byte rows through the
// same page table, converted to bf16 in shared memory by the consumers,
// score columns times k_scale and P's columns times v_scale as the Pallas
// kernel orders them (decode.py:453, 481).  Built with FA_F32
// (paged_prefill_tc_f32): float32 q over float32 pools, the exact form of
// flash_fwd_f32.cuh (each value as three bf16 terms split in shared memory,
// six products), as the Pallas kernel computes float32 pools at HIGHEST
// (decode.py:438-447).
//
// Bound on this card: operations at the serving shapes (4 d flops a live
// pair against 2 d bytes of K/V per 128-row query tile), so both products
// run as wgmma; the consumer is flash_fwd_tc.cuh's, whose design and
// rounding (P as two bf16 terms against the running max of kN-column tiles
// aligned to column 0) this form keeps.  What the paged form adds:
// - K/V through the page table: the layer's pool is a 4-D tensor map
//   (d, page_size, KVH, P), encoded per launch from the pool pointer (the
//   model passes a view at an offset into its (L, P, KVH, ps, d) pool); a
//   tile of kN rows (128, 64 at d = 256) is loaded in boxes of
//   min(kN, page_size) rows, each inside one page, from
//   page_indices[b, t / page_size]; a box that holds no column in the
//   block's [first, end) is not loaded and its table entry not read, so no
//   entry past the last page the block needs is read, nor one before its
//   window's first page.
// - Per-request scalars on the device: each block reads ctx_lens[b] and
//   its anchor itself; no host sync.
// - Rows no row may see: TMA fills zeros only past the pool's edge, not in
//   the last live page past ctx_len nor in a stale page, and a box left
//   unloaded keeps what the stage held.  Their K columns are masked like
//   any other; their V rows are zeroed in shared memory before the PV
//   product (P = 0 times NaN is NaN).
// Grid (R / 128, KVH, B), the last query tiles (the longest) first; a
// 128-row tile may cross segment boundaries (seg 200 or 512 rows), handled
// by the forward's GQA row fold.  Page sizes: multiples of 8 that divide kN
// or that kN divides (ops/flash.py::kernel_form), so that a box stays in one
// page and lands on a 1024-byte swizzle atom.
#include "flash_fwd_tc.cuh"
#ifdef FA_F32
#include "flash_fwd_f32.cuh"
#endif

namespace {

template <int D, bool kWindowCap, int kKV>
int launch(const fwd_tc::Args& a, const fwd_tc::Paged& pg, int num_pages, int kvh, int b) {
  using C = fwd_tc::Cfg<D, kKV>;
  if (pg.page_size % 8 || (C::kN % pg.page_size && pg.page_size % C::kN)) return -1;
  CUtensorMap mq, mk, mv;
  const int box = pg.page_size < C::kN ? pg.page_size : C::kN;
  const int eb = C::kQuant ? 1 : 2;  // K/V element bytes
  const long long pool_dims[4] = {D, pg.page_size, kvh, num_pages};
  const long long pool_strides[3] = {D, static_cast<long long>(pg.page_size) * D,
                                     static_cast<long long>(kvh) * pg.page_size * D};
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, static_cast<long long>(a.rows) * D,
                         fwd_tc::kBlockM);
  if (st == 0) st = tc_encode(&mk, a.k, 4, pool_dims, pool_strides, box, eb);
  if (st == 0) st = tc_encode(&mv, a.v, 4, pool_dims, pool_strides, box, eb);
  if (st != 0) return st;
  auto kernel = fwd_tc::flash_fwd_tc_kernel<D, kWindowCap, false, 0, true, kKV>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + fwd_tc::kBlockM - 1) / fwd_tc::kBlockM, kvh, b);
  kernel<<<grid, fwd_tc::kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), nullptr, nullptr, nullptr, nullptr, a.rows,
      0, 0, 0, a.q_seq_len, 1, a.scale, a.window, a.softcap, a.ex, pg, a.k_scales, a.v_scales);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kKV>
int launch_w(const fwd_tc::Args& a, const fwd_tc::Paged& pg, int num_pages, int kvh, int b) {
  return a.window > 0 || a.softcap > 0.f ? launch<D, true, kKV>(a, pg, num_pages, kvh, b)
                                         : launch<D, false, kKV>(a, pg, num_pages, kvh, b);
}

template <int kKV>
int launch_d(const fwd_tc::Args& a, const fwd_tc::Paged& pg, int d, int num_pages, int kvh,
             int b) {
  switch (d) {
    case 64: return launch_w<64, kKV>(a, pg, num_pages, kvh, b);
    case 128: return launch_w<128, kKV>(a, pg, num_pages, kvh, b);
    case 256: return launch_w<256, kKV>(a, pg, num_pages, kvh, b);
    default: return -1;
  }
}

}  // namespace

// q: (b, kvh, rows, d) bf16; k_pages, v_pages: (num_pages, kvh, page_size,
// d) bf16; page_indices: (b, pages_per_seq) int32; ctx_lens: (b,) int32; o
// like q, or float32 with o_f32 (float32 q over bf16 pages, taken in bf16:
// O from the float32 sums, no bf16 rounding).  All contiguous, on the
// device, 16-byte aligned (TMA); entries of a table row that cover live
// columns name pool pages.  window <= 0: no sliding window; softcap <= 0:
// none.
#ifdef FA_F32
// The float32 form: q (b, kvh, rows, d), the pools and o float32; no o_f32
// flag (O is float32).  Page sizes: multiples of 8 that divide the form's KV
// tile (64 rows, 32 at d = 256) or that it divides.
extern "C" int fa_paged_prefill_tc_f32(const void* q, const void* k_pages, const void* v_pages,
                                       const void* page_indices, const void* ctx_lens, void* o,
                                       int b, int kvh, int rows, int d, int num_pages,
                                       int page_size, int pages_per_seq, int chunk, int seg,
                                       float scale, int window, float softcap, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, seg, 0u, 0u, 0.f};
  fwd_tc::Args a{q, k_pages, v_pages, nullptr, nullptr, nullptr, nullptr, nullptr, b * kvh, rows,
                 0, 0, 0, seg, 1, scale, window, softcap, ex, static_cast<cudaStream_t>(stream)};
  a.o32 = static_cast<float*>(o);
  const fwd_tc::Paged pg{static_cast<const int*>(page_indices), static_cast<const int*>(ctx_lens),
                         pages_per_seq, page_size, chunk, a.o32};
  switch (d) {
    case 64: return f32tc::launch_w<64, 3, true>(a, pg, num_pages, kvh, b);
    case 128: return f32tc::launch_w<128, 3, true>(a, pg, num_pages, kvh, b);
    case 256: return f32tc::launch_w<256, 3, true>(a, pg, num_pages, kvh, b);
    default: return -1;
  }
}
#elif !defined(FA_QUANT)
extern "C" int fa_paged_prefill_tc(const void* q, const void* k_pages, const void* v_pages,
                                   const void* page_indices, const void* ctx_lens, void* o, int b,
                                   int kvh, int rows, int d, int num_pages, int page_size,
                                   int pages_per_seq, int chunk, int seg, float scale,
                                   int window, float softcap, int o_f32, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, seg, 0u, 0u, 0.f};
  const fwd_tc::Args a{q, k_pages, v_pages, o, nullptr, nullptr, nullptr, nullptr, b * kvh, rows,
                       0, 0, 0, seg, 1, scale, window, softcap, ex,
                       static_cast<cudaStream_t>(stream)};
  const fwd_tc::Paged pg{static_cast<const int*>(page_indices), static_cast<const int*>(ctx_lens),
                         pages_per_seq, page_size, chunk,
                         o_f32 ? static_cast<float*>(o) : nullptr};
  return launch_d<0>(a, pg, d, num_pages, kvh, b);
}
#else
// The 8-bit form: the pools int8 (kv_dtype 2) or fp8 e4m3 (3) payloads,
// k_scales, v_scales their (num_pages, kvh, page_size) float32 scale pools;
// o_f32 as above (float32 q over 8-bit pages, taken in bf16).
extern "C" int fa_paged_prefill_tc_quant(int kv_dtype, const void* k_scales, const void* v_scales,
                                         const void* q, const void* k_pages, const void* v_pages,
                                         const void* page_indices, const void* ctx_lens, void* o,
                                         int b, int kvh, int rows, int d, int num_pages,
                                         int page_size, int pages_per_seq, int chunk, int seg,
                                         float scale, int window, float softcap, int o_f32,
                                         void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, seg, 0u, 0u, 0.f};
  fwd_tc::Args a{q, k_pages, v_pages, o, nullptr, nullptr, nullptr, nullptr, b * kvh, rows,
                 0, 0, 0, seg, 1, scale, window, softcap, ex, static_cast<cudaStream_t>(stream)};
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  const fwd_tc::Paged pg{static_cast<const int*>(page_indices), static_cast<const int*>(ctx_lens),
                         pages_per_seq, page_size, chunk,
                         o_f32 ? static_cast<float*>(o) : nullptr};
  switch (kv_dtype) {
    case 2: return launch_d<1>(a, pg, d, num_pages, kvh, b);
    case 3: return launch_d<2>(a, pg, d, num_pages, kvh, b);
    default: return -1;
  }
}
#endif
