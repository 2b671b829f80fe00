// The tensor-core flash-attention forward's library (flash_fwd_tc, and with
// FA_EXTRA flash_fwd_tc_extra, the attention-dropout and block-mask form; with FA_QUANT
// flash_fwd_tc_quant, the form over 8-bit K/V with float32 per-row scales;
// with FA_F32 flash_fwd_tc_f32, float32 inputs as the JAX precision modes
// compute them, and with FA_F32 and FA_EXTRA flash_fwd_tc_f32_extra, their
// split-pass form with attention dropout): the C entry point over the kernel
// of flash_fwd_tc.cuh, instantiated at head_dim 64, 128 and 256 with and without the
// window/softcap form (the 8-bit library: for int8 and for fp8 e4m3
// payloads; the float32 one: "bf16" at 64, 128 and 256, "bf16_3x" at 64 and
// 128 over a split pass, and flash_fwd_f32.cuh's kernel for "float32" at
// every head_dim and "bf16_3x" at 256).  See flash_fwd_tc.cuh and
// flash_fwd_f32.cuh for what they replace and their design.
#include "flash_fwd_tc.cuh"
#if defined(FA_F32) && !defined(FA_EXTRA)
#include "flash_fwd_f32.cuh"
#endif

namespace {

using fwd_tc::Args;

template <int D, bool kWindowCap, int kKV>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return fwd_tc::launch<D, kWindowCap, true, 0>(a);
#else
  if (a.ex.threshold != 0 || a.ex.bm_ptr != nullptr) return -1;
  return fwd_tc::launch<D, kWindowCap, false, 0, kKV>(a);
#endif
}

template <int D, int kKV>
int launch_w(const Args& a) {
  return a.window > 0 || a.softcap > 0.f ? launch_x<D, true, kKV>(a) : launch_x<D, false, kKV>(a);
}

template <int kKV>
int launch_d(const Args& a, int d) {
  switch (d) {
    case 64: return launch_w<64, kKV>(a);
    case 128: return launch_w<128, kKV>(a);
    case 256: return launch_w<256, kKV>(a);
    default: return -1;
  }
}

// bm: a block mask's table over (128, kN) tiles by query tile (ptr, idx,
// part, bits; common.cuh, Extras), or null.
Args make_args(const void* q, const void* k, const void* v, void* o, void* l, void* m,
               const void* q_seg, const void* kv_seg, const void* const* bm, int bh, int rows,
               int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
               int window, float softcap, int row_stride, int dropout_seed,
               int dropout_threshold, float dropout_inv, void* stream) {
  fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                static_cast<unsigned>(dropout_seed), static_cast<unsigned>(dropout_threshold),
                dropout_inv};
  if (bm != nullptr) {
    ex.bm_ptr = static_cast<const int*>(bm[0]);
    ex.bm_idx = static_cast<const int*>(bm[1]);
    ex.bm_part = static_cast<const int*>(bm[2]);
    ex.bm_bits = static_cast<const unsigned*>(bm[3]);
  }
  return Args{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m),
              static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), bh, rows, s_kv,
              kv_len, q_offset, q_seq_len, causal, scale, window, softcap, ex,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

#ifdef FA_F32
namespace {

#ifdef FA_EXTRA
constexpr bool kF32Extra = true;
#else
constexpr bool kF32Extra = false;
#endif

// Two terms: all four products at d = 64 (the JAX packed form), three at
// 128; one term: the bf16 form.
template <int D, bool kWindowCap>
int launch_f32(const Args& a, int terms) {
  if (terms == 1) return fwd_tc::launch<D, kWindowCap, kF32Extra, 0, 0, 1>(a);
  if constexpr (D == 256) return -1;
  else return fwd_tc::launch<D, kWindowCap, kF32Extra, 0, 0, D == 64 ? 4 : 3>(a);
}

template <int D>
int launch_f32_w(const Args& a, int terms) {
  return a.window > 0 || a.softcap > 0.f ? launch_f32<D, true>(a, terms)
                                         : launch_f32<D, false>(a, terms);
}

}  // namespace

// Float32 q, k, v (bh, rows, d) / (bh, s_kv, d), contiguous, 16-byte aligned;
// o: float32 like q.  terms 3 is "float32" (three bf16 terms a value, six
// products), 2 "bf16_3x" (two terms), 1 "bf16" (one).  Where a split pass
// runs (terms 1; terms 2 at d = 64 and 128), q2, k2, v2 are bf16 buffers of
// the same rows and terms * d columns, which it fills before the kernel
// reads them; flash_fwd_f32.cuh's kernel (terms 3; terms 2 at d = 256)
// splits in shared memory and takes none.  The other arguments as in
// fa_flash_fwd_tc, without a block mask; dropout (dropout_threshold != 0)
// in the FA_EXTRA library only, which holds the split-pass form alone
// (terms 1 and 2 at d = 64 and 128).
extern "C" int fa_flash_fwd_tc_f32(int terms, const void* q, const void* k, const void* v,
                                   void* q2, void* k2, void* v2, void* o, void* l, void* m,
                                   const void* q_seg, const void* kv_seg, int bh, int rows,
                                   int s_kv, int d, int kv_len, int q_offset, int q_seq_len,
                                   int causal, float scale, int window, float softcap,
                                   int row_stride, int dropout_seed, int dropout_threshold,
                                   float dropout_inv, void* stream) {
  if (terms < 1 || terms > 3 || (d != 64 && d != 128 && d != 256)) return -1;
  if (kF32Extra ? terms == 3 || d == 256 : dropout_threshold != 0) return -1;
#ifndef FA_EXTRA
  if (terms == 3 || (terms == 2 && d == 256)) {
    Args a = make_args(q, k, v, nullptr, l, m, q_seg, kv_seg, nullptr, bh, rows, s_kv, kv_len,
                       q_offset, q_seq_len, causal, scale, window, softcap, q_seq_len, 0, 0, 0.f,
                       stream);
    a.o32 = static_cast<float*>(o);
    const fwd_tc::Paged pg{};
    if (terms == 2) return f32tc::launch_w<256, 2, false>(a, pg);
    switch (d) {
      case 64: return f32tc::launch_w<64, 3, false>(a, pg);
      case 128: return f32tc::launch_w<128, 3, false>(a, pg);
      default: return f32tc::launch_w<256, 3, false>(a, pg);
    }
  }
#endif
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = tc::split(q, q2, static_cast<long long>(bh) * rows, d, terms, st);
  if (status == 0) status = tc::split(k, k2, static_cast<long long>(bh) * s_kv, d, terms, st);
  if (status == 0) status = tc::split(v, v2, static_cast<long long>(bh) * s_kv, d, terms, st);
  if (status != 0) return status;
  Args a = make_args(q2, k2, v2, nullptr, l, m, q_seg, kv_seg, nullptr, bh, rows, s_kv, kv_len,
                     q_offset, q_seq_len, causal, scale, window, softcap, row_stride, dropout_seed,
                     dropout_threshold, dropout_inv, stream);
  a.o32 = static_cast<float*>(o);
  switch (d) {
    case 64: return launch_f32_w<64>(a, terms);
    case 128: return launch_f32_w<128>(a, terms);
#ifdef FA_EXTRA
    default: return -1;
#else
    default: return launch_f32_w<256>(a, terms);
#endif
  }
}
#elif !defined(FA_QUANT)
// q: (bh, rows, d); k, v: (bh, s_kv, d); o like q; all bf16, contiguous, on
// the device, 16-byte aligned (TMA); l, m: (bh, rows) float32 or both null;
// q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither null.
// window <= 0: no sliding window (else it requires causal); softcap <= 0:
// none.  dropout_threshold 0: no dropout; else (FA_EXTRA only) the seed,
// threshold, 1 / (1 - rate) and the raw row stride, as in fa_flash_fwd.
// bm_ptr null: no block mask; else (FA_EXTRA only, not with causal or a
// window) its table over (128, kN) tiles by query tile, kN = 128 at d = 64
// and 128 and 64 at d = 256, as in fa_flash_fwd.
extern "C" int fa_flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* l,
                               void* m, const void* q_seg, const void* kv_seg, const void* bm_ptr,
                               const void* bm_idx, const void* bm_part, const void* bm_bits,
                               int bh, int rows, int s_kv, int d, int kv_len, int q_offset,
                               int q_seq_len, int causal, float scale, int window, float softcap,
                               int row_stride, int dropout_seed, int dropout_threshold,
                               float dropout_inv, void* stream) {
  const void* const bm[4] = {bm_ptr, bm_idx, bm_part, bm_bits};
  const Args a = make_args(q, k, v, o, l, m, q_seg, kv_seg, bm_ptr != nullptr ? bm : nullptr, bh,
                           rows, s_kv, kv_len, q_offset, q_seq_len, causal, scale, window,
                           softcap, row_stride, dropout_seed, dropout_threshold, dropout_inv,
                           stream);
  return launch_d<0>(a, d);
}
#else
// The 8-bit form: k, v int8 (kv_dtype 2) or fp8 e4m3 (3) payloads, k_scales
// and v_scales (bh, s_kv) float32; no dropout (dropout_threshold 0).  o_f32:
// o is float32 (float32 q taken in bf16, as the Pallas kernel's "bf16" mode
// takes it, flash.py:825, whose output is q's type), written straight from
// the float32 sums.
extern "C" int fa_flash_fwd_tc_quant(int kv_dtype, int o_f32, const void* k_scales,
                                     const void* v_scales,
                                     const void* q, const void* k, const void* v, void* o,
                                     void* l, void* m, const void* q_seg, const void* kv_seg,
                                     int bh, int rows, int s_kv, int d, int kv_len, int q_offset,
                                     int q_seq_len, int causal, float scale, int window,
                                     float softcap, int row_stride, int dropout_seed,
                                     int dropout_threshold, float dropout_inv, void* stream) {
  Args a = make_args(q, k, v, o, l, m, q_seg, kv_seg, nullptr, bh, rows, s_kv, kv_len, q_offset,
                     q_seq_len, causal, scale, window, softcap, row_stride, dropout_seed,
                     dropout_threshold, dropout_inv, stream);
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  if (o_f32) a.o32 = static_cast<float*>(o);
  switch (kv_dtype) {
    case 2: return launch_d<1>(a, d);
    case 3: return launch_d<2>(a, d);
    default: return -1;
  }
}
#endif
