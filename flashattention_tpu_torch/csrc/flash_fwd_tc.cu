// The tensor-core flash-attention forward's library (flash_fwd_tc, and with
// FA_EXTRA flash_fwd_tc_extra, the attention-dropout form): the C entry
// point over the kernel of flash_fwd_tc.cuh, instantiated at head_dim 64,
// 128 and 256 with and without the window/softcap form.  See
// flash_fwd_tc.cuh for what it replaces and its design.
#include "flash_fwd_tc.cuh"

namespace {

using fwd_tc::Args;

template <int D, bool kWindowCap>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return fwd_tc::launch<D, kWindowCap, true, 0>(a);
#else
  if (a.ex.threshold != 0) return -1;
  return fwd_tc::launch<D, kWindowCap, false, 0>(a);
#endif
}

template <int D>
int launch_w(const Args& a) {
  return a.window > 0 || a.softcap > 0.f ? launch_x<D, true>(a) : launch_x<D, false>(a);
}

}  // namespace

// q: (bh, rows, d); k, v: (bh, s_kv, d); o like q; all bf16, contiguous, on
// the device, 16-byte aligned (TMA); l, m: (bh, rows) float32 or both null;
// q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or neither null.
// window <= 0: no sliding window (else it requires causal); softcap <= 0:
// none.  dropout_threshold 0: no dropout; else (FA_EXTRA only) the seed,
// threshold, 1 / (1 - rate) and the raw row stride, as in fa_flash_fwd.
extern "C" int fa_flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* l,
                               void* m, const void* q_seg, const void* kv_seg, int bh, int rows,
                               int s_kv, int d, int kv_len, int q_offset, int q_seq_len,
                               int causal, float scale, int window, float softcap,
                               int row_stride, int dropout_seed, int dropout_threshold,
                               float dropout_inv, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, row_stride,
                      static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m),
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), bh, rows, s_kv,
               kv_len, q_offset, q_seq_len, causal, scale, window, softcap, ex,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 64: return launch_w<64>(a);
    case 128: return launch_w<128>(a);
    case 256: return launch_w<256>(a);
    default: return -1;
  }
}
