// H100 probe of the tensor-core forward's two loop bodies, the port of
// scripts/probe_mxu.py's _qk_like (:38) and _pv_like (:100): the kernel of
// flash_fwd_tc.cuh with its QK^T products and softmax alone (mode 1, no PV
// products) or its PV products alone on a constant P (mode 2), beside the
// whole kernel (mode 0), at head_dim 128 without window or softcap.  Run by
// torch_tools/probe_mma.py, which reports each mode's time and TFLOP/s.
#include "flash_fwd_tc.cuh"

extern "C" int fa_probe_mma(int mode, const void* q, const void* k, const void* v, void* o,
                            void* l, void* m, int bh, int rows, int s_kv, int causal,
                            float scale, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, rows, 0u, 0u, 0.f};
  const fwd_tc::Args a{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m), nullptr,
                       nullptr, bh, rows, s_kv, s_kv, 0, rows, causal, scale, -1, 0.f, ex,
                       static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return fwd_tc::launch<128, false, false, 0>(a);
    case 1: return fwd_tc::launch<128, false, false, 1>(a);
    case 2: return fwd_tc::launch<128, false, false, 2>(a);
    default: return -1;
  }
}
