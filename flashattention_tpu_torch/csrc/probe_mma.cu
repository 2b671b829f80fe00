// H100 probes of the tensor-core forward's loop bodies: the kernel of
// flash_fwd_tc.cuh in its probe modes, without window or softcap.
//
// At head_dim 128 (torch_tools/probe_mma.py), the port of
// scripts/probe_mxu.py's _qk_like (:38) and _pv_like (:100): its QK^T
// products and softmax alone (mode 1, no PV products) or its PV products
// alone on a constant P (mode 2), beside the whole kernel (mode 0).
//
// At head_dim 64 (torch_tools/probe_softmax.py), the ports of
// scripts/probe_local_softmax.py's build (:41) and scripts/probe_chain.py's
// build (:40), which ask whether the online softmax stalls on its own
// recurrence: mode 3 exponentiates each tile against its own max and then
// rescales by exp(m_tile - m_next), so that no exponential waits for the
// running max; modes 4 and 5 deal the tiles round-robin to 2 and 4
// independent (m, l, O) chains, merged in the epilogue; beside mode 0.
#include "flash_fwd_tc.cuh"

namespace {

template <int D>
int launch_mode(int mode, const fwd_tc::Args& a) {
  switch (mode) {
    case 0: return fwd_tc::launch<D, false, false, 0>(a);
    case 1: return fwd_tc::launch<D, false, false, 1>(a);
    case 2: return fwd_tc::launch<D, false, false, 2>(a);
    default: break;
  }
  if constexpr (D == 64) {
    switch (mode) {
      case 3: return fwd_tc::launch<D, false, false, 3>(a);
      case 4: return fwd_tc::launch<D, false, false, 4>(a);
      case 5: return fwd_tc::launch<D, false, false, 5>(a);
      default: break;
    }
  }
  return -1;
}

}  // namespace

// q, k, v, o: (bh, rows | s_kv, d) bf16; l, m: (bh, rows) float32.  Modes
// 0-2 at d = 64 and 128, modes 3-5 at d = 64.
extern "C" int fa_probe_mma(int mode, const void* q, const void* k, const void* v, void* o,
                            void* l, void* m, int bh, int rows, int s_kv, int d, int causal,
                            float scale, void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, rows, 0u, 0u, 0.f};
  const fwd_tc::Args a{q, k, v, o, static_cast<float*>(l), static_cast<float*>(m), nullptr,
                       nullptr, bh, rows, s_kv, s_kv, 0, rows, causal, scale, -1, 0.f, ex,
                       static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 64: return launch_mode<64>(mode, a);
    case 128: return launch_mode<128>(mode, a);
    default: return -1;
  }
}
