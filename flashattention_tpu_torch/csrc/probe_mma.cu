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
// Mode 4 at head_dim 128 is scripts/probe_d128.py's split2 (:73-81, two
// independent (m, l, acc) chains merged at the end; torch_tools/probe_d128.py).
//
// At head_dim 128 (torch_tools/probe_int8.py, fa_probe_int8), the port of
// scripts/probe_int8_decode.py's make (:35, pallas_call :109), which asks
// whether 8-bit K/V should be converted before bf16 products or multiplied
// natively: flavor 0 the forward over bf16 K/V, flavor 1 over int8 K/V
// converted to bf16 in shared memory (the kernel of flash_fwd_tc_quant,
// flash_fwd_tc.cuh's kKV form), flavor 2 native products (probe_i8 below):
// wgmma s8 x s8 -> s32 for QK^T over q quantized per row in the kernel
// (absmax / 127), the scores scaled back by q's and k's scales, and for PV
// over p quantized by 1 / 127 (p in [0, 1]), O scaled back by 1 / 127 and
// the tile's largest v_scale (the TPU probe's coarse per-page V scale).  An
// 8-bit wgmma reads both operands K-major only, so V is transposed in
// shared memory each tile (byte by byte), and P goes through shared memory
// (its accumulator layout is not an 8-bit A fragment).  Flavor 2 computes
// a different function (8-bit q and p): a measurement, not a kernel form.
//
// torch_tools/probe_stream.py, fa_probe_stream: the port of
// scripts/probe_small_fp32.py's hbm_floor (:35, pallas_call :43), a copy
// kernel that streams the bytes an attention call must move and does
// nothing else, so that a kernel's time can be set beside what a plain
// stream of the same bytes reaches on this card.  Mode 0 is the TPU
// probe's own: o = q + k + v over float32 (BH, S, d) tensors, 16 bytes a
// thread per load.  Mode 1 walks paged decode's pages: for each (split, KV
// head, request) block it reads, through the page table, the K and V rows
// paged_decode_tc's block reads (the split's 64-row tiles in [first, end),
// first the window's first column), 16 bytes a thread per load, four loads
// in flight, and folds them into one word per block (written, so that no
// load is dropped).
#include "flash_fwd_tc.cuh"

namespace {

namespace probe_i8 {

constexpr int D = 128, kN = 128, kBlockM = 128, kStages = 2, kTile = kN * 128;
// Q bf16 (2 chunks) | K stages | V stages | Q int8 | V^T int8 | P int8 (a
// 64-row half per consumer warpgroup) | q scales | k scales | V scale maxima
// by warp | barriers
constexpr int kQ = 0, kK = kQ + 2 * kBlockM * 128, kV = kK + kStages * kTile;
constexpr int kQi = kV + kStages * kTile, kVT = kQi + kBlockM * 128, kP = kVT + D * 128;
constexpr int kQs = kP + kBlockM * 128, kKs = kQs + kBlockM * 4, kVm = kKs + kN * 4;
constexpr int kBar = kVm + 16, kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;

// Byte b of row r in a 128-byte-swizzled tile of 128-byte rows.
__device__ __forceinline__ int swz(int r, int b) { return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15); }

__global__ void __launch_bounds__(384, 1)
int8mma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
               const float* __restrict__ k_scales, const float* __restrict__ v_scales, int rows,
               int s_kv, int kv_len, int q_offset, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  float* qs_s = reinterpret_cast<float*>(smem + kQs);
  float* ks_t = reinterpret_cast<float*>(smem + kKs);
  float* vm_t = reinterpret_cast<float*>(smem + kVm);
  const int bh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  int end = kv_len;
  if (causal) end = min(end, q_offset + min(rows, r0 + kBlockM));
  const int n_tiles = end > 0 ? (end + kN - 1) / kN : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);
      tc::mbar_init(&empty[s], 256);
    }
    tc::mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tc::mbar_arrive_tx(q_bar, 2 * kBlockM * 128);
      for (int c = 0; c < 2; ++c)
        tc::tma_load(smem + kQ + c * kBlockM * 128, &tm_q, q_bar, c * tc::kChunk, r0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * kTile);
        tc::tma_load(smem + kK + s * kTile, &tm_k, &full[s], 0, i * kN, bh);
        tc::tma_load(smem + kV + s * kTile, &tm_v, &full[s], 0, i * kN, bh);
      } else {
        tc::mbar_arrive(&full[s]);
      }
    }
    return;
  }
  tc::setmaxnreg_inc<240>();
  const int cw = wg - 1, tid = threadIdx.x % 128, ct = threadIdx.x - 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int la = 16 * warp + g, lb = la + 8;  // this thread's rows in its warpgroup's half
  const int pos_a = q_offset + r0 + 64 * cw + la, pos_b = pos_a + 8;
  tc::mbar_wait(q_bar, 0);
  {  // q quantized per row: two threads a row, 64 columns (one bf16 chunk) each
    const int qr = 64 * cw + tid / 2, hh = tid % 2;
    const unsigned char* chunk = smem + kQ + hh * kBlockM * 128;
    float x[64], amax = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint4 w = *reinterpret_cast<const uint4*>(chunk + qr * 128 + ((u ^ (qr & 7)) << 4));
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[h]));
        x[8 * u + 2 * h] = f.x;
        x[8 * u + 2 * h + 1] = f.y;
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float qs = amax == 0.f ? 1.f : amax / 127.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t wq[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        uint32_t b = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = max(-127, min(127, __float2int_rn(x[16 * u + 4 * h + e] / qs)));
          b |= (static_cast<uint32_t>(v) & 0xFFu) << (8 * e);
        }
        wq[h] = b;
      }
      *reinterpret_cast<uint4*>(smem + kQi + swz(qr, 64 * hh + 16 * u)) =
          make_uint4(wq[0], wq[1], wq[2], wq[3]);
    }
    if (hh == 0) qs_s[qr] = qs;
    tc::fence_async_smem();
    tc::named_sync(2 + cw, 128);
  }
  const float qs_a = qs_s[64 * cw + la], qs_b = qs_s[64 * cw + lb];
  float acc[64], m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  unsigned char* p_half = smem + kP + cw * 64 * 128;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, t0 = i * kN;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    tc::named_sync(1, 256);  // neither warpgroup reads the last tile's V^T or scales
    const unsigned char* vt8 = smem + kV + s * kTile;
    for (int u = ct; u < D * 8; u += 256) {  // V^T: row n (a column of V), 16 keys a unit
      const int n = u / 8, ku = u % 8;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int kv = 16 * ku + e;
        w[e / 4] |= static_cast<uint32_t>(vt8[swz(kv, n)]) << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(smem + kVT + swz(n, 16 * ku)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    {
      const int row = ct % kN, col = t0 + row;
      const float x = col < kv_len ? (ct < kN ? k_scales : v_scales)[static_cast<size_t>(bh) * s_kv + col] : 0.f;
      if (ct < kN) {
        ks_t[row] = x;
      } else {
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (ct % 32 == 0) vm_t[(ct - kN) / 32] = mx;
      }
    }
    tc::fence_async_smem();
    tc::named_sync(1, 256);
    const float vmax = fmaxf(fmaxf(vm_t[0], vm_t[1]), fmaxf(vm_t[2], vm_t[3]));
    int si[64];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const uint64_t da = tc::make_desc(tc::smem_u32(smem + kQi + cw * 64 * 128) + kk * 32, 16, 1024);
      const uint64_t db = tc::make_desc(tc::smem_u32(smem + kK + s * kTile) + kk * 32, 16, 1024);
      tc::wgmma_s8(si, da, db, kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(si);
    const bool need_mask = t0 + kN > kv_len || (causal && t0 + kN - 1 > pos_a - la);
    float sc[64], mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), pos = e < 2 ? pos_a : pos_b;
        float x = static_cast<float>(si[4 * j + e]) * (e < 2 ? qs_a : qs_b) * ks_t[c] * scale;
        if (need_mask && !(t0 + c < kv_len && (!causal || t0 + c <= pos))) x = fa::kMaskValue;
        sc[4 * j + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = tc::ex2((m_a - mx_a) * tc::kLog2e);
    const float alpha_b = tc::ex2((m_b - mx_b) * tc::kLog2e);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      int q8[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::ex2((sc[4 * j + e] - (e < 2 ? mx_a : mx_b)) * tc::kLog2e);
        if (e < 2) sum_a += p;
        else sum_b += p;
        q8[e] = __float2int_rn(p * 127.f);
      }
      const int c = 8 * j + 2 * t;  // two neighbouring columns of rows la and lb
      *reinterpret_cast<unsigned short*>(p_half + swz(la, c)) =
          static_cast<unsigned short>(q8[0] | (q8[1] << 8));
      *reinterpret_cast<unsigned short*>(p_half + swz(lb, c)) =
          static_cast<unsigned short>(q8[2] | (q8[3] << 8));
    }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
    tc::fence_async_smem();
    tc::named_sync(2 + cw, 128);
    int pv[64];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 32; ++kk) {
      const uint64_t da = tc::make_desc(tc::smem_u32(p_half) + kk * 32, 16, 1024);
      const uint64_t db = tc::make_desc(tc::smem_u32(smem + kVT) + kk * 32, 16, 1024);
      tc::wgmma_s8(pv, da, db, kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(pv);
    const float back = vmax * (1.f / 127.f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] = acc[4 * j + 0] * alpha_a + static_cast<float>(pv[4 * j + 0]) * back;
      acc[4 * j + 1] = acc[4 * j + 1] * alpha_a + static_cast<float>(pv[4 * j + 1]) * back;
      acc[4 * j + 2] = acc[4 * j + 2] * alpha_b + static_cast<float>(pv[4 * j + 2]) * back;
      acc[4 * j + 3] = acc[4 * j + 3] * alpha_b + static_cast<float>(pv[4 * j + 3]) * back;
    }
    tc::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a, inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
  const int ra = r0 + 64 * cw + la, rb = ra + 8;
  __nv_bfloat16* o_head = o + static_cast<size_t>(bh) * rows * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(ra) * D + c) =
          tc::pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(o_head + static_cast<size_t>(rb) * D + c) =
          tc::pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
}

int launch(const fwd_tc::Args& a) {
  CUtensorMap mq, mk, mv;
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, static_cast<long long>(a.rows) * D, kBlockM);
  if (st == 0)
    st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, static_cast<long long>(a.s_kv) * D, kN, 1, true);
  if (st == 0)
    st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, static_cast<long long>(a.s_kv) * D, kN, 1, true);
  if (st != 0) return st;
  const cudaError_t err =
      cudaFuncSetAttribute(int8mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + kBlockM - 1) / kBlockM, a.bh);
  int8mma_kernel<<<grid, 384, kBytes, a.stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(a.o),
                                                  a.k_scales, a.v_scales, a.rows, a.s_kv,
                                                  a.kv_len, a.q_offset, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe_i8

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
  } else if (mode == 4) {  // probe_d128.py's split2: two chains at d = 128
    return fwd_tc::launch<D, false, false, 4>(a);
  }
  return -1;
}

}  // namespace

// q, k, v, o: (bh, rows | s_kv, d) bf16; l, m: (bh, rows) float32.  Modes
// 0-2 at d = 64 and 128, modes 3-5 at d = 64, mode 4 also at d = 128.
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

// scripts/probe_int8_decode.py's three flavors at head_dim 128, no window or
// softcap, no GQA fold: q, o (bh, rows, 128) bf16; k, v (bh, s_kv, 128) bf16
// (flavor 0) or int8 (flavors 1 and 2) with k_scales, v_scales (bh, s_kv)
// float32 (ignored by flavor 0).
extern "C" int fa_probe_int8(int flavor, const void* q, const void* k, const void* v,
                             const void* k_scales, const void* v_scales, void* o, int bh, int rows,
                             int s_kv, int kv_len, int q_offset, int causal, float scale,
                             void* stream) {
  const fa::Extras ex{nullptr, nullptr, nullptr, nullptr, rows, 0u, 0u, 0.f};
  fwd_tc::Args a{q, k, v, o, nullptr, nullptr, nullptr, nullptr, bh, rows, s_kv, kv_len, q_offset,
                 rows, causal, scale, -1, 0.f, ex, static_cast<cudaStream_t>(stream)};
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  switch (flavor) {
    case 0: return fwd_tc::launch<128, false, false, 0, 0>(a);
    case 1: return fwd_tc::launch<128, false, false, 0, 1>(a);
    case 2: return probe_i8::launch(a);
    default: return -1;
  }
}

namespace {

__global__ void __launch_bounds__(256) stream_sum_kernel(const float4* __restrict__ a,
                                                         const float4* __restrict__ b,
                                                         const float4* __restrict__ c,
                                                         float4* __restrict__ o, long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += 256ll * gridDim.x) {
    const float4 x = a[i], y = b[i], z = c[i];
    o[i] = make_float4(x.x + y.x + z.x, x.y + y.y + z.y, x.z + y.z + z.z, x.w + y.w + z.w);
  }
}

__global__ void __launch_bounds__(256) page_walk_kernel(const uint4* __restrict__ k,
                                                        const uint4* __restrict__ v,
                                                        const int* __restrict__ lengths,
                                                        const int* __restrict__ table,
                                                        unsigned* __restrict__ out, int units,
                                                        int page_size, int pages_per_seq,
                                                        int tiles_per_split, int window) {
  constexpr int kTile = 64;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, kvh = gridDim.y;
  const int length = lengths[b];
  const int end = min(length, pages_per_seq * page_size);
  const int first = window > 0 ? max(0, length - window) : 0;
  const int c0 = max(split * tiles_per_split * kTile, first);
  const int c1 = min((split + 1) * tiles_per_split * kTile, end);
  const int* row = table + static_cast<size_t>(b) * pages_per_seq;
  unsigned acc = 0u;
  const long long n = c1 > c0 ? static_cast<long long>(c1 - c0) * units : 0;
  for (long long e0 = threadIdx.x; e0 < n; e0 += 4 * 256) {
    uint4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long e = e0 + 256ll * j;
      x[j] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n) {
        const int col = c0 + static_cast<int>(e / units), u = static_cast<int>(e % units);
        const size_t at = ((static_cast<size_t>(row[col / page_size]) * kvh + h) * page_size +
                           col % page_size) * units + u;
        const uint4 kx = k[at], vx = v[at];
        x[j] = make_uint4(kx.x ^ vx.x, kx.y ^ vx.y, kx.z ^ vx.z, kx.w ^ vx.w);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc ^= x[j].x ^ x[j].y ^ x[j].z ^ x[j].w;
  }
  for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) atomicXor(out + (static_cast<size_t>(b) * kvh + h) * gridDim.x + split, acc);
}

}  // namespace

// Mode 0: o = a + b + c over n float32 elements (n a multiple of 4, 16-byte
// aligned).  Mode 1: a, b the K and V page pools (P, kvh, page_size,
// row_bytes / elem) of any element type, lengths (nb,) and table (nb,
// pages_per_seq) int32, o (nb, kvh, splits) uint32, zeroed by the caller;
// row_bytes a multiple of 16; window <= 0: none.
extern "C" int fa_probe_stream(int mode, const void* a, const void* b, const void* c, void* o,
                               const void* lengths, const void* table, long long n, int nb,
                               int kvh, int row_bytes, int page_size, int pages_per_seq,
                               int splits, int tiles_per_split, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (n % 4) return -1;
    const long long n4 = n / 4;
    const int blocks = static_cast<int>(n4 / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
    stream_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(a),
                                              static_cast<const float4*>(b),
                                              static_cast<const float4*>(c),
                                              static_cast<float4*>(o), n4);
  } else if (mode == 1) {
    if (row_bytes % 16) return -1;
    page_walk_kernel<<<dim3(splits, kvh, nb), 256, 0, st>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<const int*>(lengths), static_cast<const int*>(table),
        static_cast<unsigned*>(o), row_bytes / 16, page_size, pages_per_seq, tiles_per_split,
        window);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
