// Flash-attention forward on Hopper's tensor cores (sm_90a): the kernel
// template of flash_fwd_tc.cu (and of the probe in probe_mma.cu).
//
// Replaces flashattention_tpu/ops/flash.py::_kernel (the Pallas forward,
// pallas_call in _flash_attention) for bf16 q/k/v at head_dim 64, 128 and
// 256: causal masking at position q_offset + (r mod q_seq_len) (the GQA row
// fold), kv_len, the score scale and a ragged S, a sliding window and a
// logit softcap (the compile-time form kWindowCap), segment ids, the softmax
// statistics (l, m) in float32, and attention dropout in the compile-time
// form kExtra (built with FA_EXTRA), with the hash of common.cuh bit for bit.
//
// Bound on this card: at the prefill and training shapes (S >= 1024, d >=
// 64) attention is bound by operations: 4 d flops a live (row, column) pair
// against 2 d bytes of K/V per query tile.  So the two products run on the
// tensor cores, bf16 x bf16 -> float32 (989 TFLOP/s dense, 15x the CUDA
// cores' float32 rate), and the softmax around them is kept to what each
// thread owns of the accumulator.
//
// Design: one block per (bh, 128 query rows), 384 threads.  Warpgroup 0 is
// the producer: after setmaxnreg gives up its registers, one warp loads Q
// once by TMA and keeps the K/V tiles (kBlockN rows) of a 2-stage ring in
// shared memory in flight, each stage guarded by a full and an empty
// mbarrier.  Warpgroups 1 and 2 are the consumers, 64 query rows each, with
// 240 registers a thread.  Per KV tile: S = Q K^T by wgmma m64nNk16 with both
// operands read from the swizzled tiles; the online softmax on the
// accumulator itself (each thread owns two rows of each 16-row slab, so a
// row's max needs two quad shuffles, and l stays a per-thread partial sum
// until the end); masks, softcap and the dropout hash from each element's
// (row, column); P split into two bf16 terms in registers and fed as the
// register A operand of O += P V, V read from shared memory in its MN-major
// (transposed) form, 64 columns of d at a time, each tile's part added to
// O in float32.  The KV loop skips what the scalar kernel skips: it
// starts at the first tile the window of the block's smallest position
// reaches and stops at the causal diagonal of its largest and at kv_len; a
// consumer whose own rows see none of a tile only waits for it and frees
// it, and only tiles that cross a bound are masked element by element.
// Rows past the end and K/V rows past kv_len arrive from TMA as zeros.  At
// d = 256 the 64 x 256 float32 O is 128 registers a thread, so the KV tile
// is 64 rows there (128 below), and Q (64 KB) plus two stages of K and V
// (128 KB) fill 192 KB of shared memory.
//
// Rounding: P (against the running max of the tiles seen so far) enters the
// PV product as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), each
// with its own wgmma, so that the product sees p to about 2^-17 where the
// Pallas kernel's bf16 mode rounds it once (flash.py:149); l sums the
// float32 p.  A single rounding moves an output row whose weight sits on a
// few keys by a unit of bf16 whenever the kernel's and any other sum of the
// same scores round one p apart, which no element-wise check can hold;
// the second term costs a second PV product (probe_mma.cu measures it).
// ops/flash.py::flash_attention_plain mirrors this form (TC_KV_TILE).
//
// kProbe (probe_mma.cu only): 1 runs the QK^T products and the softmax
// without the PV products, 2 the PV products on a constant P without the
// rest; 0 is the kernel.
#pragma once

#include "common.cuh"
#include "tc_common.cuh"

namespace fwd_tc {

constexpr int kBlockM = 128;  // query rows per block
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
struct Cfg {
  static constexpr int kN = D >= 256 ? 64 : 128;            // KV rows per tile
  static constexpr int kChunks = D / tc::kChunk;
  static constexpr int kQChunk = kBlockM * tc::kChunkRowBytes;   // one chunk of Q
  static constexpr int kKVChunk = kN * tc::kChunkRowBytes;       // one chunk of a K/V tile
  static constexpr int kTileBytes = kChunks * kKVChunk;
  // Q | K stages | V stages | kv segment ids by stage | barriers
  static constexpr int kK = kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kSeg = kV + kStages * kTileBytes;
  static constexpr int kBar = kSeg + kStages * kN * 4;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + tc::kAtomBytes;  // + alignment
};

// The KV columns [kv_begin, kv_end) the query rows [r0, r0 + kBlockM) may
// see, kv_begin a multiple of the tile: the same in producer and consumers.
struct Range {
  int begin, end;
};
template <int kN, bool kWindowCap>
__device__ __forceinline__ Range kv_range(int r0, int rows, int kv_len, int q_offset,
                                          int q_seq_len, int causal, int window) {
  const int r1 = min(rows, r0 + kBlockM) - 1;
  const bool one_segment = r0 / q_seq_len == r1 / q_seq_len;
  Range r{0, kv_len};
  if (causal) r.end = min(r.end, q_offset + (one_segment ? r1 % q_seq_len : q_seq_len - 1) + 1);
  if (kWindowCap && window > 0) {
    r.begin = max(0, q_offset + (one_segment ? r0 % q_seq_len : 0) - window + 1);
    r.begin -= r.begin % kN;
  }
  return r;
}

template <int D, bool kWindowCap, bool kExtra, int kProbe>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ l_out, float* __restrict__ m_out,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int rows,
                    int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                    int window, float softcap, const fa::Extras ex) {
  using C = Cfg<D>;
  constexpr int kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  int* seg_t = reinterpret_cast<int*>(smem + C::kSeg);

  const int bh = blockIdx.y;
  // The longest query tiles (causal: the last) first, for a shorter tail.
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const bool has_seg = q_seg != nullptr;
  const Range kv = kv_range<kN, kWindowCap>(r0, rows, kv_len, q_offset, q_seq_len, causal, window);
  const int n_tiles = kv.end > kv.begin ? (kv.end - kv.begin + kN - 1) / kN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 32);   // the producer warp's lanes
      tc::mbar_init(&empty[s], 256);  // every consumer thread
    }
    tc::mbar_init(q_bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    tc::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tc::mbar_arrive_tx(q_bar, C::kChunks * C::kQChunk);
      for (int c = 0; c < C::kChunks; ++c)
        tc::tma_load(smem + c * C::kQChunk, &tm_q, q_bar, c * tc::kChunk, r0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) tc::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      const int t0 = kv.begin + i * kN;
      if (has_seg)
        for (int j = lane; j < kN; j += 32)
          seg_t[s * kN + j] = t0 + j < kv_len ? kv_seg[static_cast<size_t>(bh) * s_kv + t0 + j] : 0;
      if (lane == 0) {
        tc::mbar_arrive_tx(&full[s], 2 * C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tc::tma_load(smem + C::kK + s * C::kTileBytes + c * C::kKVChunk, &tm_k, &full[s],
                       c * tc::kChunk, t0, bh);
          tc::tma_load(smem + C::kV + s * C::kTileBytes + c * C::kKVChunk, &tm_v, &full[s],
                       c * tc::kChunk, t0, bh);
        }
      } else {
        tc::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows rw0 .. rw0 + 63.
  tc::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int rw0 = r0 + 64 * cw;
  const int ra = rw0 + 16 * warp + g;  // this thread's rows: ra and ra + 8
  const int rb = ra + 8;
  const int pos_a = q_offset + ra % q_seq_len, pos_b = q_offset + rb % q_seq_len;
  // The positions this warpgroup's rows span (a GQA segment crossing: all).
  const bool wg_live = rw0 < rows;
  const int rw1 = min(rows, rw0 + 64) - 1;
  const bool wg_one = rw0 / q_seq_len == rw1 / q_seq_len;
  const int pmin = q_offset + (wg_one ? rw0 % q_seq_len : 0);
  const int pmax = q_offset + (wg_one ? rw1 % q_seq_len : q_seq_len - 1);
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const int seg_a = has_seg && ra < rows ? q_seg[static_cast<size_t>(bh) * rows + ra] : 0;
  const int seg_b = has_seg && rb < rows ? q_seg[static_cast<size_t>(bh) * rows + rb] : 0;
  unsigned key_a = 0, key_b = 0;
  const bool dropout = kExtra && ex.threshold != 0;
  if (dropout) {
    key_a = fa::dropout_row_key(ex, bh, ra, q_seq_len);
    key_b = fa::dropout_row_key(ex, bh, rb, q_seq_len);
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint32_t q_base = tc::smem_u32(smem) + cw * 64 * tc::kChunkRowBytes;
  tc::mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (i / kStages) & 1);
    const int t0 = kv.begin + i * kN;
    const bool skip = !wg_live || (causal && t0 > pmax) || (win > 0 && t0 + kN - 1 <= pmin - win);
    if (!skip) {
      const uint32_t k_base = tc::smem_u32(smem + C::kK + s * C::kTileBytes);
      const uint32_t v_base = tc::smem_u32(smem + C::kV + s * C::kTileBytes);
      float sc[kN / 2];
      if constexpr (kProbe != 2) {
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // a k-step inside the swizzled row
          const uint64_t da = tc::make_desc(q_base + (kk / 4) * C::kQChunk + off, 16, 1024);
          const uint64_t db = tc::make_desc(k_base + (kk / 4) * C::kKVChunk + off, 16, 1024);
          tc::wgmma_ss<0, 0>(sc, da, db, kk > 0);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs(sc);

        const bool need_mask = has_seg || t0 + kN > kv_len || (causal && t0 + kN - 1 > pmin) ||
                               (win > 0 && t0 <= pmax - win);
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale;
            if (kWindowCap && cap > 0.f) x = fa::softcap(x, cap);
            if (need_mask) {
              const int col = t0 + 8 * j + 2 * t + (e & 1);
              const int pos = e < 2 ? pos_a : pos_b;
              const bool keep = col < kv_len && (!causal || col <= pos) &&
                                (win <= 0 || col > pos - win) &&
                                (!has_seg || seg_t[s * kN + col - t0] == (e < 2 ? seg_a : seg_b));
              if (!keep) x = fa::kMaskValue;
            }
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
        // exp(s - m) as 2^((s - m) log2 e), the difference taken first.
        const float alpha_a = tc::ex2((m_a - mx_a) * tc::kLog2e);
        const float alpha_b = tc::ex2((m_b - mx_b) * tc::kLog2e);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = tc::ex2((sc[4 * j + e] - (e < 2 ? m_a : m_b)) * tc::kLog2e);
            if (e < 2) sum_a += p;
            else sum_b += p;
            if (dropout) {  // l keeps the undropped sum; the PV product takes the kept p
              const int col = t0 + 8 * j + 2 * t + (e & 1);
              p = fa::dropout_kept(e < 2 ? key_a : key_b, col, ex.threshold) ? p * ex.inv : 0.f;
            }
            sc[4 * j + e] = p;
          }
        }
        l_a = alpha_a * l_a + sum_a;
        l_b = alpha_b * l_b + sum_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= alpha_a;
          acc[4 * j + 1] *= alpha_a;
          acc[4 * j + 2] *= alpha_b;
          acc[4 * j + 3] *= alpha_b;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) sc[j] = 1.f / kN;
      }
      if constexpr (kProbe != 1) {  // O += P V, P as two bf16 terms
        uint32_t pa[kN / 16][4], pl[kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) tc::pack_a2(pa[kk], pl[kk], sc, kk);
        // 64 columns of d at a time: each tile's part is summed afresh on
        // the tensor cores and added to O here in float32.  Adding every
        // tile into O on the tensor cores instead chains 2 kN / 16 k-steps
        // a tile through their truncating float32 addition, which moves the
        // small outputs of a peaked softmax (q x 8, S = 5000) by about 1e-5.
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          float part[32];
          tc::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kN / 16; ++kk) {
            const uint64_t db = tc::make_desc(
                v_base + c * C::kKVChunk + kk * 16 * tc::kChunkRowBytes, C::kKVChunk, 1024);
            tc::wgmma_rs<1>(part, pa[kk], db, kk > 0);
            tc::wgmma_rs<1>(part, pl[kk], db, 1);
          }
          tc::wgmma_commit();
          tc::wgmma_wait<0>();
          tc::fence_regs(part);
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[32 * c + x] += part[x];
        }
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(pa[kk][w]), "+r"(pl[kk][w])::"memory");
      }
    }
    tc::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // The l == 0 guard of the Pallas epilogue (flash.py:1118).
  const float inv_a = l_a == 0.f ? 1.f : 1.f / l_a;
  const float inv_b = l_b == 0.f ? 1.f : 1.f / l_b;
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
  if (l_out != nullptr && t == 0) {
    const size_t head = static_cast<size_t>(bh) * rows;
    if (ra < rows) {
      l_out[head + ra] = l_a;
      m_out[head + ra] = m_a;
    }
    if (rb < rows) {
      l_out[head + rb] = l_b;
      m_out[head + rb] = m_b;
    }
  }
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;
  float* m;
  const int* q_seg;
  const int* kv_seg;
  int bh, rows, s_kv, kv_len, q_offset, q_seq_len, causal;
  float scale;
  int window;
  float softcap;
  fa::Extras ex;
  cudaStream_t stream;
};

template <int D, bool kWindowCap, bool kExtra, int kProbe>
int launch(const Args& a) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  // K/V rows past kv_len read as zeros: V's there may be anything.
  const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, static_cast<long long>(a.rows) * D, kBlockM);
  if (st == 0)
    st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, static_cast<long long>(a.s_kv) * D, C::kN);
  if (st == 0)
    st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, static_cast<long long>(a.s_kv) * D, C::kN);
  if (st != 0) return st;
  auto kernel = flash_fwd_tc_kernel<D, kWindowCap, kExtra, kProbe>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + kBlockM - 1) / kBlockM, a.bh);
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.l, a.m, a.q_seg, a.kv_seg, a.rows, a.s_kv,
      a.kv_len, a.q_offset, a.q_seq_len, a.causal, a.scale, a.window, a.softcap, a.ex);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd_tc
