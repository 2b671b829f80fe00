// Float32 attention on Hopper's tensor cores (sm_90a), each float32 value as
// bf16 terms split in shared memory: the flash forward's float32 form in the
// JAX package's "float32" mode (XLA's HIGHEST, flash.py:40, :160-165) at
// head_dim 64, 128 and 256 and in its "bf16_3x" mode at 256 (built into
// flash_fwd_tc.cu with FA_F32), and chunked prefill over float32 page pools
// (paged_prefill_tc.cu built with FA_F32), which the Pallas kernel computes
// at HIGHEST (decode.py:438-447).
//
// Replaces flashattention_tpu/ops/flash.py::_kernel (pallas_call in
// _flash_attention) for float32 q, k and v in those modes, and
// flashattention_tpu/ops/decode.py::_paged_prefill_kernel (the pallas_calls
// in paged_prefill_attention[_batched]) for float32 q over float32 pools:
// causal masking at position q_offset + (r mod q_seq_len) (the GQA row
// fold), kv_len, the score scale and a ragged S, a sliding window and a logit
// softcap (kWindowCap), segment ids (flat form), the softmax statistics (l,
// m), float32 O; paged: K/V through each request's page table, its context
// length and anchor read on the device, rows that see no column written as
// zeros (as flash_fwd_tc.cuh's kPaged form).
//
// The arithmetic.  kT = 3 ("float32"): x = x1 + x2 + x3, x1 = bf16(x), x2 =
// bf16(x - x1), x3 = bf16(x - x1 - x2) (each rounded to nearest even), and
// a product sums the six term products x1 y1, x1 y2, x2 y1, x1 y3, x2 y2,
// x3 y1 in float32, the small ones issued first; kT = 2 ("bf16_3x"): x1 and
// x2, and the three products x1 y1, x1 y2, x2 y1 (the JAX _dot_g,
// flash.py:150-181).  S = Q K^T takes q's and k's terms, x1 y1 summed over
// all of d in one float32 accumulator and the smaller products in another,
// added once at the end: the tensor cores' float32 addition truncates, and
// a chain that adds the small products of each chunk of d to the large sum
// of the chunks before loses their low bits (5e-6 of the output at d = 256
// in one chain).  P (float32 p against the running max) is split the same
// way in registers and O += P V takes p's and v's terms, each 64-column
// chunk of V's part summed afresh on the tensor cores and added to O in
// float32; l sums the float32 p.
//
// Bound on this card: operations.  A live (row, column) pair costs 2 x 2 d
// flops per product in S and in PV: 12 products' worth at kT = 3, 24 d
// flops a pair (6 d at kT = 2), all on wgmma at the bf16 rate; the float32
// bytes are read once per query block.
//
// The hard part is room: at d = 256 a 128-row block of Q alone is 192 KB as
// three bf16 terms.  So a block is 64 query rows (one consumer warpgroup,
// 256 threads with the producer's), Q's terms stay in shared memory (24 KB
// at d = 64, 48 KB at 128, 64 / 96 KB at 256 with two / three terms), and
// K and V stream through a ring of float32 units, each a 64-column chunk of
// d of kN rows of a tile (kN = 64, 32 at d = 256 where O takes 128 registers
// a thread): the producer's one thread loads each unit by TMA (a float32
// tensor map, or through the page table in boxes of min(kN, page_size) rows,
// only those that hold a live column), and the consumers split it into the
// 128-byte-swizzled bf16 term chunks wgmma reads, in one of two conversion
// buffers, rows outside [first, end) as zeros without reading them (stale
// pages, unloaded boxes: NaN never reaches a product).  Chunk c's products
// are issued right after its split and run while chunk c + 1 is split into
// the other buffer: S accumulates over the chunks of d, O's chunk c takes V's
// chunk c.  Q comes through the same ring first and is split once per block.
// Shared memory: Q's terms, the ring (64 KB), two conversion buffers (kT
// term chunks of kN rows each): 136 KB at d = 64, 160 KB at 128, 144 KB
// (bf16_3x) and 184 KB (float32) at 256.
#pragma once

#include <type_traits>

#include "flash_fwd_tc.cuh"

namespace f32tc {

constexpr int kM = 64;  // query rows per block
constexpr int kThreads = 256;  // the producer warpgroup, then the consumer warpgroup
constexpr int kRingBytes = 64 * 1024;
constexpr int kUnitRowBytes = 256;  // a unit's row: 64 float32 columns

template <int D, int kT>
struct Cfg {
  static constexpr int kN = D >= 256 ? 32 : 64;            // KV rows per tile
  static constexpr int kChunks = D / tc::kChunk;
  static constexpr int kUnit = kN * kUnitRowBytes;        // one float32 unit of the ring
  static constexpr int kStages = kRingBytes / kUnit;
  static constexpr int kQTerm = kM * tc::kChunkRowBytes;  // one term of one chunk of Q
  static constexpr int kCTerm = kN * tc::kChunkRowBytes;  // one term of a converted chunk
  static constexpr int kPairs = kT == 3 ? 6 : 3;
  // Q's terms (term a, chunk c at (a kChunks + c) kQTerm) | ring | two
  // conversion buffers | barriers
  static constexpr int kRing = kT * kChunks * kQTerm;
  static constexpr int kConv = kRing + kRingBytes;
  static constexpr int kBar = kConv + 2 * kT * kCTerm;
  static constexpr int kBytes = kBar + 8 * 2 * kStages + tc::kAtomBytes;  // + alignment
};

// The products' (left term, right term) pairs, the small ones first: kT 3
// (2,0) (1,1) (0,2) (1,0) (0,1) (0,0); kT 2 (1,0) (0,1) (0,0).
__host__ __device__ constexpr int pair_a(int kT, int i) {
  return kT == 3 ? (i == 0 ? 2 : i == 1 || i == 3 ? 1 : 0) : (i == 0 ? 1 : 0);
}
__host__ __device__ constexpr int pair_b(int kT, int i) {
  return kT == 3 ? (i == 2 ? 2 : i == 1 || i == 4 ? 1 : 0) : (i == 1 ? 1 : 0);
}

using tc::split_pair;  // two neighbouring float32 values as kT bf16x2 words

// A float32 unit (kRows rows of 64 columns, 256-byte rows) into kT bf16
// term chunks at dst + a * term_stride, its row r at row row0 + r of the
// chunk (128-byte rows, 16-byte unit u of row R at u ^ (R % 8)), by the 128
// consumer threads: each takes 8 columns of a row.  Rows outside [lo, hi)
// are written as zeros without being read.
template <int kT, int kRows>
__device__ __forceinline__ void split_unit(const unsigned char* src, unsigned char* dst,
                                           int term_stride, int row0, int lo, int hi, int ct) {
#pragma unroll
  for (int i = 0; i < kRows * 8 / 128; ++i) {
    const int x = ct + 128 * i, row = x / 8, grp = x % 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row >= lo && row < hi) {
      a = *reinterpret_cast<const float4*>(src + row * kUnitRowBytes + grp * 32);
      b = *reinterpret_cast<const float4*>(src + row * kUnitRowBytes + grp * 32 + 16);
    }
    uint32_t w[4][kT];
    split_pair<kT>(a.x, a.y, w[0]);
    split_pair<kT>(a.z, a.w, w[1]);
    split_pair<kT>(b.x, b.y, w[2]);
    split_pair<kT>(b.z, b.w, w[3]);
    const int r = row0 + row;
    unsigned char* at = dst + r * tc::kChunkRowBytes + ((grp ^ (r % 8)) * 16);
#pragma unroll
    for (int t = 0; t < kT; ++t)
      *reinterpret_cast<uint4*>(at + t * term_stride) = make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
  }
}

template <int D, int kT, bool kWindowCap, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                     float* __restrict__ l_out, float* __restrict__ m_out,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int rows,
                     int s_kv, int kv_len, int q_offset, int q_seq_len, int causal, float scale,
                     int window, float softcap, const fwd_tc::Paged pg) {
  using C = Cfg<D, kT>;
  constexpr int kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + C::kStages;

  // Paged: grid (row tiles, KV heads, requests); q and o are (B, KVH, rows, d).
  const int bh = kPaged ? blockIdx.z * gridDim.y + blockIdx.y : blockIdx.y;
  if constexpr (kPaged) {
    const int ctx = pg.ctx_lens[blockIdx.z];
    kv_len = min(ctx, pg.pages_per_seq * pg.page_size);
    q_offset = ctx - pg.chunk;
  }
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kM;  // the longest query tiles first
  const bool has_seg = q_seg != nullptr;
  const fwd_tc::Range kv =
      fwd_tc::kv_range<kN, kWindowCap, kM>(r0, rows, kv_len, q_offset, q_seq_len, causal, window);
  const int n_tiles = kv.end > kv.begin ? (kv.end - kv.begin + kN - 1) / kN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      tc::mbar_init(&full[s], 1);    // the producer's thread
      tc::mbar_init(&empty[s], 128);  // every consumer thread
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread keeps the ring full
    if (threadIdx.x != 0) return;
    int u = 0;  // units issued
    // Unit u's stage, once free, armed for `bytes`.
    auto stage = [&](int bytes) {
      const int s = u % C::kStages;
      if (u >= C::kStages) tc::mbar_wait(&empty[s], (u / C::kStages - 1) & 1);
      tc::mbar_arrive_tx(&full[s], bytes);
      ++u;
      return s;
    };
    for (int c = 0; c < C::kChunks; ++c)
      for (int rr = 0; rr < kM; rr += kN) {
        const int s = stage(C::kUnit);
        tc::tma_load(smem + C::kRing + s * C::kUnit, &tm_q, &full[s], c * tc::kChunk, r0 + rr, bh);
      }
    for (int i = 0; i < n_tiles; ++i) {
      const int t0 = kv.begin + i * kN;
      for (int kv_side = 0; kv_side < 2; ++kv_side) {
        const CUtensorMap* map = kv_side == 0 ? &tm_k : &tm_v;
        for (int c = 0; c < C::kChunks; ++c) {
          if constexpr (kPaged) {
            // Boxes of min(kN, page_size) rows, each inside one page: only
            // those that hold a column in [kv.first, kv.end).
            const int box = min(kN, pg.page_size);
            const int* table = pg.page_indices + static_cast<size_t>(blockIdx.z) * pg.pages_per_seq;
            int n_box = 0;
            for (int j = 0; j < kN; j += box) n_box += t0 + j + box > kv.first && t0 + j < kv.end;
            const int s = stage(n_box * box * kUnitRowBytes);
            for (int j = 0; j < kN; j += box) {
              const int t = t0 + j;
              if (t + box <= kv.first || t >= kv.end) continue;
              tc::tma_load4(smem + C::kRing + s * C::kUnit + j * kUnitRowBytes, map, &full[s],
                            c * tc::kChunk, t % pg.page_size, blockIdx.y, table[t / pg.page_size]);
            }
          } else {
            const int s = stage(C::kUnit);
            tc::tma_load(smem + C::kRing + s * C::kUnit, map, &full[s], c * tc::kChunk, t0, bh);
          }
        }
      }
    }
    return;
  }

  // The consumer warpgroup: rows r0 .. r0 + 63.
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int ra = r0 + 16 * warp + g;  // this thread's rows: ra and ra + 8
  const int rb = ra + 8;
  const int pos_a = q_offset + ra % q_seq_len, pos_b = q_offset + rb % q_seq_len;
  const int r1 = min(rows, r0 + kM) - 1;
  const bool one = r0 / q_seq_len == r1 / q_seq_len;
  const int pmin = q_offset + (one ? r0 % q_seq_len : 0);
  const int pmax = q_offset + (one ? r1 % q_seq_len : q_seq_len - 1);
  const int win = kWindowCap ? window : 0;
  const float cap = kWindowCap ? softcap : 0.f;
  const int seg_a = has_seg && ra < rows ? q_seg[static_cast<size_t>(bh) * rows + ra] : 0;
  const int seg_b = has_seg && rb < rows ? q_seg[static_cast<size_t>(bh) * rows + rb] : 0;
  const int* kv_seg_h = has_seg ? kv_seg + static_cast<size_t>(bh) * s_kv : nullptr;

  int u = 0;  // units taken
  // Wait for unit u; returns its stage.
  auto take = [&]() {
    const int s = u % C::kStages;
    tc::mbar_wait(&full[s], (u / C::kStages) & 1);
    ++u;
    return s;
  };
  // Q's units into its terms, once.
  for (int c = 0; c < C::kChunks; ++c)
    for (int rr = 0; rr < kM; rr += kN) {
      const int s = take();
      split_unit<kT, kN>(smem + C::kRing + s * C::kUnit, smem + c * C::kQTerm,
                         C::kChunks * C::kQTerm, rr, 0, kN, tid);
      tc::mbar_arrive(&empty[s]);
    }
  tc::fence_async_smem();
  tc::named_sync(1, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint32_t q_base = tc::smem_u32(smem);
  int v_units = 0;  // K/V units converted: unit v goes to buffer v % 2
  // The next K or V unit of the tile at t0 into a conversion buffer, rows
  // outside [kv.first, kv.end) as zeros; returns the buffer's address.  The
  // products of the unit before last, which read that buffer, are done
  // first (at most one commit group, the last unit's, is left in flight).
  auto convert = [&](int t0) {
    const int s = take();
    unsigned char* buf = smem + C::kConv + (v_units++ % 2) * kT * C::kCTerm;
    tc::wgmma_wait<1>();
    split_unit<kT, kN>(smem + C::kRing + s * C::kUnit, buf, C::kCTerm, 0, kv.first - t0,
                       kv.end - t0, tid);
    tc::mbar_arrive(&empty[s]);
    tc::fence_async_smem();
    tc::named_sync(1, 128);
    return tc::smem_u32(buf);
  };

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = kv.begin + i * kN;
    // S = Q K^T over the chunks of d, each chunk's products in flight while
    // the next chunk is split: x1 y1 into sc, the smaller products into s_lo.
    float sc[kN / 2], s_lo[kN / 2];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      const uint32_t k_base = convert(t0);
      tc::wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < C::kPairs; ++pr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = kk * 32;  // a k-step inside the swizzled row
          const uint64_t da = tc::make_desc(
              q_base + (pair_a(kT, pr) * C::kChunks + c) * C::kQTerm + off, 16, 1024);
          const uint64_t db = tc::make_desc(k_base + pair_b(kT, pr) * C::kCTerm + off, 16, 1024);
          if (pr == C::kPairs - 1)  // x1 y1, the last pair
            tc::wgmma_ss<0, 0>(sc, da, db, c > 0 || kk > 0);
          else
            tc::wgmma_ss<0, 0>(s_lo, da, db, c > 0 || pr > 0 || kk > 0);
        }
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(s_lo);
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) sc[j] += s_lo[j];

    // The scale, softcap and masks (every test only in a tile that crosses
    // a bound or holds segment ids), and the online softmax.
    const bool need_mask = has_seg || t0 + kN > kv_len || t0 + kN > kv.end ||
                           (causal && t0 + kN - 1 > pmin) || (win > 0 && t0 <= pmax - win);
    float mx_a = m_a, mx_b = m_b;
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col0 = t0 + 8 * j + 2 * t;
        int sg[2] = {0, 0};
        if (decltype(masked)::value && has_seg) {
          sg[0] = col0 < kv_len ? kv_seg_h[col0] : 0;
          sg[1] = col0 + 1 < kv_len ? kv_seg_h[col0 + 1] : 0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale;
          if (kWindowCap && cap > 0.f) x = fa::softcap(x, cap);
          if constexpr (decltype(masked)::value) {
            const int col = col0 + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            const bool keep = col < kv_len && (!causal || col <= pos) &&
                              (win <= 0 || col > pos - win) &&
                              (!has_seg || sg[e & 1] == (e < 2 ? seg_a : seg_b));
            if (!keep) x = fa::kMaskValue;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
      }
    };
    if (need_mask) scores(std::true_type{});
    else scores(std::false_type{});
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
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::ex2((sc[4 * j + e] - (e < 2 ? mx_a : mx_b)) * tc::kLog2e);
        if (e < 2) sum_a += p;
        else sum_b += p;
        sc[4 * j + e] = p;
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

    // P's terms as register A operands: k-step kk from values 8kk .. 8kk + 7.
    uint32_t pt[kT][kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t x[kT];
        split_pair<kT>(sc[8 * kk + 2 * w], sc[8 * kk + 2 * w + 1], x);
#pragma unroll
        for (int a = 0; a < kT; ++a) pt[a][kk][w] = x[a];
      }
    // O += P V by 64-column chunks of d: chunk c's part, summed afresh on the
    // tensor cores, is added to O once chunk c + 1 is split.
    float part[32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      const uint32_t v_base = convert(t0);
      if (c > 0) {
        tc::wgmma_wait<0>();
        tc::fence_regs(part);
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[32 * (c - 1) + x] += part[x];
      }
      tc::wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < C::kPairs; ++pr)
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          const uint64_t db = tc::make_desc(
              v_base + pair_b(kT, pr) * C::kCTerm + kk * 16 * tc::kChunkRowBytes, C::kCTerm, 1024);
          tc::wgmma_rs<1>(part, pt[pair_a(kT, pr)][kk], db, pr > 0 || kk > 0);
        }
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * (C::kChunks - 1) + x] += part[x];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int a = 0; a < kT; ++a)
#pragma unroll
        for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(pt[a][kk][w])::"memory");
  }

  float la = l_a, lb = l_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  // The l == 0 guard of the Pallas epilogue (flash.py:1118).
  const float inv_a = la == 0.f ? 1.f : 1.f / la;
  const float inv_b = lb == 0.f ? 1.f : 1.f / lb;
  // Paged: a row that sees no column (a ctx_len == 0 request, a pad row
  // whose window lies past the context) is written as zeros.
  bool seen_a = true, seen_b = true;
  if constexpr (kPaged) {
    seen_a = min(pos_a, kv_len - 1) >= (win > 0 ? max(0, pos_a - win + 1) : 0);
    seen_b = min(pos_b, kv_len - 1) >= (win > 0 ? max(0, pos_b - win + 1) : 0);
  }
  float* o_head = o + static_cast<size_t>(bh) * rows * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 xa = seen_a ? make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a)
                             : make_float2(0.f, 0.f);
    const float2 xb = seen_b ? make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b)
                             : make_float2(0.f, 0.f);
    if (ra < rows) *reinterpret_cast<float2*>(o_head + static_cast<size_t>(ra) * D + c) = xa;
    if (rb < rows) *reinterpret_cast<float2*>(o_head + static_cast<size_t>(rb) * D + c) = xb;
  }
  if (l_out != nullptr && t == 0) {
    const size_t head = static_cast<size_t>(bh) * rows;
    if (ra < rows) {
      l_out[head + ra] = la;
      m_out[head + ra] = m_a;
    }
    if (rb < rows) {
      l_out[head + rb] = lb;
      m_out[head + rb] = m_b;
    }
  }
}

// One launch over float32 q (bh, rows, D) and, flat, k, v (bh, s_kv, D),
// or, paged (pg.page_indices set), pools (num_pages, kvh, page_size, D);
// o float32 like q.
template <int D, int kT, bool kWindowCap, bool kPaged>
int launch(const fwd_tc::Args& a, const fwd_tc::Paged& pg, int num_pages, int kvh, int b) {
  using C = Cfg<D, kT>;
  CUtensorMap mq, mk, mv;
  int st = tc_encode_map(&mq, a.q, D, a.rows, a.bh, static_cast<long long>(a.rows) * D, C::kN, 4);
  if constexpr (kPaged) {
    if (pg.page_size % 8 || (C::kN % pg.page_size && pg.page_size % C::kN)) return -1;
    const int box = pg.page_size < C::kN ? pg.page_size : C::kN;
    const long long dims[4] = {D, pg.page_size, kvh, num_pages};
    const long long strides[3] = {D, static_cast<long long>(pg.page_size) * D,
                                  static_cast<long long>(kvh) * pg.page_size * D};
    if (st == 0) st = tc_encode(&mk, a.k, 4, dims, strides, box, 4);
    if (st == 0) st = tc_encode(&mv, a.v, 4, dims, strides, box, 4);
  } else {
    // K/V rows past kv_len read as zeros: V's there may be anything.
    const int kv_rows = a.kv_len > 0 ? a.kv_len : 1;
    const long long stride = static_cast<long long>(a.s_kv) * D;
    if (st == 0) st = tc_encode_map(&mk, a.k, D, kv_rows, a.bh, stride, C::kN, 4);
    if (st == 0) st = tc_encode_map(&mv, a.v, D, kv_rows, a.bh, stride, C::kN, 4);
  }
  if (st != 0) return st;
  auto kernel = flash_fwd_f32_kernel<D, kT, kWindowCap, kPaged>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.rows + kM - 1) / kM;
  const dim3 grid = kPaged ? dim3(tiles, kvh, b) : dim3(tiles, a.bh);
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(
      mq, mk, mv, a.o32, a.l, a.m, a.q_seg, a.kv_seg, a.rows, a.s_kv, a.kv_len, a.q_offset,
      a.q_seq_len, a.causal, a.scale, a.window, a.softcap, pg);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kT, bool kPaged>
int launch_w(const fwd_tc::Args& a, const fwd_tc::Paged& pg, int num_pages = 0, int kvh = 0,
             int b = 0) {
  return a.window > 0 || a.softcap > 0.f ? launch<D, kT, true, kPaged>(a, pg, num_pages, kvh, b)
                                         : launch<D, kT, false, kPaged>(a, pg, num_pages, kvh, b);
}

}  // namespace f32tc
