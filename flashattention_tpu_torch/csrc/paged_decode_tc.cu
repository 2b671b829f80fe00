// Paged decode attention on Hopper's tensor cores (sm_90a): flash-decoding
// over a paged KV cache, the cache of each request split across blocks.
//
// Replaces flashattention_tpu/ops/decode.py::_paged_kernel (pallas_call in
// paged_attention) for bf16 q at head_dim 64, 128 and 256, over bf16 pages
// and (built with FA_QUANT, paged_decode_tc_quant) over int8 or fp8 e4m3
// pages with float32 scale pools (P, KVH, page_size): q (B, KVH, R, d)
// with R = G * k rows per KV head (k-minor draft rows, R <= 32); k_pages,
// v_pages (P, KVH, page_size, d); lengths (B,); page_indices (B,
// pages_per_seq).  Row r sits at draft position dp = r % k and sees the
// columns c <= length - k + dp and, with a sliding window, c > length - k +
// dp - window (decode.py:170-185); a logit softcap bends each scaled score
// before the masks.  The function, the shapes and the zeros of a length-0
// request are those of the scalar paged_decode.cu, which keeps head_dim 32
// and more than 32 rows.  Built with FA_F32 (below), float32 q over float32
// pages.
//
// Bound on this card: bytes.  A live K/V row is read once and used for 4 R
// d flops (R <= 32 against this card's ~295 flops a byte), so what matters
// is how many bytes are in flight on every SM.  The design:
// - Split the cache across blocks (flash-decoding).  The grid is (split,
//   KV head, request); split s owns tiles [s * tps, (s + 1) * tps) of 64
//   KV rows of its request (tiles aligned to column 0).  The split count
//   comes from host-known numbers only (B, KVH, pages_per_seq, the SM
//   count: ops/decode.py::decode_splits), never from `lengths`, so the
//   host makes no sync.  A split whose tiles lie past its request's length
//   or wholly before its window loads nothing and writes an empty partial
//   (m = -inf, l = 0).  Each split writes float32 partials (its running max
//   m, its sum l and its unnormalised O for every row) to scratch the
//   wrapper allocates; paged_decode_tc_merge_kernel weights split s by
//   exp(m_s - M) (0 for an empty split, and 0 for a split where a row saw
//   only masked columns, whose m_s is the finite kMaskValue) and writes O.
//   With one split the kernel writes O itself and the merge is not
//   launched.  Both launch from one C entry point.
// - Stage K/V through shared memory with TMA: one producer warp keeps a
//   ring of 3-4 stages of 64-row K and V tiles in flight, each guarded by a
//   full and an empty mbarrier.  The pool is a 4-D tensor map (d, page_size,
//   KVH, P); a tile loads in boxes of min(64, page_size) rows, each inside
//   one page, from page_indices[b, t / page_size], only the boxes that hold
//   a column in [first, end) (first: the first column of row 0's window;
//   end: the length), so no table entry outside the split's live pages is
//   read, nor one past the request's last page.  bf16 boxes are 64 columns
//   swizzled by 128 bytes; 8-bit boxes whole unswizzled rows of d bytes.
// - Products on tensor cores with mma.sync m16n8k16 (bf16 in, float32
//   out), q padded to 16 rows (32 for R > 16).  wgmma needs 64 rows and
//   would waste 4-64x at 1-32 rows; at this arithmetic intensity mma.sync
//   is not the limit.  W consumer warps share each tile (4, 8 at d = 256):
//   warp w scores its 64 / W keys for every row (S = Q K^T, Q and K by
//   ldmatrix from the swizzled tiles), the warps exchange each row's tile
//   max through shared memory (one named barrier), each exponentiates its
//   own scores against the running max and writes P as two bf16 terms (hi
//   = bf16(p), lo = bf16(p - hi), as every other tensor-core form feeds P)
//   to shared memory (a second barrier), and warp w then adds P V for its
//   d / W columns (V by ldmatrix.trans), the tile's part summed on the
//   tensor cores and added to O in float32.  So every row reads the tile
//   once: the draft form reads its K/V once for all R rows.
// - 8-bit pages: the ring carries the payload (half the bytes of bf16);
//   the consumer warps convert each stage into one bf16 K and one bf16
//   V tile in the swizzled layout (tc_common.cuh's exact conversion; rows
//   outside [first, end) as zeros, so stale bytes, an fp8 NaN among them,
//   never reach a product) and stage the tile's scales, between two named
//   barriers, and free the stage.  Score column j is multiplied by
//   k_scale[j] before the scale, softcap and masks, and p's column j by
//   v_scale[j] before its two-term split, as the Pallas kernel orders them
//   (decode.py:158-163, 199-202).
// - Rows no row may see: TMA fills zeros only past the pool's edge, not in
//   the last live page past the length nor in a box left unloaded, which
//   keeps what the stage held.  Their K columns are masked by a select
//   after the scale and softcap (a NaN there is replaced); their V rows are
//   zeroed in shared memory before the PV product (P = 0 times NaN is NaN).
//
// Rounding: the running max moves once per 64-column tile, P enters the PV
// product as two bf16 terms, l sums the float32 p, and the splits' partials
// merge in float32; ops/decode.py::paged_attention_plain(form="tc")
// mirrors all of it, the split boundaries included.
//
// The float32 form (built with FA_F32, paged_decode_tc_f32): float32 q over
// float32 pages as the Pallas kernel computes them, at Precision.HIGHEST
// for both products with p kept in float32 (decode.py:145-156, 199-208):
// each value as three bf16 terms, x1 = bf16(x), x2 = bf16(x - x1), x3 =
// bf16(x - x1 - x2), and each product as the six term products x1 y1, x1
// y2, x2 y1, x1 y3, x2 y2, x3 y1 on mma.sync, the small ones first.  The
// grid, the splits, the merge, the masks and the zeros of a length-0
// request are the bf16 form's; what differs is room and the split:
// - Bound: bytes still.  A live K/V row is 8 d bytes, read once, and costs
//   12 products x 2 x 16 ceil(R / 16) d flops on the tensor cores: 48-96
//   flops a byte against this card's ~295.
// - A 64-row float32 K or V tile is 64 KB at d = 256, so the ring carries
//   K and V tiles in slots of their own (K of tile i, then its V): while
//   the warps score tile i's K its V is in flight, and K's slot takes the
//   next tile's K while they add P V.  128 KB of slots at d = 256 (two, one
//   block an SM), 64 KB at 64 and 128 (four and two), where two blocks an
//   SM hide each other's waits better than one block with a deeper ring
//   (on an H100); 8 consumer warps at d = 128 and 256, 4 at 64.  Float32
//   boxes are 32 columns swizzled by 128 bytes, so that the threads' reads
//   below (two columns of one key for S, one column of four keys for P V)
//   meet no bank conflicts.
// - No bf16 copy of K or V is made: each thread loads the float32 values
//   its mma.sync fragments hold and splits them in registers (each value
//   read and split by one thread of one warp), rows outside [first, end)
//   as zeros without reading them (stale pages and unloaded boxes: a NaN
//   never reaches a product).  Q's three terms are split into shared memory
//   once a block, and P's three terms are written there for the P V
//   products, as the bf16 form writes P's two.
// - S keeps x1 y1 in an accumulator of its own and the five smaller
//   products in another, added once a tile (the tensor cores' float32
//   addition truncates: small products added to a large sum lose their low
//   bits); P V is summed afresh each tile and added to O in float32.
// ops/decode.py::paged_attention_plain(form="tc_f32") mirrors it.
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kTile = 64;  // KV rows per tile
constexpr int kMaxSplits = 64;

template <int D, int kMB, int kKV>
struct Cfg {
  // Consumer warps: 8 at d = 256, where each tile's chain of products,
  // softmax and 8-bit conversion is longest and one block fills an SM's
  // shared memory, so more warps share it; 4 below.
  static constexpr int kWarps = D >= 256 ? 8 : 4;
  static constexpr int kCThreads = 32 * kWarps;    // consumer threads
  static constexpr int kThreads = kCThreads + 32;  // and the producer warp
  static constexpr int kKeysW = kTile / kWarps;    // keys a warp scores
  static constexpr int kSN = kKeysW / 8;           // their 8-key n-blocks
  static constexpr int kPN = D / kWarps / 8;       // 8-column n-blocks of its part of d
  static constexpr bool kQuant = kKV != 0;
  static constexpr int kM = 16 * kMB;  // q rows, padded
  static constexpr int kChunks = D / 64;
  static constexpr int kStages = !kQuant && D >= 128 ? 3 : 4;
  static constexpr int kTileBytes = kChunks * kTile * 128;         // a bf16 K or V tile
  static constexpr int kStageBytes = kQuant ? kTile * D : kTileBytes;  // K or V of a stage
  // Q | K stages | V stages | (8-bit: bf16 K | bf16 V) | P hi | P lo |
  // (8-bit: k, v scales) | row maxima, row sums by warp | barriers
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunks * kM * 128;
  static constexpr int kV = kK + kStages * kStageBytes;
  static constexpr int kKb = kV + kStages * kStageBytes;
  static constexpr int kVb = kKb + (kQuant ? kTileBytes : 0);
  static constexpr int kP = kVb + (kQuant ? kTileBytes : 0);
  static constexpr int kScales = kP + 2 * kM * 128;
  static constexpr int kRed = kScales + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kBar = kRed + 2 * kWarps * kM * 4;
  static constexpr int kBytes = kBar + 16 * kStages + tc::kAtomBytes;  // + alignment
};

// Byte offset of element (r, c) (c a multiple of 8) in a bf16 tile of
// `rows` rows kept as 64-column chunks of 128-byte rows, 16-byte unit u of
// row r at u ^ (r % 8): TMA's 128-byte swizzle, which ldmatrix reads
// without bank conflicts.
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

// N (2 or 4) 8 x 8 bf16 matrices from shared memory, each lane's address
// one 16-byte row (lanes 8i .. 8i + 7: matrix i); kTrans: transposed.
template <bool kTrans, int N>
__device__ __forceinline__ void ldsm(uint32_t (&x)[N], uint32_t addr) {
  static_assert(N == 2 || N == 4, "two or four matrices");
  if constexpr (N == 4 && kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
                 : "r"(addr));
  else if constexpr (N == 4)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
                 : "r"(addr));
  else if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(x[0]), "=r"(x[1])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(x[0]), "=r"(x[1])
                 : "r"(addr));
}
// c += a b: a 16 x 16 bf16 (row-major fragment), b 16 x 8 bf16 (column
// fragment), c 16 x 8 float32: c[0..1] row g, c[2..3] row g + 8, columns
// 2t and 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged 8-bit K or V tile (64 rows of D payload bytes) into the bf16
// tile the products read, by the consumer threads (ct): each takes 8
// payload bytes of a row and writes one 16-byte unit.  Rows outside [lo,
// hi) are written as zeros without being read.
template <int D, int kKV, int kCThreads>
__device__ __forceinline__ void convert_tile(const unsigned char* src, unsigned char* dst, int lo,
                                             int hi, int ct) {
  constexpr int kGroups = D / 8;
#pragma unroll 4
  for (int u = ct; u < kTile * kGroups; u += kCThreads) {
    const int row = u / kGroups, grp = u % kGroups;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row >= lo && row < hi)
      out = tc::cvt8_bf16<kKV>(*reinterpret_cast<const uint2*>(src + row * D + grp * 8));
    *reinterpret_cast<uint4*>(dst + swz(kTile, row, grp * 8)) = out;
  }
}

// Grid (splits, KVH, B), Cfg::kThreads threads: warps 0 .. kWarps - 1
// consume, warp kWarps produces.  o: (B, KVH, rows, D) bf16 (o32 in
// float32 where it is given) when gridDim.x == 1; else part_o (B, KVH,
// splits, rows, D) and part_ml (B, KVH, splits, rows, 2) float32.
template <int D, int kMB, int kKV>
__global__ void __launch_bounds__(Cfg<D, kMB, kKV>::kThreads)
paged_decode_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                       const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                       const int* __restrict__ lengths, const int* __restrict__ page_indices,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
                       float* __restrict__ part_o, float* __restrict__ part_ml, int rows, int page_size, int pages_per_seq,
                       int tiles_per_split, int draft_k, float scale, int window, float softcap) {
  using C = Cfg<D, kMB, kKV>;
  constexpr int kM = C::kM, kWarps = C::kWarps, kCThreads = C::kCThreads;
  constexpr int kKeysW = C::kKeysW, kSN = C::kSN, kPN = C::kPN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + C::kStages;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = gridDim.y, ns = gridDim.x;
  const int length = lengths[b];
  // The columns some row sees: [first, end), the first from row 0's window.
  const int end = min(length, pages_per_seq * page_size);
  const bool windowed = window > 0;
  const int first = windowed ? max(0, length - draft_k - window + 1) : 0;
  const int t_begin = max(split * tiles_per_split, first / kTile);
  const int t_end = min((split + 1) * tiles_per_split, (end + kTile - 1) / kTile);
  const int n_tiles = max(0, t_end - t_begin);
  const int* table = page_indices + static_cast<size_t>(b) * pages_per_seq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      tc::mbar_init(&full[s], 1);     // the producer's arrival with the bytes
      tc::mbar_init(&empty[s], kCThreads);  // every consumer thread
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWarps) {  // producer
    if (lane == 0) {
      const int box = min(kTile, page_size);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) tc::mbar_wait(&empty[s], (i / C::kStages - 1) & 1);
        const int t0 = (t_begin + i) * kTile;
        int n_box = 0;
        for (int j = 0; j < kTile; j += box) n_box += t0 + j + box > first && t0 + j < end;
        tc::mbar_arrive_tx(&full[s], 2 * n_box * box * (C::kQuant ? D : C::kChunks * 128));
        for (int j = 0; j < kTile; j += box) {
          const int t = t0 + j;
          if (t + box <= first || t >= end) continue;
          const int page = table[t / page_size];
#pragma unroll
          for (int c = 0; c < (C::kQuant ? 1 : C::kChunks); ++c) {
            const int off = s * C::kStageBytes + (C::kQuant ? j * D : c * kTile * 128 + j * 128);
            tc::tma_load4(smem + C::kK + off, &tm_k, &full[s], c * 64, t % page_size, h, page);
            tc::tma_load4(smem + C::kV + off, &tm_v, &full[s], c * 64, t % page_size, h, page);
          }
        }
      }
    }
    return;
  }

  // Consumers.  Thread (g, t) of warp w holds, for m-block mb, rows
  // 16 mb + g and 16 mb + g + 8.
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: the lane's matrix and row
  const int ct = threadIdx.x;              // 0 .. kCThreads - 1
  const size_t head = static_cast<size_t>(b) * kvh + h;
  if (n_tiles > 0) {
    for (int u = ct; u < kM * D / 8; u += kCThreads) {
      const int r = u / (D / 8), c = (u % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) x = *reinterpret_cast<const uint4*>(q + (head * rows + r) * D + c);
      *reinterpret_cast<uint4*>(smem + C::kQ + swz(kM, r, c)) = x;
    }
  }
  tc::named_sync(1, kCThreads);

  // Row r sees columns (lo, hi]: hi = min(length - k + r % k, end - 1).
  int hi_r[kMB][2], lo_r[kMB][2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * mb + g + 8 * e;
      const int lim = length - draft_k + r % draft_k;
      hi_r[mb][e] = min(lim, end - 1);
      lo_r[mb][e] = windowed ? lim - window : -1;
    }
  float m_run[kMB][2], l_run[kMB][2];
  float acc[kMB][kPN][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    m_run[mb][0] = m_run[mb][1] = -INFINITY;
    l_run[mb][0] = l_run[mb][1] = 0.f;
#pragma unroll
    for (int nb = 0; nb < kPN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.f;
  }
  const uint32_t sm = tc::smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + C::kRed);  // [kWarps][kM] maxima, then sums
  const float* ks_t = reinterpret_cast<const float*>(smem + C::kScales);
  const float* vs_t = ks_t + kTile;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::kStages;
    tc::mbar_wait(&full[s], (i / C::kStages) & 1);
    const int t0 = (t_begin + i) * kTile;
    const int lo = first - t0, hi = end - t0;  // the tile's live rows
    int k_base, v_base;
    bool zeroed = false;
    if constexpr (C::kQuant) {
      tc::named_sync(1, kCThreads);  // no warp still reads the last tile's bf16 copies
      convert_tile<D, kKV, kCThreads>(smem + C::kK + s * C::kStageBytes, smem + C::kKb, lo, hi, ct);
      convert_tile<D, kKV, kCThreads>(smem + C::kV + s * C::kStageBytes, smem + C::kVb, lo, hi, ct);
      if (ct < 2 * kTile) {
        const int row = ct % kTile, col = t0 + row;
        float x = 0.f;
        if (row >= lo && row < hi) {
          const int page = table[col / page_size];
          x = __ldg((ct < kTile ? k_scales : v_scales) +
                    (static_cast<size_t>(page) * kvh + h) * page_size + col % page_size);
        }
        reinterpret_cast<float*>(smem + C::kScales)[ct] = x;
      }
      tc::named_sync(1, kCThreads);
      tc::mbar_arrive(&empty[s]);
      k_base = C::kKb;
      v_base = C::kVb;
    } else {
      k_base = C::kK + s * C::kStageBytes;
      v_base = C::kV + s * C::kStageBytes;
      if (lo > 0 || hi < kTile) {
        // V rows outside [lo, hi) may hold anything, NaN too: zeros, before
        // any warp's PV product (two barriers below).
        uint4* vt = reinterpret_cast<uint4*>(smem + v_base);
        for (int u = ct; u < C::kChunks * kTile * 8; u += kCThreads) {
          const int row = (u / 8) % kTile;
          if (row < lo || row >= hi) vt[u] = make_uint4(0u, 0u, 0u, 0u);
        }
        zeroed = true;
      }
    }

    // S = Q K^T for this warp's kKeysW keys.
    float sc[kMB][kSN][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int j = 0; j < kSN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mb][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[2 * kSN];
      const uint32_t ka =
          sm + k_base + swz(kTile, kKeysW * warp + (mi / 2) * 8 + mr, 16 * kk + (mi % 2) * 8);
      ldsm<false>(kb, ka);
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        uint32_t qa[4];
        ldsm<false>(qa, sm + C::kQ + swz(kM, 16 * mb + (mi % 2) * 8 + mr, 16 * kk + (mi / 2) * 8));
#pragma unroll
        for (int j = 0; j < kSN; ++j) mma(sc[mb][j], qa, kb[2 * j], kb[2 * j + 1]);
      }
    }

    // Column scales, scale, softcap, masks; the tile's row maxima.
    float mx[kMB][2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      mx[mb][0] = mx[mb][1] = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kSN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = kKeysW * warp + 8 * nb + 2 * t4 + (e & 1), ri = e >> 1;
          float x = sc[mb][nb][e];
          if constexpr (C::kQuant) x *= ks_t[cl];
          x *= scale;
          if (softcap > 0.f) x = fa::softcap(x, softcap);
          const int col = t0 + cl;
          if (!(col <= hi_r[mb][ri] && col > lo_r[mb][ri])) x = fa::kMaskValue;
          sc[mb][nb][e] = x;
          mx[mb][ri] = fmaxf(mx[mb][ri], x);
        }
    }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float x = mx[mb][ri];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (t4 == 0) red[warp * kM + 16 * mb + g + 8 * ri] = x;
      }
    tc::named_sync(1, kCThreads);

    // The running max over the warps' keys; p against it, P to shared
    // memory as two bf16 terms (8-bit: times the column's v_scale first).
    float alpha[kMB][2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = 16 * mb + g + 8 * ri;
        float tmx = red[r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tmx = fmaxf(tmx, red[w * kM + r]);
        const float m_new = fmaxf(m_run[mb][ri], tmx);
        alpha[mb][ri] = tc::ex2((m_run[mb][ri] - m_new) * tc::kLog2e);
        m_run[mb][ri] = m_new;
      }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < kSN; ++nb) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = tc::ex2((sc[mb][nb][e] - m_run[mb][e >> 1]) * tc::kLog2e);
          sum[e >> 1] += p[e];
          if constexpr (C::kQuant) p[e] *= vs_t[kKeysW * warp + 8 * nb + 2 * t4 + (e & 1)];
        }
        const int key = kKeysW * warp + 8 * nb + 2 * t4;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const uint32_t hi2 = tc::pack_bf16(p[2 * ri], p[2 * ri + 1]);
          const uint32_t lo2 = tc::pack_lo(p[2 * ri], p[2 * ri + 1], hi2);
          const int off = swz(kM, 16 * mb + g + 8 * ri, key) + (key & 7) * 2;
          *reinterpret_cast<uint32_t*>(smem + C::kP + off) = hi2;
          *reinterpret_cast<uint32_t*>(smem + C::kP + kM * 128 + off) = lo2;
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) l_run[mb][ri] = alpha[mb][ri] * l_run[mb][ri] + sum[ri];
    }
    tc::named_sync(1, kCThreads);

    // O = alpha O + P V over this warp's part of d (D / kWarps columns):
    // each pair of 8-column n-blocks (or the one) summed afresh on the tensor
    // cores, then added in float32.
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int nb = 0; nb < kPN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][nb][e] *= alpha[mb][e >> 1];
    uint32_t pa[kMB][4][4], pl[kMB][4][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int off = swz(kM, 16 * mb + (mi % 2) * 8 + mr, 16 * ks + (mi / 2) * 8);
        ldsm<false>(pa[mb][ks], sm + C::kP + off);
        ldsm<false>(pl[mb][ks], sm + C::kP + kM * 128 + off);
      }
    constexpr int kPW = kPN >= 2 ? 2 : 1;  // n-blocks per ldmatrix
#pragma unroll
    for (int pr = 0; pr < kPN / kPW; ++pr) {
      float part[kMB][kPW][4];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int j = 0; j < kPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mb][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t vb[2 * kPW];
        const uint32_t va = sm + v_base + swz(kTile, 16 * ks + (mi % 2) * 8 + mr,
                                              warp * (D / kWarps) + 16 * pr + (mi / 2) * 8);
        ldsm<true>(vb, va);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int j = 0; j < kPW; ++j) {
            mma(part[mb][j], pa[mb][ks], vb[2 * j], vb[2 * j + 1]);
            mma(part[mb][j], pl[mb][ks], vb[2 * j], vb[2 * j + 1]);
          }
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int j = 0; j < kPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][kPW * pr + j][e] += part[mb][j][e];
    }
    if constexpr (!C::kQuant) {
      if (zeroed) tc::fence_async_smem();  // the zeros before the next TMA write
      tc::mbar_arrive(&empty[s]);
    }
  }

  // Each row's sum over the warps' keys.
  float* red_l = red + kWarps * kM;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float x = l_run[mb][ri];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t4 == 0) red_l[warp * kM + 16 * mb + g + 8 * ri] = x;
    }
  tc::named_sync(1, kCThreads);
  float* po = part_o + (head * ns + split) * rows * D;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = 16 * mb + g + 8 * ri;
      if (r >= rows) continue;
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += red_l[w * kM + r];
      if (ns == 1) {
        // The l == 0 guard of the Pallas epilogue: a length-0 request's O
        // is 0 / 1.
        const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
        for (int nb = 0; nb < kPN; ++nb) {
          const int c = warp * (D / kWarps) + 8 * nb + 2 * t4;
          const float x0 = acc[mb][nb][2 * ri] * inv, x1 = acc[mb][nb][2 * ri + 1] * inv;
          if (o32 != nullptr)
            *reinterpret_cast<float2*>(o32 + (head * rows + r) * D + c) = make_float2(x0, x1);
          else
            *reinterpret_cast<uint32_t*>(o + (head * rows + r) * D + c) = tc::pack_bf16(x0, x1);
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < kPN; ++nb) {
          const int c = warp * (D / kWarps) + 8 * nb + 2 * t4;
          *reinterpret_cast<float2*>(po + static_cast<size_t>(r) * D + c) =
              make_float2(acc[mb][nb][2 * ri], acc[mb][nb][2 * ri + 1]);
        }
        if (warp == 0 && t4 == 0)
          *reinterpret_cast<float2*>(part_ml + ((head * ns + split) * rows + r) * 2) =
              make_float2(m_run[mb][ri], l);
      }
    }
}

// O from the splits' partials: per row, M = max_s m_s, w_s = exp(m_s - M)
// (0 for an empty split, m_s = -inf), O = sum_s w_s O_s / sum_s w_s l_s
// (zeros where every split is empty: a length-0 request), in bf16 or, where
// o32 is given, float32.  Grid B * KVH.  kKV only names the form the
// profiles count it under (kF32 below: the float32 form).
template <int D, int kKV>
__global__ void __launch_bounds__(256)
paged_decode_tc_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ o32, int rows,
                             int ns) {
  __shared__ float w_s[32 * kMaxSplits];
  __shared__ float inv_s[32];
  const size_t head = blockIdx.x;
  const float* ml = part_ml + head * ns * rows * 2;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float mm = -INFINITY;
    for (int s = 0; s < ns; ++s) mm = fmaxf(mm, ml[(s * rows + r) * 2]);
    float l = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float m = ml[(s * rows + r) * 2];
      const float w = m == -INFINITY ? 0.f : tc::ex2((m - mm) * tc::kLog2e);
      w_s[r * kMaxSplits + s] = w;
      l += w * ml[(s * rows + r) * 2 + 1];
    }
    inv_s[r] = l == 0.f ? 1.f : 1.f / l;
  }
  __syncthreads();
  const float* po = part_o + head * ns * rows * D;
  for (int x = threadIdx.x; x < rows * D; x += blockDim.x) {
    const int r = x / D;
    float a = 0.f;
    for (int s = 0; s < ns; ++s) a += w_s[r * kMaxSplits + s] * po[static_cast<size_t>(s) * rows * D + x];
    if (o32 != nullptr) o32[head * rows * D + x] = a * inv_s[r];
    else o[head * rows * D + x] = __float2bfloat16(a * inv_s[r]);
  }
}

template <int D, int kMB>
struct CfgF32 {
  // Consumer warps: 8 at d = 128 and 256, where each tile's chain of
  // splits and products is longest, 4 at d = 64.
  static constexpr int kWarps = D >= 128 ? 8 : 4;
  static constexpr int kCThreads = 32 * kWarps;
  static constexpr int kThreads = kCThreads + 32;
  static constexpr int kKeysW = kTile / kWarps;  // keys a warp scores
  static constexpr int kSN = kKeysW / 8;         // their 8-key n-blocks
  static constexpr int kPN = D / kWarps / 8;     // 8-column n-blocks of its part of d
  static constexpr int kM = 16 * kMB;            // q rows, padded
  static constexpr int kQTerm = D / 64 * kM * 128;  // one bf16 term of Q
  static constexpr int kPTerm = kM * 128;           // one bf16 term of P
  static constexpr int kSlotBytes = kTile * D * 4;  // a float32 K or V tile
  // 128 KB of slots at d = 256 (one block an SM), 64 KB below (two).
  static constexpr int kSlots = (D >= 256 ? 128 : 64) * 1024 / kSlotBytes;
  // Q's three terms | K/V slots | P's three terms | row maxima, row sums by
  // warp | barriers
  static constexpr int kRing = 3 * kQTerm;
  static constexpr int kP = kRing + kSlots * kSlotBytes;
  static constexpr int kRed = kP + 3 * kPTerm;
  static constexpr int kBar = kRed + 2 * kWarps * kM * 4;
  static constexpr int kBytes = kBar + 16 * kSlots + tc::kAtomBytes;  // + alignment
};

// Byte offset of float32 element (r, c) in a K or V slot: 32-column chunks
// of 128-byte rows (TMA's boxes), 16-byte unit u of row r at u ^ (r % 8).
__device__ __forceinline__ int swz32(int r, int c) {
  return (c >> 5) * kTile * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// The six term products of a b (a's and b's three terms, index 0 the
// largest), the small ones first: x3 y1, x2 y2, x1 y3, x2 y1, x1 y2 into c,
// then x1 y1 into big (S keeps it apart; P V passes c twice).
__device__ __forceinline__ void mma6(float (&c)[4], float (&big)[4], const uint32_t (&a0)[4],
                                     const uint32_t (&a1)[4], const uint32_t (&a2)[4],
                                     const uint32_t (&b0)[3], const uint32_t (&b1)[3]) {
  mma(c, a2, b0[0], b1[0]);
  mma(c, a1, b0[1], b1[1]);
  mma(c, a0, b0[2], b1[2]);
  mma(c, a1, b0[0], b1[0]);
  mma(c, a0, b0[1], b1[1]);
  mma(big, a0, b0[0], b1[0]);
}

// Grid (splits, KVH, B), CfgF32::kThreads threads: warps 0 .. kWarps - 1
// consume, warp kWarps produces.  o32: (B, KVH, rows, D) when gridDim.x ==
// 1; else part_o and part_ml as the bf16 form's.
template <int D, int kMB>
__global__ void __launch_bounds__(CfgF32<D, kMB>::kThreads)
paged_decode_tc_f32_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ q,
                           const int* __restrict__ lengths, const int* __restrict__ page_indices,
                           float* __restrict__ o32, float* __restrict__ part_o,
                           float* __restrict__ part_ml, int rows, int page_size, int pages_per_seq,
                           int tiles_per_split, int draft_k, float scale, int window,
                           float softcap) {
  using C = CfgF32<D, kMB>;
  constexpr int kM = C::kM, kWarps = C::kWarps, kCThreads = C::kCThreads;
  constexpr int kKeysW = C::kKeysW, kSN = C::kSN, kPN = C::kPN, kSlots = C::kSlots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + tc::kAtomBytes - 1) &
      ~static_cast<uintptr_t>(tc::kAtomBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + kSlots;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = gridDim.y, ns = gridDim.x;
  const int length = lengths[b];
  // The columns some row sees: [first, end), the first from row 0's window.
  const int end = min(length, pages_per_seq * page_size);
  const bool windowed = window > 0;
  const int first = windowed ? max(0, length - draft_k - window + 1) : 0;
  const int t_begin = max(split * tiles_per_split, first / kTile);
  const int t_end = min((split + 1) * tiles_per_split, (end + kTile - 1) / kTile);
  const int n_tiles = max(0, t_end - t_begin);
  const int* table = page_indices + static_cast<size_t>(b) * pages_per_seq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      tc::mbar_init(&full[s], 1);           // the producer's arrival with the bytes
      tc::mbar_init(&empty[s], kCThreads);  // every consumer thread
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWarps) {  // producer: tile i's K into slot 2 i, its V into 2 i + 1 (mod kSlots)
    if (lane == 0) {
      const int box = min(kTile, page_size);
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = (t_begin + i) * kTile;
        int n_box = 0;
        for (int j = 0; j < kTile; j += box) n_box += t0 + j + box > first && t0 + j < end;
        for (int side = 0; side < 2; ++side) {
          const int u = 2 * i + side, s = u % kSlots;
          if (u >= kSlots) tc::mbar_wait(&empty[s], (u / kSlots - 1) & 1);
          tc::mbar_arrive_tx(&full[s], n_box * box * D * 4);
          for (int j = 0; j < kTile; j += box) {
            const int t = t0 + j;
            if (t + box <= first || t >= end) continue;
            const int page = table[t / page_size];
#pragma unroll
            for (int c = 0; c < D / 32; ++c)
              tc::tma_load4(smem + C::kRing + s * C::kSlotBytes + c * kTile * 128 + j * 128,
                            side ? &tm_v : &tm_k, &full[s], c * 32, t % page_size, h, page);
          }
        }
      }
    }
    return;
  }

  // Consumers.  Thread (g, t) of warp w holds, for m-block mb, rows
  // 16 mb + g and 16 mb + g + 8.
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: the lane's matrix and row
  const int ct = threadIdx.x;              // 0 .. kCThreads - 1
  const size_t head = static_cast<size_t>(b) * kvh + h;
  if (n_tiles > 0) {  // Q's three terms, rows past `rows` as zeros
    for (int u = ct; u < kM * D / 8; u += kCThreads) {
      const int r = u / (D / 8), c = (u % (D / 8)) * 8;
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
      if (r < rows) {
        x0 = *reinterpret_cast<const float4*>(q + (head * rows + r) * D + c);
        x1 = *reinterpret_cast<const float4*>(q + (head * rows + r) * D + c + 4);
      }
      uint32_t w[4][3];
      tc::split_pair<3>(x0.x, x0.y, w[0]);
      tc::split_pair<3>(x0.z, x0.w, w[1]);
      tc::split_pair<3>(x1.x, x1.y, w[2]);
      tc::split_pair<3>(x1.z, x1.w, w[3]);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        *reinterpret_cast<uint4*>(smem + a * C::kQTerm + swz(kM, r, c)) =
            make_uint4(w[0][a], w[1][a], w[2][a], w[3][a]);
    }
  }
  tc::named_sync(1, kCThreads);

  // Row r, at draft position dp (k-minor rows), sees columns (lo, hi]:
  // hi = min(length - k + dp, end - 1).
  int hi_r[kMB][2], lo_r[kMB][2];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * mb + g + 8 * e, dp = r % draft_k;
      hi_r[mb][e] = min(length - draft_k + dp, end - 1);
      lo_r[mb][e] = windowed ? length - draft_k + dp - window : -1;
    }
  float m_run[kMB][2], l_run[kMB][2];
  float acc[kMB][kPN][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
    m_run[mb][0] = m_run[mb][1] = -INFINITY;
    l_run[mb][0] = l_run[mb][1] = 0.f;
#pragma unroll
    for (int nb = 0; nb < kPN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.f;
  }
  const uint32_t sm = tc::smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + C::kRed);  // [kWarps][kM] maxima, then sums

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (t_begin + i) * kTile;
    const int lo = first - t0, hi = end - t0;  // the tile's live rows
    const int sk = (2 * i) % kSlots, sv = (2 * i + 1) % kSlots;

    // S = Q K^T for this warp's kKeysW keys: x1 y1 into sc, the smaller
    // products into s_lo; K's values split in registers, dead rows as zeros.
    tc::mbar_wait(&full[sk], (2 * i / kSlots) & 1);
    const unsigned char* kt = smem + C::kRing + sk * C::kSlotBytes;
    float sc[kMB][kSN][4], s_lo[kMB][kSN][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int j = 0; j < kSN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mb][j][e] = s_lo[mb][j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[3][kMB][4];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          ldsm<false>(qa[a][mb], sm + a * C::kQTerm +
                                     swz(kM, 16 * mb + (mi % 2) * 8 + mr, 16 * kk + (mi / 2) * 8));
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        const int key = kKeysW * warp + 8 * j + g;
        float2 x0 = make_float2(0.f, 0.f), x1 = x0;
        if (key >= lo && key < hi) {
          x0 = *reinterpret_cast<const float2*>(kt + swz32(key, 16 * kk + 2 * t4));
          x1 = *reinterpret_cast<const float2*>(kt + swz32(key, 16 * kk + 8 + 2 * t4));
        }
        uint32_t b0[3], b1[3];
        tc::split_pair<3>(x0.x, x0.y, b0);
        tc::split_pair<3>(x1.x, x1.y, b1);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          mma6(s_lo[mb][j], sc[mb][j], qa[0][mb], qa[1][mb], qa[2][mb], b0, b1);
      }
    }
    tc::mbar_arrive(&empty[sk]);

    // Scale, softcap, masks; the tile's row maxima.
    float mx[kMB][2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      mx[mb][0] = mx[mb][1] = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kSN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = kKeysW * warp + 8 * nb + 2 * t4 + (e & 1), ri = e >> 1;
          float x = (sc[mb][nb][e] + s_lo[mb][nb][e]) * scale;
          if (softcap > 0.f) x = fa::softcap(x, softcap);
          const int col = t0 + cl;
          if (!(col <= hi_r[mb][ri] && col > lo_r[mb][ri])) x = fa::kMaskValue;
          sc[mb][nb][e] = x;
          mx[mb][ri] = fmaxf(mx[mb][ri], x);
        }
    }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float x = mx[mb][ri];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (t4 == 0) red[warp * kM + 16 * mb + g + 8 * ri] = x;
      }
    tc::named_sync(1, kCThreads);

    // The running max over the warps' keys; p against it, float32, to
    // shared memory as three bf16 terms.
    float alpha[kMB][2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = 16 * mb + g + 8 * ri;
        float tmx = red[r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tmx = fmaxf(tmx, red[w * kM + r]);
        const float m_new = fmaxf(m_run[mb][ri], tmx);
        alpha[mb][ri] = tc::ex2((m_run[mb][ri] - m_new) * tc::kLog2e);
        m_run[mb][ri] = m_new;
      }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < kSN; ++nb) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = tc::ex2((sc[mb][nb][e] - m_run[mb][e >> 1]) * tc::kLog2e);
          sum[e >> 1] += p[e];
        }
        const int key = kKeysW * warp + 8 * nb + 2 * t4;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          uint32_t w[3];
          tc::split_pair<3>(p[2 * ri], p[2 * ri + 1], w);
          const int off = swz(kM, 16 * mb + g + 8 * ri, key) + (key & 7) * 2;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            *reinterpret_cast<uint32_t*>(smem + C::kP + a * C::kPTerm + off) = w[a];
        }
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) l_run[mb][ri] = alpha[mb][ri] * l_run[mb][ri] + sum[ri];
    }
    tc::named_sync(1, kCThreads);

    // O = alpha O + P V over this warp's D / kWarps columns, the tile's part
    // summed afresh on the tensor cores and added in float32; V's values
    // split in registers, dead rows as zeros.
    tc::mbar_wait(&full[sv], ((2 * i + 1) / kSlots) & 1);
    const unsigned char* vt = smem + C::kRing + sv * C::kSlotBytes;
    float part[kMB][kPN][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int nb = 0; nb < kPN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mb][nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t pa[3][kMB][4];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          ldsm<false>(pa[a][mb], sm + C::kP + a * C::kPTerm +
                                     swz(kM, 16 * mb + (mi % 2) * 8 + mr, 16 * ks + (mi / 2) * 8));
      // This thread's V rows: r0, r0 + 1 (b0) and r0 + 8, r0 + 9 (b1).
      const int r0 = 16 * ks + 2 * t4;
      bool live[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e & 1) + 8 * (e >> 1);
        live[e] = r >= lo && r < hi;
      }
#pragma unroll
      for (int nb = 0; nb < kPN; ++nb) {
        const int c = warp * (D / kWarps) + 8 * nb + g;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = live[e] ? *reinterpret_cast<const float*>(
                               vt + swz32(r0 + (e & 1) + 8 * (e >> 1), c))
                         : 0.f;
        uint32_t b0[3], b1[3];
        tc::split_pair<3>(x[0], x[1], b0);
        tc::split_pair<3>(x[2], x[3], b1);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          mma6(part[mb][nb], part[mb][nb], pa[0][mb], pa[1][mb], pa[2][mb], b0, b1);
      }
    }
    tc::mbar_arrive(&empty[sv]);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int nb = 0; nb < kPN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mb][nb][e] = acc[mb][nb][e] * alpha[mb][e >> 1] + part[mb][nb][e];
  }

  // Each row's sum over the warps' keys; O (the l == 0 guard: a length-0
  // request's O is 0 / 1), or this split's partials.
  float* red_l = red + kWarps * kM;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float x = l_run[mb][ri];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t4 == 0) red_l[warp * kM + 16 * mb + g + 8 * ri] = x;
    }
  tc::named_sync(1, kCThreads);
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = 16 * mb + g + 8 * ri;
      if (r >= rows) continue;
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += red_l[w * kM + r];
      const float inv = ns > 1 || l == 0.f ? 1.f : 1.f / l;
      float* dst = ns > 1 ? part_o + ((head * ns + split) * rows + r) * D
                          : o32 + (head * rows + r) * D;
#pragma unroll
      for (int nb = 0; nb < kPN; ++nb) {
        const int c = warp * (D / kWarps) + 8 * nb + 2 * t4;
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(acc[mb][nb][2 * ri] * inv, acc[mb][nb][2 * ri + 1] * inv);
      }
      if (ns > 1 && warp == 0 && t4 == 0)
        *reinterpret_cast<float2*>(part_ml + ((head * ns + split) * rows + r) * 2) =
            make_float2(m_run[mb][ri], l);
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
  float* part_o;
  float* part_ml;
  int b, kvh, rows, num_pages, page_size, pages_per_seq, splits, tiles_per_split, draft_k;
  float scale;
  int window;
  float softcap;
  int o_f32;
  cudaStream_t stream;
};

// kKV: the pages' form, 0 bf16, 1 int8, 2 fp8 (FA_QUANT), kF32 float32
// (FA_F32).
constexpr int kF32 = 3;

// The dynamic shared-memory limit of `kernel`, launch<D, kMB, kKV>'s,
// raised once.
template <int D, int kMB, int kKV, typename Kernel>
int smem_attr(Kernel kernel, int bytes) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  return 0;
}

template <int D, int kMB, int kKV>
int launch(const Args& a) {
  CUtensorMap mk, mv;
  const int box = a.page_size < kTile ? a.page_size : kTile;
  const long long dims[4] = {D, a.page_size, a.kvh, a.num_pages};
  const long long strides[3] = {D, static_cast<long long>(a.page_size) * D,
                                static_cast<long long>(a.kvh) * a.page_size * D};
  // bf16 boxes of 64 columns, float32 of 32, swizzled; 8-bit rows unswizzled.
  const int eb = kKV == kF32 ? 4 : kKV != 0 ? 1 : 2;
  int st = tc_encode(&mk, a.k_pages, 4, dims, strides, box, eb, kKV == kF32);
  if (st == 0) st = tc_encode(&mv, a.v_pages, 4, dims, strides, box, eb, kKV == kF32);
  if (st != 0) return st;
  __nv_bfloat16* o = a.o_f32 ? nullptr : static_cast<__nv_bfloat16*>(a.o);
  float* o32 = a.o_f32 ? static_cast<float*>(a.o) : nullptr;
  const dim3 grid(a.splits, a.kvh, a.b);
  if constexpr (kKV == kF32) {
    using C = CfgF32<D, kMB>;
    auto kernel = paged_decode_tc_f32_kernel<D, kMB>;
    if ((st = smem_attr<D, kMB, kKV>(kernel, C::kBytes)) != 0) return st;
    kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(
        mk, mv, static_cast<const float*>(a.q), a.lengths, a.page_indices, o32, a.part_o,
        a.part_ml, a.rows, a.page_size, a.pages_per_seq, a.tiles_per_split, a.draft_k, a.scale,
        a.window, a.softcap);
  } else {
    using C = Cfg<D, kMB, kKV>;
    auto kernel = paged_decode_tc_kernel<D, kMB, kKV>;
    if ((st = smem_attr<D, kMB, kKV>(kernel, C::kBytes)) != 0) return st;
    kernel<<<grid, C::kThreads, C::kBytes, a.stream>>>(
        mk, mv, static_cast<const __nv_bfloat16*>(a.q), a.k_scales, a.v_scales, a.lengths,
        a.page_indices, o, o32, a.part_o, a.part_ml, a.rows, a.page_size, a.pages_per_seq,
        a.tiles_per_split, a.draft_k, a.scale, a.window, a.softcap);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  paged_decode_tc_merge_kernel<D, kKV><<<a.b * a.kvh, 256, 0, a.stream>>>(
      a.part_o, a.part_ml, o, o32, a.rows, a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kKV>
int launch_m(const Args& a) {
  return a.rows <= 16 ? launch<D, 1, kKV>(a) : launch<D, 2, kKV>(a);
}

template <int kKV>
int launch_d(int d, const Args& a) {
  switch (d) {
    case 64: return launch_m<64, kKV>(a);
    case 128: return launch_m<128, kKV>(a);
    case 256: return launch_m<256, kKV>(a);
    default: return -1;
  }
}

// The shapes both entry points take.
bool takes(int rows, int draft_k, int splits, int tiles_per_split, int page_size) {
  return rows >= 1 && rows <= 32 && draft_k >= 1 && rows % draft_k == 0 && splits >= 1 &&
         splits <= kMaxSplits && tiles_per_split >= 1 && page_size % 8 == 0 &&
         (kTile % page_size == 0 || page_size % kTile == 0);
}

}  // namespace

#ifdef FA_F32
// As fa_paged_decode_tc below, for float32 q over float32 pages, O float32
// (no type code, no scale pools, no o_f32 flag).
extern "C" int fa_paged_decode_tc_f32(const void* q, const void* k_pages, const void* v_pages,
                                      const void* lengths, const void* page_indices, void* o,
                                      void* part_o, void* part_ml, int b, int kvh, int rows, int d,
                                      int num_pages, int page_size, int pages_per_seq, int splits,
                                      int tiles_per_split, int draft_k, float scale, int window,
                                      float softcap, void* stream) {
  if (!takes(rows, draft_k, splits, tiles_per_split, page_size)) return -1;
  const Args a{q, k_pages, v_pages, nullptr, nullptr, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), o, static_cast<float*>(part_o),
               static_cast<float*>(part_ml), b, kvh, rows, num_pages, page_size, pages_per_seq,
               splits, tiles_per_split, draft_k, scale, window, softcap, 1,
               static_cast<cudaStream_t>(stream)};
  return launch_d<kF32>(d, a);
}
#else
// q: (b, kvh, rows, d) bf16, rows = G * draft_k <= 32, k-minor; k_pages,
// v_pages: (num_pages, kvh, page_size, d), bf16 (kv_dtype 1) or, built with
// FA_QUANT, int8 (2) / fp8 e4m3 (3) payloads with float32 scale pools
// k_scales, v_scales (num_pages, kvh, page_size); lengths: (b,) int32;
// page_indices: (b, pages_per_seq) int32; o like q, or float32 with o_f32
// (float32 q over bf16 pages, taken in bf16 as the Pallas kernel takes it,
// decode.py:145-150: O from the float32 sums, no bf16 rounding); part_o, part_ml:
// float32 scratch of b * kvh * splits * rows * d and * 2 elements (unused
// when splits is 1).  All contiguous, on the device, 16-byte aligned
// (TMA).  The page size is a multiple of 8 that divides 64 or that 64
// divides.  Split s covers tiles [s * tiles_per_split, (s + 1) *
// tiles_per_split) of 64 KV rows; splits <= 64.  window <= 0: no sliding
// window; softcap <= 0: none.
extern "C" int fa_paged_decode_tc(int kv_dtype, const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales, const void* v_scales,
                                  const void* lengths, const void* page_indices, void* o,
                                  void* part_o, void* part_ml, int b, int kvh, int rows, int d,
                                  int num_pages, int page_size, int pages_per_seq, int splits,
                                  int tiles_per_split, int draft_k, float scale, int window,
                                  float softcap, int o_f32, void* stream) {
  if (!takes(rows, draft_k, splits, tiles_per_split, page_size)) return -1;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), o, static_cast<float*>(part_o),
               static_cast<float*>(part_ml), b, kvh, rows, num_pages, page_size, pages_per_seq,
               splits, tiles_per_split, draft_k, scale, window, softcap, o_f32,
               static_cast<cudaStream_t>(stream)};
#ifdef FA_QUANT
  if (kv_dtype == fa::kInt8) return launch_d<1>(d, a);
  if (kv_dtype == fa::kFp8E4M3) return launch_d<2>(d, a);
#else
  if (kv_dtype == fa::kBFloat16) return launch_d<0>(d, a);
#endif
  return -1;
}
#endif  // FA_F32
