// Flash-attention forward for Hopper (sm_90a): QK^T -> online softmax -> PV,
// fused, with the (m, l, acc) state kept in registers across KV tiles.
//
// Replaces flashattention_tpu/ops/flash.py::_kernel (the Pallas forward,
// pallas_call in _flash_attention).  It computes what that kernel computes on
// the serving path: causal masking at query position q_offset + (r mod
// q_seq_len) (the GQA row fold), a sliding window (a row at position pos sees
// column c only where c > pos - window, flash.py:882-906), a logit softcap
// (s -> cap * tanh(s / cap) after the scale and before the masks,
// flash.py:833-835), a live KV length kv_len, a score scale, segment ids (row
// r sees column c only where their int32 ids are equal, the packed training
// step's mask, flash.py:682-688 and :837-843), and optionally the softmax
// statistics (l, m) in float32.
//
// Bound on this card: at the prefill shapes (S >= 1024, d >= 128) attention is
// bound by operations, not bytes (4*S*d flops per query row against 2*S*d
// bytes of K/V read once per query tile).  This first version does all its
// arithmetic in float32 on the CUDA cores, not on the tensor cores, so it
// sits far from that bound; wgmma, TMA and warp specialisation come later.
// What the design does keep from a fast kernel: the KV loop starts at the
// first tile the window of the block's smallest position reaches
// (flash.py:764-768) and stops at the causal diagonal of its largest and at
// kv_len, so no tile outside the live band is read or computed.
//
// Layout: one block of 256 threads per (bh, query tile); kThreadsPerRow(D)
// threads per query row: 4 up to d = 128 (64-row tiles), 8 at d = 256 (32-row
// tiles), so a thread always keeps at most 32 floats of q and 32 of the output
// accumulator in registers (as interleaved float4 chunks) beside its 32
// scores.  ptxas fits d = 128 and d = 256 in 128 registers with a 24-byte
// spill, so two blocks share an SM; that measured faster than 161 registers
// and no spill (one block per SM), and than scoring each tile in two halves
// of 16 columns (see PERF.md).  The threads of a row read neighbouring
// float4 of a shared-memory K/V row and every row of the warp reads the same
// ones (a broadcast, no bank conflict); the partial dot products meet through
// log2(kThreadsPerRow) shuffles.  K/V tiles are staged in dynamic shared
// memory as float32, 2 x 32 x d x 4 bytes (32 KB at d = 128, 64 KB at
// d = 256, above the 48 KB default, so the launch raises
// cudaFuncAttributeMaxDynamicSharedMemorySize), with the tile's segment ids
// when there are any.  A query tile that crosses a GQA segment takes the
// segment's first position for its window start and its last for its causal
// end: correct, just no skip on that side.
//
// 8-bit K/V (int8 or fp8 e4m3 payloads P with a float32 dequant scale per
// row, (BH, S_kv); attention_quantized and attention(k_scales=, v_scales=)):
// the Pallas kernel folds the K scale into the score columns and the V scale
// into p (flash.py:816-828, 968-978); here each row is dequantized as its
// tile is staged (payload x its row's scale, into the float32 tiles), four
// payload bytes per 32-bit load, one rounding fewer.  These forms are built
// into their own library (FA_QUANT, see ops/kernels.py).
//
// Attention dropout and block-sparse masks (flash.py:931-948, :1408-1428,
// :845-858) live in a compile-time form of their own (kExtra), so the kernel
// without them is the code it was.  Dropout multiplies each p fed to the PV
// sum by 1/(1 - rate) or 0 after p has been added to l, so l, m and the
// saved statistics stay the undropped softmax's, which the backward needs;
// the tile's keep bits are hashed once per (row, column) by one warp per
// row, a ballot making each row's 32-bit word (common.cuh, Extras).  A block
// mask replaces the KV loop's range by the query tile's list of live KV
// tiles, so a dead tile is neither loaded nor computed, and only a partial
// tile tests its element bits (one word per row: kBlockKV = 32).
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kBlockKV = 32;  // KV rows per shared-memory tile
constexpr int kThreads = 256;

// Threads per query row, and so query rows per block, by head_dim.
template <int D>
__host__ __device__ constexpr int threads_per_row() { return D >= 256 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr int block_q() { return kThreads / threads_per_row<D>(); }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * sizeof(float4) * kBlockKV * (D / 4) + sizeof(int) * kBlockKV;
}

// The dropout / block-mask form (kExtra, built with FA_EXTRA) is held to two
// blocks per SM: left alone ptxas gives it 184 registers and one block.  The
// form without them keeps the bound it had (an explicit minimum of one block
// moves it from 128 registers and two blocks to 168 and one, 1.5x slower).
#ifdef FA_EXTRA
#define FA_FWD_BOUNDS __launch_bounds__(kThreads, 2)
#else
#define FA_FWD_BOUNDS __launch_bounds__(kThreads)
#endif

// T: q and o; P: the K/V payload (T itself, or int8 / fp8 with scales);
// kExtra: dropout and block masks (`ex`).
template <typename T, typename P, int D, bool kExtra>
__global__ void FA_FWD_BOUNDS
flash_fwd_kernel(const T* __restrict__ q, const P* __restrict__ k,
                 const P* __restrict__ v, const float* __restrict__ k_scales,
                 const float* __restrict__ v_scales, T* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int rows,
                 int s_kv, int kv_len, int q_offset, int q_seq_len, int causal,
                 float scale, int window, float softcap, const fa::Extras ex) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  constexpr int kThreadsPerRow = threads_per_row<D>();
  constexpr int kBlockQ = block_q<D>();
  constexpr int kVec = D / 4;                     // float4 chunks per row
  constexpr int kChunks = kVec / kThreadsPerRow;  // chunks per thread
  static_assert(kChunks >= 1 && kVec % kThreadsPerRow == 0,
                "head_dim must be a multiple of 4 * kThreadsPerRow");
  // [kBlockKV][kVec] K, then V, then kBlockKV segment ids.
  extern __shared__ float4 smem[];
  float4* k_tile = smem;
  float4* v_tile = smem + kBlockKV * kVec;
  int* seg_tile = reinterpret_cast<int*>(smem + 2 * kBlockKV * kVec);
  // kExtra: each query row's dropout hash key and the tile's keep words.
  __shared__ unsigned row_key[kExtra ? kBlockQ : 1];
  __shared__ unsigned kept_t[kExtra ? kBlockQ : 1];

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = r0 + tid / kThreadsPerRow;
  const bool live = row < rows;  // the last tile may be ragged
  // Causal position of this row: GQA folds G query heads into the rows of
  // one KV head, each a q_seq_len-row segment at the same positions.
  const int pos = q_offset + (live ? row % q_seq_len : 0);
  // Columns at or before win_lo lie outside this row's window.
  const int win_lo = window > 0 ? pos - window : INT_MIN;
  const bool has_seg = q_seg != nullptr;
  const int my_seg =
      has_seg ? q_seg[static_cast<size_t>(bh) * rows + (live ? row : r0)] : 0;
  const int* seg_head = has_seg ? kv_seg + static_cast<size_t>(bh) * s_kv : nullptr;

  const T* q_row = q + (static_cast<size_t>(bh) * rows + (live ? row : r0)) * D;
  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * (part + kThreadsPerRow * i);
    qr[i] = make_float4(fa::load_f32(q_row + c), fa::load_f32(q_row + c + 1),
                        fa::load_f32(q_row + c + 2), fa::load_f32(q_row + c + 3));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Stop the KV loop at kv_len and, when causal, at the block's last
  // diagonal column (the whole-tile skip of flash.py:761 and :771-775); with
  // a window, start it at the tile holding the first column the block's
  // smallest position sees (flash.py:764-768).  A tile that crosses a GQA
  // segment spans the segment's first to last position.
  const int r1 = min(rows, r0 + kBlockQ) - 1;
  const bool one_segment = r0 / q_seq_len == r1 / q_seq_len;
  int kv_end = kv_len;
  if (causal)
    kv_end = min(kv_end, q_offset + (one_segment ? r1 % q_seq_len : q_seq_len - 1) + 1);
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, q_offset + (one_segment ? r0 % q_seq_len : 0) - window + 1);
    kv_begin -= kv_begin % kBlockKV;
  }

  const bool dropout = kExtra && ex.threshold != 0;
  // A block mask walks the query tile's live KV tiles [it, it_end) instead.
  int it = 0, it_end = 0;
  if constexpr (kExtra) {
    if (ex.bm_ptr != nullptr) {
      it = ex.bm_ptr[blockIdx.x];
      it_end = ex.bm_ptr[blockIdx.x + 1];
    }
    if (dropout && tid < kBlockQ) row_key[tid] = fa::dropout_row_key(ex, bh, r0 + tid, q_seq_len);
  }

  const P* k_head = k + static_cast<size_t>(bh) * s_kv * D;
  const P* v_head = v + static_cast<size_t>(bh) * s_kv * D;
  const float* ks_head = kQuant ? k_scales + static_cast<size_t>(bh) * s_kv : nullptr;
  const float* vs_head = kQuant ? v_scales + static_cast<size_t>(bh) * s_kv : nullptr;
  float m_run = -INFINITY;  // flash.py:752 initialises m to -inf
  float l_run = 0.f;
  for (int t0 = kv_begin; t0 < kv_end; t0 += kBlockKV) {
    unsigned bm_word = ~0u;  // block mask: this row's live columns of the tile
    if constexpr (kExtra) {
      if (ex.bm_ptr != nullptr) {
        if (it == it_end) break;
        t0 = ex.bm_idx[it] * kBlockKV;
        if (t0 >= kv_end) break;
        const int slot = ex.bm_part[it++];
        if (slot >= 0) bm_word = ex.bm_bits[static_cast<size_t>(slot) * kBlockQ + tid / kThreadsPerRow];
      }
    }
    __syncthreads();  // every thread is done with the previous tile
    if constexpr (kQuant) {  // 8-bit rows: 4 payload bytes a load, then scaled
      for (int idx = tid; idx < kBlockKV * kVec; idx += kThreads) {
        const int col = t0 + idx / kVec;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (col < kv_end) {
          const size_t off = static_cast<size_t>(col) * D + 4 * (idx % kVec);
          kx = fa::scale4(fa::load4(k_head + off), ks_head[col]);
          vx = fa::scale4(fa::load4(v_head + off), vs_head[col]);
        }
        k_tile[idx] = kx;
        v_tile[idx] = vx;
      }
    } else {
      for (int idx = tid; idx < kBlockKV * D; idx += kThreads) {
        const int col = t0 + idx / D;
        float kx = 0.f, vx = 0.f;
        if (col < kv_end) {
          const size_t off = static_cast<size_t>(col) * D + idx % D;
          kx = fa::load_f32(k_head + off);
          vx = fa::load_f32(v_head + off);
        }
        reinterpret_cast<float*>(k_tile)[idx] = kx;
        reinterpret_cast<float*>(v_tile)[idx] = vx;
      }
    }
    if (has_seg && tid < kBlockKV)
      seg_tile[tid] = t0 + tid < kv_end ? seg_head[t0 + tid] : 0;
    if constexpr (kExtra) {
      if (dropout) {  // warp w hashes rows w, w + 8, ...; lane = column
        const int lane = tid % 32;
        for (int i = tid / 32; i < kBlockQ; i += kThreads / 32) {
          const unsigned word =
              __ballot_sync(0xffffffffu, fa::dropout_kept(row_key[i], t0 + lane, ex.threshold));
          if (lane == 0) kept_t[i] = word;
        }
      }
    }
    __syncthreads();

    float s[kBlockKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = k_tile[j * kVec + part + kThreadsPerRow * i];
        dot += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z + qr[i].w * kk.w;
      }
#pragma unroll
      for (int off = 1; off < kThreadsPerRow; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = t0 + j;
      const bool keep = col < kv_len && (!causal || col <= pos) && col > win_lo &&
                        (!has_seg || seg_tile[j] == my_seg) && ((bm_word >> j) & 1u);
      s[j] = keep ? fa::softcap(dot * scale, softcap) : fa::kMaskValue;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_next = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_next);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
      s[j] = expf(s[j] - m_next);
      p_sum += s[j];
    }
    l_run = alpha * l_run + p_sum;
    m_run = m_next;
    if constexpr (kExtra) {
      if (dropout) {  // l keeps the undropped sum; the PV sum takes the kept p
        const unsigned word = kept_t[tid / kThreadsPerRow];
#pragma unroll
        for (int j = 0; j < kBlockKV; ++j) s[j] = (word >> j) & 1u ? s[j] * ex.inv : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlockKV; ++j) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = v_tile[j * kVec + part + kThreadsPerRow * i];
        acc[i].x += s[j] * vv.x;
        acc[i].y += s[j] * vv.y;
        acc[i].z += s[j] * vv.z;
        acc[i].w += s[j] * vv.w;
      }
    }
  }

  if (!live) return;
  // The l == 0 guard of the Pallas epilogue (flash.py:1118).
  const float inv = l_run == 0.f ? 1.f : 1.f / l_run;
  T* o_row = o + (static_cast<size_t>(bh) * rows + row) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = 4 * (part + kThreadsPerRow * i);
    fa::store_f32(o_row + c, acc[i].x * inv);
    fa::store_f32(o_row + c + 1, acc[i].y * inv);
    fa::store_f32(o_row + c + 2, acc[i].z * inv);
    fa::store_f32(o_row + c + 3, acc[i].w * inv);
  }
  if (l_out != nullptr && part == 0) {
    l_out[static_cast<size_t>(bh) * rows + row] = l_run;
    m_out[static_cast<size_t>(bh) * rows + row] = m_run;
  }
}

// The C interface's arguments, passed down the instantiation switches.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
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

template <typename T, typename P, int D, bool kExtra>
int launch(const Args& a) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, P, D, kExtra>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.rows + block_q<D>() - 1) / block_q<D>(), a.bh);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k), static_cast<const P*>(a.v),
      a.k_scales, a.v_scales, static_cast<T*>(a.o), a.l, a.m, a.q_seg, a.kv_seg, a.rows,
      a.s_kv, a.kv_len, a.q_offset, a.q_seq_len, a.causal, a.scale, a.window, a.softcap,
      a.ex);
  return static_cast<int>(cudaGetLastError());
}

// The dropout / block-mask form is built with FA_EXTRA into libraries of
// its own (ops/kernels.py), so the two forms compile in parallel.
template <typename T, typename P, int D>
int launch_x(const Args& a) {
#ifdef FA_EXTRA
  return launch<T, P, D, true>(a);
#else
  if (a.ex.bm_ptr != nullptr || a.ex.threshold != 0) return -1;
  return launch<T, P, D, false>(a);
#endif
}

template <typename T, typename P>
int launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_x<T, P, 16>(a);
    case 32: return launch_x<T, P, 32>(a);
    case 64: return launch_x<T, P, 64>(a);
    case 128: return launch_x<T, P, 128>(a);
    case 256: return launch_x<T, P, 256>(a);
    default: return -1;
  }
}

#ifdef FA_QUANT
template <typename T>
int launch_kv(int kv_dtype, int d, const Args& a) {
  if (kv_dtype == fa::kInt8) return launch_d<T, int8_t>(d, a);
  if (kv_dtype == fa::kFp8E4M3) return launch_d<T, __nv_fp8_e4m3>(d, a);
  return -1;
}
#else
template <typename T>
int launch_kv(int kv_dtype, int d, const Args& a) {
  if (kv_dtype != (std::is_same<T, float>::value ? fa::kFloat32 : fa::kBFloat16)) return -1;
  return launch_d<T, T>(d, a);
}
#endif

}  // namespace

// q: (bh, rows, d); k, v: (bh, s_kv, d); o like q; l, m: (bh, rows) float32
// or both null; q_seg: (bh, rows) and kv_seg: (bh, s_kv) int32, both or
// neither null.  All contiguous, on the device; q and o of dtype code
// `dtype`, k and v of `kv_dtype`: the same code (k_scales, v_scales null),
// or with FA_QUANT int8 / fp8 with float32 scales (bh, s_kv).  window <= 0:
// no sliding window (else it requires causal); softcap <= 0: no logit
// softcap.  bm_ptr, bm_idx, bm_part, bm_bits: a block mask's table over
// (kBlockQ, 32) tiles by query tile (common.cuh, Extras), or all null
// (causal, window and the GQA fold excluded).  dropout_threshold 0: no
// dropout; else the seed, threshold, 1 / (1 - rate) and the raw row stride.
extern "C" int fa_flash_fwd(int dtype, int kv_dtype, const void* q, const void* k,
                            const void* v, const void* k_scales, const void* v_scales,
                            void* o, void* l, void* m, const void* q_seg,
                            const void* kv_seg, const void* bm_ptr, const void* bm_idx,
                            const void* bm_part, const void* bm_bits, int bh, int rows,
                            int s_kv, int d, int kv_len, int q_offset, int q_seq_len,
                            int causal, float scale, int window, float softcap,
                            int row_stride, int dropout_seed, int dropout_threshold,
                            float dropout_inv, void* stream) {
  const fa::Extras ex{static_cast<const int*>(bm_ptr), static_cast<const int*>(bm_idx),
                      static_cast<const int*>(bm_part), static_cast<const unsigned*>(bm_bits),
                      row_stride, static_cast<unsigned>(dropout_seed),
                      static_cast<unsigned>(dropout_threshold), dropout_inv};
  const Args a{q, k, v, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), o, static_cast<float*>(l),
               static_cast<float*>(m), static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg), bh, rows, s_kv, kv_len, q_offset,
               q_seq_len, causal, scale, window, softcap, ex,
               static_cast<cudaStream_t>(stream)};
  if (dtype == fa::kFloat32) return launch_kv<float>(kv_dtype, d, a);
  if (dtype == fa::kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, d, a);
  return -1;
}
