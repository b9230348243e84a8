// Causal GQA flash-attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_fwd through pl.pallas_call).
// Inputs, one dtype (f32, bf16 or f16), contiguous:
//
//     q [B, S, H, D],  k, v [B, S, KV, D],  H a multiple of KV
//
// Query head h reads KV head h / (H / KV); K and V are never replicated.
// Key j counts for query i when j <= i (causal) and i - window < j
// (window > 0). With scale = 1 / sqrt(D), per query row:
//
//     s_j = scale * (q . k_j);   o = sum_j softmax(s)_j v_j
//
// computed as an online softmax over key tiles in order, with the running
// max m, denominator l and accumulator in f32: per tile
// m' = max(m, max_j s_j), alpha = exp(m - m'), p_j = exp(s_j - m'),
// l = alpha l + sum_j p_j, acc = alpha acc + sum_j p_j v_j, and at the end
// o = acc / max(l, 1e-30), written in q's dtype. As in the TPU kernel, p is
// rounded to v's dtype before the PV product (l sums the unrounded p), and
// every product accumulates in f32. Masked keys get p = 0 and the -1e30
// sentinel in the max: a row whose keys in a tile are all masked must add
// nothing, which exp(-1e30 - m) gives only once m is a real logit.
//
// The instances share the TPU grid's shape: one block per (b, h, tile of
// query rows: 64 in bf16 and f16; 128 in f32, 64 at D = 256), numbered
// heaviest
// causal tile first, with the TPU grid's sequential KV axis as the loop
// inside the block. Only live key tiles are visited: keys up to the tile's
// last row (causal) and from its first row's window start. The TPU grid
// walks every S/128 block; skipping dead ones changes nothing, because
// every row keeps its diagonal. Ragged S is masked (rows past S are
// computed on zero queries and never stored, keys past S get p = 0), so
// any S works. Instances exist for D = 64, 128 and
// 256, and the wide instance for any D past 256 in slices of 64; the
// wrapper checks each one's shared-memory budget and raises beyond it.
// flash_attention_launch dispatches on the dtype code and D: bf16 and f16
// run the tensor-core kernel, f32 the CUDA-core kernel, D > 256 the wide
// kernel in every dtype. This source builds two libraries, one nvcc each,
// side by side (kernels/_build.py): the f32 and bf16 instances, and with
// -DF16_INSTANCES the f16 ones alone, whose flash_attention_launch takes
// dtype 2 only (in one library they lengthened its nvcc time by half).
//
// What bounds it on an H100: at the training shape (B = 8, S = 512,
// H = 16, KV = 8, D = 128, bf16) one call must move q, k, v and o once,
// 50.3 MB (3.35 TB/s: 15.0 us), and do 4 B H D S (S + 1) / 2 = 8.6 GFLOP
// on the causal triangle (989 TFLOP/s of bf16 on the tensor cores: 8.7
// us). So the card's bound is bytes.
//
// bf16 and f16 instances: tensor cores (flash_attention_kernel_bf16, _f16)
// -------------------------------------------------------------------------
// One body (tc::attention) for both element types: f16 takes the same
// tiles with mma.sync's .f16 operands and __half2 packing, and rounds P to
// f16 before PV as bf16 rounds it to bf16. Below, "bf16" stands for both.
// The FlashAttention-2 shape on mma.sync. 128 threads, 4 warps; each warp
// owns 16 query rows of the block's 64 for the whole key loop, so no
// barrier guards the softmax state.
// - Staging. The Q tile [64, D] and K/V tiles [64, D] stay bf16 in shared
//   memory, copied by cp.async.cg in 16-byte chunks; rows past S are
//   zero-filled (src-size 0), so ragged S needs no padding. K and V are
//   double-buffered: tile t + 1 is in flight while tile t is computed
//   (commit_group / wait_group, then the barrier that hands the stage
//   over; a second barrier at the end of the tile frees its stage for the
//   next copy). Rows are padded to D + 8 halves, so the eight 16-byte rows
//   one ldmatrix phase reads fall in distinct bank groups. Shared memory is
//   2 (D + 8)(64 + 2 * 2 * 64) bytes: 46,080 at D = 64, 87,040 at D = 128
//   (two blocks per SM), 168,960 at D = 256.
// - S = QK^T by mma.sync.m16n8k16 (bf16 in, f32 accumulate): A fragments
//   from Q by ldmatrix.x4, held in registers for the whole loop at
//   D <= 128; B fragments from K by ldmatrix.x4 (non-transposed), two key
//   tiles of 8 per load. A warp's [16, 64] logits are 32 f32 registers a
//   thread. At D = 256 the output accumulator alone takes 128, so there Q
//   is re-read from shared memory per k-step and each 64-key stage is
//   consumed as two softmax steps of 32 keys (16 registers of logits).
// - Online softmax on the accumulator fragments. Each thread holds two
//   rows (g and g + 8 of its warp's 16) at 16 keys each; the four threads
//   of a quad share a row, so the row max is two __shfl_xor_sync and the
//   row sum one thread-partial l per row, summed over the quad at the end
//   (alpha is uniform over the quad, so the partials rescale alike).
//   log2 e is folded into the scale and every exp is exp2f: s is scaled in
//   f32 by scale * log2 e, p = exp2f(s - m), alpha = exp2f(m - m'), the
//   same function as exp(scale s - m) up to exp2f's rounding. Only the
//   tiles that need it are masked (the causal diagonal, a window's first
//   tiles, the ragged tail); there a bit per key keeps p = 0 explicit.
//   l sums the unrounded f32 p.
// - PV by mma.sync as well: the logits' accumulators, rounded to bf16
//   pairs in registers (the TPU kernel's p.astype(v.dtype)), are the A
//   fragments directly (two adjacent n8 C-tiles are one k16 A-tile), so P
//   never touches memory; B fragments from V by ldmatrix.x4.trans. The
//   output accumulator is 16 x D f32 per warp: D / 2 registers a thread.
// - Epilogue: o = acc / max(l, 1e-30) rounded to bf16, staged through the
//   warp's own Q rows in shared memory, stored as 16-byte chunks; rows past
//   S are not stored.
// Against the bound: every product runs on the tensor cores (no f32
// widening, no shared-memory round trip of P, 64-key tiles: 8 rescales of
// a 512-key row). mma.sync reaches a part of the 989 TFLOP/s that wgmma
// reaches, the diagonal tiles compute their masked half, and the blocks'
// loads are not warp-specialised; wgmma, TMA and a producer warp are the
// later work if it still trails the library.
// ptxas (CUDA 12.9, sm_90a), as chip_smoke.py's build phase prints it:
// 168 registers at D = 64 and 236 at D = 128, no spills; 255 at D = 256
// with 48 bytes spilled. Softmax steps of 16 keys at D = 256 spill the
// same 48 bytes and ran 4-8% slower on an H100, so the 32-key steps stay
// (PERF.md).
//
// f32 instance: CUDA cores (flash_attention_kernel_f32)
// -----------------------------------------------------
// Tensor cores take f32 only as TF32, which the port's f32 parity tier
// forbids, so every product is a plain f32 FMA. At the training shape the
// f32 call does 8.6 GFLOP on the causal triangle (67 TFLOP/s of f32: 128
// us) against 100.7 MB (30 us): the bound is operations. On the CUDA cores
// a thread's rate is set by how many floats it loads from shared memory
// per FMA: an SM serves 32 a cycle (one per lane of a warp) against 128
// FMAs, so a thread must do 4 FMAs per float it loads to keep the FMA
// pipes fed, and what a thread can hold is capped by its 255 registers.
// The design, FlashAttention-2's loop on the FMA pipes:
// - One block of 256 threads (8 warps) per (b, h, tile of 128 query rows;
//   64 at D = 256), heaviest causal tile first; a warp owns 16 rows for
//   the whole key loop, so no barrier guards the softmax state. A warp's
//   lanes are 4 row groups x 8 key groups: a thread holds 4 query rows
//   (2 at D = 256), 8 keys of each 64-key tile and D / 8 output columns.
//   QK^T loads 12 floats per 32 FMAs (8-byte loads along D), PV 16 per 64
//   (16-byte loads of V's rows) plus 4 shuffles.
// - P stays in registers: a row's max is a 3-shuffle tree over its row
//   group, l a thread-partial sum (alpha is uniform over the group) summed
//   at the end, and PV takes each key's p from its owner lane by shuffle.
// - Staging by cp.async: Q once; one K and one V buffer, K of tile t + 1
//   copied while tile t's softmax and PV run, V of tile t + 1 while its
//   QK^T runs. Rows are padded to D + 4 floats, so the 8 rows a quarter
//   warp's 16-byte loads read fall in distinct banks. Shared memory is
//   4 (D + 4)(BLOCK_Q + 2 * 64) bytes: 69,632 at D = 64, 135,168 at 128,
//   199,680 at 256.
// - Masks only on the tiles that need them (the causal diagonal, a
//   window's first tiles, the ragged tail); exp2f with log2 e folded into
//   the scale, as in the bf16 instance. The window branch skips each query
//   tile's dead key tiles.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; scripts/
// f32_kernels.py, PERF.md): 0.3126 ms at (8, 512, 16, 8, 128) (2.4x the
// bound; the first design, 4 x 2 tiles with P through shared memory, took
// 0.5118 in chip_smoke.py) and 7.44 ms at the ring prefill (1, 8448, 16,
// 8, 128, window 8192: 1.7x; the first design 14.109). Thread tiles of 8
// rows x 8 keys (16 floats per 64 FMAs) on 128-key tiles need more than
// 255 registers and spill (0.633 ms); 4 x 16 on 128-key tiles ran 0.617;
// blocks of 64 rows, two an SM, 0.309 but 8.07 at the ring (and spill at
// D = 256); warps skipping a causal tile they do not reach 0.307 but 7.72
// at the ring; the QK^T loop unrolled 1 or 2 steps instead of 4, 0.346
// and 0.321. ptxas (CUDA 12.9, sm_90a): 251, 255 and 254 registers at
// D = 64, 128 and 256, no spills.
//
// wide instance: D past 256, CUDA cores (flash_attention_kernel_wide_*)
// ---------------------------------------------------------------------
// A D = 512 block of the tiled instances needs 332,800 bytes of shared
// memory in bf16 and 396,288 in f32, over the H100's 232,448, and its
// output accumulator would not fit a thread's registers. So D is split
// twice: QK^T is summed over D in slices of 64 (each key tile stages Q's
// and K's slice [64, 64] in f32 in turn), and each block owns 256 output
// columns, so a block's PV accumulator is 64 registers a thread whatever
// D is; the blocks of one query tile each form the same S (QK^T runs once
// per 256 output columns). Grid: (b, h, 64 query rows, 256 columns),
// heaviest causal tile first; threads, online softmax (f32::softmax_update)
// and PV's register tiles as f32's instance at D = 256. Every dtype runs
// here on the CUDA cores, inputs converted to f32 as they are staged; P is
// rounded to T before PV (T's tensor-core instance rounds it so), and o is
// written in T. Shared memory is 101,376 bytes for any D. The wrapper pads
// D to a multiple of 64 and keeps the caller's 1/sqrt(D). A simple,
// correct kernel: no cp.async pipeline, tensor cores or shared S across
// the column blocks yet. ptxas (sm_90a): 255 registers, 48-64 bytes of
// spill loads; on an H100 it ran 1.30 ms at (4, 512, 8, 2, 512) in bf16,
// against 2.30 with 128 columns a block (no spills, QK^T formed twice as
// often), 4.3x its plain version (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// -- f32 instance: CUDA cores ---------------------------------------------

namespace f32 {

constexpr int kPad = 4;                // floats of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

// The tiles per head dim. A warp's lanes are kRowGroups row groups x
// kKeyGroups key (and output column) groups; a thread holds kRows query
// rows (row group + kRowGroups i), kKeys keys of each key tile (key group
// + kKeyGroups j) and D / kKeyGroups output columns (kChunks float4s).
template <int D>
struct Tile {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowGroups = 4;
  static constexpr int kKeyGroups = 32 / kRowGroups;
  static constexpr int kRows = D > 128 ? 2 : 4;
  static constexpr int kBlockQ = kWarps * kRowGroups * kRows;  // 128 or 64
  static constexpr int kBlockK = 64;
  static constexpr int kKeys = kBlockK / kKeyGroups;
  static constexpr int kChunks = D / (4 * kKeyGroups);
};

// the Q tile, one K tile and one V tile, rows padded to D + kPad
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * size_t(D + kPad) *
         (Tile<D>::kBlockQ + 2 * Tile<D>::kBlockK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, kTileRows) of a [*, row_step] f32 array into a
// [kTileRows, D + kPad] tile, one 16-byte cp.async per chunk; rows >=
// n_valid are zero-filled.
template <int D, int kTileRows>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_step, int n_valid,
                                          int tid) {
  constexpr int kThreads = Tile<D>::kThreads;
  constexpr int kChunks = D / 4;                 // 16-byte chunks per row
  static_assert(kTileRows * kChunks % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool in = r < n_valid;
    cp_async16(smem_addr(dst + r * (D + kPad) + ch * 4),
               src + (in ? r * row_step + ch * 4 : 0), in);
  }
}

// One key tile's online-softmax update on a thread's logits: s[i][j] is
// row row0 + kRG i, key k0 + kg + kKG j; on return it holds p (0 where
// masked). The kKG lanes of a row group share its rows: the row max is a
// shuffle tree, l a thread-partial sum (alpha is uniform over the group).
template <int kR, int kNK, int kC, int kRG, int kKG, bool kMask>
__device__ __forceinline__ void softmax_update(
    float (&s)[kR][kNK], float (&m)[kR], float (&l)[kR],
    float (&acc)[kR][kC][4], float scale_log2, int row0, int k0, int kg,
    int seqlen, int causal, int window) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = row0 + kRG * i;
    uint32_t live = 0;                  // bit j: key counts
    float row_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      float& x = s[i][j];
      if (kMask) {
        const int kj = k0 + kg + kKG * j;
        const bool ok = kj < seqlen && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        live |= uint32_t(ok) << j;
        x = ok ? x * scale_log2 : kNegInf;
      } else {
        x *= scale_log2;
      }
      row_max = fmaxf(row_max, x);
    }
#pragma unroll
    for (int off = 1; off < kKG; off <<= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    const float m_new = fmaxf(m[i], row_max);
    const float alpha = exp2f(m[i] - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      float& x = s[i][j];
      x = (!kMask || (live >> j) & 1u) ? exp2f(x - m_new) : 0.f;
      row_sum += x;
    }
    l[i] = l[i] * alpha + row_sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
  }
}

}  // namespace f32

template <int D>
__global__ void __launch_bounds__(f32::Tile<D>::kThreads, 1)
    flash_attention_kernel_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int batch, int seqlen,
                               int heads, int kv_heads, int causal,
                               int window, float scale) {
  using namespace f32;
  using Tl = Tile<D>;
  constexpr int kS = D + kPad;             // smem row stride, floats
  constexpr int kBQ = Tl::kBlockQ;
  constexpr int kBK = Tl::kBlockK;
  constexpr int kR = Tl::kRows;
  constexpr int kNK = Tl::kKeys;
  constexpr int kC = Tl::kChunks;
  constexpr int kRG = Tl::kRowGroups;
  constexpr int kKG = Tl::kKeyGroups;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ, kS]
  float* ks = qs + kBQ * kS;               // [kBK, kS]
  float* vs = ks + kBK * kS;               // [kBK, kS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane / kKG;               // row group
  const int kg = lane % kKG;               // key / column group
  const int bh_count = batch * heads;
  const int n_q = (seqlen + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_q - 1 - blockIdx.x / bh_count;   // heaviest tile first
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, seqlen - q0);

  const long long q_step = (long long)heads * D;      // between positions
  const long long kv_step = (long long)kv_heads * D;
  const float* qb = q + ((long long)b * seqlen + q0) * q_step
                    + (long long)h * D;
  const float* kb = k + (long long)b * seqlen * kv_step + (long long)kvh * D;
  const float* vb = v + (long long)b * seqlen * kv_step + (long long)kvh * D;
  float* ob = o + ((long long)b * seqlen + q0) * q_step + (long long)h * D;

  // live keys: [kv_begin, kv_end)
  const int kv_end = causal ? q0 + q_rows : seqlen;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  // one K and one V buffer: K of tile t + 1 is copied while tile t's
  // softmax and PV run, V of tile t + 1 while its QK^T runs. Groups: {Q,
  // K_t0}, {V_t0}, then per tile {K_t+1}, {V_t+1} (empty past the last).
  {
    const int k0 = t_begin * kBK;
    load_tile<D, kBQ>(qs, qb, q_step, q_rows, tid);
    load_tile<D, kBK>(ks, kb + k0 * kv_step, kv_step, seqlen - k0, tid);
    cp_async_commit();
    load_tile<D, kBK>(vs, vb + k0 * kv_step, kv_step, seqlen - k0, tid);
    cp_async_commit();
  }

  // this thread's query rows (tile-local): lrow + kRG i
  const int lrow = warp * kRG * kR + rg;
  const float* q_row = qs + lrow * kS;
  float acc[kR][kC][4];
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    cp_async_wait<1>();                    // Q and K_t
    __syncthreads();

    // S = Q K^T: 8-byte loads along D (two floats of each operand a step
    // keep the operands at 2 (kR + kNK) registers)
    float s[kR][kNK];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kNK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qv[kR], kv[kNK];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = *reinterpret_cast<const float2*>(q_row + kRG * i * kS + d);
#pragma unroll
      for (int j = 0; j < kNK; ++j)
        kv[j] = *reinterpret_cast<const float2*>(ks + (kg + kKG * j) * kS +
                                                 d);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kNK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }
    __syncthreads();                       // K_t read by every warp
    if (t + 1 < t_end) {
      const int k1 = k0 + kBK;
      load_tile<D, kBK>(ks, kb + k1 * kv_step, kv_step, seqlen - k1, tid);
    }
    cp_async_commit();

    const bool need_mask = (causal && k0 + kBK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kBQ - 1 - window) ||
                           k0 + kBK > seqlen;
    if (need_mask)
      softmax_update<kR, kNK, kC, kRG, kKG, true>(
          s, m, l, acc, scale_log2, q0 + lrow, k0, kg, seqlen, causal,
          window);
    else
      softmax_update<kR, kNK, kC, kRG, kKG, false>(
          s, m, l, acc, scale_log2, q0 + lrow, k0, kg, seqlen, causal,
          window);
    cp_async_wait<1>();                    // V_t
    __syncthreads();

    // O += P V: key kKG j + g is slot j of lane g of this row group, so p
    // comes by shuffle; V's row by 16-byte loads, columns 4 (kKG c + kg)
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int g = 0; g < kKG; ++g) {
        float p[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          p[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & ~(kKG - 1)) | g);
        const float* v_row = vs + (kKG * j + g) * kS + 4 * kg;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_row + 4 * kKG * c);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
          }
        }
      }
    __syncthreads();                       // V_t read by every warp
    if (t + 1 < t_end) {
      const int k1 = k0 + kBK;
      load_tile<D, kBK>(vs, vb + k1 * kv_step, kv_step, seqlen - k1, tid);
    }
    cp_async_commit();
  }

  // o = acc / max(l, 1e-30), 16-byte stores; rows past S are not stored
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < kKG; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float denom = fmaxf(sum, 1e-30f);
    const int r = lrow + kRG * i;
    if (r < q_rows) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        *reinterpret_cast<float4*>(ob + r * q_step + 4 * (kKG * c + kg)) =
            make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                        acc[i][c][2] / denom, acc[i][c][3] / denom);
    }
  }
}

// -- bf16 and f16 instances: tensor cores ---------------------------------

namespace tc {

constexpr int kThreads = 128;          // 4 warps, 16 query rows each
constexpr int kBlockQ = 64;            // query rows per block (BLOCK_Q)
constexpr int kBlockK = 64;            // keys per tile (BLOCK_K)
constexpr int kPad = 8;                // halves of padding per smem row
constexpr int kStages = 2;             // K/V buffers in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  return 2 * size_t(D + kPad) * (kBlockQ + 2 * kStages * kBlockK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), T (bf16 or f16) in, f32
// accumulate
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to a T pair, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  } else {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  }
}

// Copy rows [0, 64) of a [*, row_step] 2-byte array into a [64, D + 8] tile,
// one 16-byte cp.async per chunk; rows >= n_valid are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long row_step, int n_valid,
                                          int tid) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks per row
  static_assert(kBlockQ == kBlockK, "one tile loader for Q, K and V");
#pragma unroll
  for (int i = 0; i < kBlockK * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool in = r < n_valid;
    cp_async16(dst + (r * (D + kPad) + ch * 8) * 2,
               src + (in ? r * row_step + ch * 8 : 0), in);
  }
}

// One tile's online-softmax update on the logits' fragments. s[j][2 half +
// e] holds row g + 8 half, key k0 + 8 j + 2 tig + e; on return it holds p.
template <int D, int kNT, bool kMask>
__device__ __forceinline__ void softmax_update(
    float (&s)[kNT][4], float (&m)[2], float (&l)[2],
    float (&acc)[D / 8][4], float scale_log2, int row0, int k0, int seqlen,
    int causal, int window, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    uint32_t live = 0;                  // bit 2 j + e: key counts
    float row_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        if (kMask) {
          const int kj = k0 + 8 * j + 2 * tig + e;
          const bool ok = kj < seqlen && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          live |= uint32_t(ok) << (2 * j + e);
          x = ok ? x * scale_log2 : kNegInf;
        } else {
          x *= scale_log2;
        }
        row_max = fmaxf(row_max, x);
      }
    // the four threads of a quad share the row
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m[half], row_max);
    const float alpha = exp2f(m[half] - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * half + e];
        x = (!kMask || (live >> (2 * j + e)) & 1u) ? exp2f(x - m_new) : 0.f;
        row_sum += x;
      }
    l[half] = l[half] * alpha + row_sum;     // this thread's part of the row
    m[half] = m_new;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[c][2 * half] *= alpha;
      acc[c][2 * half + 1] *= alpha;
    }
  }
}

// The kernel's body, for T = bf16 or f16 (the __global__ entries below)
template <typename T, int D>
__device__ __forceinline__ void attention(const T* __restrict__ q,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          T* __restrict__ o, int batch,
                                          int seqlen, int heads, int kv_heads,
                                          int causal, int window,
                                          float scale) {
  constexpr int kS = D + kPad;             // smem row stride, halves
  constexpr int kTile = kBlockK * kS;      // halves per K or V stage
  constexpr int kKSteps = D / 16;          // k16 steps of QK^T
  constexpr int kSubK = D > 128 ? 32 : 64; // keys per softmax step
  constexpr int kNT = kSubK / 8;           // n8 key tiles of S
  constexpr int kDT = D / 8;               // n8 column tiles of O
  constexpr int kChunks = D / 8;           // 16-byte chunks per row
  constexpr bool kQRegs = D <= 128;        // Q fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBlockQ, kS]
  const uint32_t qs_a = smem_addr(qs);
  const uint32_t ks_a = qs_a + kBlockQ * kS * sizeof(T);    // [2][kBlockK, kS]
  const uint32_t vs_a = ks_a + kStages * kTile * sizeof(T); // [2][kBlockK, kS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // fragment row group
  const int tig = lane & 3;                // thread in group
  const int bh_count = batch * heads;
  const int n_q = (seqlen + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_q - 1 - blockIdx.x / bh_count;   // heaviest tile first
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBlockQ;
  const int q_rows = min(kBlockQ, seqlen - q0);

  const long long q_step = (long long)heads * D;      // between positions
  const long long kv_step = (long long)kv_heads * D;
  const T* qb = q + ((long long)b * seqlen + q0) * q_step + (long long)h * D;
  const T* kb = k + (long long)b * seqlen * kv_step + (long long)kvh * D;
  const T* vb = v + (long long)b * seqlen * kv_step + (long long)kvh * D;
  T* ob = o + ((long long)b * seqlen + q0) * q_step + (long long)h * D;

  // live keys: [kv_begin, kv_end)
  const int kv_end = causal ? q0 + q_rows : seqlen;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBlockK;
  const int t_end = (kv_end + kBlockK - 1) / kBlockK;

  // group 0: the Q tile and the first K/V tile
  load_tile<D>(qs_a, qb, q_step, q_rows, tid);
  {
    const int k0 = t_begin * kBlockK;
    load_tile<D>(ks_a, kb + k0 * kv_step, kv_step, seqlen - k0, tid);
    load_tile<D>(vs_a, vb + k0 * kv_step, kv_step, seqlen - k0, tid);
  }
  cp_async_commit();

  // each lane's ldmatrix row address within a tile (bytes): Q's A tile
  // (rows 0-15, depth halves 0/8), K's two n8 key tiles (keys 0-7 / 8-15,
  // depth 0/8) and V's two n8 column tiles (keys 0-7 / 8-15, columns 0/8)
  const uint32_t q_off =
      ((warp * 16 + (lane & 15)) * kS + (lane >> 4) * 8) * sizeof(T);
  const uint32_t k_off =
      (((lane & 7) + ((lane >> 4) << 3)) * kS + ((lane >> 3) & 1) * 8) *
      sizeof(T);
  const uint32_t v_off =
      (((lane & 7) + (((lane >> 3) & 1) << 3)) * kS + (lane >> 4) * 8) *
      sizeof(T);

  uint32_t qf[kQRegs ? kKSteps : 1][4];
  float acc[kDT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: +0, +8
  const float scale_log2 = scale * kLog2e;

  for (int t = t_begin, stage = 0; t < t_end; ++t, stage ^= 1) {
    if (t + 1 < t_end) {                   // prefetch tile t + 1
      const int k1 = (t + 1) * kBlockK;
      const uint32_t off = (stage ^ 1) * kTile * sizeof(T);
      load_tile<D>(ks_a + off, kb + k1 * kv_step, kv_step, seqlen - k1, tid);
      load_tile<D>(vs_a + off, vb + k1 * kv_step, kv_step, seqlen - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();                  // all but tile t + 1 arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // tile t visible to every warp
    if (kQRegs && t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKSteps : 1); ++kk)
        ldmatrix_x4(qf[kk], qs_a + q_off + kk * 16 * sizeof(T));
    }
    const uint32_t kt = ks_a + stage * kTile * sizeof(T);
    const uint32_t vt = vs_a + stage * kTile * sizeof(T);

#pragma unroll 1
    for (int sub = 0; sub < kBlockK / kSubK; ++sub) {
      const int k0 = t * kBlockK + sub * kSubK;
      const uint32_t kst = kt + sub * kSubK * kS * sizeof(T);
      const uint32_t vst = vt + sub * kSubK * kS * sizeof(T);

      // S = Q K^T, [16, kSubK] per warp
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4];
        if (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kQRegs ? kk : 0][e];
        } else {
          ldmatrix_x4(a, qs_a + q_off + kk * 16 * sizeof(T));
        }
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kst + k_off + (jp * 16 * kS + kk * 16) * sizeof(T));
          mma<T>(s[2 * jp], a, bk[0], bk[1]);
          mma<T>(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }

      const bool need_mask = (causal && k0 + kSubK - 1 > q0) ||
                             (window > 0 && k0 <= q0 + kBlockQ - 1 - window) ||
                             k0 + kSubK > seqlen;
      if (need_mask)
        softmax_update<D, kNT, true>(s, m, l, acc, scale_log2, row0, k0,
                                     seqlen, causal, window, tig);
      else
        softmax_update<D, kNT, false>(s, m, l, acc, scale_log2, row0, k0,
                                      seqlen, causal, window, tig);

      // O += P V: P's bf16 pairs are the A fragments (C tiles 2kk, 2kk + 1)
#pragma unroll
      for (int kk = 0; kk < kSubK / 16; ++kk) {
        const uint32_t a[4] = {pack<T>(s[2 * kk][0], s[2 * kk][1]),
                               pack<T>(s[2 * kk][2], s[2 * kk][3]),
                               pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, vst + v_off + (kk * 16 * kS + dp * 16) * sizeof(T));
          mma<T>(acc[2 * dp], a, bv[0], bv[1]);
          mma<T>(acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                       // stage free for tile t + 2
  }

  // o = acc / max(l, 1e-30) in bf16, staged through this warp's Q rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    T* row = qs + (warp * 16 + g + 8 * half) * kS + 2 * tig;
#pragma unroll
    for (int c = 0; c < kDT; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) =
          pack<T>(acc[c][2 * half] / denom, acc[c][2 * half + 1] / denom);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = warp * 16 + c / kChunks;
    const int ch = c % kChunks;
    if (r < q_rows)
      *reinterpret_cast<uint4*>(ob + r * q_step + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + r * kS + ch * 8);
  }
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
    flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int batch,
                                int seqlen, int heads, int kv_heads,
                                int causal, int window, float scale) {
  tc::attention<__nv_bfloat16, D>(q, k, v, o, batch, seqlen, heads, kv_heads,
                                  causal, window, scale);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
    flash_attention_kernel_f16(const __half* __restrict__ q,
                               const __half* __restrict__ k,
                               const __half* __restrict__ v,
                               __half* __restrict__ o, int batch, int seqlen,
                               int heads, int kv_heads, int causal,
                               int window, float scale) {
  tc::attention<__half, D>(q, k, v, o, batch, seqlen, heads, kv_heads, causal,
                           window, scale);
}

// -- wide instance: any head dim past 256, CUDA cores ----------------------

namespace wide {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowGroups = 4;          // a warp's lanes: 4 row groups x 8
constexpr int kKeyGroups = 8;          //   key (and output column) groups
constexpr int kRows = 2;               // query rows a thread holds
constexpr int kBlockQ = kWarps * kRowGroups * kRows;    // 64
constexpr int kBlockK = 64;
constexpr int kKeys = kBlockK / kKeyGroups;             // 8 a thread
constexpr int kSlice = 64;             // D columns a QK^T step stages
constexpr int kCols = 256;             // output columns a block owns
constexpr int kChunks = kCols / (4 * kKeyGroups);       // float4s a row
constexpr int kPad = 4;                // floats of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

// the Q and K slices [64, kSlice + 4] and the V slice [64, kCols + 4], f32
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBlockQ + kBlockK) * (kSlice + kPad) +
                          size_t(kBlockK) * (kCols + kPad));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// This thread's share of columns [c0, c0 + kW) of rows [0, 64) of a
// [*, row_step] array, as f32 in registers (all loads issued before the
// stores); rows >= n_valid and columns >= d_valid are zeros.
template <int kW, typename T>
__device__ __forceinline__ void load(float (&v)[64 * kW / kThreads],
                                     const T* src, long long row_step,
                                     int n_valid, int c0, int d_valid,
                                     int tid) {
#pragma unroll
  for (int u = 0; u < 64 * kW / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kW, c = i - r * kW;
    const bool in = r < n_valid && c0 + c < d_valid;
    v[u] = in ? to_f32(src[r * row_step + c0 + c]) : 0.f;
  }
}

// the registers into a [64, kW] corner of an f32 tile whose rows are
// kStride floats apart
template <int kW, int kStride = kW + kPad>
__device__ __forceinline__ void store(float* dst,
                                      const float (&v)[64 * kW / kThreads],
                                      int tid) {
#pragma unroll
  for (int u = 0; u < 64 * kW / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kW, c = i - r * kW;
    dst[r * kStride + c] = v[u];
  }
}

}  // namespace wide

// One block per (b, h, tile of 64 query rows, 256 output columns),
// heaviest causal tile first. Per live key tile: S = Q K^T summed over D
// in slices of 64 (Q's and K's slices staged in f32), the online-softmax
// update of f32's instance (f32::softmax_update), then O += P V on the
// block's 256 columns of V, p rounded to T first (T's instance rounds P so
// too); o = acc / max(l, 1e-30) in T. Every block of a row tile forms the
// same S, so QK^T runs once per 256 output columns.
template <typename T>
__device__ __forceinline__ void attention_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int batch, int seqlen, int heads, int kv_heads,
    int head_dim, int causal, int window, float scale) {
  using namespace wide;
  constexpr int kQS = kSlice + kPad;       // smem row strides, floats
  constexpr int kVS = kCols + kPad;
  constexpr int kR = kRows, kNK = kKeys, kC = kChunks;
  constexpr int kRG = kRowGroups, kKG = kKeyGroups;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBlockQ, kQS]
  float* ks = qs + kBlockQ * kQS;          // [kBlockK, kQS]
  float* vs = ks + kBlockK * kQS;          // [kBlockK, kVS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane / kKG;
  const int kg = lane % kKG;
  const int n_cols = (head_dim + kCols - 1) / kCols;
  const int bh_count = batch * heads;
  const int n_q = (seqlen + kBlockQ - 1) / kBlockQ;
  const int col = blockIdx.x % n_cols;
  const int rest = blockIdx.x / n_cols;
  const int bh = rest % bh_count;
  const int qt = n_q - 1 - rest / bh_count;   // heaviest tile first
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBlockQ;
  const int q_rows = min(kBlockQ, seqlen - q0);
  const int c0 = col * kCols;

  const long long q_step = (long long)heads * head_dim;
  const long long kv_step = (long long)kv_heads * head_dim;
  const T* qb = q + ((long long)b * seqlen + q0) * q_step
                + (long long)h * head_dim;
  const T* kb = k + (long long)b * seqlen * kv_step
                + (long long)kvh * head_dim;
  const T* vb = v + (long long)b * seqlen * kv_step
                + (long long)kvh * head_dim;
  T* ob = o + ((long long)b * seqlen + q0) * q_step + (long long)h * head_dim;

  const int kv_end = causal ? q0 + q_rows : seqlen;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBlockK;
  const int t_end = (kv_end + kBlockK - 1) / kBlockK;

  const int lrow = warp * kRG * kR + rg;   // this thread's rows: + kRG i
  float acc[kR][kC][4];
  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    float s[kR][kNK];                      // logits, then p
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kNK; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < head_dim; d0 += kSlice) {
      float qr[64 * kSlice / kThreads], kr[64 * kSlice / kThreads];
      load<kSlice>(qr, qb, q_step, q_rows, d0, head_dim, tid);
      load<kSlice>(kr, kb + k0 * kv_step, kv_step, seqlen - k0, d0,
                   head_dim, tid);
      __syncthreads();                     // the last slices are read
      store<kSlice>(qs, qr, tid);
      store<kSlice>(ks, kr, tid);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kSlice; d += 2) {
        float2 qv[kR], kv2[kNK];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          qv[i] = *reinterpret_cast<const float2*>(
              qs + (lrow + kRG * i) * kQS + d);
#pragma unroll
        for (int j = 0; j < kNK; ++j)
          kv2[j] = *reinterpret_cast<const float2*>(
              ks + (kg + kKG * j) * kQS + d);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kNK; ++j) {
            s[i][j] = fmaf(qv[i].x, kv2[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv2[j].y, s[i][j]);
          }
      }
    }
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {   // V's slice, 128 columns at once
      float vr[64 * kCols / 2 / kThreads];
      load<kCols / 2>(vr, vb + k0 * kv_step, kv_step, seqlen - k0,
                      c0 + half * kCols / 2, head_dim, tid);
      store<kCols / 2, kVS>(vs + half * kCols / 2, vr, tid);
    }

    const bool need_mask = (causal && k0 + kBlockK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kBlockQ - 1 - window) ||
                           k0 + kBlockK > seqlen;
    if (need_mask)
      f32::softmax_update<kR, kNK, kC, kRG, kKG, true>(
          s, m, l, acc, scale_log2, q0 + lrow, k0, kg, seqlen, causal,
          window);
    else
      f32::softmax_update<kR, kNK, kC, kRG, kKG, false>(
          s, m, l, acc, scale_log2, q0 + lrow, k0, kg, seqlen, causal,
          window);
#pragma unroll
    for (int i = 0; i < kR; ++i)           // p in T, as T's instance has it
#pragma unroll
      for (int j = 0; j < kNK; ++j) s[i][j] = to_f32(from_f32<T>(s[i][j]));
    __syncthreads();                       // V's slice staged

    // O += P V, as f32's instance: key kKG j + g is slot j of lane g of
    // this row group; columns 4 (kKG c + kg) of the block's kCols
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int g = 0; g < kKG; ++g) {
        float p[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          p[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & ~(kKG - 1)) | g);
        const float* v_row = vs + (kKG * j + g) * kVS + 4 * kg;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_row + 4 * kKG * c);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
          }
        }
      }
  }

  // o = acc / max(l, 1e-30) in T; rows past S and columns past D not stored
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < kKG; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float denom = fmaxf(sum, 1e-30f);
    const int r = lrow + kRG * i;
    if (r < q_rows) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = c0 + 4 * (kKG * c + kg) + e;
          if (cc < head_dim)
            ob[r * q_step + cc] = from_f32<T>(acc[i][c][e] / denom);
        }
    }
  }
}

#ifndef F16_INSTANCES
__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_attention_kernel_wide_f32(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ o, int batch,
                                    int seqlen, int heads, int kv_heads,
                                    int head_dim, int causal, int window,
                                    float scale) {
  attention_wide<float>(q, k, v, o, batch, seqlen, heads, kv_heads, head_dim,
                        causal, window, scale);
}

__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_attention_kernel_wide_bf16(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     __nv_bfloat16* __restrict__ o, int batch,
                                     int seqlen, int heads, int kv_heads,
                                     int head_dim, int causal, int window,
                                     float scale) {
  attention_wide<__nv_bfloat16>(q, k, v, o, batch, seqlen, heads, kv_heads,
                                head_dim, causal, window, scale);
}

#else
__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_attention_kernel_wide_f16(const __half* __restrict__ q,
                                    const __half* __restrict__ k,
                                    const __half* __restrict__ v,
                                    __half* __restrict__ o, int batch,
                                    int seqlen, int heads, int kv_heads,
                                    int head_dim, int causal, int window,
                                    float scale) {
  attention_wide<__half>(q, k, v, o, batch, seqlen, heads, kv_heads, head_dim,
                         causal, window, scale);
}
#endif  // F16_INSTANCES

// -- launch ---------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, seqlen, heads, kv_heads, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, int block_q,
           const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_q = (a.seqlen + block_q - 1) / block_q;
  kernel<<<a.batch * a.heads * n_q, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.batch, a.seqlen,
      a.heads, a.kv_heads, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dim(const Args& a, int dtype) {
#ifndef F16_INSTANCES
  if (dtype == 0)
    return launch<float>(flash_attention_kernel_f32<D>, f32::smem_bytes<D>(),
                         f32::Tile<D>::kThreads, f32::Tile<D>::kBlockQ, a);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_attention_kernel_bf16<D>,
                                 tc::smem_bytes<D>(), tc::kThreads,
                                 tc::kBlockQ, a);
#else
  if (dtype == 2)
    return launch<__half>(flash_attention_kernel_f16<D>, tc::smem_bytes<D>(),
                          tc::kThreads, tc::kBlockQ, a);
#endif
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Kernel>
int launch_wide(Kernel kernel, int head_dim, const Args& a) {
  const size_t smem = wide::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (a.seqlen + wide::kBlockQ - 1) / wide::kBlockQ;
  const int n_cols = (head_dim + wide::kCols - 1) / wide::kCols;
  kernel<<<a.batch * a.heads * n_q * n_cols, wide::kThreads, smem,
           a.stream>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v), static_cast<T*>(a.o),
                       a.batch, a.seqlen, a.heads, a.kv_heads, head_dim,
                       a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16, 2 = float16 (tensor
// cores; the -DF16_INSTANCES build's only dtype, the other build's two
// others); q, k, v and o share it. All tensors contiguous; heads %
// kv_heads == 0; head_dim 64, 128 or 256, or past 256 a multiple of 64
// (the wide instance, CUDA cores in every dtype); causal 0/1; window <= 0
// for none. Returns the cudaError_t of the launch (0 = ok).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int seqlen, int heads,
                           int kv_heads, int head_dim, int causal, int window,
                           float scale, int dtype, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,        v,      o,      batch, seqlen,
               heads, kv_heads, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 64: return launch_dim<64>(a, dtype);
    case 128: return launch_dim<128>(a, dtype);
    case 256: return launch_dim<256>(a, dtype);
  }
  if (head_dim < 256 || head_dim % wide::kSlice)
    return (int)cudaErrorInvalidValue;
#ifndef F16_INSTANCES
  if (dtype == 0)
    return launch_wide<float>(flash_attention_kernel_wide_f32, head_dim, a);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(flash_attention_kernel_wide_bf16,
                                      head_dim, a);
#else
  if (dtype == 2)
    return launch_wide<__half>(flash_attention_kernel_wide_f16, head_dim, a);
#endif
  return (int)cudaErrorInvalidValue;
}

// The wide instance's dynamic shared memory (the wrapper's must agree).
int flash_attention_wide_smem() { return (int)wide::smem_bytes(); }

// Largest dynamic shared memory one block may opt into on `device`.
int flash_attention_max_smem(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
