// Mamba-2 chunked SSD (state-space duality) forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_fwd through pl.pallas_call). Inputs:
//
//     x  [B, S, H, P]  already scaled by dt, f32 or bf16
//     da [B, S, H]     dt * A (<= 0), f32
//     Bm, Cm [B, S, N] in x's dtype, one group shared by every head
//
// S is cut into chunks of L <= 128 rows (S % L == 0; any L, powers of two
// or not). Per (b, h), walking the chunks in order with the [P, N] f32
// state carried from one chunk to the next, and a_cs the cumulative sum of
// da inside the chunk:
//
//     Gd[i, j] = (C_i . B_j) * exp(a_cs[i] - a_cs[j])     for j <= i, else 0
//     y[i, :]  = sum_j Gd[i, j] x[j, :] + exp(a_cs[i]) * (state . C_i)
//     state    = exp(a_cs[L-1]) * state
//                + sum_l exp(a_cs[L-1] - a_cs[l]) * x[l, :]^T B_l
//
// y is written in x's dtype, the final state in f32; every sum is an f32
// accumulation from f32 or bf16 inputs. exp is evaluated only where j <= i:
// above the diagonal a_cs[i] - a_cs[j] > 0 can overflow to inf, and a
// multiply by a 0/1 mask would turn that into NaN.
//
// ssd_scan_launch picks the instance by dtype: bf16 runs on the tensor
// cores, f32 on the CUDA cores (tensor cores take f32 only as TF32, which
// the port's f32 parity tier forbids).
//
// bf16 instance: tensor cores (ssd_scan_kernel_bf16)
// ---------------------------------------------------
// What bounds it on an H100: at the serving prefill's shape (B = 4, S = 512,
// H = 32, P = 64, N = 128, L = 128) one call must read x, da, B, C and write
// y and the state once, 22.3 MB (3.35 TB/s: 6.7 us), and do 2.72 GFLOP on
// the causal triangle with G = C B^T once per (b, chunk) (989 TFLOP/s of
// bf16: 2.8 us). So the card's bound is bytes.
// The first design (one block of 256 threads per (b, h), every product an
// f32 FMA on shared-memory operands, G formed again by each head, the
// cumulative sum on one thread, loads behind the math) took 1.151 ms there,
// 1.6x its plain version. This one takes 0.0569 ms there (8.6x the bound,
// 12x faster than the plain version; PERF.md, section 6):
// - One block of 256 threads (8 warps) per (b, h, P tile). The tile is P,
//   or P / 2 where twice B * H blocks still fit one wave (the wrapper
//   plans it: at one block per SM, two waves of half tiles ran 1.7x slower
//   at the serving shape). Each block walks the chunks in order (the TPU
//   grid's sequential axis).
// - Staging: per chunk, x [Lp, Pt], B and C [Lp, N] (Lp = L rounded up to
//   16) and da are copied by cp.async, double-buffered: chunk c + 1's
//   copies are in flight while chunk c computes. Rows past L are zero-
//   filled and get decay 0. Rows are padded by 8 halves so the eight rows
//   one ldmatrix phase reads fall in distinct bank groups.
// - The cumulative sum of da is a warp scan (shuffles) per 32 rows plus
//   the warps' totals; every thread that needs a_cs[l] adds the same terms
//   in the same order, so exp(a_cs[L-1] - a_cs[L-1]) is exactly 1.
// - Phase A, warp w on row tiles w, w + 8, ...: y_off = exp(a_cs) o (C
//   state^T), then y_diag = (G o decay) x on the causal tiles, each 16 x 16
//   tile of G = C B^T formed on the tensor cores from the staged C and B
//   (its accumulators are the next product's A fragment layout), the decay
//   applied on the fragments (exp only where j <= i < L). Operands come by
//   ldmatrix (.trans for x). y is stored from the accumulators in bf16.
// - Phase B, after a barrier (phase A reads the state that B rewrites):
//   state = exp(a_last) state + (x o w)^T B, w = exp(a_last - a_cs). Each
//   warp owns items of 16 rows of p and 32 columns of n, all in one p
//   tile, and keeps their f32 values as mma accumulators in registers for
//   the whole sequence (kItems items: 16 kItems registers); x o w is formed
//   once per k step for all of them. After each chunk the owners write the
//   state's hi and lo bf16 parts to shared memory, [Pt, N + 8] each, the B
//   operand of the next chunk's C state^T (by ldmatrix). The final state
//   goes to memory from the registers.
// - Precision: x, B and C are bf16 inputs and go into the products as they
//   are. The three f32 operands (G o decay, the state, x o w) are each split
//   into a hi and a lo bf16 part, two mma.sync per product, which keeps ~16
//   of their mantissa bits; the state carried between chunks stays f32 in
//   the registers. Without the lo parts (one bf16 rounding of each, as
//   FlashAttention rounds P) it ran 14% faster at the serving shape, but 29
//   elements there landed outside the kernel check's allowed error
//   (ref.allowed_error), so the split stays.
// - Registers (ptxas, CUDA 12.9): 181 at (Pt, kItems) = (64, 2), the
//   serving shape's, 130 at (32, 1); 120-244 over all instances, no
//   spills.
// - G per block, not shared: a kernel of its own forming G once per
//   (b, chunk) into an f32 buffer that the scan blocks read (prefetched a
//   tile ahead) saves the heads' repeated G (~2.4 MFLOP per (b, h, chunk))
//   at the cost of a launch and of L2 reads on each warp's path; on an
//   H100 it was 7% slower at the serving shape and at S = 640, 18% at
//   P = 128 and 38% at a lone prompt (B = 1).
//   scripts/ssd_scan_variants.py builds both variants as edits of this
//   file and times them.
// - Limits: P and N multiples of 16; P tiles of 16, 32, 64 or 128; at most
//   kMaxItems state items a warp; the shared-memory plan 2 (Lp (Pt + 8) 2 +
//   2 Lp (N + 8) 2 + 4 Lp) + 4 Pt (N + 8) + 4 (4 Lp + 8) bytes within the
//   card's opt-in limit (214,048 at Pt = 64, N = 128, L = 128). The wrapper
//   raises otherwise.
// mma.sync reaches a part of the 989 TFLOP/s that wgmma reaches, and one
// block of 8 warps per SM hides little latency; TMA, wgmma and warp
// specialisation are the later work.
//
// f32 instance: CUDA cores (ssd_scan_kernel_f32_diag, _carry)
// -------------------------------------------------------------
// Tensor cores take f32 only as TF32, which the port's f32 parity tier
// forbids, so every product is a plain f32 FMA. At the serving shape the
// call needs 2.72 GFLOP (67 TFLOP/s of f32: 41 us) against 40.1 MB (12
// us): the bound is operations. As in flash_attention's f32 instance, an
// SM's shared memory serves 32 floats a cycle against 128 FMAs, so a
// thread's register tile sets the rate. The first design (one block of
// 256 threads per (b, h) walking the chunks, one shared load per FMA, G
// formed by every head, the cumulative sum on one thread) took 1.18 ms
// there, 1.8x its plain version. This one takes the chunked form the plain
// version uses (ref.py) in two launches on one stream, with no scratch:
// kernel 1 writes each chunk's diagonal part of y, kernel 2 carries the
// state and adds the off-diagonal part.
// - Kernel 1 (ssd_scan_kernel_f32_diag): one block of 256 threads per (b,
//   chunk, group of up to 16 heads; the wrapper plans the group,
//   kernel.f32_heads_per_block). C, B and the group's da by cp.async; each
//   head's a_cs by a warp scan; G = C B^T once for the group, warp w on
//   rows 16 w .. 16 w + 15 and the w + 1 column blocks the causal triangle
//   needs ([8, w + 1] register tiles, 16-byte loads along N); then per
//   head Gd = G o exp(a_cs[i] - a_cs[j]) (exp only where j <= i < L, on
//   the columns its rows read) and y = Gd x on [8 rows x 4 columns]
//   tiles, warp w's keys ending at 16 w + 15, a slab of 64 columns of P
//   at a time, the next slab copied while one is used.
// - Kernel 2 (ssd_scan_kernel_f32_carry): one block of 256 threads per
//   (b, h, 64 columns of P), the state [64, N] in registers ([4, 4 kNV] a
//   thread) for the whole sequence, the chunks in order: (a) y +=
//   exp(a_cs) o (C state^T) past the first chunk, on [8 rows x 4 columns]
//   tiles reading the state from its shared-memory copy, kernel 1's part
//   of y loaded before the product; (b) state = exp(a_last) state + (x o
//   w)^T B, w = exp(a_last - a_cs). C and da of chunk c + 1 are copied
//   while (b) of chunk c runs, x and B while (a) of chunk c + 1 runs; the
//   final state is stored from the registers.
// - Shapes: any chunk <= 128 (rows padded to 16 and zero-filled), P and N
//   of any size (4-byte copies where a row is not a 16-byte multiple), N
//   <= 256 (kernel 2's state). The wrapper raises beyond that or the
//   shared memory: 210,944 bytes (kernel 1) and 203,776 (kernel 2) at
//   L = N = 128.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; scripts/f32_kernels.py,
// PERF.md): 0.147 ms at the serving shape (3.6x the bound; the plain
// version 0.673), kernel 1 65 us and kernel 2 81 us; 0.930 ms at jamba's
// P = N = 128 (2.9x the bound; plain 3.64), 301 and 632 us. Cut out one
// at a time at the serving shape, (a) costs 35 us, (b) 26, G 16, Gd x 17,
// the exps 9: the products run at 30-60 % of the FMA rate on register
// tiles of 32 floats a thread (2.7 FMAs per float loaded), and G is formed
// again by each of a chunk's 8 blocks. G as a full square (balanced warps,
// twice the work) took 0.167 ms, y's part read after (a)'s product 0.169;
// G shared over thread-block clusters of a chunk's blocks (distributed
// shared memory) ran slower, its clusters holding fewer blocks resident.
// ptxas (CUDA 12.9, sm_90a): kernel 1 168 registers, kernel 2 244, 254
// and 254 at N padded to 64, 128 and 256; no spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// -- f32 instance: CUDA cores ---------------------------------------------

namespace f32 {

constexpr int kThreads = 256;          // 8 warps; 16 x 16 thread grids
constexpr int kPad = 4;                // floats of padding per smem row
constexpr int kPTile = 64;             // P columns of a carry block
constexpr int kXS = 64;                // P columns of a diagonal x slab
constexpr int kMaxGroup = 16;          // heads a diagonal block takes

__host__ __device__ inline int padded_chunk(int chunk) {
  return (chunk + 15) / 16 * 16;
}

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// N padded to 64 kNV, the carry kernel's state columns
__host__ __device__ inline int carry_nv(int n_dim) {
  return n_dim <= 64 ? 1 : n_dim <= 128 ? 2 : n_dim <= 256 ? 4 : 0;
}

// Dynamic shared memory (bytes) of a diagonal block: G [Lp, Lp + 4], then
// C and B [Lp, N4 + 4] (N4 = N rounded up to 4) while G is formed, later
// Gd [Lp, Lp + 4] and two x slabs [Lp, 64] in the same bytes; da, then
// a_cs, of up to kMaxGroup heads [kMaxGroup, Lp].
__host__ __device__ inline int diag_smem(int n_dim, int chunk) {
  const int lp = padded_chunk(chunk);
  const int gs = lp + kPad;
  const int ns = pad4(n_dim) + kPad;
  const int phase1 = 2 * lp * ns;
  const int phase2 = lp * gs + 2 * lp * kXS;
  return 4 * (lp * gs + (phase1 > phase2 ? phase1 : phase2) +
              kMaxGroup * lp);
}

// Dynamic shared memory (bytes) of a carry block: C and B [Lp, 64 kNV +
// 4], x [Lp, 64], the state [64, 64 kNV + 4], and da, a_cs, exp(a_cs)
// and w [Lp].
__host__ __device__ inline int carry_smem(int n_dim, int chunk) {
  const int lp = padded_chunk(chunk);
  const int ns = 64 * carry_nv(n_dim) + kPad;
  return 4 * (2 * lp * ns + lp * kPTile + kPTile * ns + 4 * lp);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, 16 or 4 bytes; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copy the [rows_pad, cols_pad] corner of a row-major f32 array (rows
// src_step floats apart) into shared memory (rows dst_step apart); what
// lies past rows_valid or cols_valid is zero-filled. vec: 16-byte pieces
// (cols_valid, cols_pad, the steps and src 16-byte multiples), else 4.
__device__ __forceinline__ void stage(float* dst, int dst_step,
                                      const float* src, long long src_step,
                                      int rows_valid, int rows_pad,
                                      int cols_valid, int cols_pad, bool vec,
                                      int tid) {
  if (vec) {
    const int cw = cols_pad / 4;
    for (int k = tid; k < rows_pad * cw; k += kThreads) {
      const int r = k / cw;
      const int c = (k - r * cw) * 4;
      const bool in = r < rows_valid && c < cols_valid;
      cp_async16(smem_addr(dst + r * dst_step + c),
                 src + (in ? r * src_step + c : 0), in);
    }
  } else {
    for (int k = tid; k < rows_pad * cols_pad; k += kThreads) {
      const int r = k / cols_pad;
      const int c = k - r * cols_pad;
      const bool in = r < rows_valid && c < cols_valid;
      cp_async4(smem_addr(dst + r * dst_step + c),
                src + (in ? r * src_step + c : 0), in);
    }
  }
}

// a_cs[l] = da[0] + ... + da[l] for l < lp (rows past the chunk add 0),
// by one warp: a shuffle scan per 32 rows plus the running total; a_cs may
// be da itself. Both kernels form a chunk's a_cs with these same adds.
__device__ __forceinline__ void scan_chunk(const float* da, int chunk, int lp,
                                           float* a_cs, int lane) {
  float v[4];                              // lp <= 128: loads first
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int l = 32 * s + lane;
    v[s] = l < chunk ? da[l] : 0.f;
  }
  float carry = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (32 * s >= lp) break;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v[s], off);
      if (lane >= off) v[s] += u;
    }
    v[s] += carry;
    if (32 * s + lane < lp) a_cs[32 * s + lane] = v[s];
    carry = __shfl_sync(0xffffffffu, v[s], 31);
  }
}

}  // namespace f32

// G = C B^T for a warp's 16 rows (a thread's rows row0 + 2 r) and its
// kNC column blocks of 16 (a thread's columns tx + 16 c): the causal
// triangle's blocks on and below the diagonal, 16-byte loads along N.
template <int kNC>
__device__ __forceinline__ void gram_rows(const float* cs, const float* bs,
                                          float* g, int ns, int gs, int n4,
                                          int row0, int tx) {
  using f32::dot4;
  using f32::ld4;
  float acc[8][kNC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[r][c] = 0.f;
#pragma unroll 1
  for (int n = 0; n < n4; n += 4) {
    float4 cv[8], bv[kNC];
#pragma unroll
    for (int r = 0; r < 8; ++r) cv[r] = ld4(cs + (row0 + 2 * r) * ns + n);
#pragma unroll
    for (int c = 0; c < kNC; ++c) bv[c] = ld4(bs + (tx + 16 * c) * ns + n);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c)
      g[(row0 + 2 * r) * gs + tx + 16 * c] = acc[r][c];
}

// Kernel 1: per (b, chunk, group of `hg` <= kMaxGroup heads), everything
// of a chunk that needs no carried state. G = C B^T once for the group,
// on the causal triangle's column blocks; then per head Gd = G o
// exp(a_cs[i] - a_cs[j]) (exp only where j <= i < L) and y = Gd x, a slab
// of 64 columns of P at a time, written to y. The 16 x 16 thread grid
// gives warp w rows 16 w .. 16 w + 15 (a thread rows 16 w + (ty & 1) +
// 2 r), so a warp's G needs column blocks c <= w and its Gd x keys
// j < 16 w + 16: the triangle's dead half is skipped warp by warp.
// Operands are read as 16-byte vectors along the reduction; the next x
// slab is copied (cp.async) while one is used.
__global__ void __launch_bounds__(f32::kThreads, 1)
    ssd_scan_kernel_f32_diag(const float* __restrict__ x,
                             const float* __restrict__ da,
                             const float* __restrict__ bm,
                             const float* __restrict__ cm, int seqlen,
                             int heads, int p_dim, int n_dim, int chunk,
                             int hg, int vec_x, int vec_bc,
                             float* __restrict__ y) {
  using namespace f32;
  extern __shared__ __align__(16) float smem[];
  const int lp = padded_chunk(chunk);
  const int gs = lp + kPad;
  const int n4 = pad4(n_dim);
  const int ns = n4 + kPad;
  float* g = smem;                         // [lp, gs]
  float* cs = g + lp * gs;                 // [lp, ns]     (phase 1)
  float* bs = cs + lp * ns;                // [lp, ns]     (phase 1)
  float* gd = g + lp * gs;                 // [lp, gs]     (phase 2)
  float* xs = gd + lp * gs;                // [2][lp, kXS] (phase 2)
  float* a_cs = g + lp * gs + max(2 * lp * ns, lp * gs + 2 * lp * kXS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n_chunks = seqlen / chunk;
  const int n_groups = (heads + hg - 1) / hg;
  const int gi = blockIdx.x % n_groups;
  const int ci = (blockIdx.x / n_groups) % n_chunks;
  const int bi = blockIdx.x / n_groups / n_chunks;
  const int h0 = gi * hg;
  const int n_heads = min(hg, heads - h0);
  // first row of this chunk in the flattened [B * S] sequence axis
  const long long t0 = (long long)bi * seqlen + (long long)ci * chunk;
  const long long x_step = (long long)heads * p_dim;
  const bool live = 16 * warp < lp;        // the warp has rows
  const int row0 = 16 * warp + (ty & 1);   // its rows: row0 + 2 r
  const int n_slabs = (p_dim + kXS - 1) / kXS;
  const int n_items = n_heads * n_slabs;   // (head, slab) in order

  auto stage_x = [&](int item) {
    const int p0 = item % n_slabs * kXS;
    stage(xs + (item & 1) * lp * kXS, kXS,
          x + t0 * x_step + (long long)(h0 + item / n_slabs) * p_dim + p0,
          x_step, chunk, lp, min(kXS, p_dim - p0), kXS, vec_x, tid);
  };
  stage(cs, ns, cm + t0 * n_dim, n_dim, chunk, lp, n_dim, n4, vec_bc, tid);
  stage(bs, ns, bm + t0 * n_dim, n_dim, chunk, lp, n_dim, n4, vec_bc, tid);
  for (int k = tid; k < n_heads * lp; k += kThreads) {
    const int hh = k / lp;
    const int l = k - hh * lp;
    cp_async4(smem_addr(a_cs + k),
              da + (l < chunk ? (t0 + l) * heads + h0 + hh : 0), l < chunk);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // da -> a_cs in place, a head per warp
  for (int hh = warp; hh < n_heads; hh += kThreads / 32)
    scan_chunk(a_cs + hh * lp, chunk, lp, a_cs + hh * lp, lane);

  switch (warp) {                          // warp w: column blocks <= w
#define SSD_F32_GRAM(W)                                                      \
  case W:                                                                    \
    if (live) gram_rows<W + 1>(cs, bs, g, ns, gs, n4, row0, tx);              \
    break;
    SSD_F32_GRAM(0)
    SSD_F32_GRAM(1)
    SSD_F32_GRAM(2)
    SSD_F32_GRAM(3)
    SSD_F32_GRAM(4)
    SSD_F32_GRAM(5)
    SSD_F32_GRAM(6)
    SSD_F32_GRAM(7)
#undef SSD_F32_GRAM
  }
  __syncthreads();                         // C and B make way for Gd, x
  stage_x(0);
  cp_async_commit();

  for (int item = 0; item < n_items; ++item) {
    const int hh = item / n_slabs;
    const int p0 = item % n_slabs * kXS;
    const int h = h0 + hh;
    if (item + 1 < n_items) stage_x(item + 1);
    cp_async_commit();
    if (p0 == 0) {                         // this head's Gd
      const float* ac = a_cs + hh * lp;
      for (int i = warp; i < lp; i += kThreads / 32)   // the keys Gd x
        for (int j = lane; j <= (i | 15); j += 32)      // reads for row i
          gd[i * gs + j] = j <= i && i < chunk
                               ? g[i * gs + j] * expf(ac[i] - ac[j])
                               : 0.f;
    }
    cp_async_wait<1>();                    // this item's x slab
    __syncthreads();
    if (live) {
      const float* xt = xs + (item & 1) * lp * kXS;
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
      const int j_end = 16 * warp + 16;    // keys j <= i of the warp's rows
#pragma unroll 1
      for (int j = 0; j < j_end; j += 4) {
        float4 gv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) gv[r] = ld4(gd + (row0 + 2 * r) * gs + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 xv = ld4(xt + (j + jj) * kXS + 4 * tx);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float gj = jj == 0   ? gv[r].x
                             : jj == 1 ? gv[r].y
                             : jj == 2 ? gv[r].z
                                       : gv[r].w;
            acc[r][0] = fmaf(gj, xv.x, acc[r][0]);
            acc[r][1] = fmaf(gj, xv.y, acc[r][1]);
            acc[r][2] = fmaf(gj, xv.z, acc[r][2]);
            acc[r][3] = fmaf(gj, xv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = row0 + 2 * r;
        if (i < chunk) {
          float* yr = y + (t0 + i) * x_step + (long long)h * p_dim + p0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p0 + 4 * tx + e < p_dim) yr[4 * tx + e] = acc[r][e];
        }
      }
    }
    __syncthreads();                       // x slab and Gd free
  }
}

// Kernel 2: per (b, h, tile of 64 columns of P), the chunks in order with
// the state [64, N] carried in registers, after kernel 1 has written each
// chunk's y = Gd x:
//   (a) y += exp(a_cs) o (C state^T), the state as it entered the chunk
//       (read from its shared-memory copy; nothing to add at chunk 0);
//   (b) state = exp(a_last) state + (x o w)^T B, w = exp(a_last - a_cs).
// (a) runs on a 16 x 16 grid of [8 rows, 4 columns] tiles (rows ty + 16 r,
// columns tx + 16 e), (b) on [4 rows of p, 4 kNV columns of n] tiles
// (p = 4 ty + e, n = 64 q + 4 tx + e'), both fed by 16-byte loads. C and
// da for chunk c + 1 are copied (cp.async) while (b) of chunk c runs, x
// and B while (a) of chunk c + 1 runs.
template <int kNV>
__global__ void __launch_bounds__(f32::kThreads, 1)
    ssd_scan_kernel_f32_carry(const float* __restrict__ x,
                              const float* __restrict__ da,
                              const float* __restrict__ bm,
                              const float* __restrict__ cm, int seqlen,
                              int heads, int p_dim, int n_dim, int chunk,
                              int vec_x, int vec_bc, float* __restrict__ y,
                              float* __restrict__ state_out) {
  using namespace f32;
  constexpr int kNP = 64 * kNV;            // N padded
  constexpr int kNS = kNP + kPad;          // row stride of C, B, state
  extern __shared__ __align__(16) float smem[];
  const int lp = padded_chunk(chunk);
  float* cs = smem;                        // [lp, kNS]
  float* bs = cs + lp * kNS;               // [lp, kNS]
  float* xs = bs + lp * kNS;               // [lp, kPTile]
  float* ss = xs + lp * kPTile;            // [kPTile, kNS] the state
  float* da_s = ss + kPTile * kNS;         // [lp]
  float* a_cs = da_s + lp;                 // [lp]
  float* e_cs = a_cs + lp;                 // [lp] exp(a_cs)
  float* w = e_cs + lp;                    // [lp] exp(a_last - a_cs)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n_pt = (p_dim + kPTile - 1) / kPTile;
  const int p0 = (blockIdx.x % n_pt) * kPTile;
  const int bh = blockIdx.x / n_pt;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int p_cols = min(kPTile, p_dim - p0);
  const int n_chunks = seqlen / chunk;
  const long long x_step = (long long)heads * p_dim;

  auto stage_c = [&](int ic) {             // C and da of chunk ic
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;
    stage(cs, kNS, cm + t0 * n_dim, n_dim, chunk, lp, n_dim, kNP, vec_bc,
          tid);
    for (int l = tid; l < lp; l += kThreads)
      cp_async4(smem_addr(da_s + l), da + (l < chunk ? (t0 + l) * heads + h
                                                      : 0),
                l < chunk);
  };
  auto stage_xb = [&](int ic) {            // x's tile and B of chunk ic
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;
    stage(xs, kPTile, x + t0 * x_step + (long long)h * p_dim + p0, x_step,
          chunk, lp, p_cols, kPTile, vec_x, tid);
    stage(bs, kNS, bm + t0 * n_dim, n_dim, chunk, lp, n_dim, kNP, vec_bc,
          tid);
  };
  stage_c(0);
  cp_async_commit();
  stage_xb(0);
  cp_async_commit();

  float st[4][kNV][4];                     // state rows 4 ty + e
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int q = 0; q < kNV; ++q)
#pragma unroll
      for (int f = 0; f < 4; ++f) st[e][q][f] = 0.f;

  for (int ic = 0; ic < n_chunks; ++ic) {
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;
    cp_async_wait<1>();                    // C and da of chunk ic
    __syncthreads();
    if (warp == 0) {
      scan_chunk(da_s, chunk, lp, a_cs, lane);
      __syncwarp();
      const float a_last = a_cs[chunk - 1];
      for (int l = lane; l < lp; l += 32) {
        e_cs[l] = expf(a_cs[l]);
        w[l] = expf(a_last - a_cs[l]);
      }
    }
    __syncthreads();

    if (ic > 0) {                          // (a)
      float yv[8][4], acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ty + 16 * r;
          const int p = tx + 16 * e;
          acc[r][e] = 0.f;
          yv[r][e] = i < chunk && p < p_cols
                         ? y[(t0 + i) * x_step + (long long)h * p_dim + p0 + p]
                         : 0.f;
        }
      for (int n = 0; n < kNP; n += 4) {
        float4 sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = ld4(ss + (tx + 16 * e) * kNS + n);
#pragma unroll
        for (int r = 0; r < 8; ++r) {     // rows past lp: the last, unused
          const float4 cv = ld4(cs + min(ty + 16 * r, lp - 1) * kNS + n);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = dot4(cv, sv[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ty + 16 * r;
          const int p = tx + 16 * e;
          if (i < chunk && p < p_cols)
            y[(t0 + i) * x_step + (long long)h * p_dim + p0 + p] =
                fmaf(e_cs[i], acc[r][e], yv[r][e]);
        }
    }
    __syncthreads();                       // C, da and the state copy read
    if (ic + 1 < n_chunks) stage_c(ic + 1);
    cp_async_commit();
    cp_async_wait<1>();                    // x and B of chunk ic
    __syncthreads();
    for (int k = tid; k < lp * kPTile; k += kThreads)
      xs[k] *= w[k / kPTile];
    __syncthreads();

    // (b)
    const float e_last = e_cs[chunk - 1];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < kNV; ++q)
#pragma unroll
        for (int f = 0; f < 4; ++f) st[e][q][f] *= e_last;
#pragma unroll 4
    for (int l = 0; l < lp; ++l) {
      const float4 xv = ld4(xs + l * kPTile + 4 * ty);
      const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < kNV; ++q) {
        const float4 bv = ld4(bs + l * kNS + 64 * q + 4 * tx);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[e][q][0] = fmaf(xe[e], bv.x, st[e][q][0]);
          st[e][q][1] = fmaf(xe[e], bv.y, st[e][q][1]);
          st[e][q][2] = fmaf(xe[e], bv.z, st[e][q][2]);
          st[e][q][3] = fmaf(xe[e], bv.w, st[e][q][3]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < kNV; ++q)
        *reinterpret_cast<float4*>(ss + (4 * ty + e) * kNS + 64 * q +
                                   4 * tx) =
            make_float4(st[e][q][0], st[e][q][1], st[e][q][2], st[e][q][3]);
    __syncthreads();                       // x and B read, the state copied
    if (ic + 1 < n_chunks) stage_xb(ic + 1);
    cp_async_commit();
  }

  float* out = state_out + ((long long)bh * p_dim + p0) * n_dim;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = 4 * ty + e;
    if (p < p_cols) {
#pragma unroll
      for (int q = 0; q < kNV; ++q)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int n = 64 * q + 4 * tx + f;
          if (n < n_dim) out[(long long)p * n_dim + n] = st[e][q][f];
        }
    }
  }
}

// -- bf16 instance: tensor cores ------------------------------------------

namespace bf16 {

using T = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                // halves of padding per staged row
constexpr int kItemCols = 32;          // state columns per phase-B item
constexpr int kMaxItems = 4;           // phase-B items a warp may own

// Byte offsets of the scan block's shared memory (the wrapper's
// kernel.smem_bytes mirrors `total`). A stage holds one chunk's x [Lp,
// Pt + 8], B and C [Lp, N + 8] in bf16 and da [Lp] in f32; the state's hi
// and lo bf16 parts are [Pt, N + 8] each.
struct Layout {
  int lp, xs, ns;                      // rows; x and B/C row strides (halves)
  int b_off, c_off, da_off, stage;     // within a stage (x at 0)
  int state_off, vec_off, total;
};

__host__ __device__ inline Layout layout(int pt, int n, int chunk) {
  Layout l;
  l.lp = (chunk + 15) / 16 * 16;
  l.xs = pt + kPad;
  l.ns = n + kPad;
  l.b_off = l.lp * l.xs * 2;
  l.c_off = l.b_off + l.lp * l.ns * 2;
  l.da_off = l.c_off + l.lp * l.ns * 2;
  l.stage = l.da_off + l.lp * 4;
  l.state_off = 2 * l.stage;
  l.vec_off = l.state_off + 2 * pt * l.ns * 2;
  l.total = l.vec_off + (4 * l.lp + 8) * 4;   // a_cs, e, w, scan, totals
  return l;
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
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

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (a, b) as a bf16 pair `hi` plus the pair of what it leaves, `lo`
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// c += (a_hi + a_lo) b
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(c, hi, b0, b1);
  mma(c, lo, b0, b1);
}

// Rows [0, Lp) of a [*, row_step] bf16 array, `cols` wide, into a tile
// with row stride `stride` halves; rows >= n_valid are zero-filled.
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src,
                                          long long row_step, int lp,
                                          int cols, int stride, int n_valid,
                                          int tid) {
  const int chunks = cols / 8;                   // 16-byte chunks per row
  for (int c = tid; c < lp * chunks; c += kThreads) {
    const int r = c / chunks;
    const int ch = c - r * chunks;
    const bool in = r < n_valid;
    cp_async16(dst + (r * stride + ch * 8) * 2,
               src + (in ? r * row_step + ch * 8 : 0), in);
  }
}

// The 16 x 16 tile of G = C B^T at rows i0, columns j0 as two n8 C-layout
// fragments, from C and B staged with row stride ns (halves)
__device__ __forceinline__ void gram_tile(float (&gv)[2][4], uint32_t cs,
                                          uint32_t bs, int ns, int n_dim,
                                          int i0, int j0, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) gv[e][q] = 0.f;
  const uint32_t a_off = ((i0 + (lane & 15)) * ns + (lane >> 4) * 8) * 2;
  const uint32_t b_off =
      ((j0 + (lane & 7) + ((lane >> 4) << 3)) * ns + ((lane >> 3) & 1) * 8) *
      2;
  for (int kk = 0; kk < n_dim / 16; ++kk) {
    uint32_t a[4], bk[4];
    ldmatrix_x4(a, cs + a_off + kk * 32);
    ldmatrix_x4(bk, bs + b_off + kk * 32);
    mma(gv[0], a, bk[0], bk[1]);
    mma(gv[1], a, bk[2], bk[3]);
  }
}

}  // namespace bf16

template <int kPt, int kItems>
__global__ void __launch_bounds__(bf16::kThreads, 1)
    ssd_scan_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ da,
                         const __nv_bfloat16* __restrict__ bm,
                         const __nv_bfloat16* __restrict__ cm, int seqlen,
                         int heads, int p_dim, int n_dim, int chunk,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ state_out) {
  using namespace bf16;
  constexpr int kNT = kPt / 8;             // n8 tiles of a y row tile
  constexpr int kPT = kPt / 16;            // 16-row tiles of p
  constexpr int kWP = kWarps / kPT;        // warps sharing a p tile
  constexpr int kIT = kItemCols / 8;       // n8 tiles of a state item
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout ly = layout(kPt, n_dim, chunk);
  const int lp = ly.lp, xs = ly.xs, ns = ly.ns;
  float* a_s = reinterpret_cast<float*>(smem_raw + ly.vec_off);  // a_cs
  float* e_s = a_s + lp;                   // exp(a_cs), 0 past L
  float* w_s = e_s + lp;                   // exp(a_last - a_cs), 0 past L
  float* scan_s = w_s + lp;                // inclusive scan in each warp
  float* tot_s = scan_s + lp;              // each scanning warp's total
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t hi_a = base + ly.state_off;         // state, bf16 hi part
  const uint32_t lo_a = hi_a + kPt * ns * 2;         // and lo part
  uint32_t* hi_s = reinterpret_cast<uint32_t*>(smem_raw + ly.state_off);
  uint32_t* lo_s = hi_s + kPt * ns / 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                 // fragment row group
  const int tig = lane & 3;                // thread in group
  const int n_pt = p_dim / kPt;
  const int bh = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x - bh * n_pt) * kPt;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int mt = lp / 16;
  const int n_chunks = seqlen / chunk;
  // this warp's state items: rows pr..pr+15 of the tile, columns
  // kItemCols * ng(j) on, ng(j) = warp / kPT + kWP j; their f32 values live
  // in these accumulators for the whole sequence
  const int pr = (warp % kPT) * 16;
  float state[kItems][kIT][4];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int t = 0; t < kIT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) state[j][t][q] = 0.f;

  auto load_chunk = [&](int ic, int st) {
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;
    const uint32_t sb = base + st * ly.stage;
    load_rows(sb, x + (t0 * heads + h) * p_dim + p0, (long long)heads * p_dim,
              lp, kPt, xs, chunk, tid);
    load_rows(sb + ly.b_off, bm + t0 * n_dim, n_dim, lp, n_dim, ns, chunk,
              tid);
    load_rows(sb + ly.c_off, cm + t0 * n_dim, n_dim, lp, n_dim, ns, chunk,
              tid);
    for (int l = tid; l < lp; l += kThreads)
      cp_async4(sb + ly.da_off + 4 * l,
                da + (l < chunk ? (t0 + l) * heads + h : 0), l < chunk);
  };
  load_chunk(0, 0);
  cp_async_commit();

  // each lane's ldmatrix row address within a tile (bytes, before the
  // tile's own row and column): A fragments non-transposed (rows 0-15,
  // depth 0/8); B fragments of a [k, n] array by .trans (k 0-7 / 8-15,
  // columns 0/8); A fragments of a [k, m] array by .trans, or B fragments
  // of an [n, k] array non-transposed (rows 0-7 / 8-15 of m or n, depth
  // 0/8)
  const int row_a = lane & 15, col_a = (lane >> 4) * 8;
  const int row_kn = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col_kn = (lane >> 4) * 8;
  const int row_mk = (lane & 7) + ((lane >> 4) << 3);
  const int col_mk = ((lane >> 3) & 1) * 8;

  for (int ic = 0; ic < n_chunks; ++ic) {
    const int st = ic & 1;
    if (ic + 1 < n_chunks) {               // prefetch chunk ic + 1
      load_chunk(ic + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                  // all but chunk ic + 1 arrived
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // chunk ic visible to every warp
    const uint32_t xs_a = base + st * ly.stage;
    const uint32_t bs_a = xs_a + ly.b_off;
    const uint32_t cs_a = xs_a + ly.c_off;
    const float* da_s =
        reinterpret_cast<const float*>(smem_raw + st * ly.stage + ly.da_off);
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;

    // a_cs: a warp scan per 32 rows (warps 0-3, rows past L hold 0) ...
    if (tid < 128) {
      float v = tid < lp ? da_s[tid] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (tid < lp) scan_s[tid] = v;
      if (lane == 31) tot_s[warp] = v;
    }
    __syncthreads();
    // ... plus the totals of the warps before, the same sum in every thread
    auto a_at = [&](int l) {
      float pre = 0.f;
      for (int w = 0; w < (l >> 5); ++w) pre += tot_s[w];
      return pre + scan_s[l];
    };
    const float a_last = a_at(chunk - 1);
    if (tid < lp) {
      const bool in = tid < chunk;
      const float a = a_at(tid);
      a_s[tid] = a;
      e_s[tid] = in ? __expf(a) : 0.f;
      w_s[tid] = in ? __expf(a_last - a) : 0.f;
    }
    __syncthreads();
    const float e_last = __expf(a_last);

    // phase A: y for row tiles warp, warp + 8, ...
    for (int rt = warp; rt < mt; rt += kWarps) {
      const int i0 = rt * 16;
      const int r0 = i0 + g, r1 = r0 + 8;  // this thread's rows
      float acc[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;

      if (ic > 0) {                        // exp(a_cs) o (C state^T)
        for (int kk = 0; kk < n_dim / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, cs_a + ((i0 + row_a) * ns + kk * 16 + col_a) * 2);
#pragma unroll
          for (int dp = 0; dp < kPt / 16; ++dp) {
            // B [k = n][col = p] = state[p][n], from the [p, n] hi and lo
            const uint32_t off =
                ((dp * 16 + row_mk) * ns + kk * 16 + col_mk) * 2;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, hi_a + off);
            ldmatrix_x4(bl, lo_a + off);
            mma(acc[2 * dp], a, bh[0], bh[1]);
            mma(acc[2 * dp + 1], a, bh[2], bh[3]);
            mma(acc[2 * dp], a, bl[0], bl[1]);
            mma(acc[2 * dp + 1], a, bl[2], bl[3]);
          }
        }
        const float e0 = e_s[r0], e1 = e_s[r1];
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          acc[t][0] *= e0;
          acc[t][1] *= e0;
          acc[t][2] *= e1;
          acc[t][3] *= e1;
        }
      }

      // (G o decay) x on the causal tiles kt <= rt
      const float ai0 = a_s[r0], ai1 = a_s[r1];
      for (int kt = 0; kt <= rt; ++kt) {
        const int j0 = kt * 16;
        float gv[2][4];                    // C layout: cols j0 + 8e + 2tig
        gram_tile(gv, cs_a, bs_a, ns, n_dim, i0, j0, lane);
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? r1 : r0;
            const float ai = half ? ai1 : ai0;
            float d[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = j0 + 8 * e + 2 * tig + c;
              d[c] = (j <= i && i < chunk)
                         ? gv[e][2 * half + c] * __expf(ai - a_s[j])
                         : 0.f;
            }
            // A fragment: a0 (r0, cols 0-7), a1 (r1, 0-7), a2 (r0, 8-15),
            // a3 (r1, 8-15)
            split(d[0], d[1], ahi[2 * e + half], alo[2 * e + half]);
          }
#pragma unroll
        for (int dp = 0; dp < kPt / 16; ++dp) {
          uint32_t bv[4];                  // x [j, p]: k = j, col = p
          ldmatrix_x4_trans(
              bv, xs_a + ((j0 + row_kn) * xs + dp * 16 + col_kn) * 2);
          mma2(acc[2 * dp], ahi, alo, bv[0], bv[1]);
          mma2(acc[2 * dp + 1], ahi, alo, bv[2], bv[3]);
        }
      }

#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int col = p0 + t * 8 + 2 * tig;
        if (r0 < chunk)
          *reinterpret_cast<uint32_t*>(
              y + ((t0 + r0) * heads + h) * p_dim + col) =
              pack_bf16(acc[t][0], acc[t][1]);
        if (r1 < chunk)
          *reinterpret_cast<uint32_t*>(
              y + ((t0 + r1) * heads + h) * p_dim + col) =
              pack_bf16(acc[t][2], acc[t][3]);
      }
    }
    __syncthreads();                       // phase A's state reads are done

    // phase B: state = exp(a_last) state + (x o w)^T B on this warp's
    // items, accumulated into the state's registers; x o w is formed once
    // per k step for all of them (they share rows pr..pr+15)
#pragma unroll
    for (int j = 0; j < kItems; ++j)
#pragma unroll
      for (int t = 0; t < kIT; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) state[j][t][q] *= e_last;
    for (int kt = 0; kt < mt; ++kt) {
      const int l0 = kt * 16;
      uint32_t xa[4];                      // A = x^T [p, l] from x [l, p]
      ldmatrix_x4_trans(xa, xs_a + ((l0 + row_mk) * xs + pr + col_mk) * 2);
      const float2 w0 = *reinterpret_cast<const float2*>(w_s + l0 + 2 * tig);
      const float2 w1 =
          *reinterpret_cast<const float2*>(w_s + l0 + 8 + 2 * tig);
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {        // a0, a1: l 2tig..; a2, a3: +8
        const float2 v = unpack_bf16(xa[q]);
        const float2 w = q < 2 ? w0 : w1;
        split(v.x * w.x, v.y * w.y, ahi[q], alo[q]);
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int n0 = (warp / kPT + kWP * j) * kItemCols;
#pragma unroll
        for (int np = 0; np < kIT / 2; ++np) {
          if (n0 + np * 16 < n_dim) {
            uint32_t bv[4];                // B [l, n]: k = l, col = n
            ldmatrix_x4_trans(
                bv, bs_a + ((l0 + row_kn) * ns + n0 + np * 16 + col_kn) * 2);
            mma2(state[j][2 * np], ahi, alo, bv[0], bv[1]);
            mma2(state[j][2 * np + 1], ahi, alo, bv[2], bv[3]);
          }
        }
      }
    }
    // the new state's hi and lo parts, the B operand of the next chunk's
    // C state^T
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int n0 = (warp / kPT + kWP * j) * kItemCols;
#pragma unroll
      for (int t = 0; t < kIT; ++t) {
        const int col = n0 + t * 8 + 2 * tig;
        if (col < n_dim) {
          const int k0 = ((pr + g) * ns + col) / 2, k1 = k0 + 4 * ns;
          split(state[j][t][0], state[j][t][1], hi_s[k0], lo_s[k0]);
          split(state[j][t][2], state[j][t][3], hi_s[k1], lo_s[k1]);
        }
      }
    }
    __syncthreads();  // the state, this stage and the vectors are reused
  }

  float* out = state_out + ((long long)bh * p_dim + p0 + pr) * n_dim;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int n0 = (warp / kPT + kWP * j) * kItemCols;
#pragma unroll
    for (int t = 0; t < kIT; ++t) {
      const int col = n0 + t * 8 + 2 * tig;
      if (col < n_dim) {
        *reinterpret_cast<float2*>(out + g * n_dim + col) =
            make_float2(state[j][t][0], state[j][t][1]);
        *reinterpret_cast<float2*>(out + (g + 8) * n_dim + col) =
            make_float2(state[j][t][2], state[j][t][3]);
      }
    }
  }
}

// -- launch ---------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Kernel 1 (the chunks' diagonal blocks into y), then kernel 2 (the
// carried state: y's off-diagonal part and the final state), on one
// stream. hg is the heads a kernel-1 block takes (the wrapper plans it).
int launch_f32(const float* x, const float* da, const float* bm,
               const float* cm, int batch, int seqlen, int heads, int p_dim,
               int n_dim, int chunk, int hg, float* y, float* state_out,
               cudaStream_t stream) {
  using namespace f32;
  const int nv = carry_nv(n_dim);
  if (chunk < 1 || chunk > 128 || seqlen % chunk || hg < 1 ||
      hg > kMaxGroup || nv == 0)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = p_dim % 4 == 0 && aligned(x);
  const int vec_bc = n_dim % 4 == 0 && aligned(bm) && aligned(cm);
  const int n_chunks = seqlen / chunk;

  auto diag = ssd_scan_kernel_f32_diag;
  const int diag_bytes = diag_smem(n_dim, chunk);
  if (int err = set_smem(diag, diag_bytes)) return err;
  diag<<<batch * n_chunks * ((heads + hg - 1) / hg), kThreads, diag_bytes,
         stream>>>(x, da, bm, cm, seqlen, heads, p_dim, n_dim, chunk, hg,
                   vec_x, vec_bc, y);
  if (int err = (int)cudaGetLastError()) return err;

  auto carry = nv == 1   ? ssd_scan_kernel_f32_carry<1>
               : nv == 2 ? ssd_scan_kernel_f32_carry<2>
                         : ssd_scan_kernel_f32_carry<4>;
  const int carry_bytes = carry_smem(n_dim, chunk);
  if (int err = set_smem(carry, carry_bytes)) return err;
  carry<<<batch * heads * ((p_dim + kPTile - 1) / kPTile), kThreads,
          carry_bytes, stream>>>(x, da, bm, cm, seqlen, heads, p_dim, n_dim,
                                 chunk, vec_x, vec_bc, y, state_out);
  return (int)cudaGetLastError();
}

template <int kPt, int kItems>
int launch_scan_bf16(const __nv_bfloat16* x, const float* da,
                     const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                     int batch, int seqlen, int heads,
                     int p_dim, int n_dim, int chunk, __nv_bfloat16* y,
                     float* state_out, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel_bf16<kPt, kItems>;
  const int smem = bf16::layout(kPt, n_dim, chunk).total;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<batch * heads * (p_dim / kPt), bf16::kThreads, smem, stream>>>(
      x, da, bm, cm, seqlen, heads, p_dim, n_dim, chunk, y, state_out);
  return (int)cudaGetLastError();
}

// the instance with the fewest state registers that holds `items`, the
// phase-B items (16 rows of p, kItemCols columns of n) each warp owns; the
// wrapper plans that count (kernel.state_items), this only dispatches
template <int kPt>
int launch_tile_bf16(const __nv_bfloat16* x, const float* da,
                     const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                     int batch, int seqlen, int heads,
                     int p_dim, int n_dim, int chunk, int items,
                     __nv_bfloat16* y, float* state_out,
                     cudaStream_t stream) {
  if (items < 1) return (int)cudaErrorInvalidValue;
  if (items <= 1)
    return launch_scan_bf16<kPt, 1>(x, da, bm, cm, batch, seqlen,
                                    heads, p_dim, n_dim, chunk, y, state_out,
                                    stream);
  if (items <= 2)
    return launch_scan_bf16<kPt, 2>(x, da, bm, cm, batch, seqlen,
                                    heads, p_dim, n_dim, chunk, y, state_out,
                                    stream);
  if (items <= bf16::kMaxItems)
    return launch_scan_bf16<kPt, bf16::kMaxItems>(
        x, da, bm, cm, batch, seqlen, heads, p_dim, n_dim, chunk, y,
        state_out, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const __nv_bfloat16* x, const float* da,
                const __nv_bfloat16* bm, const __nv_bfloat16* cm, int batch,
                int seqlen, int heads, int p_dim, int n_dim, int chunk,
                int p_tile, int items, __nv_bfloat16* y, float* state_out,
                cudaStream_t stream) {
  if (p_dim % 16 || n_dim % 16 || p_tile <= 0 || p_dim % p_tile)
    return (int)cudaErrorInvalidValue;
  switch (p_tile) {
#define SSD_SCAN_TILE(PT)                                                    \
  case PT:                                                                   \
    return launch_tile_bf16<PT>(x, da, bm, cm, batch, seqlen, heads,         \
                                p_dim, n_dim, chunk, items, y, state_out,    \
                                stream);
    SSD_SCAN_TILE(16)
    SSD_SCAN_TILE(32)
    SSD_SCAN_TILE(64)
    SSD_SCAN_TILE(128)
#undef SSD_SCAN_TILE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); x, Bm, Cm
// and y share it, da and the state are f32. All tensors contiguous;
// seqlen % chunk == 0, chunk <= 128. bf16 only: p_tile (16, 32, 64 or 128,
// dividing P) is the P columns a scan block owns, and items (1 to
// kMaxItems) the state items each of its warps holds, both as the wrapper
// planned them; P and N must be multiples of 16. f32 ignores p_tile and
// takes items as the heads one block of its diagonal kernel forms (the
// wrapper plans it); N <= 256. Returns the cudaError_t of the launch
// (0 = ok).
int ssd_scan_launch(const void* x, const void* da, const void* bm,
                    const void* cm, int batch, int seqlen, int heads,
                    int p_dim, int n_dim, int chunk, int dtype, int p_tile,
                    int items, void* y, void* state_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* da_f = static_cast<const float*>(da);
  float* st = static_cast<float*>(state_out);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), da_f,
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm), batch, seqlen, heads,
                      p_dim, n_dim, chunk, items, static_cast<float*>(y), st,
                      s);
  if (dtype == 1)
    return launch_bf16(static_cast<const __nv_bfloat16*>(x), da_f,
                       static_cast<const __nv_bfloat16*>(bm),
                       static_cast<const __nv_bfloat16*>(cm), batch, seqlen,
                       heads, p_dim, n_dim, chunk, p_tile, items,
                       static_cast<__nv_bfloat16*>(y), st, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 scan block's dynamic shared memory at (p_tile, N, chunk), as
// the kernel lays it out (the wrapper's smem_bytes must agree).
int ssd_scan_bf16_smem(int p_tile, int n_dim, int chunk) {
  return bf16::layout(p_tile, n_dim, chunk).total;
}

// The f32 kernels' dynamic shared memory at (N, chunk): which = 0 the
// diagonal block, 1 the carry block (the wrapper's f32 plan must agree).
int ssd_scan_f32_smem(int n_dim, int chunk, int which) {
  return which == 0 ? f32::diag_smem(n_dim, chunk)
                    : f32::carry_smem(n_dim, chunk);
}

// Largest dynamic shared memory one block may opt into on `device`.
int ssd_scan_max_smem(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
