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
// f32 instance: CUDA cores (ssd_scan_kernel_f32)
// ----------------------------------------------
// One block of 256 threads per (b, h): the TPU grid's sequential chunk axis
// becomes the loop inside the block, and the state stays in shared memory
// for the whole sequence. Per chunk the block stages x [L, P] and B [L, N],
// then walks the chunk's rows in blocks of 32: stage those rows of C, form
// their rows of Gd (exp only on the causal triangle), and write their y
// rows; last it updates the state in place. Computing Gd a row block at a
// time keeps the [L, L] tile out of shared memory: at L = 128, P = 64,
// N = 128 the block uses 166 KB, and at P = N = 128 227 KB, all the card
// allows. Rows of the state and of B are padded to N + 1 floats so that the
// threads of a warp hit 32 distinct banks; C and Gd are read as warp-wide
// broadcasts. At the serving shape its 5.4 GFLOP of f32 FMAs (67 TFLOP/s:
// 80 us of operations; 2.72 GFLOP needed with G shared, 41 us) are bound
// by shared-memory bandwidth (one load per FMA), and G is formed by each
// of the H blocks of a batch row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// -- f32 instance: CUDA cores ---------------------------------------------

namespace f32 {
constexpr int kThreads = 256;
constexpr int kRows = 32;  // chunk rows per block of Gd (the wrapper's ROWS)
}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads)
    ssd_scan_kernel_f32(const float* __restrict__ x,
                        const float* __restrict__ da,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm, int seqlen, int heads,
                        int p_dim, int n_dim, int chunk,
                        float* __restrict__ y, float* __restrict__ state_out) {
  using namespace f32;
  extern __shared__ float smem[];
  const int ns = n_dim + 1;              // padded row stride: state, B
  float* state = smem;                   // [P, ns]
  float* xs = state + p_dim * ns;        // [L, P]
  float* bs = xs + chunk * p_dim;        // [L, ns]
  float* cs = bs + chunk * ns;           // [kRows, N]
  float* gd = cs + kRows * n_dim;        // [kRows, L]
  float* a_cs = gd + kRows * chunk;      // [L] cumulative sum of da
  float* e_cs = a_cs + chunk;            // [L] exp(a_cs)
  float* w = e_cs + chunk;               // [L] exp(a_cs[L-1] - a_cs)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int pn = p_dim * n_dim;

  for (int k = tid; k < pn; k += kThreads) {
    const int p = k / n_dim;
    state[p * ns + (k - p * n_dim)] = 0.f;
  }

  const int n_chunks = seqlen / chunk;
  for (int ic = 0; ic < n_chunks; ++ic) {
    // first row of this chunk in the flattened [B * S] sequence axis
    const long long t0 = (long long)b * seqlen + (long long)ic * chunk;

    for (int k = tid; k < chunk * p_dim; k += kThreads) {
      const int l = k / p_dim;
      xs[k] = x[((t0 + l) * heads + h) * p_dim + (k - l * p_dim)];
    }
    for (int k = tid; k < chunk * n_dim; k += kThreads) {
      const int l = k / n_dim;
      const int n = k - l * n_dim;
      bs[l * ns + n] = bm[(t0 + l) * n_dim + n];
    }
    for (int l = tid; l < chunk; l += kThreads)
      a_cs[l] = da[(t0 + l) * heads + h];
    __syncthreads();
    if (tid == 0) {  // L <= 128 serial adds, in the reference's order
      float s = 0.f;
      for (int l = 0; l < chunk; ++l) {
        s += a_cs[l];
        a_cs[l] = s;
      }
    }
    __syncthreads();
    const float a_last = a_cs[chunk - 1];
    for (int l = tid; l < chunk; l += kThreads) {
      e_cs[l] = expf(a_cs[l]);
      w[l] = expf(a_last - a_cs[l]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < chunk; r0 += kRows) {
      const int rows = min(kRows, chunk - r0);
      for (int k = tid; k < rows * n_dim; k += kThreads) {
        const int r = k / n_dim;
        cs[k] = cm[(t0 + r0 + r) * n_dim + (k - r * n_dim)];
      }
      __syncthreads();
      // rows r0 .. r0+rows of Gd; the causal triangle only
      for (int k = tid; k < rows * chunk; k += kThreads) {
        const int r = k / chunk;
        const int j = k - r * chunk;
        const int i = r0 + r;
        float g = 0.f;
        if (j <= i) {
          const float* cr = cs + r * n_dim;
          const float* br = bs + j * ns;
          float acc = 0.f;
          for (int n = 0; n < n_dim; ++n) acc = fmaf(cr[n], br[n], acc);
          g = acc * expf(a_cs[i] - a_cs[j]);
        }
        gd[k] = g;
      }
      __syncthreads();
      // their rows of y: diagonal block plus the carried state's share
      for (int k = tid; k < rows * p_dim; k += kThreads) {
        const int r = k / p_dim;
        const int p = k - r * p_dim;
        const int i = r0 + r;
        const float* gr = gd + r * chunk;
        float acc = 0.f;
        for (int j = 0; j <= i; ++j) acc = fmaf(gr[j], xs[j * p_dim + p], acc);
        const float* cr = cs + r * n_dim;
        const float* sr = state + p * ns;
        float off = 0.f;
        for (int n = 0; n < n_dim; ++n) off = fmaf(cr[n], sr[n], off);
        y[((t0 + i) * heads + h) * p_dim + p] = fmaf(e_cs[i], off, acc);
      }
      __syncthreads();  // cs and gd are refilled by the next row block
    }

    // state update, in place: each thread owns its (p, n) entries
    const float e_last = e_cs[chunk - 1];
    for (int k = tid; k < pn; k += kThreads) {
      const int p = k / n_dim;
      const int n = k - p * n_dim;
      float acc = 0.f;
      for (int l = 0; l < chunk; ++l)
        acc = fmaf(xs[l * p_dim + p] * w[l], bs[l * ns + n], acc);
      float* s = state + p * ns + n;
      *s = fmaf(e_last, *s, acc);
    }
    __syncthreads();  // xs, bs and the state are read by the next chunk
  }

  float* out = state_out + (long long)blockIdx.x * pn;
  for (int k = tid; k < pn; k += kThreads) {
    const int p = k / n_dim;
    out[k] = state[p * ns + (k - p * n_dim)];
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

int launch_f32(const float* x, const float* da, const float* bm,
               const float* cm, int batch, int seqlen, int heads, int p_dim,
               int n_dim, int chunk, float* y, float* state_out,
               cudaStream_t stream) {
  using namespace f32;
  const size_t smem =
      (size_t(p_dim) * (n_dim + 1) + size_t(chunk) * p_dim +
       size_t(chunk) * (n_dim + 1) + size_t(kRows) * n_dim +
       size_t(kRows) * chunk + 3 * size_t(chunk)) *
      sizeof(float);
  if (int err = set_smem(ssd_scan_kernel_f32, (int)smem)) return err;
  ssd_scan_kernel_f32<<<batch * heads, kThreads, smem, stream>>>(
      x, da, bm, cm, seqlen, heads, p_dim, n_dim, chunk, y, state_out);
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
// planned them; P and N must be multiples of 16. f32 ignores both.
// Returns the cudaError_t of the launch (0 = ok).
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
                      p_dim, n_dim, chunk, static_cast<float*>(y), st, s);
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

// Largest dynamic shared memory one block may opt into on `device`.
int ssd_scan_max_smem(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
