// Causal GQA flash-attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel, launched by flash_attention_fwd through pl.pallas_call).
// Inputs, one dtype (f32 or bf16), contiguous:
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
// every product accumulates in f32 with plain FMAs (no TF32, no fast-math
// exp). Masked keys get p = 0 and the -1e30 sentinel in the max.
//
// Design. One block of 256 threads per (b, h, tile of 64 query rows): the
// TPU grid's sequential KV axis becomes the loop inside the block. The
// block stages its query tile once, then per tile of 32 keys stages K and
// V (all in f32, converted on load) and computes its [64, 32] logits as a
// 16 x 16 grid of threads, each owning 4 rows x 2 columns in registers;
// the 16 threads of a row group are one half-warp, so row max and row sum
// are shuffles. The probabilities go through shared memory to the PV
// product, where each thread owns the same 4 rows x D/16 columns of the
// output accumulator in registers. Only live tiles are visited: keys up to
// the tile's last row (causal) and from its first row's window start. The
// TPU grid walks every S/128 block; skipping dead ones changes nothing,
// because every row keeps its diagonal. Ragged S is masked (rows past S
// are computed on zero queries and never stored, keys past S get p = 0),
// so any S works. Blocks are numbered heaviest query tile first, so the
// long causal rows start early and the short ones fill in at the end.
// Rows of the query and key tiles are padded to D + 1 floats and those of
// the probabilities to 33, so a warp's reads hit distinct banks or
// broadcast. Shared memory is 4 (64 (D+1) + 32 (D+1) + 32 D + 64 * 33)
// bytes: 41,600 at D = 64, 74,368 at D = 128 (three blocks per SM),
// 139,904 at D = 256; the wrapper checks the budget and raises beyond it.
// Instances exist for D = 64, 128 and 256.
//
// What bounds it on an H100: at the training shape (B = 8, S = 512,
// H = 16, KV = 8, D = 128, bf16) one call must move q, k, v and o once,
// 50.3 MB (3.35 TB/s: 15.0 us), and do 4 B H D S (S + 1) / 2 = 8.6 GFLOP
// on the causal triangle (989 TFLOP/s of bf16 on the tensor cores: 8.7
// us). So the card's bound is bytes. This simple design runs every product
// on the CUDA cores in f32 (67 TFLOP/s) with about one shared-memory load
// per two FMAs, so shared-memory bandwidth and the FMA pipes bound it, far
// above that: tensor cores (wgmma on bf16 tiles), TMA loads and a
// producer warp are the later work that closes the gap.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;            // query rows per block (BLOCK_Q)
constexpr int kBlockK = 32;            // keys per tile (BLOCK_K)
constexpr int kRows = kBlockQ / 16;    // query rows per thread
constexpr int kCols = kBlockK / 16;    // key columns per thread
constexpr int kP1 = kBlockK + 1;       // padded row stride of the p tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// p rounded to the dtype of v, as the TPU kernel casts it before PV
__device__ __forceinline__ float round_like(float v, float) { return v; }
__device__ __forceinline__ float round_like(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int batch, int seqlen, int heads, int kv_heads,
                           int causal, int window, float scale) {
  constexpr int kD1 = D + 1;           // padded row stride: q, k tiles
  constexpr int kDCols = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockQ, D + 1]
  float* ks = qs + kBlockQ * kD1;      // [kBlockK, D + 1]
  float* vs = ks + kBlockK * kD1;      // [kBlockK, D]
  float* ps = vs + kBlockK * D;        // [kBlockQ, kBlockK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;             // key column / output column group
  const int ty = tid >> 4;             // query row group
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

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    qs[r * kD1 + c] = r < q_rows ? to_f32(qb[r * q_step + c]) : 0.f;
  }

  // live keys: [kv_begin, kv_end)
  const int kv_end = causal ? q0 + q_rows : seqlen;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBlockK;
  const int t_end = (kv_end + kBlockK - 1) / kBlockK;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    const int k_rows = min(kBlockK, seqlen - k0);
    __syncthreads();  // the last tile's ks, vs and ps are consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const bool in = r < k_rows;
      ks[r * kD1 + c] = in ? to_f32(kb[(k0 + r) * kv_step + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[(k0 + r) * kv_step + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * kD1 + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * kD1 + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[kCols];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < seqlen && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads of this row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        ps[(ty + 16 * i) * kP1 + tx + 16 * j] = round_like(p, T());
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kP1 + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kDCols; ++c)
        store(ob + r * q_step + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seqlen, int heads, int kv_heads, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(kBlockQ) * (D + 1) +
                                       size_t(kBlockK) * (D + 1) +
                                       size_t(kBlockK) * D +
                                       size_t(kBlockQ) * kP1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_q = (seqlen + kBlockQ - 1) / kBlockQ;
  flash_attention_kernel<T, D><<<batch * heads * n_q, kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), batch, seqlen, heads,
      kv_heads, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 int batch, int seqlen, int heads, int kv_heads,
                 int head_dim, int causal, int window, float scale,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seqlen, heads, kv_heads,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seqlen, heads, kv_heads,
                            causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, seqlen, heads, kv_heads,
                            causal, window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). All tensors
// contiguous; heads % kv_heads == 0; head_dim 64, 128 or 256; causal 0/1;
// window <= 0 for none. Returns the cudaError_t of the launch (0 = ok).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int seqlen, int heads,
                           int kv_heads, int head_dim, int causal, int window,
                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, o, batch, seqlen, heads, kv_heads,
                               head_dim, causal, window, scale, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, batch, seqlen, heads,
                                       kv_heads, head_dim, causal, window,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}

// Largest dynamic shared memory one block may opt into on `device`.
int flash_attention_max_smem(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
