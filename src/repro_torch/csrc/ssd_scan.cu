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
// Design. One block of 256 threads per (b, h): the TPU grid's sequential
// chunk axis becomes the loop inside the block, and the state stays in
// shared memory for the whole sequence. Per chunk the block stages x [L, P]
// and B [L, N] in f32, then walks the chunk's rows in blocks of 32: stage
// those rows of C, form their rows of Gd (exp only on the causal
// triangle), and write their y rows; last it updates the state in place.
// Computing Gd a row block at a time keeps the [L, L] tile out of shared
// memory: at L = 128, P = 64, N = 128 the block uses 166 KB (state 33 KB,
// x 32 KB, B 66 KB, C and Gd rows 32 KB), and at P = N = 128 227 KB, all
// the card allows. The wrapper checks the budget per shape and raises
// where it does not fit. Rows of the state and of B are padded to N + 1
// floats so that the threads of a warp, which run along n (B, the state
// update) or along p (the state read for y), hit 32 distinct banks; C and
// Gd are read as warp-wide broadcasts.
//
// What bounds it on an H100: at the main path's prefill shape (B = 4,
// S = 512, H = 32, P = 64, N = 128, L = 128) one call moves ~22 MB (3.35
// TB/s: 6.6 us) and does, per (b, h, chunk), 2L^2 N + 2L^2 P + 4LPN
// = 10.5 MFLOP, 5.4 GFLOP in all (67 TFLOP/s of f32 on the CUDA cores:
// 80 us). It is operation-bound. Its inner loops are f32 FMAs on shared-
// memory operands, about one conflict-free shared load per FMA, so shared-
// memory bandwidth rather than the FMA units bounds this simple design;
// and B * H = 128 blocks leave 4 of 132 SMs idle. Known redundancies, for
// the PRs that make it fast: G = C B^T is the same for every head and is
// recomputed by each of the H blocks of a batch row, and the products run
// on CUDA cores, not on tensor cores (no wgmma, no TMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // chunk rows per block of Gd (the wrapper's ROWS)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ da,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    int seqlen, int heads, int p_dim, int n_dim, int chunk,
                    T* __restrict__ y, float* __restrict__ state_out) {
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
      xs[k] = to_f32(x[((t0 + l) * heads + h) * p_dim + (k - l * p_dim)]);
    }
    for (int k = tid; k < chunk * n_dim; k += kThreads) {
      const int l = k / n_dim;
      const int n = k - l * n_dim;
      bs[l * ns + n] = to_f32(bm[(t0 + l) * n_dim + n]);
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
        cs[k] = to_f32(cm[(t0 + r0 + r) * n_dim + (k - r * n_dim)]);
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
        store(y + ((t0 + i) * heads + h) * p_dim + p, fmaf(e_cs[i], off, acc));
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

template <typename T>
int launch(const void* x, const float* da, const void* bm, const void* cm,
           int batch, int seqlen, int heads, int p_dim, int n_dim, int chunk,
           void* y, float* state_out, cudaStream_t stream) {
  const size_t smem =
      (size_t(p_dim) * (n_dim + 1) + size_t(chunk) * p_dim +
       size_t(chunk) * (n_dim + 1) + size_t(kRows) * n_dim +
       size_t(kRows) * chunk + 3 * size_t(chunk)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_scan_kernel<T><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), da, static_cast<const T*>(bm),
      static_cast<const T*>(cm), seqlen, heads, p_dim, n_dim, chunk,
      static_cast<T*>(y), state_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it; da and the
// state are f32). All tensors contiguous; seqlen % chunk == 0, chunk <= 128.
// Returns the cudaError_t of the launch (0 = success).
int ssd_scan_launch(const void* x, const void* da, const void* bm,
                    const void* cm, int batch, int seqlen, int heads,
                    int p_dim, int n_dim, int chunk, int dtype, void* y,
                    void* state_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* da_f = static_cast<const float*>(da);
  float* st = static_cast<float*>(state_out);
  if (dtype == 0)
    return launch<float>(x, da_f, bm, cm, batch, seqlen, heads, p_dim, n_dim,
                         chunk, y, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, da_f, bm, cm, batch, seqlen, heads,
                                 p_dim, n_dim, chunk, y, st, s);
  return (int)cudaErrorInvalidValue;
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
