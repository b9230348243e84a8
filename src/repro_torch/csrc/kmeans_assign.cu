// K-means E-step (assignment) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign/kernel.py
// (_assign_kernel, launched by assign_fwd through pl.pallas_call). For each
// point x of X [N, D] against centroids C [K, D] it computes, in f32,
//
//     d2[k] = ||x||^2 - 2 x.c_k + ||c_k||^2
//     assign = argmin_k d2[k]   (int32, ties to the LOWEST k, as jnp.argmin)
//     min_d2 = min_k d2[k]      (f32)
//
// The expansion is kept on purpose (not ||x - c||^2): the reference's min_d2
// is defined by it and may dip below 0 by rounding. Inputs are f32 or bf16,
// upcast to f32 on load; every sum is an f32 accumulation.
//
// What bounds it on an H100: at the main path's shapes (N=128 local-step
// minibatch, D=64, K=3) one call reads ~33 KB and does ~49 kFLOP, i.e.
// ~10 ns at 3.35 TB/s and under 1 ns of f32 math, far below the few
// microseconds a launch costs. Fixed latencies bound it, not bytes or
// FLOPs: the launch, and each thread's serial walk over D (staging loads,
// then K*D dependent FMAs); at the evaluation shape (N=4000, ~1 MB) the
// byte bound is still ~0.3 us.
// The design is therefore the simplest one that moves each byte once:
//   * one block of `rows` threads per tile of `rows` points, one point per
//     thread; any N is handled by masking the last tile (no padding);
//   * the [K, D] centroids and their ||c||^2 live in shared memory for the
//     block's lifetime (the TPU kernel's "centroids resident in VMEM");
//   * the [rows, D] point tile is staged into shared memory with coalesced
//     loads (consecutive threads read consecutive elements), stored with an
//     odd row stride so the per-thread row reads are bank-conflict free;
//   * centroid reads are warp-wide broadcasts.
// wgmma/TMA pipelines are left for when a caller's shape makes this
// bandwidth- or compute-bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void kmeans_assign_kernel(const T* __restrict__ x,
                                     const T* __restrict__ centers, int n,
                                     int d, int k, int x_stride,
                                     int32_t* __restrict__ out_assign,
                                     float* __restrict__ out_d2) {
  extern __shared__ float smem[];
  float* c_s = smem;            // [k, d]
  float* c2_s = c_s + k * d;    // [k]
  float* x_s = c2_s + k;        // [rows, x_stride]

  const int rows = blockDim.x;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, (long long)n - row0);

  for (int i = tid; i < k * d; i += rows) c_s[i] = to_f32(centers[i]);
  const T* xb = x + row0 * d;
  for (int i = tid; i < valid * d; i += rows) {
    const int r = i / d;
    x_s[r * x_stride + (i - r * d)] = to_f32(xb[i]);
  }
  __syncthreads();
  for (int c = tid; c < k; c += rows) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_s[c * d + j], c_s[c * d + j], s);
    c2_s[c] = s;
  }
  __syncthreads();
  if (tid >= valid) return;

  const float* xr = x_s + tid * x_stride;
  float x2 = 0.f;
  for (int j = 0; j < d; ++j) x2 = fmaf(xr[j], xr[j], x2);
  float best = 0.f;
  int best_k = 0;
  for (int c = 0; c < k; ++c) {
    const float* cr = c_s + c * d;
    float dot = 0.f;
    for (int j = 0; j < d; ++j) dot = fmaf(xr[j], cr[j], dot);
    // 2*dot is exact, so a contracted fma(-2, dot, x2) rounds identically
    const float d2 = (x2 - 2.f * dot) + c2_s[c];
    if (c == 0 || d2 < best) {  // strict <: ties keep the lowest index
      best = d2;
      best_k = c;
    }
  }
  out_assign[row0 + tid] = best_k;
  out_d2[row0 + tid] = best;
}

template <typename T>
int launch(const void* x, const void* centers, int n, int d, int k, int rows,
           int x_stride, int32_t* out_assign, float* out_d2,
           cudaStream_t stream) {
  const size_t smem =
      (size_t(k) * d + k + size_t(rows) * x_stride) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kmeans_assign_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + rows - 1) / rows;
  kmeans_assign_kernel<T><<<blocks, rows, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(centers), n, d, k,
      x_stride, out_assign, out_d2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and centers share it). rows is the
// tile height (threads per block); x_stride the odd shared-memory row
// stride (>= d). Returns the cudaError_t of the launch (0 = success).
int kmeans_assign_launch(const void* x, const void* centers, int n, int d,
                         int k, int dtype, int rows, int x_stride,
                         int32_t* out_assign, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, centers, n, d, k, rows, x_stride, out_assign,
                         out_d2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, centers, n, d, k, rows, x_stride,
                                 out_assign, out_d2, s);
  return (int)cudaErrorInvalidValue;
}

// Largest dynamic shared memory one block may opt into on `device`.
int kmeans_assign_max_smem(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* kmeans_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
