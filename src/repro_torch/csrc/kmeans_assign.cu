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
// microseconds a launch costs. Latencies bound it, not bytes or FLOPs: the
// launch, the global loads, and the longest chain of dependent FMAs. The
// first design gave each point one thread, which walked all of D serially
// (D FMAs for ||x||^2, then K*D for the dots: ~250 in a chain at D = 64).
//
// Design: a group of G lanes shares one point, G a power of two <= 32
// chosen by the wrapper from D (8 at D = 64: at most 8 elements a lane).
//   * Lane r of a group holds vectors r, r + G, r + 2G, ... of the point's
//     row in registers, loaded straight from global memory: 16-byte vectors
//     (4 f32 or 8 bf16) where D and the pointers allow it, else scalars.
//     The loads are issued before the centroids are staged, so the two
//     global latencies overlap. Past 8 elements a lane (D > 256 at G = 32)
//     the rest of the row is re-read per centroid (from L1).
//   * The [K, D] centroids live in shared memory in f32 (the TPU kernel's
//     "centroids resident in VMEM"); a lane reads its slice of a centroid,
//     the groups of a warp read the same addresses (broadcasts). Where K
//     centroids do not fit one block's shared memory, the block walks them
//     in tiles of Kt rows (the wrapper sizes Kt to fit, all K in one tile
//     where they do), and each group keeps its point's running minimum and
//     argmin in registers from tile to tile. The comparison stays strict
//     and runs in centroid order, so ties keep the lowest index across
//     tiles too. With one tile the launch takes an instance with the tile
//     loop folded away (kTiled false): the whole-K kernel's code, and its
//     outputs bit for bit.
//   * Each lane forms its partial ||x||^2 and the K partial dots in a fixed
//     order; the group sums them with log2 G rounds of __shfl_xor_sync. The
//     butterfly leaves every lane with the same bits (a + b == b + a), and
//     every centroid's dot goes through the same tree, so two identical
//     centroids give identical d2 and the tie still goes to the lower index.
//     ||c||^2 is split over a group's lanes and summed by the same tree,
//     one centroid per group.
//   * Lane 0 of the group writes argmin and min; points past N compute on
//     zeros and write nothing. 128 threads a block: 16 points at G = 8, so
//     the local step's N = 128 spreads over 8 SMs instead of one.
// The dependent chain at D = 64 is now 8 FMAs, 3 shuffles and an add per
// product. A centre set in several tiles is another matter: each block
// restages every tile for its few points (8 at D = 128), one block an SM
// when a tile fills the shared memory, and walks the centres one dependent
// chain after another; such a shape wants many points a block (a GEMM's
// tiles). That, and wgmma/TMA pipelines, are left for when a caller's shape
// makes this bandwidth- or compute-bound.
//
// Edges: the reference also runs the TPU kernel under jax.vmap over edges
// (src/repro/el/ingraph.py, the compiled EL round's local blocks), so the
// compiled round's E-step is E problems X [E, N, D] against C [E, K, D], each
// edge against its own centroids. One launch covers them all: blockIdx.y is
// the edge, blockIdx.x the point block, and each block stages its own edge's
// centroids and norms in shared memory. A single problem is one edge, so a
// batched launch computes bit for bit what E single launches compute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRegElems = 8;           // elements of the row a lane keeps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive elements of a row, from global memory, as f32
template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&out)[V], const T* p) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are 16 bytes");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 16 bytes");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// V consecutive f32 of a shared-memory row
template <int V>
__device__ __forceinline__ void load_smem(float (&out)[V], const float* p) {
  if constexpr (V == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ float group_sum(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This lane's share of x . c over the vectors it owns: the ones held in xv,
// then any past them read again from global memory (x_row). c_row is a
// shared-memory row; c_row == nullptr gives x . x.
template <typename T, int V>
__device__ __forceinline__ float lane_dot(const float (&xv)[kRegElems],
                                          const T* x_row, const float* c_row,
                                          int nv, int r, int group) {
  constexpr int kSlots = kRegElems / V;
  float part = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int q = r + group * s;
    if (q < nv) {
      float c[V];
      if (c_row) {
        load_smem<V>(c, c_row + q * V);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) c[t] = xv[s * V + t];
      }
#pragma unroll
      for (int t = 0; t < V; ++t) part = fmaf(xv[s * V + t], c[t], part);
    }
  }
  for (int q = r + group * kSlots; q < nv; q += group) {
    float v[V], c[V];
    load_vec<T, V>(v, x_row + q * V);
    if (c_row) {
      load_smem<V>(c, c_row + q * V);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) c[t] = v[t];
    }
#pragma unroll
    for (int t = 0; t < V; ++t) part = fmaf(v[t], c[t], part);
  }
  return part;
}

// kTiled false: all k centroids in one tile (kt == k), the loop over tiles
// folded away at compile time, so the code is the whole-K kernel's (kt comes
// last, leaving the other parameters where that kernel had them)
template <typename T, int V, bool kTiled>
__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const T* __restrict__ x,
                         const T* __restrict__ centers, int n, int d, int k,
                         int group, int32_t* __restrict__ out_assign,
                         float* __restrict__ out_d2, int kt) {
  constexpr int kSlots = kRegElems / V;
  extern __shared__ float4 smem4[];
  if (!kTiled) kt = k;                  // (the launch passes k; folded)
  float* c_s = reinterpret_cast<float*>(smem4);  // [kt, d]
  float* c2_s = c_s + kt * d;                     // [kt]

  // this block's edge: its points, centroids and outputs
  const long long edge = blockIdx.y;
  x += edge * n * d;
  centers += edge * k * d;
  out_assign += edge * n;
  out_d2 += edge * n;

  const int tid = threadIdx.x;
  const int r = tid & (group - 1);       // lane within the group
  const int gi = tid / group;            // group within the block
  const int groups = kThreads / group;
  const int nv = d / V;                  // vectors per row
  const long long point = (long long)blockIdx.x * groups + gi;
  const bool live = point < n;
  const T* x_row = x + (live ? point : 0) * d;

  // this lane's vectors of the point, issued before the centroids' loads
  float xv[kRegElems];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int q = r + group * s;
    float v[V];
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = 0.f;
    if (live && q < nv) load_vec<T, V>(v, x_row + q * V);
#pragma unroll
    for (int t = 0; t < V; ++t) xv[s * V + t] = v[t];
  }

  float x2 = 0.f;
  float best = 0.f;
  int best_k = 0;
  // centroids t0 .. t0 + kc - 1 at a time (the loop is uniform over the
  // block, so every lane takes part in every shuffle and barrier)
  for (int t0 = 0; t0 < (kTiled ? k : 1); t0 += (kTiled ? kt : 1)) {
    const int kc = kTiled ? min(kt, k - t0) : k;
    if (kTiled && t0 > 0) __syncthreads();   // every group is done with it
    const T* tile = centers + (long long)t0 * d;
    for (int i = tid; i < kc * d; i += kThreads) c_s[i] = to_f32(tile[i]);
    __syncthreads();
    // ||c||^2, centroid c0 + gi by group gi
    for (int c0 = 0; c0 < kc; c0 += groups) {
      const int c = c0 + gi;
      float part = 0.f;
      if (c < kc) {
        for (int j = r; j < d; j += group)
          part = fmaf(c_s[c * d + j], c_s[c * d + j], part);
      }
      part = group_sum(part, group);
      if (c < kc && r == 0) c2_s[c] = part;
    }
    __syncthreads();

    // a dead point's lanes still join the shuffles; its tail is not read
    const int nv_live = live ? nv : min(nv, group * kSlots);
    if (!kTiled || t0 == 0)
      x2 = group_sum(lane_dot<T, V>(xv, x_row, nullptr, nv_live, r, group),
                     group);
    for (int c = 0; c < kc; ++c) {
      const float dot = group_sum(
          lane_dot<T, V>(xv, x_row, c_s + c * d, nv_live, r, group), group);
      // 2*dot is exact, so a contracted fma(-2, dot, x2) rounds identically
      const float d2 = (x2 - 2.f * dot) + c2_s[c];
      if (t0 + c == 0 || d2 < best) {  // strict <: ties keep the lowest index
        best = d2;
        best_k = t0 + c;
      }
    }
  }
  if (live && r == 0) {
    out_assign[point] = best_k;
    out_d2[point] = best;
  }
}

template <typename T, int V>
int launch(const void* x, const void* centers, int edges, int n, int d, int k,
           int kt, int group, int32_t* out_assign, float* out_d2,
           cudaStream_t stream) {
  auto kernel = kt < k ? kmeans_assign_kernel<T, V, true>
                       : kmeans_assign_kernel<T, V, false>;
  const size_t smem = (size_t(kt) * d + kt) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int points = kThreads / group;   // per block
  const dim3 blocks((n + points - 1) / points, edges);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(centers), n, d, k,
      group, out_assign, out_d2, kt);
  return (int)cudaGetLastError();
}

// 16-byte vectors when every row of x and of the centroids starts on a
// 16-byte boundary (every edge's too: rows are D elements apart); scalars
// otherwise
template <typename T>
int launch_dtype(const void* x, const void* centers, int edges, int n, int d,
                 int k, int kt, int group, int32_t* out_assign, float* out_d2,
                 cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool aligned = d % kV == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)centers % 16 == 0;
  if (aligned)
    return launch<T, kV>(x, centers, edges, n, d, k, kt, group, out_assign,
                         out_d2, stream);
  return launch<T, 1>(x, centers, edges, n, d, k, kt, group, out_assign,
                      out_d2, stream);
}

}  // namespace

extern "C" {

// x [edges, n, d] and centers [edges, k, d], contiguous, into out_assign /
// out_d2 [edges, n]; edge e's points against edge e's centroids (edges = 1:
// one problem). kt: the centroids a block holds in shared memory at once
// (1 to k; k: all of them). dtype: 0 = float32, 1 = bfloat16 (x and
// centers share it). group: lanes per point, a power of two <= 32.
// Returns the cudaError_t of the launch (0 = success).
int kmeans_assign_launch(const void* x, const void* centers, int edges, int n,
                         int d, int k, int kt, int dtype, int group,
                         int32_t* out_assign, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || edges < 1 ||
      edges > 65535 || kt < 1 || kt > k)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dtype<float>(x, centers, edges, n, d, k, kt, group,
                               out_assign, out_d2, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(x, centers, edges, n, d, k, kt, group,
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
