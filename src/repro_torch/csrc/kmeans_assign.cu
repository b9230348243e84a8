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
// is defined by it and may dip below 0 by rounding. Inputs are f32, bf16 or
// f16, upcast to f32 on load; every sum is an f32 accumulation. Two
// instances, which the wrapper's plan picks (kernel.plan): the lane-group
// kernel for every shape whose K centroids fit one block and whose point a
// group's registers hold (D <= 256: the paper's shapes), and the
// block-tiled kernel for the rest.
//
// Lane-group instance (kmeans_assign_kernel)
// ------------------------------------------
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
//     (4 f32 or 8 bf16 / f16) where D and the pointers allow it, else
//     scalars. The loads are issued before the centroids are staged, so the
//     two global latencies overlap. (lane_dot's loop over vectors past a
//     lane's 8 elements never runs since the wrapper sends D > 256 to the
//     block-tiled instance; it stays so the f32 and bf16 instances compile
//     to the SASS they had before the f16 and block-tiled instances came.)
//   * The [K, D] centroids live in shared memory in f32 for the block's
//     lifetime (the TPU kernel's "centroids resident in VMEM"); a lane reads
//     its slice of a centroid, the groups of a warp read the same addresses
//     (broadcasts).
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
// product. wgmma/TMA pipelines are left for when a caller's shape makes this
// bandwidth- or compute-bound.
//
// Block-tiled instance (kmeans_assign_block_kernel)
// -------------------------------------------------
// For centre sets beyond one block's shared memory and points wider than a
// group's registers (any K, any D). A centre set in several tiles of the
// lane-group kernel's layout cost each block of 8 points a restage of every
// tile, one dependent chain per centroid (1.5675 ms at (4096, 128, 1024),
// 14.5x its plain version: PERF.md); here a block holds many points, as a
// GEMM's tiles do. What bounds it: at (4096, 128, 1024) 1.09 GFLOP of f32
// against 2.6 MB, so operations (67 TFLOP/s of f32: 16 us).
//   * One block of 256 threads (a 16 x 16 grid) per kBM = 64 points; it
//     walks the centres in tiles of kBK = 64 and D in slices of kDK = 32.
//     Each slice of the points [64, 32] and of the tile's centres [64, 32]
//     is read from global memory into registers (converted to f32) while
//     the slice before it is used, then stored transposed in shared
//     memory, [32, 64 + 4] each; thread (ty, tx) then owns
//     points 4 ty .. 4 ty + 3 against centres 4 tx .. 4 tx + 3, a 4 x 4
//     register tile fed by two 16-byte shared loads per step of D (16 FMAs
//     per 8 floats loaded).
//   * Every sum runs in one fixed order over D, slice after slice: each
//     (point, centre) dot is one thread's FMA chain, ||x||^2 one thread's
//     (warps 0-1, the first centre tile only) and ||c||^2 one thread's
//     (warps 2-3, each tile), so two identical centroids give identical
//     d2 and the tie still goes to the lower index. Points past N and
//     columns past D are zeros; centres past K never win.
//   * A tile's minimum: each thread scans its 4 centres in order (strict
//     <), then the 16 lanes sharing a point combine by shuffles, keeping
//     the smaller d2 and, on equal d2, the lower index: the first minimum
//     in centre order. Each point's running minimum and argmin stay in
//     registers from tile to tile, replaced only on a strict <, so ties
//     keep the lowest index across tiles too.
//   * A simple, correct kernel on the FMA pipes: no cp.async or TMA
//     pipeline, no wgmma, and a shape with few point blocks (N / 64 under
//     the SM count) leaves SMs idle. On an H100 (PERF.md): 0.123 ms at
//     (4096, 128, 1024), near its plain version; 0.43 ms at (1024, 8192,
//     64), 16 blocks, 3.2x its plain version; staging each slice with
//     its loads and stores interleaved, before the register prefetch,
//     took 0.227 and 1.408. ptxas: 159-161 registers, no spills.
//
// Edges: the reference also runs the TPU kernel under jax.vmap over edges
// (src/repro/el/ingraph.py, the compiled EL round's local blocks), so the
// compiled round's E-step is E problems X [E, N, D] against C [E, K, D], each
// edge against its own centroids. One launch covers them all, in both
// instances: blockIdx.y is the edge, blockIdx.x the point block, and each
// block reads its own edge's centroids. A single problem is one edge, so a
// batched launch computes bit for bit what E single launches compute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kRegElems = 8;           // elements of the row a lane keeps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// V consecutive elements of a row, from global memory, as f32
template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&out)[V], const T* p) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are 16 bytes");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (std::is_same_v<T, __half>) {
    static_assert(V == 8, "f16 vectors are 16 bytes");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const T* __restrict__ x,
                         const T* __restrict__ centers, int n, int d, int k,
                         int group, int32_t* __restrict__ out_assign,
                         float* __restrict__ out_d2) {
  constexpr int kSlots = kRegElems / V;
  extern __shared__ float4 smem4[];
  float* c_s = reinterpret_cast<float*>(smem4);  // [k, d]
  float* c2_s = c_s + k * d;                      // [k]

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

  for (int i = tid; i < k * d; i += kThreads) c_s[i] = to_f32(centers[i]);
  __syncthreads();
  // ||c||^2, centroid c0 + gi by group gi (the loop is uniform over the
  // block, so every lane takes part in every shuffle)
  for (int c0 = 0; c0 < k; c0 += groups) {
    const int c = c0 + gi;
    float part = 0.f;
    if (c < k) {
      for (int j = r; j < d; j += group)
        part = fmaf(c_s[c * d + j], c_s[c * d + j], part);
    }
    part = group_sum(part, group);
    if (c < k && r == 0) c2_s[c] = part;
  }
  __syncthreads();

  // a dead point's lanes still join the shuffles; its tail is not read
  const int nv_live = live ? nv : min(nv, group * kSlots);
  const float x2 =
      group_sum(lane_dot<T, V>(xv, x_row, nullptr, nv_live, r, group), group);
  float best = 0.f;
  int best_k = 0;
  for (int c = 0; c < k; ++c) {
    const float dot = group_sum(
        lane_dot<T, V>(xv, x_row, c_s + c * d, nv_live, r, group), group);
    // 2*dot is exact, so a contracted fma(-2, dot, x2) rounds identically
    const float d2 = (x2 - 2.f * dot) + c2_s[c];
    if (c == 0 || d2 < best) {  // strict <: ties keep the lowest index
      best = d2;
      best_k = c;
    }
  }
  if (live && r == 0) {
    out_assign[point] = best_k;
    out_d2[point] = best;
  }
}

template <typename T, int V>
int launch(const void* x, const void* centers, int edges, int n, int d, int k,
           int group, int32_t* out_assign, float* out_d2,
           cudaStream_t stream) {
  auto kernel = kmeans_assign_kernel<T, V>;
  const size_t smem = (size_t(k) * d + k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int points = kThreads / group;   // per block
  const dim3 blocks((n + points - 1) / points, edges);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(centers), n, d, k,
      group, out_assign, out_d2);
  return (int)cudaGetLastError();
}

// 16-byte vectors when every row of x and of the centroids starts on a
// 16-byte boundary (every edge's too: rows are D elements apart); scalars
// otherwise
template <typename T>
int launch_dtype(const void* x, const void* centers, int edges, int n, int d,
                 int k, int group, int32_t* out_assign, float* out_d2,
                 cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool aligned = d % kV == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)centers % 16 == 0;
  if (aligned)
    return launch<T, kV>(x, centers, edges, n, d, k, group, out_assign,
                         out_d2, stream);
  return launch<T, 1>(x, centers, edges, n, d, k, group, out_assign, out_d2,
                      stream);
}


// -- block-tiled instance ----------------------------------------------------

constexpr int kBThreads = 256;         // a 16 x 16 thread grid
constexpr int kBM = 64;                // points a block
constexpr int kBK = 64;                // centres a tile
constexpr int kDK = 32;                // features a slice
constexpr int kSS = kBM + 4;           // row stride of a staged slice (floats)
static_assert(kBM == kBK, "one stride for both staged slices");

constexpr int kPer = kBM * kDK / kBThreads;   // elements a thread stages

// this thread's share of rows [r0, r0 + 64) x columns [d0, d0 + 32) of a
// [rows, d] array, as f32 in registers (the next slice's loads are in
// flight while the current one is used); past `rows` or d: zeros
template <typename T>
__device__ __forceinline__ void load_slice(float (&v)[kPer], const T* src,
                                           int r0, int rows, int d0, int d,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kBThreads;
    const int r = i / kDK, j = i - r * kDK;
    const bool in = r0 + r < rows && d0 + j < d;
    v[u] = in ? to_f32(src[(long long)(r0 + r) * d + d0 + j]) : 0.f;
  }
}

// a slice from registers into dst[32][kSS], transposed
__device__ __forceinline__ void store_slice(float* dst,
                                            const float (&v)[kPer],
                                            int tid) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + u * kBThreads;
    const int r = i / kDK, j = i - r * kDK;
    dst[j * kSS + r] = v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kBThreads)
    kmeans_assign_block_kernel(const T* __restrict__ x,
                               const T* __restrict__ centers, int n, int d,
                               int k, int32_t* __restrict__ out_assign,
                               float* __restrict__ out_d2) {
  __shared__ __align__(16) float xs[kDK * kSS];   // [feature][point]
  __shared__ __align__(16) float cs[kDK * kSS];   // [feature][centre]
  __shared__ float x2_s[kBM];
  __shared__ float c2_s[kBK];

  // this block's edge: its points, centroids and outputs
  const long long edge = blockIdx.y;
  x += edge * n * d;
  centers += edge * k * d;
  out_assign += edge * n;
  out_d2 += edge * n;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.x * kBM;
  float best[4];
  int best_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = 0.f;
    best_k[i] = -1;                    // no centre yet
  }
  float norm = 0.f;   // warps 0-1: ||x||^2 of point tid; 2-3: ||c||^2
  // slices in order: the first tile's, then the next tile's, ...; each
  // staged from registers loaded while the slice before was used
  float xr[kPer], cr[kPer];
  load_slice(xr, x, p0, n, 0, d, tid);
  load_slice(cr, centers, 0, k, 0, d, tid);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
    if (tid >= kBM) norm = 0.f;        // ||c||^2 starts again each tile
    for (int d0 = 0; d0 < d; d0 += kDK) {
      __syncthreads();                 // the last slice is read
      store_slice(xs, xr, tid);
      store_slice(cs, cr, tid);
      __syncthreads();
      const bool last = d0 + kDK >= d;  // the next slice: this tile's, or
      const int nd0 = last ? 0 : d0 + kDK;   // the next tile's first
      const int nk0 = last ? k0 + kBK : k0;
      if (nk0 < k) {
        load_slice(xr, x, p0, n, nd0, d, tid);
        load_slice(cr, centers, nk0, k, nd0, d, tid);
      }
      if (tid < kBM) {
        if (k0 == 0)                   // one pass over D is enough
          for (int j = 0; j < kDK; ++j)
            norm = fmaf(xs[j * kSS + tid], xs[j * kSS + tid], norm);
      } else if (tid < kBM + kBK) {
        const int c = tid - kBM;
        for (int j = 0; j < kDK; ++j)
          norm = fmaf(cs[j * kSS + c], cs[j * kSS + c], norm);
      }
#pragma unroll 8
      for (int j = 0; j < kDK; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + j * kSS + 4 * ty);
        const float4 cv = *reinterpret_cast<const float4*>(
            cs + j * kSS + 4 * tx);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dot[i][c] = fmaf(xa[i], ca[c], dot[i][c]);
      }
    }
    if (tid < kBM) {
      if (k0 == 0) x2_s[tid] = norm;
    } else if (tid < kBM + kBK) {
      c2_s[tid - kBM] = norm;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x2 = x2_s[4 * ty + i];
      // this thread's centres in order, strict <: the first minimum
      float v = 0.f;
      int vk = -1;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = k0 + 4 * tx + c;
        // 2*dot is exact, so a contracted fma(-2, dot, x2) rounds identically
        const float d2 = (x2 - 2.f * dot[i][c]) + c2_s[4 * tx + c];
        if (kc < k && (vk < 0 || d2 < v)) {
          v = d2;
          vk = kc;
        }
      }
      // the 16 lanes of the point: the smaller d2, the lower index on ties
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int ok = __shfl_xor_sync(0xffffffffu, vk, off);
        if (ok >= 0 && (vk < 0 || ov < v || (ov == v && ok < vk))) {
          v = ov;
          vk = ok;
        }
      }
      if (best_k[i] < 0 || v < best[i]) {  // strict <: earlier tiles win ties
        best[i] = v;
        best_k[i] = vk;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 4 * ty + i;
      if (p < n) {
        out_assign[p] = best_k[i];
        out_d2[p] = best[i];
      }
    }
  }
}

template <typename T>
int launch_block(const void* x, const void* centers, int edges, int n, int d,
                 int k, int32_t* out_assign, float* out_d2,
                 cudaStream_t stream) {
  const dim3 blocks((n + kBM - 1) / kBM, edges);
  kmeans_assign_block_kernel<T><<<blocks, kBThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(centers), n, d, k,
      out_assign, out_d2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [edges, n, d] and centers [edges, k, d], contiguous, into out_assign /
// out_d2 [edges, n]; edge e's points against edge e's centroids (edges = 1:
// one problem). dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and
// centers share it). group: lanes per point, a power of two <= 32; all k
// centroids are staged at once (the wrapper plans that they fit). Returns
// the cudaError_t of the launch (0 = success).
int kmeans_assign_launch(const void* x, const void* centers, int edges, int n,
                         int d, int k, int dtype, int group,
                         int32_t* out_assign, float* out_d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || edges < 1 ||
      edges > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dtype<float>(x, centers, edges, n, d, k, group, out_assign,
                               out_d2, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(x, centers, edges, n, d, k, group,
                                       out_assign, out_d2, s);
  if (dtype == 2)
    return launch_dtype<__half>(x, centers, edges, n, d, k, group,
                                out_assign, out_d2, s);
  return (int)cudaErrorInvalidValue;
}

// The block-tiled instance: the same arguments and outputs, any k and d
// (no alignment needed).
int kmeans_assign_block_launch(const void* x, const void* centers, int edges,
                               int n, int d, int k, int dtype,
                               int32_t* out_assign, float* out_d2,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (edges < 1 || edges > 65535 || k < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_block<float>(x, centers, edges, n, d, k, out_assign,
                               out_d2, s);
  if (dtype == 1)
    return launch_block<__nv_bfloat16>(x, centers, edges, n, d, k,
                                       out_assign, out_d2, s);
  if (dtype == 2)
    return launch_block<__half>(x, centers, edges, n, d, k, out_assign,
                                out_d2, s);
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
