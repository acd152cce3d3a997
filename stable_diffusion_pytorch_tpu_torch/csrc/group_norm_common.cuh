// Shared by the GroupNorm kernels (csrc/group_norm.cu: the forward K6 and the
// concat forward K8; csrc/group_norm_bwd.cu: the backward K7): the CTA size,
// the element conversions, the vector type, the per-thread column mapping of
// a map made of one or two channel parts, and the cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sd_gn {

constexpr int GN_NT = 256;           // threads per CTA
constexpr int GN_SMEM_MAX = 232448;  // shared memory a block can use (227 KB)

__device__ __forceinline__ float raw_to_f32(uint16_t u) { return __uint_as_float(uint32_t(u) << 16); }
__device__ __forceinline__ float raw_to_f32(uint32_t u) { return __uint_as_float(u); }
template <typename RAW> __device__ __forceinline__ RAW f32_to_raw(float x);
template <> __device__ __forceinline__ uint16_t f32_to_raw<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ uint32_t f32_to_raw<uint32_t>(float x) { return __float_as_uint(x); }

// VEC elements of one row, loaded and stored as one access of up to 16 bytes
template <typename RAW, int VEC>
struct alignas(sizeof(RAW) * VEC) Pack {
  RAW v[VEC];
};

// Where a thread's vector column lives. The map's channels are the concat of
// part 0 (c0 channels, row stride c0) and part 1 (c1 channels, row stride c1;
// none for a plain map). The launch plan makes the vector width divide c0 and
// c1, so the VEC channels from concat channel `cc` (a multiple of VEC) lie
// wholly in one part: the thread picks its part's base pointer, row stride
// and first column once.
template <typename T>
struct PartCol {
  T* base;
  int ld;
  int col;
};

template <bool TWO, typename T>
__device__ __forceinline__ PartCol<T> part_col(T* p0, T* p1, int c0, int c1, int cc) {
  if (TWO && cc >= c0) return {p1, c1, cc - c0};
  return {p0, c0, cc};
}

// A cluster kernel's one-time attributes: clusters past the portable 8 and
// the shared memory past 48 KB. `configured` is the caller's flag per kernel
// instantiation: the call sits on every launch's host path.
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_SMEM_MAX);
  if (err == cudaSuccess) configured = true;
  return err;
}

// The launch of a cluster kernel: grid (cluster, n_slices, B) of GN_NT-thread
// CTAs, clusters along x (a CTA's rank is its blockIdx.x). Built in place:
// `cfg` points at `attr`.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cluster, int n_slices, int B, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(cluster, n_slices, B);
    cfg.blockDim = dim3(GN_NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

}  // namespace sd_gn
