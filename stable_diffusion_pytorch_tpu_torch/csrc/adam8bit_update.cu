// The int8 Adam leaf update (K9) for Hopper (sm_90a), CUDA C++ with a plain C interface.
//
// Replaces the Pallas TPU kernel stable_diffusion_pytorch_tpu/ops/adam8bit_update.py
// `_kernel`: dequantize both stored moments, the f32 Adam recurrence with the
// bias corrections passed in, update = (mu / bc1) / (sqrt(nu / bc2) + eps),
// the blockwise absmax, and the requantized moments (nu in the sqrt domain):
//
//   q  = clip(rint(127 * sign(x) * sqrt(|x| / absmax_block)), -127, 127)
//   x~ = sign(q) * (q/127)^2 * absmax_block
//
// Numerics follow the JAX package's op order exactly. Every product, sum,
// quotient and square root is written with the IEEE round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never
// contracts into FMAs; rint rounds half to even as jnp.round does; sign(0) = 0;
// the scale of an all-zero block is 1 for the division and stored as 0.
//
// Layout (ops/adam8bit_update.py): the leaf is viewed as [O, R] (O = dim 0 of
// the port's layout, the JAX minor axis); the absmax blocks run along dim 0,
// `block` rows for each column r; scales are f32 [nb, R]. A thread block of
// 32 x 8 threads owns one quantization block j and 32 neighbouring columns:
// the 32 threads of a warp take neighbouring columns, so every load and store
// of a warp is contiguous, and the 8 warps split the block's rows. Each
// thread walks its rows twice: pass 1 computes the moments, writes the
// update and takes both absmaxes over its rows; the 8 partial maxima of a
// column meet in shared memory; pass 2 recomputes the moments (bit for bit
// the same arithmetic) from the unchanged inputs and writes the codes. The
// f32 moments never reach device memory.
//
// What bounds it on this card: bytes. Per parameter it must read g (4 or 2 B)
// and two codes and write two codes and the update (4 or 2 B), plus the
// scales: about 12 B at f32 g, 8 B at bf16 g; at 3.35 TB/s the SD-1.5 UNet's
// 859.5 M parameters need about 3.1 ms at f32. This first version reads g and
// the codes twice, and a leaf is one launch (686 per optimizer step), so the
// small leaves pay the launch and the sequential walk of up to block/8 rows.
// Keeping the moments in registers or shared memory between the passes, one
// launch for many leaves, and fusing the parameter apply are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;        // columns per thread block, one warp wide
constexpr int TY = 8;         // warps, each taking every TY-th row of the block
constexpr int NT = TX * TY;   // threads per block

struct Coeffs {
  float b1, omb1, b2, omb2, eps, bc1, bc2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // sign(0) = 0, sign(NaN) = NaN
}

// jnp.max semantics: a NaN anywhere makes the maximum NaN
__device__ __forceinline__ float max_nan(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// sign(qf) * qf * qf * scale with qf = q * (1/127), left to right
__device__ __forceinline__ float dequant(int8_t q, float scale) {
  const float qf = __fmul_rn(float(q), 1.0f / 127.0f);
  return __fmul_rn(__fmul_rn(__fmul_rn(sign_of(qf), qf), qf), scale);
}

__device__ __forceinline__ int8_t quant(float x, float absmax) {
  const float safe = absmax > 0.f ? absmax : 1.f;
  const float y = __fdiv_rn(x, safe);
  const float v = __fmul_rn(__fmul_rn(127.f, sign_of(y)), __fsqrt_rn(fabsf(y)));
  const float q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return int8_t(q);
}

// mu = b1 * mu~ + (1 - b1) * g ;  nu = b2 * (sqrt(nu)~)^2 + (1 - b2) * g * g
__device__ __forceinline__ void moments(float g, int8_t mq, float ms, int8_t nq, float ns,
                                        const Coeffs& c, float& mu, float& nu) {
  mu = __fadd_rn(__fmul_rn(c.b1, dequant(mq, ms)), __fmul_rn(c.omb1, g));
  const float nu_sqrt = dequant(nq, ns);
  nu = __fadd_rn(__fmul_rn(c.b2, __fmul_rn(nu_sqrt, nu_sqrt)), __fmul_rn(__fmul_rn(c.omb2, g), g));
}

template <typename G>
__global__ void __launch_bounds__(NT) adam8bit_update_kernel(
    const G* __restrict__ g, const int8_t* __restrict__ muq, const float* __restrict__ mus,
    const int8_t* __restrict__ nuq, const float* __restrict__ nus, G* __restrict__ upd,
    int8_t* __restrict__ nmuq, float* __restrict__ nmus, int8_t* __restrict__ nnuq,
    float* __restrict__ nnus, long long R, int block, Coeffs c) {
  __shared__ float part_mu[TY][TX];
  __shared__ float part_nu[TY][TX];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long j = blockIdx.y;
  const long long r = (long long)blockIdx.x * TX + tx;
  const bool valid = r < R;
  const long long base = j * block * R + r;  // element (j*block, r) of the [O, R] view
  const float ms = valid ? mus[j * R + r] : 0.f;  // scale (j, r) of the [nb, R] view
  const float ns = valid ? nus[j * R + r] : 0.f;

  float amax_mu = 0.f, amax_nu = 0.f;
  if (valid) {
#pragma unroll 4
    for (int i = ty; i < block; i += TY) {
      const long long idx = base + i * R;
      float mu, nu;
      moments(to_f32(g[idx]), muq[idx], ms, nuq[idx], ns, c, mu, nu);
      const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c.bc2)), c.eps);
      upd[idx] = from_f32<G>(__fdiv_rn(__fdiv_rn(mu, c.bc1), denom));
      amax_mu = max_nan(amax_mu, fabsf(mu));
      amax_nu = max_nan(amax_nu, __fsqrt_rn(nu));
    }
  }
  part_mu[ty][tx] = amax_mu;
  part_nu[ty][tx] = amax_nu;
  __syncthreads();
  for (int k = 0; k < TY; ++k) {  // the column's absmax over all its rows
    amax_mu = max_nan(amax_mu, part_mu[k][tx]);
    amax_nu = max_nan(amax_nu, part_nu[k][tx]);
  }
  if (!valid) return;
#pragma unroll 4
  for (int i = ty; i < block; i += TY) {
    const long long idx = base + i * R;
    float mu, nu;
    moments(to_f32(g[idx]), muq[idx], ms, nuq[idx], ns, c, mu, nu);
    nmuq[idx] = quant(mu, amax_mu);
    nnuq[idx] = quant(__fsqrt_rn(nu), amax_nu);
  }
  if (ty == 0) {
    nmus[j * R + r] = amax_mu;
    nnus[j * R + r] = amax_nu;
  }
}

template <typename G>
int launch(const void* g, const int8_t* muq, const float* mus, const int8_t* nuq, const float* nus,
           void* upd, int8_t* nmuq, float* nmus, int8_t* nnuq, float* nnus, long long R, int block,
           int nb, const Coeffs& c, cudaStream_t s) {
  const long long col_tiles = (R + TX - 1) / TX;
  if (col_tiles > 2147483647LL || nb > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid{static_cast<unsigned>(col_tiles), static_cast<unsigned>(nb), 1u};
  adam8bit_update_kernel<G><<<grid, NT, 0, s>>>(
      static_cast<const G*>(g), muq, mus, nuq, nus, static_cast<G*>(upd), nmuq, nmus, nnuq, nnus, R,
      block, c);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// g_dtype: 0 = float32, 1 = bfloat16 (the update is written in g's dtype).
// The leaf is [nb * block, R]; codes int8 in that shape, scales f32 [nb, R].
// The outputs must not alias the inputs. Returns the CUDA error code of the
// launch (0 on success); the caller raises on nonzero.
int sd_adam8bit_update(int g_dtype, const void* g, const void* mu_q, const void* mu_s,
                       const void* nu_q, const void* nu_s, void* upd, void* new_mu_q,
                       void* new_mu_s, void* new_nu_q, void* new_nu_s, long long R, int block,
                       int nb, float b1, float omb1, float b2, float omb2, float eps, float bc1,
                       float bc2, void* stream) {
  if (R <= 0 || block <= 0 || nb <= 0) return int(cudaErrorInvalidValue);
  const Coeffs c{b1, omb1, b2, omb2, eps, bc1, bc2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* mq = static_cast<const int8_t*>(mu_q);
  const int8_t* nq = static_cast<const int8_t*>(nu_q);
  const float* ms = static_cast<const float*>(mu_s);
  const float* ns = static_cast<const float*>(nu_s);
  int8_t* nmq = static_cast<int8_t*>(new_mu_q);
  int8_t* nnq = static_cast<int8_t*>(new_nu_q);
  float* nms = static_cast<float*>(new_mu_s);
  float* nns = static_cast<float*>(new_nu_s);
  if (g_dtype == 0)
    return launch<float>(g, mq, ms, nq, ns, upd, nmq, nms, nnq, nns, R, block, nb, c, s);
  if (g_dtype == 1)
    return launch<__nv_bfloat16>(g, mq, ms, nq, ns, upd, nmq, nms, nnq, nns, R, block, nb, c, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
