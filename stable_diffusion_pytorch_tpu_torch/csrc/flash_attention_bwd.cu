// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C interface.
//
// Replaces the Pallas TPU kernel stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py
// `_fused_bwd_kernel` (launched from `flash_attention_bwd_fused`, the default
// SD_FLASH_BWD=fused backward of the JAX package's flash attention).
//
// Given q, k, v, the forward's output o, its row log-sum-exp (lse2, base 2, from
// csrc/flash_attention.cu) and the output gradient do, for each (batch, head):
//   P  = exp2(Q K^T * scale * log2(e) - lse2)        (the forward's softmax)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(dO * O),  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// All of it in f32 (the TPU kernel's algebra is f32 too); kv columns at or past
// the true length M are masked, rows past N contribute nothing.
//
// Why not the TPU design: the TPU kernel keeps one head's whole K/V resident in
// VMEM and carries dk/dv in scratch across a sequential grid over q tiles. On
// Hopper one head's K plus V at 4096 x 48 is 786 KB against 227 KB of shared
// memory, and blocks run in no order. So the design is FA2's:
//   1. `delta_kernel`: delta = rowsum(dO * O), one warp per row;
//   2. `dkv_kernel` (its body, `dkv_body`, is shared with the split kernels in
//      flash_attention_bwd_common.cuh): a block owns 64 kv rows (its K and V
//      tiles stay in shared memory), loops over all q tiles of 64 rows,
//      recomputes S and dP, and
//      keeps its dK/dV accumulators in f32 registers for the whole loop; its
//      share of dQ for each q tile (dS K over its 64 kv columns) goes to an
//      f32 [B, N, H, D] buffer with atomicAdd. The order of those adds varies
//      from run to run, so dQ may differ in the last bit between runs (the
//      split kernels of csrc/flash_attention_bwd_split.cu do without atomics);
//   3. `cast_kernel`: the f32 dQ buffer to bf16 (skipped for f32 inputs, where
//      the buffer is the output).
//
// What bounds it on this card: five products of 2*N*M*D FLOPs each (S, dP, dV,
// dK, dQ) against O((N+M)*D) bytes: arithmetic, far above the ridge. This
// first version runs them on f32 FMAs from shared memory (no tensor cores),
// with the same 16 x 16 thread layout and 4-row micro-tiles as the forward;
// each thread holds 4 kv rows x DP/16 head-dim columns of both dK and dV.
// Shared memory holds Q, dO, K and V transposed (f32) plus P and dS: 204 KB at
// DP = 160, the widest instance (the UNet's d_head 160). Tensor cores (wgmma)
// are later work.
//
// Layout: q/o/do [B, N, H, D] and k/v [B, M, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous; dk, dv and
// dq are written contiguous [B, L, H, D]; lse and delta are f32 [B, H, N].

#include "flash_attention_bwd_common.cuh"

namespace {

template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, int H, int N, int D,
                             int64_t o_sb, int64_t o_sn, int64_t o_sh,
                             int64_t d_sb, int64_t d_sn, int64_t d_sh, int64_t rows) {
  delta_rows<T>(o, dout, delta, H, N, D, o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, rows);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
    int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  dkv_body<T, DP, true>(smem, q, k, v, dout, lse, delta, dq_acc, dk, dv, H, N, M, D, q_sb, q_sn,
                        q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, d_sb, d_sn, d_sh, scale,
                        scale_log2);
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst, int64_t n) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x)
    dst[i] = from_f32<T>(src[i]);
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dq_acc, void* dk, void* dv, int B, int H, int N,
               int M, int D, const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((M + BK - 1) / BK, H, B);
  dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[12], st[13], st[14], scale, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

template <typename T>
int backward(int D, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, float* dq_acc, void* dq,
             void* dk, void* dv, int B, int H, int N, int M, const long long* st, float scale,
             cudaStream_t stream) {
  const int64_t rows = int64_t(B) * H * N;
  const int64_t blocks = (rows * 32 + 255) / 256;
  delta_kernel<T><<<unsigned(blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, N, D, st[9], st[10],
      st[11], st[12], st[13], st[14], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  int rc = int(cudaErrorInvalidValue);
#define SD_BWD_CASE(DP)                                                                    \
  if (D <= DP) {                                                                           \
    rc = launch_dkv<T, DP>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, H, N, M, D, st,   \
                           scale, stream);                                                 \
  } else
  SD_BWD_CASE(32) SD_BWD_CASE(48) SD_BWD_CASE(64) SD_BWD_CASE(80) SD_BWD_CASE(96)
  SD_BWD_CASE(128) SD_BWD_CASE(160) {}
#undef SD_BWD_CASE
  if (rc != 0 || dq == nullptr) return rc;

  const int64_t n = int64_t(B) * N * H * D;
  const int64_t cast_blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  cast_kernel<T><<<unsigned(cast_blocks), 256, 0, stream>>>(dq_acc, static_cast<T*>(dq), n);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D <= 160. `strides` holds 15 element
// strides: (batch, token, head) of q, k, v, o and do in that order. `delta`
// is f32 [B, H, N] scratch; `dq_acc` is f32 [B, N, H, D], zeroed by the
// caller; `dq` is null when dq_acc is itself the output (f32), else the bf16
// output. Returns the first nonzero CUDA error code, 0 on success.
int sd_flash_attention_backward(int dtype, const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse, void* delta,
                                void* dq_acc, void* dq, void* dk, void* dv, int B, int H, int N,
                                int M, int D, const long long* strides, float scale,
                                void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || D > 160 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == 0)
    return backward<float>(D, q, k, v, o, dout, l, de, acc, dq, dk, dv, B, H, N, M, strides,
                           scale, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(D, q, k, v, o, dout, l, de, acc, dq, dk, dv, B, H, N, M,
                                   strides, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
