// Flash-attention backward, split form, for Hopper (sm_90a), CUDA C++ with a
// plain C interface.
//
// Replaces the Pallas TPU kernels of stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py
//   K4: `_dq_kernel` and `_dkv_kernel` (`flash_attention_bwd`, the resident
//       split backward the JAX package runs under SD_FLASH_BWD=split), and
//   K5: `_sbwd_stats_kernel`, `_sbwd_dq_kernel` and `_sbwd_dkv_kernel`
//       (`flash_attention_bwd_streaming`, its backward past 9216 padded kv
//       tokens, e.g. the 16384-token self-attention of 1024px training).
// K4 keeps one head's K/V resident in VMEM and K5 streams it in chunks; on
// Hopper no head's K/V is ever resident in shared memory (see
// csrc/flash_attention_bwd.cu), so one kernel set computes what both compute,
// in f32 from the forward's row log-sum-exp (the algebra is in
// flash_attention_bwd_common.cuh):
//   1. stats, `split_delta_kernel`: delta = rowsum(dO * O), one warp per row.
//      The TPU's `_sbwd_stats_kernel` also recomputes the row log-sum-exp,
//      because the JAX forward keeps none; here the forward kernel
//      (csrc/flash_attention.cu) writes lse2 and FlashAttention saves it, so
//      the stats pass is delta alone.
//   2. `split_dq_kernel`: a block owns 64 q rows (its Q and dO tiles stay in
//      shared memory) and loops over all kv tiles of 64 rows; it recomputes S
//      and dP, forms dS and accumulates dQ = scale * dS K in f32 registers,
//      written once at the end. No atomics: K3 adds dQ from every kv block with
//      atomicAdd, whose traffic per head grows as N * M / 64 * D.
//   3. `split_dkv_kernel`: a block owns 64 kv rows and loops over all q tiles
//      (`dkv_body` without its dQ share, the loop K3 runs).
// Every output element is summed by one thread in a fixed order, so two
// launches on the same inputs give bit-identical dQ, dK and dV.
//
// What bounds it on this card: seven products of 2*N*M*D FLOPs (S and dP in
// both kernels, then dQ, dK and dV) against O((N+M)*D) bytes: arithmetic, far
// above the ridge. Like K1 and K3, this first version runs them on f32 FMAs
// from shared memory with the 16 x 16 thread layout and 4-row micro-tiles; the
// dq kernel's shared memory holds Q, dO, K and V transposed plus dS (191 KB at
// DP = 160). Tensor cores (wgmma) and TMA are later work.
//
// Layout: q/o/do [B, N, H, D] and k/v [B, M, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous; dq, dk and
// dv are written contiguous [B, L, H, D] in the input dtype; lse and delta are
// f32 [B, H, N].

#include "flash_attention_bwd_common.cuh"

namespace {

template <typename T>
__global__ void split_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                   float* __restrict__ delta, int H, int N, int D,
                                   int64_t o_sb, int64_t o_sn, int64_t o_sh,
                                   int64_t d_sb, int64_t d_sn, int64_t d_sh, int64_t rows) {
  delta_rows<T>(o, dout, delta, H, N, D, o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, rows);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt [DP][LDQ]; Kt, Vt [DP][LDK]; dSs [BQ][LDK]
  return sizeof(float) * (2 * size_t(DP) * LDQ + 2 * size_t(DP) * LDK + size_t(BQ) * LDK);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1) split_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  constexpr int DJ = DP / 16;  // head-dim columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [DP][LDQ]  this block's q rows, transposed
  float* dOt = Qt + DP * LDQ;  // [DP][LDQ]  this block's do rows, transposed
  float* Kt = dOt + DP * LDQ;  // [DP][LDK]  k tile, transposed
  float* Vt = Kt + DP * LDK;   // [DP][LDK]  v tile, transposed
  float* dSs = Vt + DP * LDK;  // [BQ][LDK]  dS of the current kv tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    const bool ok = (q0 + r < N) && (d < D);
    Qt[d * LDQ + r] = ok ? to_f32(qb[int64_t(q0 + r) * q_sn + d]) : 0.f;
    dOt[d * LDQ + r] = ok ? to_f32(db[int64_t(q0 + r) * d_sn + d]) : 0.f;
  }
  float lr[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lr[i] = r < N ? lse_bh[r] : INFINITY;  // rows past N: P = 0
    dl[i] = r < N ? delta_bh[r] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // Qt/dOt are written; the previous tile's reads of Kt/dSs are done
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int c = idx / DP, d = idx % DP;
      const bool ok = (k0 + c < M) && (d < D);
      Kt[d * LDK + c] = ok ? to_f32(kb[int64_t(k0 + c) * k_sm + d]) : 0.f;
      Vt[d * LDK + c] = ok ? to_f32(vb[int64_t(k0 + c) * v_sm + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: q rows ty*4+i, kv columns tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDQ + ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&dOt[d * LDQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LDK + tx * 4]);
      const float4 e = *reinterpret_cast<const float4*>(&Vt[d * LDK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], cv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], ev[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx * 4 + j < M) ? exp2f(s[i][j] * scale_log2 - lr[i]) : 0.f;
        dp[i][j] = p * (dp[i][j] - dl[i]);  // dS
      }
      *reinterpret_cast<float4*>(&dSs[(ty * 4 + i) * LDK + tx * 4]) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();

    // dQ += dS K: q rows ty*4+i, head-dim columns tx+16j; masked kv columns
    // hold dS = 0 and K = 0
    for (int c = 0; c < BK; c += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * LDK + c]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&Kt[(tx + 16 * j) * LDK + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] = fmaf(a[i].x, kk.x, fmaf(a[i].y, kk.y, fmaf(a[i].z, kk.z, fmaf(a[i].w, kk.w, acc[i][j]))));
      }
    }
  }

  const int64_t row_stride = int64_t(H) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= N) continue;
    T* out = dq + (int64_t(b) * N + r) * row_stride + int64_t(h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1) split_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  dkv_body<T, DP, false>(smem, q, k, v, dout, lse, delta, nullptr, dk, dv, H, N, M, D, q_sb,
                         q_sn, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, d_sb, d_sn, d_sh,
                         scale, scale_log2);
}

template <typename T, int DP>
int launch_split(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dq, void* dk, void* dv, int B, int H, int N, int M,
                 int D, const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t dq_smem = dq_smem_bytes<DP>();
  constexpr size_t dkv_smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      split_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(
      split_dkv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dkv_smem));
  if (err != cudaSuccess) return int(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const float scale_log2 = scale * 1.4426950408889634f;
  split_dq_kernel<T, DP><<<dim3((N + BQ - 1) / BQ, H, B), NT, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), H, N, M, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_dkv_kernel<T, DP><<<dim3((M + BK - 1) / BK, H, B), NT, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, N, M, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale_log2);
  return int(cudaGetLastError());
}

template <typename T>
int backward_split(int D, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int N, int M, const long long* st, float scale,
                   cudaStream_t stream) {
  const int64_t rows = int64_t(B) * H * N;
  const int64_t blocks = (rows * 32 + 255) / 256;
  split_delta_kernel<T><<<unsigned(blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, N, D, st[9], st[10],
      st[11], st[12], st[13], st[14], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
#define SD_SPLIT_CASE(DP)                                                                    \
  if (D <= DP)                                                                               \
    return launch_split<T, DP>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, st,     \
                               scale, stream);
  SD_SPLIT_CASE(32) SD_SPLIT_CASE(48) SD_SPLIT_CASE(64) SD_SPLIT_CASE(80) SD_SPLIT_CASE(96)
  SD_SPLIT_CASE(128) SD_SPLIT_CASE(160)
#undef SD_SPLIT_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D <= 160. `strides` holds 15 element
// strides: (batch, token, head) of q, k, v, o and do in that order. `delta` is
// f32 [B, H, N] scratch; dq, dk and dv are the contiguous outputs. Returns the
// first nonzero CUDA error code, 0 on success.
int sd_flash_attention_backward_split(int dtype, const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B, int H,
                                      int N, int M, int D, const long long* strides, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || D > 160 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  if (dtype == 0)
    return backward_split<float>(D, q, k, v, o, dout, l, de, dq, dk, dv, B, H, N, M, strides,
                                 scale, s);
  if (dtype == 1)
    return backward_split<__nv_bfloat16>(D, q, k, v, o, dout, l, de, dq, dk, dv, B, H, N, M,
                                         strides, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
