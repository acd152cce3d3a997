// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C interface.
//
// Replaces the Pallas TPU kernel stable_diffusion_pytorch_tpu/ops/flash_attention.py
// `_fa_kernel` (resident K/V, one exact softmax per q-block), and covers what
// `_fa_kernel_stream` does for long kv too: here one online-softmax loop over kv
// tiles serves every kv length, so there is no resident/streaming split.
//
// Computes, for each (batch, head):  O = softmax(Q K^T * scale) V
//   - scores, the running max/normalizer and the output accumulator are f32;
//   - kv columns at or past the true length M are masked (M = 77 for
//     cross-attention is not a tile multiple);
//   - P is rounded to the value dtype before P.V, as the TPU kernel and the
//     plain path do; the output is written in the input dtype;
//   - optionally the row log-sum-exp, in base-2 units of the scaled scores
//     (lse2 = max + log2(sum), scores taken as s * scale * log2(e)), as f32
//     [B, H, N] for the backward kernel (csrc/flash_attention_bwd.cu).
//
// What bounds it on this card: at the UNet's self-attention shapes
// (N = M = 4096, d_head 40) the work is 4*N*M*D FLOPs against O(N*D) bytes,
// far above the H100's ridge, so it is bound by arithmetic. This first version
// does that arithmetic with f32 FMAs from shared memory (no tensor cores):
// a block owns 64 q rows and streams K/V in BK-row tiles through shared
// memory; each of its 256 threads keeps a 4 x (BK/16) score micro-tile and a
// 4 x (DP/16) slice of the output accumulator in registers, so scores never
// reach device memory and each K/V tile is read once per q block. The q rows'
// softmax statistics live in the registers of the 16 threads that share the
// rows and are reduced with warp shuffles. BK is 64 up to DP = 256; the VAE
// encoder's single 512-wide head takes 16-row kv tiles so that its f32 tiles
// fit the 227 KB of shared memory. Tensor-core MMA (wgmma), TMA and warp
// specialisation are later work.
//
// Layout: q [B, N, H, D], k/v [B, M, H, D], o [B, N, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous. D is padded
// in shared memory to DP (a multiple of 16); loads past D read as 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int NT = 256;   // threads per block, as 16 (rows) x 16 (cols)
constexpr int PAD = 4;    // row padding of the transposed tiles (keeps float4 alignment)
constexpr int LDQ = BQ + PAD;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DP, int BK>
constexpr size_t smem_bytes() {
  // Qt [DP][LDQ] + Kt [DP][BK+PAD] + Vs [BK][DP] + Pt [BK][LDQ], all f32
  return sizeof(float) *
         (size_t(DP) * LDQ + size_t(DP) * (BK + PAD) + size_t(BK) * DP + size_t(BK) * LDQ);
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(NT) fa_forward_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale_log2) {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  static_assert(BK == 64 || BK == 16, "kv tile of 64 or 16 rows");
  constexpr int DJ = DP / 16;   // output columns per thread
  constexpr int CPT = BK / 16;  // score columns per thread
  constexpr int LDK = BK + PAD;

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [DP][LDQ]  q tile, transposed
  float* Kt = Qt + DP * LDQ;        // [DP][LDK]  k tile, transposed
  float* Vs = Kt + DP * LDK;        // [BK][DP]   v tile
  float* Pt = Vs + BK * DP;         // [BK][LDQ]  probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx*CPT..; output columns tx + 16*j
  const int ty = tid >> 4;   // rows ty*4..ty*4+3 (the 16 threads of a row share a half-warp)
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, d = idx % DP;
    float val = 0.f;
    if (q0 + r < N && d < D) val = to_f32(qb[int64_t(q0 + r) * q_sn + d]);
    Qt[d * LDQ + r] = val;
  }

  float acc[4][DJ];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // the previous tile's reads of Kt/Vs/Pt are done
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int c = idx / DP, d = idx % DP;
      const bool ok = (k0 + c < M) && (d < D);
      Kt[d * LDK + c] = ok ? to_f32(kb[int64_t(k0 + c) * k_sm + d]) : 0.f;
      Vs[c * DP + d] = ok ? to_f32(vb[int64_t(k0 + c) * v_sm + d]) : 0.f;
    }
    __syncthreads();

    float s[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDQ + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float cv[CPT];
      if constexpr (CPT == 4) {
        const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LDK + tx * 4]);
        cv[0] = c.x; cv[1] = c.y; cv[2] = c.z; cv[3] = c.w;
      } else {
        cv[0] = Kt[d * LDK + tx];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = (k0 + tx * CPT + j < M) ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds column k0 < M, so m_new is finite
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = exp2f(s[i][j] - m_new);
        rowsum += e;
        p[i][j] = to_f32(from_f32<T>(e));  // P in the value dtype for P.V
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l_i[i] = l_i[i] * alpha + rowsum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * CPT + j) * LDQ + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    const int kn = min(BK, M - k0);
    for (int c = 0; c < kn; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(&Pt[c * LDQ + ty * 4]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * DP + tx + 16 * j];
        acc[0][j] = fmaf(pc.x, vv, acc[0][j]);
        acc[1][j] = fmaf(pc.y, vv, acc[1][j]);
        acc[2][j] = fmaf(pc.z, vv, acc[2][j]);
        acc[3][j] = fmaf(pc.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= N) continue;
    const float inv_l = 1.f / l_i[i];
    T* orow = o + b * o_sb + int64_t(r) * o_sn + h * o_sh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] * inv_l);
    }
    if (lse != nullptr && tx == 0) lse[(int64_t(b) * H + h) * N + r] = m_i[i] + log2f(l_i[i]);
  }
}

template <typename T, int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int N, int M, int D, const long long* st, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + BQ - 1) / BQ, H, B);
  fa_forward_kernel<T, DP, BK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int H, int N, int M, const long long* st, float scale_log2, cudaStream_t stream) {
#define SD_FA_CASE(DP, BK) \
  if (D <= DP) return launch<T, DP, BK>(q, k, v, o, lse, B, H, N, M, D, st, scale_log2, stream);
  SD_FA_CASE(32, 64)
  SD_FA_CASE(48, 64)
  SD_FA_CASE(64, 64)
  SD_FA_CASE(80, 64)
  SD_FA_CASE(96, 64)
  SD_FA_CASE(128, 64)
  SD_FA_CASE(160, 64)
  SD_FA_CASE(192, 64)
  SD_FA_CASE(256, 64)
  SD_FA_CASE(512, 16)
#undef SD_FA_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D <= 512. Strides are in elements. `lse` is
// null or f32 [B, H, N]. Returns the CUDA error code of the launch (0 on
// success); the caller raises on nonzero.
int sd_flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int N, int M, int D,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sm, long long k_sh,
                               long long v_sb, long long v_sm, long long v_sh,
                               long long o_sb, long long o_sn, long long o_sh,
                               float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sm, k_sh,
                            v_sb, v_sm, v_sh, o_sb, o_sn, o_sh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return dispatch<float>(D, q, k, v, o, l, B, H, N, M, st, scale_log2, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, l, B, H, N, M, st, scale_log2, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
