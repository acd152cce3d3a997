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
// Hopper no head's K/V is ever resident in shared memory, so one kernel set
// computes what both compute, from the forward's row log-sum-exp (the algebra
// is in flash_attention_bwd_common.cuh):
//   1. stats, delta. The TPU's `_sbwd_stats_kernel` also recomputes the row
//      log-sum-exp, because the JAX forward keeps none; here the forward
//      kernel (csrc/flash_attention.cu) writes lse2 and FlashAttention saves
//      it, so the stats pass is delta alone. In bfloat16,
//      `bwd_stats_wgmma_kernel` sums P * dP in f32 as the TPU kernels do,
//      recomputing S and dP on the tensor cores with the dQ kernel's tiling
//      (two products of 2*N*M*D FLOPs; `launch_bwd_stats_bf16`, which K3
//      runs too). The stored bf16 O carries the forward's roundings, and
//      where keys share a large component rowsum(dO * O) from it moved dQ
//      by 0.12-0.17 of its scale. In float32, whose O is exact to f32
//      rounding, `split_delta_kernel`: delta = rowsum(dO * O), one warp per row.
//   2. a q-outer dQ kernel: a block owns 64 q rows and loops over all kv
//      tiles; it recomputes S and dP, forms dS and accumulates dQ = scale *
//      dS K in f32 registers, written once at the end. No atomics.
//   3. a kv-outer dK/dV kernel: a block owns 64 kv rows and loops over all q
//      tiles, accumulating dV = P^T dO and dK = scale * dS^T Q.
// Every output element is summed by one thread in a fixed order, so two
// launches on the same inputs give bit-identical dQ, dK and dV.
//
// What bounds it on this card: seven products of 2*N*M*D FLOPs (S and dP in
// both kernels, then dQ, dK and dV; nine with the bf16 stats pass) against
// O((N+M)*D) bytes: arithmetic, far above the ridge, with 2*N*M
// exponentials beside them (3*N*M in bf16).
//
// bfloat16, `split_dq_wgmma_kernel` and `split_dkv_wgmma_kernel`, on the
// tensor cores (the building blocks are in attention_sm90.cuh). Each block
// has two consumer warpgroups of 64 rows of the outer dimension that share the
// streamed tiles (K and V in the dQ kernel; Q, dO and their lse and delta in
// the dK/dV kernel), which run through a ring of two shared-memory stages
// filled by cp.async, the next tile's copy in flight during this tile's
// products.
//   - dQ kernel: S = Q K^T and dP = dO V^T on wgmma with both operands in
//     shared memory; P = exp2(S * scale * log2(e) - lse2) and dS = P * (dP -
//     delta) in f32 registers; dS rounded to bf16 (the TPU kernels'
//     `t.astype(k.dtype)`) becomes the register A operand of dQ += dS K, K read
//     MN-major from the same tile.
//   - dK/dV kernel: it computes S^T = K Q^T and dP^T = V dO^T directly (its
//     own K and V rows as the A operands), so P^T and dS^T come out in the
//     accumulator layout with kv rows: rounded to bf16 (`p.astype(v.dtype)`,
//     `t.astype(q.dtype)`) they are the register A operands of dV += P^T dO
//     and dK += dS^T Q, dO and Q read MN-major. No transpose pass anywhere.
//   - At DP = 128 and 160 the f32 dK and dV accumulators of 64 kv rows would
//     take 160 registers a thread, so the dK/dV kernel's two warpgroups split
//     the head dim of one 64-row kv tile instead, each recomputing S^T and
//     dP^T (cheaper than an exchange through shared memory with a barrier per
//     tile), with 32-row q tiles; the dQ kernel takes 32-row kv tiles and
//     one warpgroup per block there. Shared memory stays at or under 81 KB
//     at every DP up to 160, so two blocks fit an SM where registers allow.
//   - DP = 512 (the VAE's single head): a [64 x 512] bf16 operand tile is 64
//     KB, so every kernel keeps one 64-row tile of its outer operands resident
//     (Q and dO, or K and V: 128 KB) and streams 16-row tiles of the others
//     through the two stages (192 KB in all, one block an SM), S and dP on
//     m64n16 products. The f32 accumulators are split by columns: the dQ
//     kernel's two warpgroups take 256 dQ columns each, and the dK/dV kernel
//     runs two blocks per 64 kv rows, each of two warpgroups taking 128
//     columns of dK and dV (64 + 64 accumulator registers a thread). Every
//     warpgroup recomputes S and dP over the whole head dim for its columns
//     (as the forward does at D 512): the dQ kernel does its two score
//     products twice, the dK/dV kernel four times: 34 N M D FLOPs with the
//     stats pass where one pass over the columns would take 18. Not made
//     fast yet: the 16-row tiles and the redundant score products.
//
// float32 keeps the FMA kernels, `split_dq_kernel` and `split_dkv_kernel`
// (`dkv_body`, the loop K3 runs): the f32 parity checks (1e-4 against the
// plain version, the UNet's and the VAE's gradients on the card against the
// CPU) need full f32 products; TF32 keeps about three decimal digits. They
// use the 16 x 16 thread layout and 4-row micro-tiles with Q, dO, K and V
// transposed in shared memory (191 KB at DP = 160, one block per SM). At DP
// = 512 each block takes 128 output columns and sums S and dP over 128-column
// chunks (flash_attention_bwd_common.cuh), four blocks per 64 rows: 38 N M D
// FLOPs where one block per 64 rows would do 14.
//
// Layout: q/o/do [B, N, H, D] and k/v [B, M, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous; dq, dk and
// dv are written contiguous [B, L, H, D] in the input dtype; lse and delta are
// f32 [B, H, N].

#include "flash_attention_bwd_common.cuh"
#include "attention_sm90.cuh"

namespace {

template <typename T>
__global__ void split_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                   float* __restrict__ delta, int H, int N, int D,
                                   int64_t o_sb, int64_t o_sn, int64_t o_sh,
                                   int64_t d_sb, int64_t d_sn, int64_t d_sh, int64_t rows) {
  delta_rows<T>(o, dout, delta, H, N, D, o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, rows);
}

template <int CH>
constexpr size_t dq_smem_bytes() {
  // Qt, dOt [CH][LDQ]; Kt, Vt [CH][LDK]; dSs [BQ][LDK]
  return sizeof(float) * (2 * size_t(CH) * LDQ + 2 * size_t(CH) * LDK + size_t(BQ) * LDK);
}

// dQ for 64 q rows and CH of its columns (part blockIdx.x % (DP / CH), the
// parts fastest), S and dP summed over the head dim in CH-column chunks
// (flash_attention_bwd_common.cuh); CH = DP: one part, Q and dO resident.
template <typename T, int DP, int CH>
__global__ void __launch_bounds__(NT, 1) split_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  static_assert(CH % 16 == 0 && DP % CH == 0, "chunks of 16-column multiples");
  constexpr int NCH = DP / CH;  // column parts, one a block
  constexpr int DJ = CH / 16;   // head-dim columns per thread

  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [CH][LDQ]  this block's q rows, transposed (one chunk)
  float* dOt = Qt + CH * LDQ;  // [CH][LDQ]  this block's do rows, transposed
  float* Kt = dOt + CH * LDQ;  // [CH][LDK]  k tile, transposed
  float* Vt = Kt + CH * LDK;   // [CH][LDK]  v tile, transposed
  float* dSs = Vt + CH * LDK;  // [BQ][LDK]  dS of the current kv tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int part = blockIdx.x % NCH;
  const int q0 = blockIdx.x / NCH * BQ;
  const int c0 = part * CH;  // this block's output columns c0..c0+CH
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh + q0 * q_sn;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* db = dout + b * d_sb + h * d_sh + q0 * d_sn;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;

  if constexpr (NCH == 1) {  // Q and dO stay resident
    load_chunk_t<T, BQ, CH, LDQ>(Qt, qb, q_sn, N - q0, 0, D);
    load_chunk_t<T, BQ, CH, LDQ>(dOt, db, d_sn, N - q0, 0, D);
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
    // S = Q K^T and dP = dO V^T over the whole head dim: q rows ty*4+i, kv
    // columns tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ci = 0; ci < NCH; ++ci) {
      const int c = (part + 1 + ci) % NCH;  // this block's own chunk last
      __syncthreads();  // the previous reads of the tiles are done
      if constexpr (NCH > 1) {
        load_chunk_t<T, BQ, CH, LDQ>(Qt, qb, q_sn, N - q0, c * CH, D);
        load_chunk_t<T, BQ, CH, LDQ>(dOt, db, d_sn, N - q0, c * CH, D);
      }
      load_chunk_t<T, BK, CH, LDK>(Kt, kb + int64_t(k0) * k_sm, k_sm, M - k0, c * CH, D);
      load_chunk_t<T, BK, CH, LDK>(Vt, vb + int64_t(k0) * v_sm, v_sm, M - k0, c * CH, D);
      __syncthreads();
      score_chunk<CH>(s, dp, Qt, dOt, Kt, Vt, tx, ty);
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

    // dQ += dS K on this block's columns: q rows ty*4+i, columns c0 +
    // tx+16j; masked kv columns hold dS = 0 and K = 0
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
    T* out = dq + (int64_t(b) * N + r) * row_stride + int64_t(h) * D + c0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (c0 + d < D) out[d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int DP, int CH>
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
  dkv_body<T, DP, false, CH>(smem, q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, H, N, M, D,
                             q_sb, q_sn, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, d_sb, d_sn, d_sh,
                             scale, scale_log2);
}

template <typename T, int DP, int CH>
int launch_split(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dq, void* dk, void* dv, int B, int H, int N, int M,
                 int D, const long long* st, float scale, cudaStream_t stream, int* impl) {
  constexpr size_t dq_smem = dq_smem_bytes<CH>();
  constexpr size_t dkv_smem = dkv_smem_bytes<CH>();
  constexpr int parts = DP / CH;
  cudaError_t err = cudaFuncSetAttribute(
      split_dq_kernel<T, DP, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(
      split_dkv_kernel<T, DP, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dkv_smem));
  if (err != cudaSuccess) return int(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const float scale_log2 = scale * 1.4426950408889634f;
  split_dq_kernel<T, DP, CH><<<dim3((N + BQ - 1) / BQ * parts, H, B), NT, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), H, N, M, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_dkv_kernel<T, DP, CH><<<dim3((M + BK - 1) / BK * parts, H, B), NT, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, N, M, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale_log2);
  err = cudaGetLastError();
  if (err == cudaSuccess) *impl = 0;
  return int(err);
}

template <typename T>
int backward_split(int D, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int N, int M, const long long* st, float scale,
                   cudaStream_t stream, int* impl) {
  const int64_t rows = int64_t(B) * H * N;
  const int64_t blocks = (rows * 32 + 255) / 256;
  split_delta_kernel<T><<<unsigned(blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, N, D, st[9], st[10],
      st[11], st[12], st[13], st[14], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  // (DP, column chunk)
#define SD_SPLIT_CASE(DP, CH)                                                                    \
  if (D <= DP)                                                                                   \
    return launch_split<T, DP, CH>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, st,     \
                                   scale, stream, impl);
  SD_SPLIT_CASE(32, 32) SD_SPLIT_CASE(48, 48) SD_SPLIT_CASE(64, 64) SD_SPLIT_CASE(80, 80)
  SD_SPLIT_CASE(96, 96) SD_SPLIT_CASE(128, 128) SD_SPLIT_CASE(160, 160) SD_SPLIT_CASE(512, 128)
#undef SD_SPLIT_CASE
  return int(cudaErrorInvalidValue);
}

// ---- bfloat16: tensor cores ------------------------------------------------

using sd_sm90::bf16;

// The q-outer loop over all kv tiles of BKV rows, for 64 * WGR q rows of one
// (batch, head); WGR x WGC warpgroups, (wr, wc) owning q rows 64 wr.. and DP
// / WGC columns of dQ, all sharing the K and V tiles (each of a row's WGC
// warpgroups computes the same S and dP). STATS: the stats pass, delta =
// rowsum(P * dP) in f32 registers, written to `delta` (WGC = 1). Otherwise
// the dQ kernel: dQ = scale * dS K, with `delta` read.
template <int DP, int BKV, int WGR, int WGC, bool STATS>
__device__ __forceinline__ void dq_wgmma_body(
    uint8_t* smem_tc,
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2, int vec) {
  using namespace sd_sm90;
  static_assert(DP % 16 == 0 && BKV % 16 == 0 && DP % (16 * WGC) == 0 && (!STATS || WGC == 1),
                "tile widths");
  constexpr int BQ = 64 * WGR;
  constexpr int NT = 128 * WGR * WGC;
  constexpr int DS = DP / WGC;  // dQ columns of a warpgroup
  constexpr uint32_t KV_TILE = BKV * DP * 2;

  const uint32_t sQ = smem_u32(smem_tc);
  const uint32_t sdO = sQ + BQ * DP * 2;
  const uint32_t sK = sdO + BQ * DP * 2;  // stage s at sK + s * KV_TILE
  const uint32_t sV = sK + 2 * KV_TILE;

  const int tid = threadIdx.x;
  const int wr = (tid >> 7) / WGC;
  const int wc = (tid >> 7) % WGC;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const bf16* db = dout + b * d_sb + h * d_sh;

  const TileCopy<BKV, DP, NT> k_copy(k_sm, D, tid), v_copy(v_sm, D, tid);
  TileCopy<BQ, DP, NT>(q_sn, D, tid).copy(sQ, qb + q0 * q_sn, N - q0, tid, vec);
  TileCopy<BQ, DP, NT>(d_sn, D, tid).copy(sdO, db + q0 * d_sn, N - q0, tid, vec);
  k_copy.copy(sK, kb, M, tid, vec);
  v_copy.copy(sV, vb, M, tid, vec);
  cp_async_commit();

  const int row0 = q0 + 64 * wr + 16 * warp + (lane >> 2);
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  float* delta_bh = delta + (int64_t(b) * H + h) * N;
  float neg_lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    neg_lse[r] = row < N ? -lse_bh[row] : -INFINITY;  // rows past N: P = 0
    dl[r] = (STATS || row >= N) ? 0.f : delta_bh[row];  // STATS: the running sum
  }

  constexpr int ACC = STATS ? 1 : DS / 2;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const uint64_t q_desc = desc_k_major<DP>(sQ) + wr * 8 * DP;  // rows 64 wr..
  const uint64_t do_desc = desc_k_major<DP>(sdO) + wr * 8 * DP;
  const int n_tiles = (M + BKV - 1) / BKV;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int r0 = (j + 1) * BKV;
      k_copy.copy(sK + (st ^ 1) * KV_TILE, kb + r0 * k_sm, M - r0, tid, vec);
      v_copy.copy(sV + (st ^ 1) * KV_TILE, vb + r0 * v_sm, M - r0, tid, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, [64 x BKV] in f32
    float s[BKV / 2], dp[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = dp[i] = 0.f;
    const uint64_t k_desc = desc_k_major<DP>(sK + st * KV_TILE);
    const uint64_t v_desc = desc_k_major<DP>(sV + st * KV_TILE);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BKV>::ss(s, q_desc + 16 * kk, k_desc + 16 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BKV>::ss(dp, do_desc + 16 * kk, v_desc + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = (j + 1) * BKV > M;
    if constexpr (STATS) {
      // delta += P * dP, P in f32 (the TPU kernels' sum); a fixed order per row
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int r = frag_row_half(i);
        float p = exp2_ftz(fmaf(s[i], scale_log2, neg_lse[r]));
        if (edge && j * BKV + frag_col(i, lane) >= M) p = 0.f;
        dl[r] = fmaf(p, dp[i], dl[r]);
      }
      __syncthreads();
      continue;
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int r = frag_row_half(i);
        float p = exp2_ftz(fmaf(s[i], scale_log2, neg_lse[r]));
        if (edge && j * BKV + frag_col(i, lane) >= M) p = 0.f;
        s[i] = p * (dp[i] - dl[r]);  // dS
      }
      uint32_t da[BKV / 16][4];
      to_a_frag(s, da);  // dS in bf16 before dS K

      // dQ += dS K: K read MN-major (its rows are the product's depth), this
      // warpgroup's DS columns
      const uint64_t kt_desc = desc_mn_major<DP>(sK + st * KV_TILE) + wc * DS;
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) Wgmma<DS>::rs(acc, da[kk], kt_desc + 2 * DP * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();
    }
  }

  if constexpr (STATS) {
    // the four lanes of a row hold its partial sums over their columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float total = quad_sum(dl[r]);
      const int row = row0 + 8 * r;
      if ((lane & 3) == 0 && row < N) delta_bh[row] = total;
    }
  } else {
    const int64_t row_stride = int64_t(H) * D;
#pragma unroll
    for (int i = 0; i < DS / 2; i += 2) {
      const int row = row0 + 8 * frag_row_half(i);
      const int col = wc * DS + frag_col(i, lane);
      if (row < N && col < D)
        store_bf16_pair(dq + (int64_t(b) * N + row) * row_stride + int64_t(h) * D + col,
                        acc[i] * scale, acc[i + 1] * scale, col + 1 < D);
    }
  }
}

template <int DP, int BKV, int WGR>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO [64 * WGR][DP] + K, V [2 stages][BKV][DP], bf16
  return 2 * (2 * size_t(64) * WGR * DP + 4 * size_t(BKV) * DP);
}

#define SD_DQ_WGMMA_PARAMS                                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,        \
      const bf16 *__restrict__ dout, const float *__restrict__ lse, float *__restrict__ delta, \
      bf16 *__restrict__ dq, int H, int N, int M, int D, int64_t q_sb, int64_t q_sn,          \
      int64_t q_sh, int64_t k_sb, int64_t k_sm, int64_t k_sh, int64_t v_sb, int64_t v_sm,     \
      int64_t v_sh, int64_t d_sb, int64_t d_sn, int64_t d_sh, float scale, float scale_log2,  \
      int vec
#define SD_DQ_WGMMA_ARGS                                                                    \
  q, k, v, dout, lse, delta, dq, H, N, M, D, q_sb, q_sn, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, \
      v_sh, d_sb, d_sn, d_sh, scale, scale_log2, vec

// dQ for 64 * WGR q rows (the split set's dQ kernel)
template <int DP, int BKV, int WGR, int WGC>
__global__ void __launch_bounds__(128 * WGR * WGC) split_dq_wgmma_kernel(SD_DQ_WGMMA_PARAMS) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  dq_wgmma_body<DP, BKV, WGR, WGC, false>(smem_tc, SD_DQ_WGMMA_ARGS);
}

// delta = rowsum(P * dP) for 64 * WGR q rows (the bf16 stats pass of both
// backward routes; `dq` unused)
template <int DP, int BKV, int WGR>
__global__ void __launch_bounds__(128 * WGR) bwd_stats_wgmma_kernel(SD_DQ_WGMMA_PARAMS) {
  extern __shared__ __align__(128) uint8_t smem_tc[];
  dq_wgmma_body<DP, BKV, WGR, 1, true>(smem_tc, SD_DQ_WGMMA_ARGS);
}

template <int DP, int BQT, int WGR, int NPART = 1, bool WITH_DQ = false>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V [64 * WGR][DP] + Q, dO [2 stages][BQT][DP], bf16; lse, delta [2 stages][BQT], f32;
  // WITH_DQ: dS^T [64 * WGR][BQT] bf16 and the dQ share [BQT][DP / NPART + 4] f32
  return 2 * (2 * size_t(64) * WGR * DP + 4 * size_t(BQT) * DP) + 4 * 4 * size_t(BQT) +
         (WITH_DQ ? 2 * size_t(64) * WGR * BQT + 4 * size_t(BQT) * (DP / NPART + 4) : 0);
}

// dK and dV for 64 * WGR kv rows of one (batch, head) and DP / NPART of their
// columns (part blockIdx.x % NPART, the parts fastest), over all q tiles of
// BQT rows; WGR x WGC warpgroups, (wr, wc) owning kv rows 64 wr.. and DS =
// DP / (NPART * WGC) columns of both, all sharing the Q and dO tiles (each
// computes S^T and dP^T over the whole head dim for its columns).
// WITH_DQ (K3's bfloat16 kernel past D 160, WGR = 1): also the block's share
// of dQ on its part's columns, dQ^T = K^T dS^T (K and dS^T both read
// MN-major, so the product's 64 rows are head-dim columns and its N the
// BQT q rows), each warpgroup DS columns; staged in shared memory and added
// to the f32 buffer `dq_acc` at the block's turn, in kv-block order, under
// one counter per (batch, head, q tile of BQT, part) in `dq_sem` (the
// ordered adds of flash_attention_bwd_common.cuh).
template <int DP, int BQT, int WGR, int WGC, int NPART, bool WITH_DQ = false>
__global__ void __launch_bounds__(128 * WGR * WGC) split_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, int* __restrict__ dq_sem,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2, int vec) {
  using namespace sd_sm90;
  static_assert(DP % (16 * WGC * NPART) == 0 && BQT % 16 == 0 && 2 * BQT <= 128 * WGR * WGC,
                "tile widths");
  static_assert(!WITH_DQ || (WGR == 1 && DP % (64 * WGC * NPART) == 0), "dQ share tiles of 64 columns");
  constexpr int BKV = 64 * WGR;
  constexpr int NT = 128 * WGR * WGC;
  constexpr int DS = DP / (WGC * NPART);
  constexpr int DPART = DP / NPART;  // the columns of a block
  constexpr int LDS = DPART + 4;     // f32 row stride of the staged dQ share
  constexpr uint32_t Q_TILE = BQT * DP * 2;

  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sK = smem_u32(smem_tc);
  const uint32_t sV = sK + BKV * DP * 2;
  const uint32_t sQ = sV + BKV * DP * 2;     // stage s at sQ + s * Q_TILE
  const uint32_t sdO = sQ + 2 * Q_TILE;
  const uint32_t sDS = sdO + 2 * Q_TILE;     // WITH_DQ: dS^T [BKV kv rows][BQT q columns] bf16
  const uint32_t sStat = sDS + (WITH_DQ ? BKV * BQT * 2 : 0);  // [2 stages][lse BQT, delta BQT] f32
  const float* stat = reinterpret_cast<const float*>(smem_tc + (sStat - sK));
  float* shares = reinterpret_cast<float*>(smem_tc + (sStat - sK) + 4 * 4 * BQT);  // [BQT][LDS]

  const int tid = threadIdx.x;
  const int wr = (tid >> 7) / WGC;
  const int wcl = (tid >> 7) % WGC;
  const int part = blockIdx.x % NPART;
  const int wc = wcl + part * WGC;  // this warpgroup's column slice
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kvb = blockIdx.x / NPART;  // the kv block: the order of the dQ adds
  const int kv0 = kvb * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const bf16* db = dout + b * d_sb + h * d_sh;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;

  const TileCopy<BQT, DP, NT> q_copy(q_sn, D, tid), do_copy(d_sn, D, tid);
  auto load_q_tile = [&](int j, int st) {
    const int r0 = j * BQT;
    q_copy.copy(sQ + st * Q_TILE, qb + r0 * q_sn, N - r0, tid, vec);
    do_copy.copy(sdO + st * Q_TILE, db + r0 * d_sn, N - r0, tid, vec);
    if (tid < 2 * BQT) {
      const int row = j * BQT + (tid % BQT);
      const bool ok = row < N;
      const float* src = tid < BQT ? lse_bh : delta_bh;
      cp_async4(sStat + (st * 2 * BQT + tid) * 4, ok ? src + row : src, ok);
    }
  };

  TileCopy<BKV, DP, NT>(k_sm, D, tid).copy(sK, kb + kv0 * k_sm, M - kv0, tid, vec);
  TileCopy<BKV, DP, NT>(v_sm, D, tid).copy(sV, vb + kv0 * v_sm, M - kv0, tid, vec);
  load_q_tile(0, 0);
  cp_async_commit();

  float acc_k[DS / 2], acc_v[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint64_t k_desc = desc_k_major<DP>(sK) + wr * 8 * DP;  // kv rows 64 wr..
  const uint64_t v_desc = desc_k_major<DP>(sV) + wr * 8 * DP;
  const int n_tiles = (N + BQT - 1) / BQT;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, [64 kv x BQT q] in f32
    float s[BQT / 2], dp[BQT / 2];
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) s[i] = dp[i] = 0.f;
    const uint64_t q_desc = desc_k_major<DP>(sQ + st * Q_TILE);
    const uint64_t do_desc = desc_k_major<DP>(sdO + st * Q_TILE);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BQT>::ss(s, k_desc + 16 * kk, q_desc + 16 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BQT>::ss(dp, v_desc + 16 * kk, do_desc + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T; the columns are q rows, their lse and delta in shared memory
    const float* lse_t = stat + st * 2 * BQT;
    const float* delta_t = lse_t + BQT;
    const bool edge = (j + 1) * BQT > N;
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) {
      const int c = frag_col(i, lane);
      float p = exp2_ftz(fmaf(s[i], scale_log2, -lse_t[c]));
      if (edge && j * BQT + c >= N) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - delta_t[c]);
    }
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
    to_a_frag(s, pa);   // P^T in bf16 before P^T dO
    to_a_frag(dp, da);  // dS^T in bf16 before dS^T Q (and K^T dS^T)

    if constexpr (WITH_DQ) {
      // dS^T to shared memory in the core-matrix tiling of BQT columns:
      // da[kk][r] holds kv row 16 warp + lane/4 + 8 (r % 2) and the q columns
      // 16 kk + 8 (r / 2) + 2 (lane % 4) and the next, one 4-byte word; the
      // block's warpgroups hold the same values, the first writes them
      if (wcl == 0) {
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 16 * warp + (lane >> 2) + 8 * (r & 1);
            const int col = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
            const uint32_t addr =
                sDS + ((row >> 3) * (BQT / 8) + (col >> 3)) * 128 + (row & 7) * 16 + (col & 7) * 2;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(da[kk][r]) : "memory");
          }
        fence_proxy_async();
      }
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major, this warpgroup's DS columns
    const uint64_t dot_desc = desc_mn_major<DP>(sdO + st * Q_TILE) + wc * DS;
    const uint64_t qt_desc = desc_mn_major<DP>(sQ + st * Q_TILE) + wc * DS;
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) Wgmma<DS>::rs(acc_v, pa[kk], dot_desc + 2 * DP * kk, 1);
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) Wgmma<DS>::rs(acc_k, da[kk], qt_desc + 2 * DP * kk, 1);
    wgmma_commit();

    if constexpr (WITH_DQ) {
      __syncthreads();  // the whole dS^T tile is in shared memory
      // this warpgroup's DS columns of the share, transposed: DS / 64 tiles
      // of [64 head-dim columns x BQT q rows] over the block's BKV kv rows
      float dqs[DS / 64][BQT / 2];
      const uint64_t ds_desc = desc_mn_major<BQT>(sDS);
      const uint64_t kt_desc = desc_mn_major<DP>(sK) + wc * DS;
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt) {
#pragma unroll
        for (int i = 0; i < BQT / 2; ++i) dqs[mt][i] = 0.f;
        fence_regs(dqs[mt]);
      }
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt)
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          WgmmaTT<BQT>::ss(dqs[mt], kt_desc + 64 * mt + 2 * DP * kk, ds_desc + 2 * BQT * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      // pa and da stay live until here: the dV/dK products read them asynchronously
      fence_regs(pa);
      fence_regs(da);
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt) {
        fence_regs(dqs[mt]);
#pragma unroll
        for (int i = 0; i < BQT / 2; ++i) {
          const int col = wcl * DS + 64 * mt + 16 * warp + (lane >> 2) + 8 * frag_row_half(i);
          shares[frag_col(i, lane) * LDS + col] = dqs[mt][i] * scale;
        }
      }
      // at this block's turn, the share added to dQ's f32 buffer on the part's columns
      int* sem = dq_sem + ((int64_t(b) * H + h) * n_tiles + j) * NPART + part;
      wait_turn(sem, kvb);  // its barrier also orders the shares' writes
      const int rows = min(BQT, N - j * BQT);
      const int cols = min(DPART, D - part * DPART);
      float* out = dq_acc + (int64_t(b) * N + j * BQT) * int64_t(H) * D + int64_t(h) * D + part * DPART;
      for (int i = tid; i < rows * cols; i += NT) {
        const int r = i / cols, c = i % cols;
        ordered_add(out + r * int64_t(H) * D + c, shares[r * LDS + c], kvb == 0);
      }
      pass_turn(sem, kvb + 1);  // its barrier also ends the tile
    } else {
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncthreads();
    }
  }

  const int row0 = kv0 + 64 * wr + 16 * warp + (lane >> 2);
  const int64_t row_stride = int64_t(H) * D;
#pragma unroll
  for (int i = 0; i < DS / 2; i += 2) {
    const int row = row0 + 8 * frag_row_half(i);
    const int col = wc * DS + frag_col(i, lane);
    if (row < M && col < D) {
      const int64_t off = (int64_t(b) * M + row) * row_stride + int64_t(h) * D + col;
      store_bf16_pair(dk + off, acc_k[i] * scale, acc_k[i + 1] * scale, col + 1 < D);
      store_bf16_pair(dv + off, acc_v[i], acc_v[i + 1], col + 1 < D);
    }
  }
}

template <int DP, int BKV, int QWGR, int QWGC, int BQT, int KVWGR, int WGC, int NPART>
int launch_split_wgmma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int N, int M, int D, const long long* st, float scale,
                       cudaStream_t stream, int* impl) {
  constexpr size_t dq_smem = dq_wgmma_smem_bytes<DP, BKV, QWGR>();
  constexpr size_t dkv_smem = dkv_wgmma_smem_bytes<DP, BQT, KVWGR>();
  cudaError_t err = cudaFuncSetAttribute(split_dq_wgmma_kernel<DP, BKV, QWGR, QWGC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(dq_smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(split_dkv_wgmma_kernel<DP, BQT, KVWGR, WGC, NPART>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dkv_smem));
  if (err != cudaSuccess) return int(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int vec = sd_sm90::rows_aligned(q, B, N, H, st[0], st[1], st[2]) &&
                  sd_sm90::rows_aligned(k, B, M, H, st[3], st[4], st[5]) &&
                  sd_sm90::rows_aligned(v, B, M, H, st[6], st[7], st[8]) &&
                  sd_sm90::rows_aligned(dout, B, N, H, st[12], st[13], st[14]);
  split_dq_wgmma_kernel<DP, BKV, QWGR, QWGC>
      <<<dim3((N + 64 * QWGR - 1) / (64 * QWGR), H, B), 128 * QWGR * QWGC, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, const_cast<float*>(delta), static_cast<bf16*>(dq), H, N, M, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale_log2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  split_dkv_wgmma_kernel<DP, BQT, KVWGR, WGC, NPART>
      <<<dim3((M + 64 * KVWGR - 1) / (64 * KVWGR) * NPART, H, B), 128 * KVWGR * WGC, dkv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, nullptr, nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
      N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14],
      scale, scale_log2, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) *impl = 1;
  return int(err);
}

template <int DP, int BKV, int WGR>
int launch_stats(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 float* delta, int B, int H, int N, int M, int D, const long long* st,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_wgmma_smem_bytes<DP, BKV, WGR>();
  cudaError_t err = cudaFuncSetAttribute(bwd_stats_wgmma_kernel<DP, BKV, WGR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int vec = sd_sm90::rows_aligned(q, B, N, H, st[0], st[1], st[2]) &&
                  sd_sm90::rows_aligned(k, B, M, H, st[3], st[4], st[5]) &&
                  sd_sm90::rows_aligned(v, B, M, H, st[6], st[7], st[8]) &&
                  sd_sm90::rows_aligned(dout, B, N, H, st[12], st[13], st[14]);
  bwd_stats_wgmma_kernel<DP, BKV, WGR>
      <<<dim3((N + 64 * WGR - 1) / (64 * WGR), H, B), 128 * WGR, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, nullptr, H, N, M, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale * 1.4426950408889634f, vec);
  return int(cudaGetLastError());
}

}  // namespace

// The bf16 stats pass (declared in flash_attention_bwd_common.cuh): the dQ
// kernel's tiling and loop, two products per tile (S and dP) and no third.
int launch_bwd_stats_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, float* delta, int B, int H, int N, int M, int D,
                          const long long* st, float scale, cudaStream_t stream) {
#define SD_STATS_CASE(DP, BKV, WGR) \
  if (D <= DP) return launch_stats<DP, BKV, WGR>(q, k, v, dout, lse, delta, B, H, N, M, D, st, scale, stream);
  SD_STATS_CASE(32, 64, 2) SD_STATS_CASE(48, 64, 2) SD_STATS_CASE(64, 64, 2)
  SD_STATS_CASE(80, 64, 2) SD_STATS_CASE(128, 32, 1) SD_STATS_CASE(160, 32, 1)
  SD_STATS_CASE(512, 16, 1)
#undef SD_STATS_CASE
  return int(cudaErrorInvalidValue);
}

// K3's bfloat16 kernel past D 160 (declared in flash_attention_bwd_common.cuh):
// the split set's dK/dV kernel at DP 512 (two blocks of two warpgroups per
// 64 kv rows, 16-row q tiles), each block also adding its share of dQ on its
// 256 columns to the f32 buffer `dq_acc` in kv-block order; `dq_sem` holds
// B * H * ceil(N / 16) * 2 zeroed counters. Returns a CUDA error code.
int launch_fused_bwd_wgmma_d512(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dq_acc, int* dq_sem,
                                void* dk, void* dv, int B, int H, int N, int M, int D,
                                const long long* st, float scale, cudaStream_t stream) {
  constexpr int DP = 512, BQT = 16, WGC = 2, NPART = 2;
  constexpr size_t smem = dkv_wgmma_smem_bytes<DP, BQT, 1, NPART, true>();
  cudaError_t err = cudaFuncSetAttribute(split_dkv_wgmma_kernel<DP, BQT, 1, WGC, NPART, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int vec = sd_sm90::rows_aligned(q, B, N, H, st[0], st[1], st[2]) &&
                  sd_sm90::rows_aligned(k, B, M, H, st[3], st[4], st[5]) &&
                  sd_sm90::rows_aligned(v, B, M, H, st[6], st[7], st[8]) &&
                  sd_sm90::rows_aligned(dout, B, N, H, st[12], st[13], st[14]);
  // kv blocks (their parts fastest) fastest: the order of the dQ adds
  split_dkv_wgmma_kernel<DP, BQT, 1, WGC, NPART, true>
      <<<dim3((M + 63) / 64 * NPART, H, B), 128 * WGC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, dq_acc, dq_sem, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[12], st[13], st[14], scale, scale * 1.4426950408889634f, vec);
  return int(cudaGetLastError());
}

namespace {

int backward_split_wgmma(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int H, int N, int M, const long long* st, float scale,
                         cudaStream_t stream, int* impl) {
  const int err = launch_bwd_stats_bf16(q, k, v, dout, lse, delta, B, H, N, M, D, st, scale, stream);
  if (err != 0) return err;
  // (DP; kv tile, row and column warpgroups of the dQ kernel; q tile, row and
  // column warpgroups and column parts (blocks) of the dK/dV kernel)
#define SD_SPLIT_WGMMA_CASE(DP, BKV, QWGR, QWGC, BQT, KVWGR, WGC, NPART)                        \
  if (D <= DP)                                                                                \
    return launch_split_wgmma<DP, BKV, QWGR, QWGC, BQT, KVWGR, WGC, NPART>(                   \
        q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, st, scale, stream, impl);
  SD_SPLIT_WGMMA_CASE(32, 64, 2, 1, 64, 2, 1, 1)
  SD_SPLIT_WGMMA_CASE(48, 64, 2, 1, 64, 2, 1, 1)
  SD_SPLIT_WGMMA_CASE(64, 64, 2, 1, 64, 2, 1, 1)
  SD_SPLIT_WGMMA_CASE(80, 64, 2, 1, 64, 2, 1, 1)
  SD_SPLIT_WGMMA_CASE(128, 32, 1, 1, 32, 1, 2, 1)
  SD_SPLIT_WGMMA_CASE(160, 32, 1, 1, 32, 1, 2, 1)
  SD_SPLIT_WGMMA_CASE(512, 16, 1, 2, 16, 1, 2, 2)
#undef SD_SPLIT_WGMMA_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core
// kernels); D <= 512. `strides` holds 15 element strides: (batch, token,
// head) of q, k, v, o and do in that order. `delta` is f32 [B, H, N] scratch;
// dq, dk and dv are the contiguous outputs. `impl` receives the kernels
// launched, written by the launch once both succeeded: 0 = FMA, 1 = wgmma. Returns the first nonzero CUDA error code, 0
// on success.
int sd_flash_attention_backward_split(int dtype, const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B, int H,
                                      int N, int M, int D, const long long* strides, float scale,
                                      void* stream, int* impl) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || D > 512 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  if (dtype == 0)
    return backward_split<float>(D, q, k, v, o, dout, l, de, dq, dk, dv, B, H, N, M, strides,
                                 scale, s, impl);
  if (dtype == 1)
    return backward_split_wgmma(D, q, k, v, o, dout, l, de, dq, dk, dv, B, H, N, M, strides,
                                scale, s, impl);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
