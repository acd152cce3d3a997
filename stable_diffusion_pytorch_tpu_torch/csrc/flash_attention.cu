// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C interface.
//
// Replaces the Pallas TPU kernels stable_diffusion_pytorch_tpu/ops/flash_attention.py
// `_fa_kernel` (resident K/V, one exact softmax per q-block) and
// `_fa_kernel_stream` (kv past 9216 tokens, online softmax over kv chunks): here
// one online-softmax loop over kv tiles serves every kv length, so there is no
// resident/streaming split.
//
// Computes, for each (batch, head):  O = softmax(Q K^T * scale) V
//   - scores, the running max/normalizer and the output accumulator are f32;
//   - kv columns at or past the true length M are masked (M = 77 for
//     cross-attention is not a tile multiple);
//   - P is rounded to the value dtype before P.V, as the TPU kernel
//     (`p.astype(v.dtype)`) and the plain path do; the output is written in
//     the input dtype;
//   - optionally the row log-sum-exp, in base-2 units of the scaled scores
//     (lse2 = max + log2(sum), scores taken as s * scale * log2(e)), as f32
//     [B, H, N] for the backward kernels (flash_attention_bwd*.cu).
//
// What bounds it on this card: 4*N*M*D FLOPs against O((N+M)*D) bytes, far
// above the H100's ridge, so arithmetic; at the UNet's d_head 40 the N*M
// exponentials (16 per clock per SM) weigh as much as the products.
//
// bfloat16, `fa_forward_wgmma_kernel`, on the tensor cores (989 TFLOP/s bf16
// against 67 TFLOP/s of f32 FMAs). A block owns 128 q rows of one (batch,
// head) as two consumer warpgroups of 64 rows that share every K/V tile
// (half the copies and barriers per thread of one warpgroup per block, which
// ran slower at d_head 40), or 64 rows split by head-dim columns (below). Q is
// copied once; K and V stream in BK-row tiles through a ring of two
// shared-memory stages filled by cp.async, the next tile's copy in flight
// while this tile's products run; each thread's copy offsets are worked out
// once (`TileCopy`). S = Q K^T is wgmma with both operands in shared memory
// (attention_sm90.cuh: core-matrix tiling, no swizzle); the online softmax
// runs in registers on the accumulator fragment (row max and sum over the four
// lanes of a row; p = 2^(s * scale * log2(e) - m) as one FFMA and one EX2; the
// row sum kept per thread and reduced once at the end); P is rounded to bf16
// in registers and is wgmma's register A operand for O += P V, V read
// MN-major from the same tile layout. D is padded to an instantiated DP and
// zero-filled by the copies. The head dims on the main path: 40 (padded to
// 48), 80, 160 and the VAE's single 512-wide head. At DP = 512 a 64 x 512 f32
// accumulator would take 256 registers a thread, so two warpgroups split the
// head dim (256 columns each) and each computes the whole S = Q K^T itself:
// S costs half of the block's products, so recomputing it once more is cheaper
// than a shared-memory exchange of P with a barrier per tile; both run the
// same instructions on the same data, so their P agree bit for bit. BK = 32
// there so that Q and two stages of K and V fit in 192 KB. DP = 256 splits the
// same way with BK = 64. Not yet done: TMA, a producer warp, overlapping one
// tile's softmax with the next tile's S (FA3's ping-pong).
//
// float32 keeps the FMA kernel, `fa_forward_kernel`, unchanged: the f32
// parity checks (1e-5 against the plain version, the UNet on the card against
// the CPU) need full f32 products, and the tensor cores' f32 path (TF32)
// keeps about three decimal digits. A block owns 64 q rows and streams K/V
// in BK-row tiles through shared memory; each of its 256 threads keeps a
// 4 x (BK/16) score micro-tile and a 4 x (DP/16) slice of the output
// accumulator in registers. BK is 64 up to DP = 256; the 512-wide head takes
// 16-row kv tiles so that its f32 tiles fit the 227 KB of shared memory.
//
// Layout: q [B, N, H, D], k/v [B, M, H, D], o [B, N, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_sm90.cuh"

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
           int N, int M, int D, const long long* st, float scale_log2, cudaStream_t stream,
           int* impl) {
  constexpr size_t smem = smem_bytes<DP, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + BQ - 1) / BQ, H, B);
  fa_forward_kernel<T, DP, BK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2);
  err = cudaGetLastError();
  if (err == cudaSuccess) *impl = 0;
  return int(err);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int H, int N, int M, const long long* st, float scale_log2, cudaStream_t stream,
             int* impl) {
#define SD_FA_CASE(DP, BK) \
  if (D <= DP)             \
    return launch<T, DP, BK>(q, k, v, o, lse, B, H, N, M, D, st, scale_log2, stream, impl);
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

// ---- bfloat16: tensor cores ------------------------------------------------

using sd_sm90::bf16;

template <int DP, int BK, int WGR>
constexpr size_t wgmma_smem_bytes() {
  // Q [64 * WGR][DP] + K, V [2 stages][BK][DP], bf16
  return 2 * (size_t(64) * WGR * DP + 4 * size_t(BK) * DP);
}

// One block: 64 * WGR q rows of one (batch, head) and WGR x WGC warpgroups;
// warpgroup (wr, wc) owns q rows 64 wr.. and output columns DS wc.. (see the
// note at the top).
template <int DP, int BK, int WGR, int WGC>
__global__ void __launch_bounds__(128 * WGR * WGC) fa_forward_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale_log2, int vec) {
  using namespace sd_sm90;
  static_assert(DP % 16 == 0 && DP % WGC == 0 && BK % 16 == 0, "tile widths");
  constexpr int BQ = 64 * WGR;
  constexpr int NT = 128 * WGR * WGC;
  constexpr int DS = DP / WGC;                      // output columns of one warpgroup
  constexpr uint32_t KV_TILE = BK * DP * 2;         // bytes of one K or V stage

  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sQ = smem_u32(smem_tc);
  const uint32_t sK = sQ + BQ * DP * 2;             // stage s at sK + s * KV_TILE
  const uint32_t sV = sK + 2 * KV_TILE;

  const int tid = threadIdx.x;
  const int wr = (tid >> 7) / WGC;                  // this warpgroup's 64 q rows
  const int wc = (tid >> 7) % WGC;                  // and its output columns
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  const TileCopy<BK, DP, NT> k_copy(k_sm, D, tid), v_copy(v_sm, D, tid);
  TileCopy<BQ, DP, NT>(q_sn, D, tid).copy(sQ, qb + q0 * q_sn, N - q0, tid, vec);
  k_copy.copy(sK, kb, M, tid, vec);
  v_copy.copy(sV, vb, M, tid, vec);
  cp_async_commit();

  float acc[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint64_t q_desc = desc_k_major<DP>(sQ) + wr * 8 * DP;  // rows 64 wr..
  const int n_tiles = (M + BK - 1) / BK;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      const int r0 = (j + 1) * BK;
      k_copy.copy(sK + (st ^ 1) * KV_TILE, kb + r0 * k_sm, M - r0, tid, vec);
      v_copy.copy(sV + (st ^ 1) * KV_TILE, vb + r0 * v_sm, M - r0, tid, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // tile j (and Q) landed for every thread's copies

    // S = Q K^T, [64 x BK] in f32
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    const uint64_t k_desc = desc_k_major<DP>(sK + st * KV_TILE);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<BK>::ss(s, q_desc + 16 * kk, k_desc + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax on the fragment, base 2: the max of the raw scores,
    // then p = 2^(s * scale * log2(e) - m) in one FFMA and one EX2
    if ((j + 1) * BK > M) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (j * BK + frag_col(i, lane) >= M) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[frag_row_half(i)] = fmaxf(mx[frag_row_half(i)], s[i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite after the first tile: every tile holds a column < M
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * scale_log2);
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      neg_m[r] = -m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2_ftz(fmaf(s[i], scale_log2, neg_m[frag_row_half(i)]));
      l_run[frag_row_half(i)] += p;
      s[i] = p;
    }
    uint32_t pa[BK / 16][4];
    to_a_frag(s, pa);  // P in bf16, the value dtype, before P.V
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) acc[i] *= alpha[frag_row_half(i)];

    // O += P V: V read MN-major, this warpgroup's DS columns
    const uint64_t v_desc = desc_mn_major<DP>(sV + st * KV_TILE) + wc * DS;
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Wgmma<DS>::rs(acc, pa[kk], v_desc + 2 * DP * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage st before it is refilled
  }

  const int row0 = q0 + 64 * wr + 16 * warp + (lane >> 2);
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv_l[r] = 1.f / l_run[r];
  }
  bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < DS / 2; i += 2) {
    const int row = row0 + 8 * frag_row_half(i);
    const int col = wc * DS + frag_col(i, lane);
    if (row < N && col < D) {
      const float inv = inv_l[frag_row_half(i)];
      store_bf16_pair(ob + int64_t(row) * o_sn + col, acc[i] * inv, acc[i + 1] * inv, col + 1 < D);
    }
  }
  if (lse != nullptr && wc == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < N) lse[(int64_t(b) * H + h) * N + row] = m_run[r] + log2f(l_run[r]);
    }
  }
}

template <int DP, int BK, int WGR, int WGC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int N, int M, int D, const long long* st, float scale_log2, cudaStream_t stream,
                 int* impl) {
  constexpr size_t smem = wgmma_smem_bytes<DP, BK, WGR>();
  cudaError_t err = cudaFuncSetAttribute(fa_forward_wgmma_kernel<DP, BK, WGR, WGC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + 64 * WGR - 1) / (64 * WGR), H, B);
  const int vec = sd_sm90::rows_aligned(q, B, N, H, st[0], st[1], st[2]) &&
                  sd_sm90::rows_aligned(k, B, M, H, st[3], st[4], st[5]) &&
                  sd_sm90::rows_aligned(v, B, M, H, st[6], st[7], st[8]);
  fa_forward_wgmma_kernel<DP, BK, WGR, WGC><<<grid, 128 * WGR * WGC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2, vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) *impl = 1;
  return int(err);
}

int dispatch_wgmma(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int N, int M, const long long* st, float scale_log2,
                   cudaStream_t stream, int* impl) {
#define SD_FA_WGMMA_CASE(DP, BK, WGR, WGC) \
  if (D <= DP)                             \
    return launch_wgmma<DP, BK, WGR, WGC>(q, k, v, o, lse, B, H, N, M, D, st, scale_log2, stream, \
                                          impl);
  SD_FA_WGMMA_CASE(32, 64, 2, 1)
  SD_FA_WGMMA_CASE(48, 64, 2, 1)
  SD_FA_WGMMA_CASE(64, 64, 2, 1)
  SD_FA_WGMMA_CASE(80, 64, 2, 1)
  SD_FA_WGMMA_CASE(128, 64, 2, 1)
  SD_FA_WGMMA_CASE(160, 64, 2, 1)
  SD_FA_WGMMA_CASE(256, 64, 1, 2)
  SD_FA_WGMMA_CASE(512, 32, 1, 2)
#undef SD_FA_WGMMA_CASE
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel); D <= 512.
// Strides are in elements. `lse` is null or f32 [B, H, N]. `impl` receives
// the kernel launched, written by the launch once it succeeded: 0 = FMA,
// 1 = wgmma. Returns the CUDA error code of the launch (0 on success); the
// caller raises on nonzero.
int sd_flash_attention_forward(int dtype, const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int N, int M, int D,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sm, long long k_sh,
                               long long v_sb, long long v_sm, long long v_sh,
                               long long o_sb, long long o_sn, long long o_sh,
                               float scale, void* stream, int* impl) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sn, q_sh, k_sb, k_sm, k_sh,
                            v_sb, v_sm, v_sh, o_sb, o_sn, o_sh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return dispatch<float>(D, q, k, v, o, l, B, H, N, M, st, scale_log2, s, impl);
  if (dtype == 1) return dispatch_wgmma(D, q, k, v, o, l, B, H, N, M, st, scale_log2, s, impl);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
