// Shared pieces of the two flash-attention backward sources: the fused kernel
// (csrc/flash_attention_bwd.cu, K3) and the split kernels
// (csrc/flash_attention_bwd_split.cu, K4/K5). Both compute, per (batch, head),
//   P  = exp2(Q K^T * scale * log2(e) - lse2)        (the forward's softmax)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(P * dP),  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// in f32 from the forward's row log-sum-exp lse2 (base 2, csrc/flash_attention.cu).
// delta = rowsum(P * dP) = rowsum(dO * O) in exact arithmetic. float32 takes
// the cheap form, rowsum(dO * O) (`delta_rows`), since its O is exact to f32
// rounding. bfloat16 takes the TPU kernels' form, an f32 sum of P * dP with S
// and dP recomputed (`launch_bwd_stats_bf16`, in flash_attention_bwd_split.cu):
// the stored O carries the forward's bf16 roundings, and where keys share a
// large component that error, common to a row's dS, survives into dQ.
//
// Here: the tile sizes and thread layout (16 x 16 threads, 4-row micro-tiles),
// the dtype conversions, `delta_rows` (one warp per row of delta), the ordered
// dQ adds (`wait_turn`, `pass_turn`) and `dkv_body`: a block owns 64 kv rows,
// keeps their K and V in shared memory and dK/dV in f32 registers, and loops
// over all q tiles. With WITH_DQ it also adds the block's share of dQ for each
// q tile to an f32 buffer, in kv-block order (K3); without, dQ is left to its
// own kernel (the split form). Past DP 160 (the VAE's 512-wide head) the f32
// tiles and accumulators of a whole head would not fit, so a block takes 128
// of the output columns and recomputes S and dP over the whole head dim in
// 128-column chunks, K and V reloaded per q tile (`load_chunk_t`): the four
// blocks of 64 rows do the two score products four times (K3: 22 N M D
// FLOPs where one block would do 10).
//
// The ordered adds: kv block j adds its dQ share of q tile t only after block
// j - 1 has added its own, so every element of dQ is the same sum, in the same
// order, on every run (no unordered atomics). A per-(batch, head, q tile,
// column part) int32 counter, zeroed by the caller, holds the index of the
// block whose turn it is; block 0 stores its share instead of adding, so the
// f32 buffer needs no zeroing. The kv-block index is blockIdx.x (over the
// parts, which vary fastest), the fastest-varying part of the grid: blocks
// are dispatched in increasing linear index, so block j - 1 of the same
// (batch, head, part) was dispatched before block j, is resident or done when
// block j waits, and never waits on block j itself (it waits only on lower
// indices).
// The wait therefore always ends, and with neighbouring kv blocks running
// side by side it is short.
//
// Layout: q/o/do [B, N, H, D] and k/v [B, M, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous; dk, dv (and
// dq) are written contiguous [B, L, H, D]; lse and delta are f32 [B, H, N].

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// bf16 delta = rowsum(P * dP) in f32, S and dP recomputed on the tensor cores
// (defined in flash_attention_bwd_split.cu). `st` holds the 15 strides of the
// C entry points (q, k, v, o, do); returns a CUDA error code.
int launch_bwd_stats_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, float* delta, int B, int H, int N, int M, int D,
                          const long long* st, float scale, cudaStream_t stream);

// K3 in bfloat16 past D 160, up to 512: the split set's dK/dV kernel at DP 512
// adding each block's dQ share in kv-block order (defined in
// flash_attention_bwd_split.cu); `dq_acc` f32 [B, N, H, D], `dq_sem` B * H *
// ceil(N / 16) * 2 zeroed int32 counters. Returns a CUDA error code.
int launch_fused_bwd_wgmma_d512(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dq_acc, int* dq_sem,
                                void* dk, void* dv, int B, int H, int N, int M, int D,
                                const long long* st, float scale, cudaStream_t stream);

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 256;   // threads per block, as 16 x 16
constexpr int PAD = 4;    // row padding (keeps float4 alignment)
constexpr int LDQ = BQ + PAD;
constexpr int LDK = BK + PAD;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// delta = rowsum(dO * O): one warp per (batch, head, row), `rows` = B * H * N.
template <typename T>
__device__ __forceinline__ void delta_rows(const T* __restrict__ o, const T* __restrict__ dout,
                                           float* __restrict__ delta, int H, int N, int D,
                                           int64_t o_sb, int64_t o_sn, int64_t o_sh,
                                           int64_t d_sb, int64_t d_sn, int64_t d_sh,
                                           int64_t rows) {
  const int64_t row = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together: one row per warp
  const int n = int(row % N);
  const int64_t bh = row / N;
  const int h = int(bh % H);
  const int64_t b = bh / H;
  const T* orow = o + b * o_sb + n * o_sn + h * o_sh;
  const T* drow = dout + b * d_sb + n * d_sn + h * d_sh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Block `turn`'s turn at one ordered dQ add: thread 0 waits until the counter
// reads `turn` (acquire), then the block goes on together.
__device__ __forceinline__ void wait_turn(const int* sem, int turn) {
  if (threadIdx.x == 0) {
    int v;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(sem) : "memory");
    } while (v != turn);
  }
  __syncthreads();
}

// After the block's adds: every thread's writes reach the device, then the
// counter passes to `next` (release).
__device__ __forceinline__ void pass_turn(int* sem, int next) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(sem), "r"(next) : "memory");
}

// dq_acc[i] = v for the first block in the order, += v for the others: a
// reduction performed at the L2 (no round trip), after the previous block's
// (its release and this block's acquire order them), rounded to nearest
__device__ __forceinline__ void ordered_add(float* p, float v, bool first) {
  if (first)
    __stcg(p, v);
  else
    asm volatile("red.relaxed.gpu.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// The f32 FMA kernels take the head dim in chunks of CH columns (CH = DP up
// to DP 160; 128 at DP 512, where whole f32 tiles would not fit shared
// memory): S and dP are summed over the chunks, and a block owns one chunk's
// worth of the output columns (part `blockIdx.x % (DP / CH)`), recomputing S
// and dP over the whole head dim for it. The chunks are visited with the
// block's own last, so that its Q, dO, K and V columns stay in shared memory
// for the products that follow.
template <int CH>
constexpr size_t dkv_smem_bytes() {
  // Qt, dOt [CH][LDQ]; Kt, Vt [CH][LDK]; Ps, dSs [BQ][LDK]; lse, delta [BQ]
  return sizeof(float) *
         (2 * size_t(CH) * LDQ + 2 * size_t(CH) * LDK + 2 * size_t(BQ) * LDK + 2 * BQ);
}

// S += Q K^T and dP += dO V^T over one chunk of CH head-dim columns, from the
// transposed tiles: q rows ty*4+i, kv columns tx*4+j
template <int CH>
__device__ __forceinline__ void score_chunk(float (&s)[4][4], float (&dp)[4][4], const float* Qt,
                                            const float* dOt, const float* Kt, const float* Vt,
                                            int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < CH; ++d) {
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
}

// rows r0.. (at most R of them, `rows` inside the matrix) of one chunk of
// columns c0..c0+CH of a [L, D] row-major view (row stride `ld`), transposed
// into dst [CH][LDT] as f32; zero past the matrix and past D
template <typename T, int R, int CH, int LDT>
__device__ __forceinline__ void load_chunk_t(float* dst, const T* __restrict__ src, int64_t ld,
                                             int rows, int c0, int D) {
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, d = idx % CH;
    const bool ok = (r < rows) && (c0 + d < D);
    dst[d * LDT + r] = ok ? to_f32(src[int64_t(r) * ld + c0 + d]) : 0.f;
  }
}

// The kv-outer loop, for a block of NT threads with dkv_smem_bytes<CH>() of
// dynamic shared memory at `smem`. dq_acc is f32 [B, N, H, D] and dq_sem int32
// [B, H, ceil(N / BQ), DP / CH], zeroed (both used only WITH_DQ). The grid's x
// is (kv block, part), the part fastest.
template <typename T, int DP, bool WITH_DQ, int CH = DP>
__device__ __forceinline__ void dkv_body(
    float* smem,
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, int* __restrict__ dq_sem, T* __restrict__ dk, T* __restrict__ dv,
    int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  static_assert(CH % 16 == 0 && DP % CH == 0, "chunks of 16-column multiples");
  constexpr int NCH = DP / CH;  // column parts, one a block
  constexpr int DJ = CH / 16;   // output columns per thread

  float* Qt = smem;               // [CH][LDQ]  q tile, transposed (one chunk)
  float* dOt = Qt + CH * LDQ;     // [CH][LDQ]  do tile, transposed
  float* Kt = dOt + CH * LDQ;     // [CH][LDK]  this block's k rows, transposed
  float* Vt = Kt + CH * LDK;      // [CH][LDK]  this block's v rows, transposed
  float* Ps = Vt + CH * LDK;      // [BQ][LDK]  P of the current q tile
  float* dSs = Ps + BQ * LDK;     // [BQ][LDK]  dS of the current q tile
  float* lse_s = dSs + BQ * LDK;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int part = blockIdx.x % NCH;
  const int kvb = blockIdx.x / NCH;  // the kv block: the order of the dQ adds
  const int k0 = kvb * BK;
  const int c0 = part * CH;          // this block's output columns c0..c0+CH
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh + k0 * k_sm;
  const T* vb = v + b * v_sb + h * v_sh + k0 * v_sm;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;
  const int64_t row_stride = int64_t(H) * D;  // of the contiguous [B, L, H, D] outputs

  if constexpr (NCH == 1) {  // K and V stay resident
    load_chunk_t<T, BK, CH, LDK>(Kt, kb, k_sm, M - k0, 0, D);
    load_chunk_t<T, BK, CH, LDK>(Vt, vb, v_sm, M - k0, 0, D);
  }

  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
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
      load_chunk_t<T, BQ, CH, LDQ>(Qt, qb + int64_t(q0) * q_sn, q_sn, N - q0, c * CH, D);
      load_chunk_t<T, BQ, CH, LDQ>(dOt, db + int64_t(q0) * d_sn, d_sn, N - q0, c * CH, D);
      if constexpr (NCH > 1) {
        load_chunk_t<T, BK, CH, LDK>(Kt, kb, k_sm, M - k0, c * CH, D);
        load_chunk_t<T, BK, CH, LDK>(Vt, vb, v_sm, M - k0, c * CH, D);
      }
      if (ci == 0 && tid < BQ) {
        const int r = q0 + tid;
        lse_s[tid] = r < N ? lse_bh[r] : INFINITY;  // rows past N: P = 0
        delta_s[tid] = r < N ? delta_bh[r] : 0.f;
      }
      __syncthreads();
      score_chunk<CH>(s, dp, Qt, dOt, Kt, Vt, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lr = lse_s[ty * 4 + i];
      const float dl = delta_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx * 4 + j < M) ? exp2f(s[i][j] * scale_log2 - lr) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl);  // dS
      }
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * LDK + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(&dSs[(ty * 4 + i) * LDK + tx * 4]) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q on this block's columns: kv rows ty*4+i,
    // columns c0 + tx+16j
    const int qn = min(BQ, N - q0);
    for (int r = 0; r < qn; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * LDK + ty * 4]);
      const float4 sv = *reinterpret_cast<const float4*>(&dSs[r * LDK + ty * 4]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = dOt[(tx + 16 * j) * LDQ + r];
        const float qv = Qt[(tx + 16 * j) * LDQ + r];
        acc_dv[0][j] = fmaf(pv.x, dov, acc_dv[0][j]);
        acc_dv[1][j] = fmaf(pv.y, dov, acc_dv[1][j]);
        acc_dv[2][j] = fmaf(pv.z, dov, acc_dv[2][j]);
        acc_dv[3][j] = fmaf(pv.w, dov, acc_dv[3][j]);
        acc_dk[0][j] = fmaf(sv.x, qv, acc_dk[0][j]);
        acc_dk[1][j] = fmaf(sv.y, qv, acc_dk[1][j]);
        acc_dk[2][j] = fmaf(sv.z, qv, acc_dk[2][j]);
        acc_dk[3][j] = fmaf(sv.w, qv, acc_dk[3][j]);
      }
    }

    if constexpr (WITH_DQ) {
      // this block's share of dQ = scale * dS K on its columns: q rows
      // ty*4+i, columns c0 + tx+16j
      float* dq_bh = dq_acc + int64_t(b) * N * row_stride + int64_t(h) * D + c0;
      float dq[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
      for (int c = 0; c < BK; c += 4) {  // masked kv columns hold dS = 0 and K = 0
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * LDK + c]);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(&Kt[(tx + 16 * j) * LDK + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dq[i][j] = fmaf(a[i].x, kk.x, fmaf(a[i].y, kk.y, fmaf(a[i].z, kk.z, fmaf(a[i].w, kk.w, dq[i][j]))));
        }
      }
      int* sem = dq_sem + ((int64_t(b) * H + h) * ((N + BQ - 1) / BQ) + q0 / BQ) * NCH + part;
      wait_turn(sem, kvb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (c0 + d < D) ordered_add(&dq_bh[int64_t(r) * row_stride + d], dq[i][j] * scale, kvb == 0);
        }
      }
      pass_turn(sem, kvb + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= M) continue;
    const int64_t base = (int64_t(b) * M + c) * row_stride + int64_t(h) * D + c0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (c0 + d < D) {
        dk[base + d] = from_f32<T>(acc_dk[i][j] * scale);
        dv[base + d] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

}  // namespace
