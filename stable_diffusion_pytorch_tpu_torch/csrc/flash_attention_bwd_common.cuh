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
// own kernel (the split form).
//
// The ordered adds: kv block j adds its dQ share of q tile t only after block
// j - 1 has added its own, so every element of dQ is the same sum, in the same
// order, on every run (no unordered atomics). A per-(batch, head, q tile) int32 counter,
// zeroed by the caller, holds the index of the block whose turn it is; block 0
// stores its share instead of adding, so the f32 buffer needs no zeroing. The
// kv-block index is blockIdx.x, the fastest-varying part of the grid: blocks
// are dispatched in increasing linear index, so block j - 1 of the same
// (batch, head) was dispatched before block j, is resident or done when block
// j waits, and never waits on block j itself (it waits only on lower indices).
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

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // Qt, dOt [DP][LDQ]; Kt, Vt [DP][LDK]; Ps, dSs [BQ][LDK]; lse, delta [BQ]
  return sizeof(float) *
         (2 * size_t(DP) * LDQ + 2 * size_t(DP) * LDK + 2 * size_t(BQ) * LDK + 2 * BQ);
}

// The kv-outer loop, for a block of NT threads with dkv_smem_bytes<DP>() of
// dynamic shared memory at `smem`. dq_acc is f32 [B, N, H, D] and dq_sem int32
// [B, H, ceil(N / BQ)], zeroed (both used only WITH_DQ).
template <typename T, int DP, bool WITH_DQ>
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
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  constexpr int DJ = DP / 16;  // head-dim columns per thread

  float* Qt = smem;               // [DP][LDQ]  q tile, transposed
  float* dOt = Qt + DP * LDQ;     // [DP][LDQ]  do tile, transposed
  float* Kt = dOt + DP * LDQ;     // [DP][LDK]  this block's k rows, transposed
  float* Vt = Kt + DP * LDK;      // [DP][LDK]  this block's v rows, transposed
  float* Ps = Vt + DP * LDK;      // [BQ][LDK]  P of the current q tile
  float* dSs = Ps + BQ * LDK;     // [BQ][LDK]  dS of the current q tile
  float* lse_s = dSs + BQ * LDK;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;
  const int64_t row_stride = int64_t(H) * D;  // of the contiguous [B, L, H, D] outputs

  for (int idx = tid; idx < BK * DP; idx += NT) {
    const int c = idx / DP, d = idx % DP;
    const bool ok = (k0 + c < M) && (d < D);
    Kt[d * LDK + c] = ok ? to_f32(kb[int64_t(k0 + c) * k_sm + d]) : 0.f;
    Vt[d * LDK + c] = ok ? to_f32(vb[int64_t(k0 + c) * v_sm + d]) : 0.f;
  }

  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous tile's reads of Qt/dOt/Ps/dSs are done
    for (int idx = tid; idx < BQ * DP; idx += NT) {
      const int r = idx / DP, d = idx % DP;
      const bool ok = (q0 + r < N) && (d < D);
      Qt[d * LDQ + r] = ok ? to_f32(qb[int64_t(q0 + r) * q_sn + d]) : 0.f;
      dOt[d * LDQ + r] = ok ? to_f32(db[int64_t(q0 + r) * d_sn + d]) : 0.f;
    }
    if (tid < BQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < N ? lse_bh[r] : INFINITY;  // rows past N: P = 0
      delta_s[tid] = r < N ? delta_bh[r] : 0.f;
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

    // dV += P^T dO and dK += dS^T Q: kv rows ty*4+i, head-dim columns tx+16j
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
      // this block's share of dQ = scale * dS K: q rows ty*4+i, columns tx+16j
      float* dq_bh = dq_acc + int64_t(b) * N * row_stride + int64_t(h) * D;
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
      int* sem = dq_sem + (int64_t(b) * H + h) * ((N + BQ - 1) / BQ) + q0 / BQ;
      wait_turn(sem, blockIdx.x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= N) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) ordered_add(&dq_bh[int64_t(r) * row_stride + d], dq[i][j] * scale, blockIdx.x == 0);
        }
      }
      pass_turn(sem, blockIdx.x + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= M) continue;
    const int64_t base = (int64_t(b) * M + c) * row_stride + int64_t(h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[base + d] = from_f32<T>(acc_dk[i][j] * scale);
        dv[base + d] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

}  // namespace
