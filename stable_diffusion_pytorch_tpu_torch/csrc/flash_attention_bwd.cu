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
//   dP = dO V^T,  delta = rowsum(P * dP),  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// with f32 sums; kv columns at or past the true length M are masked, rows past
// N contribute nothing.
//
// Why not the TPU design: the TPU kernel keeps one head's whole K/V resident in
// VMEM and carries dk/dv in scratch across a sequential grid over q tiles,
// writing each q tile's dQ once. On Hopper one head's K plus V at 4096 x 48 is
// 786 KB against 227 KB of shared memory, and blocks run in no order. So the
// loop is kv-outer: a block owns a slice of kv rows (their K and V resident in
// shared memory, dK/dV in f32 registers) and walks all q tiles; every block
// contributes a share of each q tile's dQ, and those shares meet in an f32
// [B, N, H, D] buffer through ordered adds: kv block j adds its share after
// block j - 1, as a per-(batch, head, q tile) counter says (the argument that
// the wait ends is in flash_attention_bwd_common.cuh). The adds are
// reductions at the L2 made one block at a time, in that order: dQ, dK and
// dV are the same bits on every run, in both dtypes. A cast pass turns the
// buffer into bf16 dQ (f32 inputs take the buffer as the output).
//
// What bounds it on this card: five products of 2*N*M*D FLOPs each (S, dP, dV,
// dK, dQ) against O((N+M)*D) bytes: arithmetic, far above the ridge; in
// bfloat16 the stats pass adds two more (S and dP once more, for delta).
//
// bfloat16, `fused_bwd_wgmma_kernel`, on the tensor cores (building blocks in
// attention_sm90.cuh; the dK/dV half is the split set's `split_dkv_wgmma_kernel`):
//   - delta first, by the split set's stats pass (`launch_bwd_stats_bf16`):
//     an f32 sum of P * dP with S and dP recomputed, as the TPU kernel sums
//     it, not rowsum(dO * O) from the bf16 O, whose rounding moves dQ where
//     keys share a large component;
//   - two consumer warpgroups share a ring of two shared-memory stages of Q,
//     dO, lse and delta tiles of 64 q rows, filled by cp.async; K and V stay
//     resident. Per tile, S^T = K Q^T and dP^T = V dO^T on wgmma; P^T and
//     dS^T in f32 registers, rounded to bf16 (the TPU kernel's
//     `e.astype(v.dtype)`, `t.astype(k.dtype)`) as the register A operands of
//     dV += P^T dO and dK += dS^T Q (dO and Q read MN-major);
//   - the fifth product, which the split set spends a kernel on: dS^T goes to
//     shared memory as bf16 in its own layout (kv rows x q columns) and is read
//     back MN-major as the A operand of dS K; the 64 x D f32 share is split by
//     columns over the warpgroups, each taking D/2 of them over all the
//     block's kv rows, staged in shared memory and, at the block's turn, added
//     to the dQ buffer in 16-byte reductions at the L2 (`add_dq_tile`);
//   - tiling: D up to 80 (40 pads to 48) takes 128 kv rows a block, one
//     warpgroup per 64; D 128 and 160 take 64 kv rows and split the head dim
//     of dK/dV over the two warpgroups, each recomputing S^T and dP^T (as
//     the split set does), to keep the accumulators within 255 registers.
//     Shared memory: 120 KB at D 80, 172 KB at D 160.
// Measured on the H100 (PERF.md, section 6), this kernel runs K3's main-path
// shapes about 1.4x slower than the split set: at 160-220 registers a thread
// one block fills an SM, so a block's softmax, its products and its turn at
// the ordered adds run one after another, where the split set's kernels run
// two blocks an SM. bfloat16 therefore routes to the split set
// (ops/flash_attention.py:backward_route); this kernel stays, held to its
// plain version at every K3 shape.
// float32 keeps `dkv_kernel` (`dkv_body`, f32 FMAs from shared memory, the
// 16 x 16 thread layout with 4-row micro-tiles, Q, dO, K and V transposed;
// 204 KB at DP = 160) with delta = rowsum(dO * O) and the same ordered dQ
// adds: the f32 parity checks need full f32 products, and its O is exact to
// f32 rounding. The VAE's 512-wide head (DP = 512) splits the output columns
// over four blocks of 128 and sums S and dP in 128-column chunks (171 KB;
// flash_attention_bwd_common.cuh); each part keeps its own ordered adds.
// bf16 past D 160 (the VAE's head of 512, off every path: bf16 routes to the
// split set) takes `launch_fused_bwd_wgmma_d512`: the split set's DP 512
// dK/dV kernel (K and V resident, 16-row q tiles, two blocks per 64 kv rows)
// that also forms its dQ share, dQ^T = K^T dS^T on wgmma with dS^T staged in
// shared memory, and adds it in kv-block order per (16-row q tile, part).
//
// Layout: q/o/do [B, N, H, D] and k/v [B, M, H, D], each with its own
// batch/token/head strides in elements and the head dim contiguous; dk, dv and
// dq are written contiguous [B, L, H, D]; lse and delta are f32 [B, H, N].

#include "flash_attention_bwd_common.cuh"
#include "attention_sm90.cuh"

namespace {

template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, int H, int N, int D,
                             int64_t o_sb, int64_t o_sn, int64_t o_sh,
                             int64_t d_sb, int64_t d_sn, int64_t d_sh, int64_t rows) {
  delta_rows<T>(o, dout, delta, H, N, D, o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, rows);
}

template <typename T, int DP, int CH>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, int* __restrict__ dq_sem, T* __restrict__ dk, T* __restrict__ dv,
    int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  dkv_body<T, DP, true, CH>(smem, q, k, v, dout, lse, delta, dq_acc, dq_sem, dk, dv, H, N, M, D,
                            q_sb, q_sn, q_sh, k_sb, k_sm, k_sh, v_sb, v_sm, v_sh, d_sb, d_sn, d_sh,
                            scale, scale_log2);
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst, int64_t n) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x)
    dst[i] = from_f32<T>(src[i]);
}

template <int DP, int CH>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse,
               const float* delta, float* dq_acc, int* dq_sem, float* dk, float* dv, int B, int H,
               int N, int M, int D, const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<CH>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<float, DP, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // kv blocks (each DP / CH column parts, those fastest) fastest: the order of the dQ adds
  dim3 grid((M + BK - 1) / BK * (DP / CH), H, B);
  dkv_kernel<float, DP, CH><<<grid, NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq_acc, dq_sem, dk, dv, H, N, M, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

int backward_f32(int D, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, float* dq, int* dq_sem,
                 void* dk, void* dv, int B, int H, int N, int M, const long long* st,
                 float scale, cudaStream_t stream, int* impl) {
  const int64_t rows = int64_t(B) * H * N;
  const int64_t blocks = (rows * 32 + 255) / 256;
  delta_kernel<float><<<unsigned(blocks), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, H, N, D, st[9],
      st[10], st[11], st[12], st[13], st[14], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dt = static_cast<const float*>(dout);
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  int rc = int(cudaErrorInvalidValue);
  // (DP, column chunk)
#define SD_BWD_CASE(DP, CH)                                                                       \
  if (D <= DP) {                                                                                  \
    rc = launch_dkv<DP, CH>(qt, kt, vt, dt, lse, delta, dq, dq_sem, dkt, dvt, B, H, N, M, D, st,  \
                            scale, stream);                                                       \
  } else
  SD_BWD_CASE(32, 32) SD_BWD_CASE(48, 48) SD_BWD_CASE(64, 64) SD_BWD_CASE(80, 80)
  SD_BWD_CASE(96, 96) SD_BWD_CASE(128, 128) SD_BWD_CASE(160, 160) SD_BWD_CASE(512, 128) {}
#undef SD_BWD_CASE
  if (rc == 0) *impl = 0;
  return rc;
}

// ---- bfloat16: tensor cores ------------------------------------------------

using sd_sm90::bf16;

constexpr int FQ = 64;  // q rows per tile of the fused bf16 kernel (wgmma's M of the dQ share)

template <int DP, int WGR, int WGC>
constexpr size_t fused_wgmma_smem_bytes() {
  // K, V [64 * WGR][DP] + Q, dO [2 stages][FQ][DP] + dS^T [64 * WGR][FQ], bf16;
  // lse, delta [2 stages][FQ] and the dQ shares [WGR * WGC][FQ][DP / (WGR * WGC) + 4], f32
  return 2 * (2 * size_t(64) * WGR * DP + 4 * size_t(FQ) * DP + size_t(64) * WGR * FQ) +
         4 * 4 * size_t(FQ) + 4 * size_t(FQ) * (DP + 4 * WGR * WGC);
}

// One block's dQ share of a q tile, [rows x D] f32, from the warpgroups'
// column strips in shared memory (warpgroup w holds columns w * DQN.., row
// stride LDS), into the dQ buffer at `out` (row stride `row_stride`): stored
// by the first block in the order, added by the others. Where the head dim
// allows, each thread moves four columns at once, a 16-byte reduction at the
// L2: a quarter of the operations of single adds.
template <int DQN, int LDS, int NT>
__device__ __forceinline__ void add_dq_tile(const float* shares, float* out, int rows, int D,
                                            int64_t row_stride, bool first) {
  if (D % 4 == 0) {
    const int c4 = D / 4;
    for (int i = threadIdx.x; i < rows * c4; i += NT) {
      const int r = i / c4, c = (i % c4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(shares + (c / DQN) * FQ * LDS + r * LDS + c % DQN);
      float4* p = reinterpret_cast<float4*>(out + r * row_stride + c);
      if (first)
        __stcg(p, x);
      else
        atomicAdd(p, x);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, c = i % D;
      ordered_add(out + r * row_stride + c, shares[(c / DQN) * FQ * LDS + r * LDS + c % DQN], first);
    }
  }
}

// dK and dV for 64 * WGR kv rows of one (batch, head) and their share of dQ,
// over all q tiles of FQ rows; WGR x WGC warpgroups, (wr, wc) owning kv rows
// 64 wr.. and DP / WGC columns of dK and dV; warpgroup w = wr * WGC + wc
// takes dQ's columns w * DQN.. over all of the block's kv rows.
template <int DP, int WGR, int WGC>
__global__ void __launch_bounds__(128 * WGR * WGC) fused_bwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, int* __restrict__ dq_sem, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int N, int M, int D,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    int64_t d_sb, int64_t d_sn, int64_t d_sh,
    float scale, float scale_log2, int vec) {
  using namespace sd_sm90;
  constexpr int BKV = 64 * WGR;
  constexpr int NT = 128 * WGR * WGC;
  constexpr int DS = DP / WGC;          // dK/dV columns of a warpgroup
  constexpr int DQN = DP / (WGR * WGC);  // dQ columns of a warpgroup
  static_assert(DP % 16 == 0 && DS % 16 == 0 && DQN % 8 == 0, "tile widths");
  constexpr uint32_t Q_TILE = FQ * DP * 2;

  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sK = smem_u32(smem_tc);
  const uint32_t sV = sK + BKV * DP * 2;
  const uint32_t sQ = sV + BKV * DP * 2;     // stage s at sQ + s * Q_TILE
  const uint32_t sdO = sQ + 2 * Q_TILE;
  const uint32_t sDS = sdO + 2 * Q_TILE;     // dS^T [BKV kv rows][FQ q columns] bf16
  const uint32_t sStat = sDS + BKV * FQ * 2;  // [2 stages][lse FQ, delta FQ] f32
  const float* stat = reinterpret_cast<const float*>(smem_tc + (sStat - sK));
  constexpr int LDS = DQN + 4;  // f32 row stride of a warpgroup's dQ share
  float* shares = reinterpret_cast<float*>(smem_tc + (sStat - sK) + 4 * 4 * FQ);

  const int tid = threadIdx.x;
  const int w = tid >> 7;
  const int wr = w / WGC;
  const int wc = w % WGC;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kv0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const bf16* db = dout + b * d_sb + h * d_sh;
  const float* lse_bh = lse + (int64_t(b) * H + h) * N;
  const float* delta_bh = delta + (int64_t(b) * H + h) * N;
  const int n_tiles = (N + FQ - 1) / FQ;
  int* sem_bh = dq_sem + (int64_t(b) * H + h) * n_tiles;
  const int64_t row_stride = int64_t(H) * D;  // of the contiguous [B, L, H, D] outputs
  float* dq_bh = dq_acc + int64_t(b) * N * row_stride + int64_t(h) * D;

  const TileCopy<FQ, DP, NT> q_copy(q_sn, D, tid), do_copy(d_sn, D, tid);
  auto load_q_tile = [&](int j, int st) {
    const int r0 = j * FQ;
    q_copy.copy(sQ + st * Q_TILE, qb + r0 * q_sn, N - r0, tid, vec);
    do_copy.copy(sdO + st * Q_TILE, db + r0 * d_sn, N - r0, tid, vec);
    if (tid < 2 * FQ) {
      const int row = j * FQ + (tid % FQ);
      const bool ok = row < N;
      const float* src = tid < FQ ? lse_bh : delta_bh;
      cp_async4(sStat + (st * 2 * FQ + tid) * 4, ok ? src + row : src, ok);
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
  // dQ share = dS K: dS from the dS^T tile (its rows are the product's depth),
  // K from the resident tile, both MN-major; this warpgroup's DQN columns
  const uint64_t ds_desc = desc_mn_major<FQ>(sDS);
  const uint64_t kt_desc = desc_mn_major<DP>(sK) + w * DQN;

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

    // S^T = K Q^T and dP^T = V dO^T, [64 kv x FQ q] in f32
    float s[FQ / 2], dp[FQ / 2];
#pragma unroll
    for (int i = 0; i < FQ / 2; ++i) s[i] = dp[i] = 0.f;
    const uint64_t q_desc = desc_k_major<DP>(sQ + st * Q_TILE);
    const uint64_t do_desc = desc_k_major<DP>(sdO + st * Q_TILE);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<FQ>::ss(s, k_desc + 16 * kk, q_desc + 16 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) Wgmma<FQ>::ss(dp, v_desc + 16 * kk, do_desc + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T; the columns are q rows, their lse and delta in shared memory
    const float* lse_t = stat + st * 2 * FQ;
    const float* delta_t = lse_t + FQ;
    const bool edge = (j + 1) * FQ > N;
#pragma unroll
    for (int i = 0; i < FQ / 2; ++i) {
      const int c = frag_col(i, lane);
      float p = exp2_ftz(fmaf(s[i], scale_log2, -lse_t[c]));
      if (edge && j * FQ + c >= N) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - delta_t[c]);
    }
    uint32_t pa[FQ / 16][4], da[FQ / 16][4];
    to_a_frag(s, pa);   // P^T in bf16 before P^T dO
    to_a_frag(dp, da);  // dS^T in bf16 before dS^T Q and dS K

    // dS^T to shared memory, core-matrix tiling of FQ columns: register
    // da[kk][r] holds kv row 16 warp + lane/4 + 8 (r % 2) and the q columns
    // 16 kk + 8 (r / 2) + 2 (lane % 4) and the next, one 4-byte word
    if (wc == 0) {
#pragma unroll
      for (int kk = 0; kk < FQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 64 * wr + 16 * warp + (lane >> 2) + 8 * (r & 1);
          const int col = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
          const uint32_t addr =
              sDS + ((row >> 3) * (FQ / 8) + (col >> 3)) * 128 + (row & 7) * 16 + (col & 7) * 2;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(da[kk][r]) : "memory");
        }
      fence_proxy_async();
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
    for (int kk = 0; kk < FQ / 16; ++kk) Wgmma<DS>::rs(acc_v, pa[kk], dot_desc + 2 * DP * kk, 1);
#pragma unroll
    for (int kk = 0; kk < FQ / 16; ++kk) Wgmma<DS>::rs(acc_k, da[kk], qt_desc + 2 * DP * kk, 1);
    wgmma_commit();
    __syncthreads();  // the whole dS^T tile is in shared memory

    // this warpgroup's share of dQ for q tile j: [FQ q x DQN] over the block's BKV kv rows
    float dqs[DQN / 2];
#pragma unroll
    for (int i = 0; i < DQN / 2; ++i) dqs[i] = 0.f;
    fence_regs(dqs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      WgmmaTT<DQN>::ss(dqs, ds_desc + 2 * FQ * kk, kt_desc + 2 * DP * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    // pa and da stay live until here: the dV/dK products read them
    // asynchronously, so their registers must not be reused for dqs
    fence_regs(pa);
    fence_regs(da);
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(dqs);

    // the share, scaled, to shared memory; then, at this block's turn, the
    // whole FQ x D tile added to the dQ buffer in 16-byte reductions
    float* mine = shares + w * FQ * LDS;
#pragma unroll
    for (int i = 0; i < DQN / 2; i += 2) {
      const int row = 16 * warp + (lane >> 2) + 8 * frag_row_half(i);
      *reinterpret_cast<float2*>(mine + row * LDS + frag_col(i, lane)) =
          make_float2(dqs[i] * scale, dqs[i + 1] * scale);
    }
    wait_turn(sem_bh + j, blockIdx.x);  // its barrier also orders the shares' writes
    add_dq_tile<DQN, LDS, NT>(shares, dq_bh + int64_t(j) * FQ * row_stride, min(FQ, N - j * FQ), D,
                              row_stride, blockIdx.x == 0);
    pass_turn(sem_bh + j, blockIdx.x + 1);  // its barrier also ends the tile
  }

  const int row0 = kv0 + 64 * wr + 16 * warp + (lane >> 2);
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

template <int DP, int WGR, int WGC>
int launch_fused_wgmma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, float* dq_acc, int* dq_sem,
                       void* dk, void* dv, int B, int H, int N, int M, int D,
                       const long long* st, float scale, cudaStream_t stream) {
  constexpr size_t smem = fused_wgmma_smem_bytes<DP, WGR, WGC>();
  cudaError_t err = cudaFuncSetAttribute(fused_bwd_wgmma_kernel<DP, WGR, WGC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int vec = sd_sm90::rows_aligned(q, B, N, H, st[0], st[1], st[2]) &&
                  sd_sm90::rows_aligned(k, B, M, H, st[3], st[4], st[5]) &&
                  sd_sm90::rows_aligned(v, B, M, H, st[6], st[7], st[8]) &&
                  sd_sm90::rows_aligned(dout, B, N, H, st[12], st[13], st[14]);
  // kv blocks fastest: the order of the dQ adds
  fused_bwd_wgmma_kernel<DP, WGR, WGC>
      <<<dim3((M + 64 * WGR - 1) / (64 * WGR), H, B), 128 * WGR * WGC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, dq_acc, dq_sem, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, N, M, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[12], st[13], st[14], scale, scale * 1.4426950408889634f, vec);
  return int(cudaGetLastError());
}

int backward_bf16(int D, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, float* delta, float* dq_acc, int* dq_sem, void* dq, void* dk,
                  void* dv, int B, int H, int N, int M, const long long* st, float scale,
                  cudaStream_t stream, int* impl) {
  int rc = launch_bwd_stats_bf16(q, k, v, dout, lse, delta, B, H, N, M, D, st, scale, stream);
  if (rc != 0) return rc;
  rc = int(cudaErrorInvalidValue);
  // (DP, row and column warpgroups)
#define SD_FUSED_CASE(DP, WGR, WGC)                                                           \
  if (D <= DP) {                                                                              \
    rc = launch_fused_wgmma<DP, WGR, WGC>(q, k, v, dout, lse, delta, dq_acc, dq_sem, dk, dv,  \
                                          B, H, N, M, D, st, scale, stream);                  \
  } else
  SD_FUSED_CASE(32, 2, 1) SD_FUSED_CASE(48, 2, 1) SD_FUSED_CASE(64, 2, 1) SD_FUSED_CASE(80, 2, 1)
  SD_FUSED_CASE(128, 1, 2) SD_FUSED_CASE(160, 1, 2) if (D <= 512) {
    rc = launch_fused_bwd_wgmma_d512(q, k, v, dout, lse, delta, dq_acc, dq_sem, dk, dv, B, H, N, M,
                                     D, st, scale, stream);
  }
#undef SD_FUSED_CASE
  if (rc != 0) return rc;

  const int64_t n = int64_t(B) * N * H * D;
  const int64_t cast_blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  cast_kernel<bf16><<<unsigned(cast_blocks), 256, 0, stream>>>(dq_acc, static_cast<bf16*>(dq), n);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *impl = 1;
  return int(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel); D <= 512. `strides` holds 15 element strides: (batch, token, head)
// of q, k, v, o and do in that order. `delta` is f32 [B, H, N] scratch;
// `dq_acc` is f32 [B, N, H, D], written in full (no zeroing needed); `dq_sem`
// is int32, B * H * ceil(N / 16) * 4 counters (one per q tile and column
// part, enough for every kernel's tiling), zeroed by the caller; `dq` is null when dq_acc is
// itself the output (f32), else the bf16 output. `impl` receives the kernel
// launched, written once every launch succeeded: 0 = FMA, 1 = wgmma. Returns
// the first nonzero CUDA error code, 0 on success.
int sd_flash_attention_backward(int dtype, const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const void* lse, void* delta,
                                void* dq_acc, void* dq_sem, void* dq, void* dk, void* dv, int B,
                                int H, int N, int M, int D, const long long* strides, float scale,
                                void* stream, int* impl) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D <= 0 || D > 512 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  int* sem = static_cast<int*>(dq_sem);
  if (dtype == 0)
    return backward_f32(D, q, k, v, o, dout, l, de, acc, sem, dk, dv, B, H, N, M, strides, scale,
                        s, impl);
  if (dtype == 1)
    return backward_bf16(D, q, k, v, dout, l, de, acc, sem, dq, dk, dv, B, H, N, M, strides,
                         scale, s, impl);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
