// GroupNorm(+SiLU) backward for Hopper (sm_90a) in one launch on thread-block
// clusters, CUDA C++ with a plain C interface (K7). It also serves the concat
// form's backward: x may be two channel parts, as in the concat forward (K8).
//
// Replaces the Pallas TPU kernel stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py
// `_gn_bwd_kernel` (launched from `pallas_group_norm_bwd`): with
// x^ = (x - mean) * rstd and, under SiLU, y = x^ * gamma + beta and
// dy' = dy * s(y) * (1 + y * (1 - s(y))) (s the logistic function; else
// dy' = dy),
//   dbeta  = sum over batch and rows of dy',
//   dgamma = sum over batch and rows of dy' * x^,
//   dx     = rstd * (gamma * dy' - (S1 + x^ * S2) / n),
// S1 and S2 the per-(batch, group) sums of gamma * dy' and gamma * dy' * x^,
// n = rows * channels per group. Unlike the TPU kernel, which recomputes the
// statistics from x, it takes mean and rstd (f32 [B, G]) from the forward
// (K6 or K8), as the port has since its first backward.
//
// What bounds it on this card: about 20 FLOPs per element, so bytes; the least
// it can move is one read of x and of dy and one write of dx.
//
// Design: K6's (csrc/group_norm.cu), with a second pass of the same shape.
//   - a cluster of up to 16 CTAs owns one (batch element, slice of whole
//     groups); its CTAs split the rows. The plan is `gn_launch_plan(...,
//     inputs=2)` in ops/fused_groupnorm.py: x and dy share the resident
//     budget, so where both fit, a CTA keeps its rows of both in shared
//     memory; else it reads them again in pass 2 (largely from the 50 MB L2).
//     Slices are at most 16 vectors wide, so a CTA pass has 16 rows in flight;
//   - pass 1 reads x and dy (vectors of up to 16 bytes, two rows of each in
//     flight per thread), forms x^ and dy', and sums dy' and dy' * x^ per
//     channel in f32, in row order. Registers are capped at 128 a thread so
//     that two CTAs share an SM (uncapped, one CTA an SM, it measured
//     slower on the H100: PERF.md, section 6);
//   - per channel over the CTA's row lanes, then per group (times gamma), in
//     shared memory; the CTAs meet through distributed shared memory in rank
//     order (all of a thread's remote loads in flight first) for S1 and S2
//     (every CTA forms the same sums), and for the per-channel dbeta and
//     dgamma, which each CTA sums for a share of the channels and writes as
//     f32 [B, C] partials;
//   - pass 2 writes dx once, into its part;
//   - dgamma and dbeta: the last cluster of each slice to finish sums the
//     [B, C] partials over the batch in batch order. It learns that it is
//     last from a per-slice counter (`atomicInc` wraps it back to 0 at B - 1,
//     so the counter is reset by the launch itself: no memset, and the call
//     stays one device kernel that a CUDA graph can capture). The writers
//     fence their partials before the count; the last reads them past L1.
// Every sum runs in an order fixed by the plan, so a repeat gives the same
// bits, and no launch waits on another block: the count only picks the block
// that finishes the sum.
//
// Layout: x (each part), dy and dx (each part) contiguous, channels last;
// gamma, beta f32 [C]; partial f32 [2, B, C] scratch; dgamma, dbeta f32 [C];
// counter uint32 [n_slices], zero before the first launch.

#include "group_norm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sd_gn;

constexpr int GN_BWD_UNROLL = 2;  // rows of x and of dy a thread loads before it uses any
constexpr int GN_BWD_MIN_BLOCKS = 2;  // CTAs an SM holds: registers capped at 128 a thread
constexpr int GN_MAX_RANKS = 16;  // CTAs of a cluster
constexpr int GN_SUM_UNROLL = 8;  // batch partials a thread loads before it adds any

template <int VEC>
struct Elem {  // one thread's per-channel constants
  float mean[VEC], rstd[VEC], gamma[VEC], beta[VEC];
};

// x^ and dy' of one element
__device__ __forceinline__ void xhat_dy(float x, float dy, float mean, float rstd, float gamma,
                                        float beta, int silu, float& xh, float& d) {
  xh = (x - mean) * rstd;
  d = dy;
  if (silu) {
    const float y = fmaf(xh, gamma, beta);
    const float sg = __fdividef(1.f, 1.f + __expf(-y));
    d = dy * (sg * fmaf(y, 1.f - sg, 1.f));
  }
}

// a and b: the sums over the cluster's ranks 0..cs-1, in rank order, of the
// floats at p and q in each CTA's shared memory (all loads in flight first)
__device__ __forceinline__ void rank_sums(cg::cluster_group& cluster, float* p, float* q, int cs,
                                          float& a, float& b) {
  float vp[GN_MAX_RANKS], vq[GN_MAX_RANKS];
#pragma unroll
  for (int r = 0; r < GN_MAX_RANKS; ++r)
    if (r < cs) {
      vp[r] = *cluster.map_shared_rank(p, r);
      vq[r] = *cluster.map_shared_rank(q, r);
    }
  a = b = 0.f;
#pragma unroll
  for (int r = 0; r < GN_MAX_RANKS; ++r)
    if (r < cs) {
      a += vp[r];
      b += vq[r];
    }
}

// Grid (cluster, n_slices, B), cluster (cluster, 1, 1), as K6.
template <typename RAW, int VEC>
__global__ void __launch_bounds__(GN_NT, GN_BWD_MIN_BLOCKS) gn_bwd_cluster_kernel(
    const RAW* __restrict__ x0, const RAW* __restrict__ x1, const RAW* __restrict__ dy,
    RAW* __restrict__ dx0, RAW* __restrict__ dx1, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ partial, float* __restrict__ dgamma, float* __restrict__ dbeta,
    unsigned int* __restrict__ counter, int S, int c0, int c1, int G, int cpg, int gps,
    int rows_per_cta, int resident, int silu) {
  using P = Pack<RAW, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = c0 + c1;
  const int B = gridDim.z;
  const int W = gps * cpg;  // slice channels
  const int V = W / VEC;    // vectors per row
  const int RP = GN_NT / V; // rows in flight per pass of the CTA (plan: V <= GN_NT)
  const int tid = threadIdx.x;
  const bool active = tid < RP * V;
  const int vc = tid % V;   // this thread's vector column
  const int rl = tid / V;   // and its first row
  const int rank = blockIdx.x;
  const int slice = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = rank * rows_per_cta;
  const int r1 = min(S, r0 + rows_per_cta);
  const int g0 = slice * gps;         // the slice's first group
  const int cc = g0 * cpg + vc * VEC;  // this thread's first channel of the concat
  const PartCol<const RAW> in = part_col<true>(x0, x1, c0, c1, cc);
  const PartCol<RAW> out = part_col<true>(dx0, dx1, c0, c1, cc);

  extern __shared__ __align__(16) uint8_t smem_gn[];
  // [resident rows x W] RAW of x, the same of dy, then red_b, red_s [RP][W]
  // f32, part [2][gps], sums [2][gps], wred [2][W]
  const size_t buf_bytes = resident ? (size_t(rows_per_cta) * W * sizeof(RAW) + 15) / 16 * 16 : 0;
  RAW* buf_x = reinterpret_cast<RAW*>(smem_gn);
  RAW* buf_dy = reinterpret_cast<RAW*>(smem_gn + buf_bytes);
  float* red_b = reinterpret_cast<float*>(smem_gn + 2 * buf_bytes);  // dy' per lane, then per channel
  float* red_s = red_b + RP * W;  // dy' * x^
  float* part = red_s + RP * W;   // [S1 gps][S2 gps] of this CTA
  float* sums = part + 2 * gps;   // [S1 gps][S2 gps] of the cluster
  float* wred = sums + 2 * gps;   // gamma * red_b, gamma * red_s per channel

  const RAW* xb = in.base + int64_t(b) * S * in.ld + in.col;
  const RAW* dyb = dy + int64_t(b) * S * C + cc;
  RAW* dxb = out.base + int64_t(b) * S * out.ld + out.col;

  Elem<VEC> k;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int g = g0 + (vc * VEC + e) / cpg;
    k.mean[e] = mean[int64_t(b) * G + g];
    k.rstd[e] = rstd[int64_t(b) * G + g];
    k.gamma[e] = gamma[cc + e];
    k.beta[e] = beta[cc + e];
  }

  // pass 1: per-channel sums of dy' and dy' * x^ over this thread's rows, in row order
  float sb[VEC], ss[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sb[e] = ss[e] = 0.f;
  if (active) {
    for (int r = r0 + rl; r < r1; r += GN_BWD_UNROLL * RP) {
      P px[GN_BWD_UNROLL], pd[GN_BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_BWD_UNROLL; ++u)
        if (r + u * RP < r1) {
          px[u] = *reinterpret_cast<const P*>(xb + int64_t(r + u * RP) * in.ld);
          pd[u] = *reinterpret_cast<const P*>(dyb + int64_t(r + u * RP) * C);
        }
#pragma unroll
      for (int u = 0; u < GN_BWD_UNROLL; ++u) {
        if (r + u * RP >= r1) break;
        if (resident) {
          *reinterpret_cast<P*>(buf_x + (r + u * RP - r0) * W + vc * VEC) = px[u];
          *reinterpret_cast<P*>(buf_dy + (r + u * RP - r0) * W + vc * VEC) = pd[u];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float xh, d;
          xhat_dy(raw_to_f32(px[u].v[e]), raw_to_f32(pd[u].v[e]), k.mean[e], k.rstd[e], k.gamma[e],
                  k.beta[e], silu, xh, d);
          sb[e] += d;
          ss[e] = fmaf(d, xh, ss[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red_b[rl * W + vc * VEC + e] = sb[e];
      red_s[rl * W + vc * VEC + e] = ss[e];
    }
  }
  __syncthreads();
  // per channel over the RP row lanes (kept for dbeta and dgamma, and times
  // gamma for S1 and S2), then per group over its channels
  for (int c = tid; c < W; c += GN_NT) {
    float a = 0.f, a2 = 0.f;
    for (int r = 0; r < RP; ++r) {
      a += red_b[r * W + c];
      a2 += red_s[r * W + c];
    }
    red_b[c] = a;
    red_s[c] = a2;
    const float w = gamma[g0 * cpg + c];
    wred[c] = w * a;
    wred[W + c] = w * a2;
  }
  __syncthreads();
  for (int g = tid; g < gps; g += GN_NT) {
    float a = 0.f, a2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += wred[c];
      a2 += wred[W + c];
    }
    part[g] = a;
    part[gps + g] = a2;
  }

  // S1 and S2 of the cluster (every CTA), and the per-channel partials of
  // dbeta and dgamma (each CTA a share of the channels), in rank order from
  // every CTA's shared memory
  cluster.sync();
  const int cs = gridDim.x;  // the cluster spans the grid's x: ranks 0..cs-1 = blockIdx.x
  for (int g = tid; g < gps; g += GN_NT) rank_sums(cluster, part + g, part + gps + g, cs, sums[g], sums[gps + g]);
  for (int c = rank + cs * tid; c < W; c += cs * GN_NT) {
    float a, a2;
    rank_sums(cluster, red_b + c, red_s + c, cs, a, a2);
    partial[(int64_t(B) + b) * C + g0 * cpg + c] = a;  // dbeta
    partial[int64_t(b) * C + g0 * cpg + c] = a2;       // dgamma
  }
  if (rank + cs * tid < W) __threadfence();  // the partials are visible to the device before the count
  cluster.sync();   // every share written and fenced; no CTA reads another's sums past here

  // pass 2: dx = rstd * (gamma * dy' - (S1 + x^ * S2) / n), from shared memory
  // or from x and dy again (streaming)
  if (active) {
    const float inv_n = 1.f / (float(S) * float(cpg));
    float k1[VEC], k2[VEC];  // rstd * S1 / n, rstd * S2 / n
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int gl = (vc * VEC + e) / cpg;
      k1[e] = k.rstd[e] * sums[gl] * inv_n;
      k2[e] = k.rstd[e] * sums[gps + gl] * inv_n;
    }
    for (int r = r0 + rl; r < r1; r += GN_BWD_UNROLL * RP) {
      P px[GN_BWD_UNROLL], pd[GN_BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_BWD_UNROLL; ++u)
        if (r + u * RP < r1) {
          const int rr = r + u * RP;
          px[u] = resident ? *reinterpret_cast<const P*>(buf_x + (rr - r0) * W + vc * VEC)
                           : *reinterpret_cast<const P*>(xb + int64_t(rr) * in.ld);
          pd[u] = resident ? *reinterpret_cast<const P*>(buf_dy + (rr - r0) * W + vc * VEC)
                           : *reinterpret_cast<const P*>(dyb + int64_t(rr) * C);
        }
#pragma unroll
      for (int u = 0; u < GN_BWD_UNROLL; ++u) {
        if (r + u * RP >= r1) break;
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float xh, d;
          xhat_dy(raw_to_f32(px[u].v[e]), raw_to_f32(pd[u].v[e]), k.mean[e], k.rstd[e], k.gamma[e],
                  k.beta[e], silu, xh, d);
          o.v[e] = f32_to_raw<RAW>(fmaf(k.rstd[e] * k.gamma[e], d, -fmaf(k2[e], xh, k1[e])));
        }
        *reinterpret_cast<P*>(dxb + int64_t(r + u * RP) * out.ld) = o;
      }
    }
  }

  // dgamma and dbeta: the slice's last cluster (its rank 0) sums the
  // partials over the batch, in batch order
  if (rank != 0) return;
  unsigned int* last = reinterpret_cast<unsigned int*>(part);  // free since the cluster sync
  __syncthreads();
  if (tid == 0) *last = atomicInc(counter + slice, unsigned(B - 1)) == unsigned(B - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int c = tid; c < W; c += GN_NT) {
    const float* pg = partial + g0 * cpg + c;  // dgamma partials, batch stride C
    const float* pb = pg + int64_t(B) * C;     // dbeta
    float a = 0.f, a2 = 0.f;
    for (int b0 = 0; b0 < B; b0 += GN_SUM_UNROLL) {
      float vb[GN_SUM_UNROLL], vg[GN_SUM_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_SUM_UNROLL; ++u)
        if (b0 + u < B) {
          vb[u] = __ldcg(pb + int64_t(b0 + u) * C);  // past L1: written by other SMs
          vg[u] = __ldcg(pg + int64_t(b0 + u) * C);
        }
#pragma unroll
      for (int u = 0; u < GN_SUM_UNROLL; ++u)
        if (b0 + u < B) {
          a += vb[u];
          a2 += vg[u];
        }
    }
    dbeta[g0 * cpg + c] = a;
    dgamma[g0 * cpg + c] = a2;
  }
}

template <typename RAW, int VEC>
int launch_gn_bwd(const void* x0, const void* x1, const void* dy, void* dx0, void* dx1,
                  const float* mean, const float* rstd, const float* gamma, const float* beta,
                  float* partial, float* dgamma, float* dbeta, unsigned int* counter, int B, int S,
                  int c0, int c1, int G, int gps, int cluster, int rows_per_cta, int resident,
                  size_t smem, int silu, cudaStream_t stream) {
  auto kernel = gn_bwd_cluster_kernel<RAW, VEC>;
  static bool configured = false;
  cudaError_t err = configure_once(kernel, configured);
  if (err != cudaSuccess) return int(err);
  ClusterLaunch launch(cluster, G / gps, B, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, static_cast<const RAW*>(x0), static_cast<const RAW*>(x1),
                           static_cast<const RAW*>(dy), static_cast<RAW*>(dx0), static_cast<RAW*>(dx1),
                           mean, rstd, gamma, beta, partial, dgamma, dbeta, counter, S, c0, c1, G,
                           (c0 + c1) / G, gps, rows_per_cta, resident, silu);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// GroupNorm(+SiLU) backward (dtype 0 = float32, 1 = bfloat16) of x0 [B, S, C0]
// (x1 and dx1 null, C1 = 0) or of the concat of x0 and x1 [B, S, C1] along
// channels: from dy [B, S, C0 + C1] and the forward's mean and rstd f32
// [B, G], writes dx0 (and dx1) like the parts, and dgamma and dbeta f32
// [C0 + C1], with `partial` f32 [2, B, C0 + C1] scratch and `counter` uint32
// [G / gps], zero before the first launch (each launch leaves it zero). The
// launch plan comes from `gn_launch_plan(..., inputs=2)` in
// ops/fused_groupnorm.py. Returns the first nonzero CUDA error code, 0 on
// success.
int sd_group_norm_backward(int dtype, const void* x0, const void* x1, const void* dy, void* dx0,
                           void* dx1, const void* mean, const void* rstd, const void* gamma,
                           const void* beta, void* partial, void* dgamma, void* dbeta,
                           void* counter, int B, int S, int C0, int C1, int G, int gps, int cluster,
                           int rows_per_cta, int vec, int resident, long long smem, int silu,
                           void* stream) {
  const int C = C0 + C1;
  if (B <= 0 || S <= 0 || C0 <= 0 || C1 < 0 || (C1 > 0) != (x1 != nullptr) ||
      (C1 > 0) != (dx1 != nullptr) || G <= 0 || C % G || G % gps || cluster < 1 || cluster > 16 ||
      B > 65535 || G / gps > 65535 || rows_per_cta <= 0 || vec <= 0 || C0 % vec || C1 % vec ||
      (gps * (C / G)) % vec || (gps * (C / G)) / vec > GN_NT || smem > GN_SMEM_MAX)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* w = static_cast<const float*>(gamma);
  const float* bb = static_cast<const float*>(beta);
  float* pp = static_cast<float*>(partial);
  float* dw = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  unsigned int* ctr = static_cast<unsigned int*>(counter);
#define SD_GN_BWD_CASE(RAW, V)                                                                      \
  if (vec == V)                                                                                     \
    return launch_gn_bwd<RAW, V>(x0, x1, dy, dx0, dx1, m, r, w, bb, pp, dw, db, ctr, B, S, C0, C1, G, \
                                 gps, cluster, rows_per_cta, resident, size_t(smem), silu, s);
  if (dtype == 1) {
    SD_GN_BWD_CASE(uint16_t, 8) SD_GN_BWD_CASE(uint16_t, 4) SD_GN_BWD_CASE(uint16_t, 2)
    SD_GN_BWD_CASE(uint16_t, 1)
  } else if (dtype == 0) {
    SD_GN_BWD_CASE(uint32_t, 4) SD_GN_BWD_CASE(uint32_t, 2) SD_GN_BWD_CASE(uint32_t, 1)
  }
#undef SD_GN_BWD_CASE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
