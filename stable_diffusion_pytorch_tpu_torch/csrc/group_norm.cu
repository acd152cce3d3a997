// GroupNorm(+SiLU) forward for Hopper (sm_90a) in one launch on thread-block
// clusters, CUDA C++ with a plain C interface: the plain form (K6) and the
// concat form (K8), two kernels on one body.
//
// Replaces the Pallas TPU kernels stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py
// `_gn_kernel` (launched from `pallas_group_norm`; K6) and `_gn_cat_kernel`
// (from `pallas_group_norm_cat`; K8): y = (x - mean) * rstd * gamma + beta,
// SiLU optional, over channels-last x [B, S, C] with per-(batch, group)
// statistics in f32, var = E[x^2] - mean^2 (the JAX kernel's formula), and
// the statistics written out as f32 [B, G] for the backward (K7). K8's x is
// the virtual concat of two parts [B, S, C0] and [B, S, C1] along channels,
// never stored: the output is [B, S, C0 + C1].
//
// What bounds it on this card: about 10 FLOPs per element, so bytes; the least
// it can move is one read of x and one write of y.
//
// Why not the TPU design: the TPU kernel holds a whole batch element in VMEM
// (one grid step per image). A Hopper block has at most 227 KB of shared
// memory, the UNet's 1024px level-0 map is 16384 x 320 bf16 = 10.5 MB, and one
// block per image would leave most of the 132 SMs idle. The statistics need
// a reduction over a whole (batch, group) before any element can be written,
// and a reduction across blocks would need a second launch, or atomics and a
// second read of x. Clusters give a third way:
//   - a cluster of up to 16 CTAs owns one (batch element, slice of whole
//     groups); its CTAs split the slice's rows (CTA rank r takes rows
//     r * rows_per_cta..). The slice width (groups per slice) and the cluster
//     size come from the launch plan in ops/fused_groupnorm.py
//     (`gn_launch_plan`): as wide a slice as still puts about one CTA on
//     every SM at the call's batch, the cluster large enough that a CTA's
//     rows fit its shared memory where the map allows;
//   - each CTA reads its rows x slice channels once, with vector loads of up
//     to 16 bytes, eight rows' loads in flight per thread before any is used
//     (one at a time left each CTA at a few GB/s, latency-bound), keeping
//     them in shared memory (`resident`), and forms per
//     channel f32 sums of x and x^2, then per-group sums, in a fixed order;
//   - the CTAs of the cluster read each other's group sums through
//     distributed shared memory, in rank order, so every CTA forms the same
//     mean and rstd and the result does not depend on scheduling; rank 0
//     writes them to [B, G];
//   - each CTA then normalizes, applies the affine and SiLU from shared
//     memory and writes y once. Where a CTA's rows do not fit (the VAE
//     decoder's 512^2 x 128 map: 64 MB per image in bf16), the plan streams:
//     the CTA reads its rows again from device memory (largely from the 50 MB
//     L2) in the second pass. Still one launch.
// A cluster of 16 exceeds the portable 8: the launch allows non-portable
// cluster sizes; a plan that the card cannot schedule fails the launch, and
// the wrapper raises.
//
// The concat form (K8) runs the same loops: each thread's vector column lies
// wholly in one part (the plan's vector width divides C0 and C1 and suits
// both pointers), so the thread picks that part's base pointer and row stride
// once (`part_col`); the output's row stride is C0 + C1. A group that
// straddles the parts needs no special case: sums run per channel, then per
// group, in shared memory. Its kernel has its own name
// (`gn_cat_cluster_kernel`) so that a profile tells it from K6's.
//
// Layout: x (each part) and y contiguous (channels last), gamma and beta f32
// [C].

#include "group_norm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sd_gn;

constexpr int GN_UNROLL = 8;  // rows a thread loads before it uses any: the loads in flight

// Grid (cluster, n_slices, B), cluster (cluster, 1, 1): blockIdx.x is the
// CTA's rank in its cluster, blockIdx.y the slice, blockIdx.z the batch
// element. RAW is the element's bits (uint16_t bf16, uint32_t f32). TWO: x is
// the concat of the parts x0 [B, S, c0] and x1 [B, S, c1]; else x0 [B, S, c0].
template <typename RAW, int VEC, bool TWO>
__device__ __forceinline__ void gn_fwd_body(
    const RAW* __restrict__ x0, const RAW* __restrict__ x1, int c0, int c1, RAW* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, const float* __restrict__ gamma,
    const float* __restrict__ beta, int S, int G, int cpg, int gps, int rows_per_cta, int resident,
    int silu, float eps) {
  using P = Pack<RAW, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int ld_out = c0 + c1;
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
  const int g0 = slice * gps;             // the slice's first group
  const int c_out = g0 * cpg + vc * VEC;  // this thread's first channel of the (concat) map
  const PartCol<const RAW> in = part_col<TWO>(x0, x1, c0, c1, c_out);

  extern __shared__ __align__(16) uint8_t smem_gn[];
  // [resident rows x W] RAW, then red_s, red_q [RP][W] f32, part [2][gps], stats [2][gps]
  RAW* buf = reinterpret_cast<RAW*>(smem_gn);
  const size_t buf_bytes = resident ? (size_t(rows_per_cta) * W * sizeof(RAW) + 15) / 16 * 16 : 0;
  float* red_s = reinterpret_cast<float*>(smem_gn + buf_bytes);
  float* red_q = red_s + RP * W;
  float* part = red_q + RP * W;   // [sum gps][sum of squares gps] of this CTA
  float* stats = part + 2 * gps;  // [mean gps][rstd gps] of the cluster

  const RAW* xb = in.base + int64_t(b) * S * in.ld + in.col;
  RAW* yb = y + int64_t(b) * S * ld_out;

  // pass 1: per-channel sums of x and x^2 over this thread's rows, in row order
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (active) {
    for (int r = r0 + rl; r < r1; r += GN_UNROLL * RP) {
      // GN_UNROLL independent loads in flight before any is used
      P p[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u)
        if (r + u * RP < r1) p[u] = *reinterpret_cast<const P*>(xb + int64_t(r + u * RP) * in.ld);
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        if (r + u * RP >= r1) break;
        if (resident) *reinterpret_cast<P*>(buf + (r + u * RP - r0) * W + vc * VEC) = p[u];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = raw_to_f32(p[u].v[e]);
          s[e] += f;
          q[e] = fmaf(f, f, q[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red_s[rl * W + vc * VEC + e] = s[e];
      red_q[rl * W + vc * VEC + e] = q[e];
    }
  }
  __syncthreads();
  // per channel over the RP row lanes, then per group over its channels
  for (int c = tid; c < W; c += GN_NT) {
    float a = 0.f, a2 = 0.f;
    for (int r = 0; r < RP; ++r) {
      a += red_s[r * W + c];
      a2 += red_q[r * W + c];
    }
    red_s[c] = a;
    red_q[c] = a2;
  }
  __syncthreads();
  for (int g = tid; g < gps; g += GN_NT) {
    float a = 0.f, a2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      a += red_s[c];
      a2 += red_q[c];
    }
    part[g] = a;
    part[gps + g] = a2;
  }

  // the cluster's sums, in rank order, from every CTA's shared memory
  cluster.sync();
  const int cs = gridDim.x;  // the cluster spans the grid's x: ranks 0..cs-1 = blockIdx.x
  const float n = float(S) * float(cpg);
  for (int g = tid; g < gps; g += GN_NT) {
    float a = 0.f, a2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float* remote = cluster.map_shared_rank(part, r);
      a += remote[g];
      a2 += remote[gps + g];
    }
    const float mean = a / n;
    const float var = a2 / n - mean * mean;
    const float rstd = rsqrtf(var + eps);
    stats[g] = mean;
    stats[gps + g] = rstd;
    if (rank == 0) {
      mean_out[int64_t(b) * G + g0 + g] = mean;
      rstd_out[int64_t(b) * G + g0 + g] = rstd;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its sums; stats visible

  // pass 2: normalize, affine, SiLU; from shared memory, or x again (streaming)
  if (!active) return;
  // y = x * a + c per channel, a = rstd * gamma, c = beta - mean * a: one FMA
  // an element (the pass has about as many instructions as bytes to move)
  float a[VEC], c[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int gl = (vc * VEC + e) / cpg;
    a[e] = stats[gps + gl] * gamma[c_out + e];
    c[e] = fmaf(-stats[gl], a[e], beta[c_out + e]);
  }
  for (int r = r0 + rl; r < r1; r += GN_UNROLL * RP) {
    P p[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (r + u * RP < r1)
        p[u] = resident ? *reinterpret_cast<const P*>(buf + (r + u * RP - r0) * W + vc * VEC)
                        : *reinterpret_cast<const P*>(xb + int64_t(r + u * RP) * in.ld);
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      if (r + u * RP >= r1) break;
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = fmaf(raw_to_f32(p[u].v[e]), a[e], c[e]);
        if (silu) v = __fdividef(v, 1.f + __expf(-v));  // v * sigmoid(v)
        o.v[e] = f32_to_raw<RAW>(v);
      }
      *reinterpret_cast<P*>(yb + int64_t(r + u * RP) * ld_out + c_out) = o;
    }
  }
}

// K6: GroupNorm of x [B, S, C]
template <typename RAW, int VEC>
__global__ void __launch_bounds__(GN_NT) gn_fwd_cluster_kernel(
    const RAW* __restrict__ x, RAW* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, const float* __restrict__ gamma, const float* __restrict__ beta,
    int S, int C, int G, int cpg, int gps, int rows_per_cta, int resident, int silu, float eps) {
  gn_fwd_body<RAW, VEC, false>(x, x, C, 0, y, mean_out, rstd_out, gamma, beta, S, G, cpg, gps,
                               rows_per_cta, resident, silu, eps);
}

// K8: GroupNorm of the virtual concat(x0 [B, S, c0], x1 [B, S, c1]) into y [B, S, c0 + c1]
template <typename RAW, int VEC>
__global__ void __launch_bounds__(GN_NT) gn_cat_cluster_kernel(
    const RAW* __restrict__ x0, const RAW* __restrict__ x1, int c0, int c1, RAW* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, const float* __restrict__ gamma,
    const float* __restrict__ beta, int S, int G, int cpg, int gps, int rows_per_cta, int resident,
    int silu, float eps) {
  gn_fwd_body<RAW, VEC, true>(x0, x1, c0, c1, y, mean_out, rstd_out, gamma, beta, S, G, cpg, gps,
                              rows_per_cta, resident, silu, eps);
}

template <typename RAW, int VEC>
int launch_gn(const void* x0, const void* x1, void* y, float* mean, float* rstd,
              const float* gamma, const float* beta, int B, int S, int c0, int c1, int G, int gps,
              int cluster, int rows_per_cta, int resident, size_t smem, int silu, float eps,
              cudaStream_t stream) {
  static bool configured_k6 = false, configured_k8 = false;
  cudaError_t err = c1 ? configure_once(gn_cat_cluster_kernel<RAW, VEC>, configured_k8)
                       : configure_once(gn_fwd_cluster_kernel<RAW, VEC>, configured_k6);
  if (err != cudaSuccess) return int(err);
  ClusterLaunch launch(cluster, G / gps, B, smem, stream);
  const int cpg = (c0 + c1) / G;
  const RAW* p0 = static_cast<const RAW*>(x0);
  RAW* out = static_cast<RAW*>(y);
  if (c1)
    err = cudaLaunchKernelEx(&launch.cfg, gn_cat_cluster_kernel<RAW, VEC>, p0, static_cast<const RAW*>(x1),
                             c0, c1, out, mean, rstd, gamma, beta, S, G, cpg, gps, rows_per_cta,
                             resident, silu, eps);
  else
    err = cudaLaunchKernelEx(&launch.cfg, gn_fwd_cluster_kernel<RAW, VEC>, p0, out, mean, rstd, gamma,
                             beta, S, c0, G, cpg, gps, rows_per_cta, resident, silu, eps);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// GroupNorm(+SiLU) of x0 [B, S, C0] (K6; x1 null, C1 = 0) or of the concat of
// x0 and x1 [B, S, C1] along channels (K8) (dtype 0 = float32, 1 = bfloat16)
// into y [B, S, C0 + C1], with mean and rstd f32 [B, G], gamma/beta f32
// [C0 + C1]; the launch plan (groups per slice, cluster size, rows per CTA,
// vector width in elements, whether the rows stay in shared memory, and the
// dynamic shared memory in bytes) comes from `gn_launch_plan` in
// ops/fused_groupnorm.py. Returns the first nonzero CUDA error code, 0 on
// success.
int sd_group_norm_forward(int dtype, const void* x0, const void* x1, void* y, void* mean,
                          void* rstd, const void* gamma, const void* beta, int B, int S, int C0,
                          int C1, int G, int gps, int cluster, int rows_per_cta, int vec,
                          int resident, long long smem, int silu, float eps, void* stream) {
  const int C = C0 + C1;
  if (B <= 0 || S <= 0 || C0 <= 0 || C1 < 0 || (C1 > 0) != (x1 != nullptr) || G <= 0 || C % G ||
      G % gps || cluster < 1 || cluster > 16 || B > 65535 || G / gps > 65535 || rows_per_cta <= 0 ||
      vec <= 0 || C0 % vec || C1 % vec || (gps * (C / G)) % vec || (gps * (C / G)) / vec > GN_NT ||
      smem > GN_SMEM_MAX)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const float* w = static_cast<const float*>(gamma);
  const float* bb = static_cast<const float*>(beta);
#define SD_GN_CASE(RAW, V)                                                                         \
  if (vec == V)                                                                                    \
    return launch_gn<RAW, V>(x0, x1, y, m, r, w, bb, B, S, C0, C1, G, gps, cluster, rows_per_cta,  \
                             resident, size_t(smem), silu, eps, s);
  if (dtype == 1) {
    SD_GN_CASE(uint16_t, 8) SD_GN_CASE(uint16_t, 4) SD_GN_CASE(uint16_t, 2) SD_GN_CASE(uint16_t, 1)
  } else if (dtype == 0) {
    SD_GN_CASE(uint32_t, 4) SD_GN_CASE(uint32_t, 2) SD_GN_CASE(uint32_t, 1)
  }
#undef SD_GN_CASE
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
