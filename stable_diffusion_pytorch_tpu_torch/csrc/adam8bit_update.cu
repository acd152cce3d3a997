// The int8 Adam optimizer step (K9) for Hopper (sm_90a), CUDA C++ with a plain C interface.
//
// Replaces the Pallas TPU kernel stable_diffusion_pytorch_tpu/ops/adam8bit_update.py
// `_kernel`, and fuses into it the gradient clip before it and the parameter
// apply after it (trainers/adam8bit.py). One launch updates every leaf of an
// optimizer step. Per element, in this order:
//
//   the clip      g' = g when norm < clip, else (g / norm) * clip, each op
//                 rounded to g's dtype (optax.clip_by_global_norm, as
//                 torch.where(keep, g, (g / norm.to(g.dtype)) * clip.to(g.dtype)))
//   K9            dequantize both stored moments, the f32 Adam recurrence with
//                 the bias corrections, u = (mu / bc1) / (sqrt(nu / bc2) + eps)
//                 rounded to g's dtype, the blockwise absmax, the requantized
//                 moments (nu in the sqrt domain):
//                   q  = clip(rint(127 * sign(x) * sqrt(|x| / absmax_block)), -127, 127)
//                   x~ = sign(q) * (q/127)^2 * absmax_block
//   the apply     t = p * wd; t += u; t *= -lr; p += t, in f32
//
// Numerics follow the plain version's op order exactly
// (ops/adam8bit_update.py:adam8bit_step_plain). Every product, sum, quotient
// and square root is written with the IEEE round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into FMAs; rint rounds half to even as torch.round does; sign(0) = 0; the
// scale of an all-zero block is 1 for the division and stored as 0. The
// update never reaches device memory on the step path (the one-leaf entry
// writes it instead of applying it).
//
// Layout and work (ops/adam8bit_update.py:adam8bit_plan builds both tables):
// each leaf is viewed as [O, R] (O = dim 0 of the port's layout, the JAX
// minor axis); the absmax blocks run along dim 0, `block` rows for each
// column r; scales are f32 [nb, R]. A work item is (leaf, block j, a run of
// `cols` neighbouring columns); one CTA of NT = 512 threads takes one item,
// thread t the column t % cols and every (512 / cols)-th row from t / cols.
// With R >= 32 (the column mapping) a warp's lanes take neighbouring columns;
// with R < 32 (the row mapping: the whole width in one item) consecutive
// threads take consecutive addresses across the block's rows, so no lane
// idles. Both are the same index rule. A quantization block is owned by
// exactly one CTA, so the update is in place: codes and scales are read
// before the CTA writes them, each element by the thread that writes it, the
// scales before the barrier that precedes their write.
//
// One pass where the item fits on chip: the f32 moments (mu and sqrt(nu)) wait
// in shared memory between the absmax and the requantize (item <= 8192
// elements, 64 KB). Where a block is too tall for that, the item recomputes
// them in a second pass from the unchanged gradient and codes (flag
// RECOMPUTE), bit for bit the same arithmetic. In the SD-1.5 UNet (686
// leaves, 859,520,964 parameters, 114,955 items) every item takes one pass:
// the 404 1-D leaves take the row mapping (blocks of 4 to 1920 rows, one
// column); the column mapping takes 32 columns of a 256-row block (O = 1280
// to 10240), 16 of a 320-row block, 8 of a 640-row block (O = 320 and 640
// take one block) and 512 of the output conv's 4 rows.
//
// What bounds it on this card: bytes. Per parameter it must read g (4 or 2 B),
// both codes (2 B) and p (4 B) and write both codes (2 B) and p (4 B), plus
// the scales: 16 B at f32 g and 14 B at bf16 g, 4.12 and 3.61 ms at 3.35 TB/s
// for the SD-1.5 UNet. Each thread issues the loads of UNROLL rows before it
// uses them (the in-place stores would otherwise keep the compiler from
// hoisting the next rows' loads); two CTAs share an SM. Measured on the H100
// it runs at about 2.3x that bound; a variant of the same structure with the
// arithmetic stripped out takes about 90 % of its time, so the IEEE divisions
// and square roots are not what holds it back, and neither occupancy, deeper
// unrolling, a persistent grid nor 16-byte accesses moved it (PERF.md,
// section 6, PR 8, has the variants tried, cp.async staging among them).
//
// The bias corrections and the learning rate are read from a device buffer
// written once per step and the gradient pointers from a device array, so
// the launch's only per-step argument is the address of the global norm,
// which the kernel reads on the device.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;             // threads per CTA (ops/adam8bit_update.py:THREADS)
constexpr int MIN_CTAS = 2;         // CTAs per SM the register budget allows
constexpr int UNROLL = 4;           // rows a thread loads before it computes
constexpr int RECOMPUTE = 1 << 30;  // item flag: requantize from recomputed moments
constexpr int MAX_SMEM = 227 * 1024;

// One leaf of the table (ops/adam8bit_update.py:LEAF_FIELDS, 12 x 8 bytes).
// The *_out pointers equal the inputs on the step path (in place).
struct Leaf {
  const int8_t* mu_q;
  const float* mu_s;
  const int8_t* nu_q;
  const float* nu_s;
  int8_t* mu_q_out;
  float* mu_s_out;
  int8_t* nu_q_out;
  float* nu_s_out;
  float* p;    // the f32 parameter, updated in place (null when upd is set)
  void* upd;   // the update in g's dtype, written instead of applied (null on the step path)
  long long R;
  long long block;
};

// One work item (ops/adam8bit_update.py:adam8bit_plan, 4 x int32).
struct Item {
  int leaf, j, c0, cols;  // cols | RECOMPUTE
};

struct Coeffs {
  float b1, omb1, b2, omb2, eps, wd, clip;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to G's precision, as an f32 value
template <typename G> __device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<G>(x)); }

// sign(qf) * qf * qf * scale with qf = q * (1/127), left to right; sign(qf) * qf
// is |qf| exactly, so the first product is |qf| * qf
__device__ __forceinline__ float dequant(int8_t q, float scale) {
  const float qf = __fmul_rn(float(q), 1.0f / 127.0f);
  return __fmul_rn(__fmul_rn(fabsf(qf), qf), scale);
}

// 127 * sign(y) * sqrt(|y|): the first product is exact, and rounding is
// symmetric, so it is sign(y) times the rounded 127 * sqrt(|y|) (y = +-0 and
// NaN give 0 and -127 either way)
__device__ __forceinline__ int8_t quant(float x, float absmax) {
  const float safe = absmax > 0.f ? absmax : 1.f;
  const float y = __fdiv_rn(x, safe);
  const float v = copysignf(__fmul_rn(127.f, __fsqrt_rn(fabsf(y))), y);
  const float q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return int8_t(q);
}

// |x| as bits: ordered as the floats, a NaN above every number (jnp.max and
// torch.amax propagate NaN), so a max of bits is the absmax
__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(fabsf(x)); }

// The clipped gradient: g when keep, else (g / norm) * clip in G's precision
// (norm_g and clip_g already rounded to it).
template <typename G>
__device__ __forceinline__ float clipped(G g, bool keep, float norm_g, float clip_g) {
  const float x = to_f32(g);
  return keep ? x : round_to<G>(__fmul_rn(round_to<G>(__fdiv_rn(x, norm_g)), clip_g));
}

// mu = b1 * mu~ + (1 - b1) * g ;  nu = b2 * (sqrt(nu)~)^2 + (1 - b2) * g * g
__device__ __forceinline__ void moments(float g, int8_t mq, float ms, int8_t nq, float ns,
                                        const Coeffs& c, float& mu, float& nu) {
  mu = __fadd_rn(__fmul_rn(c.b1, dequant(mq, ms)), __fmul_rn(c.omb1, g));
  const float nu_sqrt = dequant(nq, ns);
  nu = __fadd_rn(__fmul_rn(c.b2, __fmul_rn(nu_sqrt, nu_sqrt)), __fmul_rn(__fmul_rn(c.omb2, g), g));
}

template <typename G>
__global__ void __launch_bounds__(NT, MIN_CTAS) adam8bit_step_kernel(
    const Leaf* __restrict__ leaves, const Item* __restrict__ items, const void* const* __restrict__ grads,
    const float* __restrict__ scalars, const float* __restrict__ norm, Coeffs c) {
  extern __shared__ float moments_smem[];  // one-pass items: mu, then sqrt(nu), each [rows][cols]
  __shared__ unsigned amax[2][NT];         // per column: |mu| and sqrt(nu) maxima, as bits

  const Item it = items[blockIdx.x];
  const Leaf L = leaves[it.leaf];
  const bool recompute = (it.cols & RECOMPUTE) != 0;
  const int cols = it.cols & (RECOMPUTE - 1);
  const int t = threadIdx.x;
  const int lanes = NT / cols;  // row lanes: thread t walks rows t / cols, + lanes, ...
  const int row0 = t / cols, col = t % cols;
  const bool active = row0 < lanes;
  const long long R = L.R;
  const int block = int(L.block);
  const long long column = (long long)it.c0 + col;
  const long long base = (long long)it.j * block * R + column;  // element (j * block, column) of [O, R]
  const long long sidx = (long long)it.j * R + column;          // scale (j, column) of [nb, R]
  const G* g = static_cast<const G*>(grads[it.leaf]);
  const float bc1 = scalars[0], bc2 = scalars[1], neg_lr = -scalars[2];

  bool keep = true;
  float norm_g = 1.f, clip_g = 1.f;
  if (norm != nullptr) {
    const float n = *norm;
    keep = n < c.clip;
    norm_g = round_to<G>(n);
    clip_g = round_to<G>(c.clip);
  }
  if (t < cols) {
    amax[0][t] = 0u;
    amax[1][t] = 0u;
  }
  float ms = 0.f, ns = 0.f;
  if (active) {
    ms = L.mu_s[sidx];
    ns = L.nu_s[sidx];
  }
  float* smu = moments_smem;
  float* snu = moments_smem + block * cols;

  // pass 1: the clip, the moments, the update and the apply; each column's absmax
  unsigned am = 0u, an = 0u;
  if (active) {
    for (int i0 = row0; i0 < block; i0 += UNROLL * lanes) {
      G gv[UNROLL];
      int8_t mq[UNROLL], nq[UNROLL];
      float pv[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {  // every load of the batch first
        const int i = i0 + k * lanes;
        if (i < block) {
          const long long idx = base + (long long)i * R;
          gv[k] = g[idx];
          mq[k] = L.mu_q[idx];
          nq[k] = L.nu_q[idx];
          if (L.upd == nullptr) pv[k] = L.p[idx];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * lanes;
        if (i < block) {
          const long long idx = base + (long long)i * R;
          float mu, nu;
          moments(clipped<G>(gv[k], keep, norm_g, clip_g), mq[k], ms, nq[k], ns, c, mu, nu);
          const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), c.eps);
          const G ug = from_f32<G>(__fdiv_rn(__fdiv_rn(mu, bc1), denom));
          if (L.upd != nullptr) {
            static_cast<G*>(L.upd)[idx] = ug;
          } else {
            float s = __fmul_rn(pv[k], c.wd);  // add_decayed_weights: u + wd * p
            s = __fadd_rn(s, to_f32(ug));
            s = __fmul_rn(s, neg_lr);          // scale_by_learning_rate
            L.p[idx] = __fadd_rn(pv[k], s);    // apply_updates
          }
          const float nu_sqrt = __fsqrt_rn(nu);
          am = max(am, abs_bits(mu));
          an = max(an, abs_bits(nu_sqrt));
          if (!recompute) {
            smu[i * cols + col] = mu;
            snu[i * cols + col] = nu_sqrt;
          }
        }
      }
    }
  }
  // a column's maxima across its row lanes: within the warp where the lanes of
  // a column are lanes l, l + cols, ... (cols a power of two below 32), then
  // across the warps in shared memory
  const bool shuffled = cols < 32 && (cols & (cols - 1)) == 0;
  if (shuffled) {
    for (int off = 16; off >= cols; off >>= 1) {
      am = max(am, __shfl_xor_sync(0xffffffffu, am, off));
      an = max(an, __shfl_xor_sync(0xffffffffu, an, off));
    }
  }
  __syncthreads();  // the maxima zeroed; every scale read
  if (active && (!shuffled || (t & 31) < cols)) {
    atomicMax(&amax[0][col], am);
    atomicMax(&amax[1][col], an);
  }
  __syncthreads();
  if (!active) return;
  const float amax_mu = __uint_as_float(amax[0][col]);
  const float amax_nu = __uint_as_float(amax[1][col]);

  // pass 2: the requantized codes, then the scales
  if (recompute) {
    for (int i0 = row0; i0 < block; i0 += UNROLL * lanes) {
      G gv[UNROLL];
      int8_t mq[UNROLL], nq[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * lanes;
        if (i < block) {
          const long long idx = base + (long long)i * R;
          gv[k] = g[idx];
          mq[k] = L.mu_q[idx];
          nq[k] = L.nu_q[idx];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * lanes;
        if (i < block) {
          const long long idx = base + (long long)i * R;
          float mu, nu;
          moments(clipped<G>(gv[k], keep, norm_g, clip_g), mq[k], ms, nq[k], ns, c, mu, nu);
          L.mu_q_out[idx] = quant(mu, amax_mu);
          L.nu_q_out[idx] = quant(__fsqrt_rn(nu), amax_nu);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int i = row0; i < block; i += lanes) {
      const long long idx = base + (long long)i * R;
      L.mu_q_out[idx] = quant(smu[i * cols + col], amax_mu);
      L.nu_q_out[idx] = quant(snu[i * cols + col], amax_nu);
    }
  }
  if (row0 == 0) {
    L.mu_s_out[sidx] = amax_mu;
    L.nu_s_out[sidx] = amax_nu;
  }
}

template <typename G>
int launch(const void* leaves, const void* items, long long n_items, const void* grads, const void* scalars,
           const void* norm, const Coeffs& c, int smem_elems, cudaStream_t s) {
  const long long smem = 2LL * smem_elems * (long long)sizeof(float);
  if (n_items <= 0 || n_items > 2147483647LL || smem_elems < 0 || smem > MAX_SMEM - 2 * NT * 4)
    return int(cudaErrorInvalidValue);
  if (smem + 2 * NT * 4 > 48 * 1024) {  // above 48 KB in all only once the kernel is allowed it (on this device)
    const cudaError_t err = cudaFuncSetAttribute(adam8bit_step_kernel<G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  adam8bit_step_kernel<G><<<static_cast<unsigned>(n_items), NT, size_t(smem), s>>>(
      static_cast<const Leaf*>(leaves), static_cast<const Item*>(items), static_cast<const void* const*>(grads),
      static_cast<const float*>(scalars), static_cast<const float*>(norm), c);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// g_dtype: 0 = float32, 1 = bfloat16 (every gradient of the launch).
// leaves: n Leaf rows; items: n_items Item rows; grads: one device pointer per
// leaf; scalars: f32 {bc1, bc2, lr}; norm: the f32 global norm on the device,
// or null for no clip. smem_elems: the largest one-pass item's elements.
// Returns the CUDA error code of the launch (0 on success); the caller raises
// on nonzero.
int sd_adam8bit_step(int g_dtype, const void* leaves, const void* items, long long n_items, const void* grads,
                     const void* scalars, const void* norm, float clip, float b1, float omb1, float b2, float omb2,
                     float eps, float wd, int smem_elems, void* stream) {
  const Coeffs c{b1, omb1, b2, omb2, eps, wd, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return launch<float>(leaves, items, n_items, grads, scalars, norm, c, smem_elems, s);
  if (g_dtype == 1) return launch<__nv_bfloat16>(leaves, items, n_items, grads, scalars, norm, c, smem_elems, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
