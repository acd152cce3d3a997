// Hopper (sm_90a) building blocks of the bf16 tensor-core attention kernels:
// the forward (csrc/flash_attention.cu, the port of the TPU kernels
// `_fa_kernel` and `_fa_kernel_stream` of stable_diffusion_pytorch_tpu/ops/
// flash_attention.py), the fused backward (csrc/flash_attention_bwd.cu, the
// port of `_fused_bwd_kernel` of ops/flash_attention_bwd.py) and the split
// backward (csrc/flash_attention_bwd_split.cu, the port of `_dq_kernel`,
// `_dkv_kernel`, `_sbwd_stats_kernel`, `_sbwd_dq_kernel` and
// `_sbwd_dkv_kernel`). Plain PTX, no CUTLASS.
//
// What bounds those kernels on this card is arithmetic: the products (4 to 7
// of 2*N*M*D FLOPs) and N*M exponentials, against O((N+M)*D) bytes. These
// helpers put the products on the tensor cores (wgmma, 989 TFLOP/s bf16
// against 67 TFLOP/s of f32 FMAs) with operands in shared memory or
// registers, so the FMA pipes are left to the softmax. float32 inputs keep
// the FMA kernels in the same sources: wgmma takes f32 only as TF32 (about
// three decimal digits), and the f32 parity checks need full f32 products.
//
// What the kernels share:
//   - Tiles in shared memory in the "core-matrix" tiling that wgmma reads
//     without swizzle: an R x C bf16 tile (C a multiple of 8) is cut into 8 x 8
//     blocks of 128 bytes, each block 8 rows of 16 bytes, blocks in row-block-
//     major order: element (r, c) at ((r/8) * (C/8) + c/8) * 128 + (r%8) * 16 +
//     (c%8) * 2. One tile serves both operand orders: read as a K-major operand
//     (rows = M or N, cols = K) its descriptor has LBO = 128 (the next 8 of K)
//     and SBO = C/8 * 128 (the next 8 rows); read as an MN-major operand (rows
//     = K, cols = M or N) it has LBO = C/8 * 128 and SBO = 128. So K^T, V^T, P^T
//     and dS^T never need a transpose pass: wgmma's transpose bit for B does it.
//   - The copies: `TileCopy` fills a tile with 16-byte `cp.async` copies, one
//     block of 8 rows x 16 bytes per 8 lanes, so a warp writes 512 contiguous
//     bytes of shared memory and reads 64 contiguous bytes of 8 rows; rows past
//     the matrix and columns past the head dim are zero-filled by the copy
//     itself (src-size). That needs every row to start 16-byte aligned, as the
//     model's views (the fused-QKV split included) do; any other view, such as
//     a contiguous [B, L, 8, 20], is copied element by element instead.
//   - `Wgmma<N>`: wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators;
//     `ss` takes A and B from shared memory (both K-major), `rs` takes A from
//     registers and B MN-major from shared memory; `WgmmaTT<N>::ss` takes
//     both from shared memory MN-major (the transpose bits of A and B). An
//     asm string must be a literal, so each width has its own, operands
//     written out.
//   - The accumulator fragment of m64nN: thread t of the warpgroup (warp w =
//     t/32, lane l) holds element i at row 16w + l/4 + 8 * ((i/2) % 2) and
//     column 8 * (i/4) + 2 * (l%4) + i%2. Columns 16k..16k+15 of an
//     accumulator, rounded to bf16 pairwise, are exactly the A-register
//     fragment of k-step k (`to_a_frag`): P and dS go from the softmax to the
//     next product without shared memory.
//   - Ordering: `fence_regs` pins registers around the asynchronous wgmma
//     (the compiler must not move a read or write across it),
//     `fence.proxy.async` makes cp.async's writes visible to wgmma's reads.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sd_sm90 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of the first `bytes` (0 to 16) of `src`, the
// rest zero-filled; `src` 16-byte aligned
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte global -> shared copy; zero-fills when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's finished cp.async writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. Adding n to the descriptor
// moves its start by 16 * n bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

// a tile of C columns read as a K-major operand; + 16 per k-step of 16 columns
template <int C>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 128, C / 8 * 128);
}

// a tile of C columns read as an MN-major operand (its rows are K); + 2 * C
// per k-step of 16 rows, + c for the columns from c on (c a multiple of 8)
template <int C>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return make_desc(addr, C / 8 * 128, 128);
}

// The copies of an R x C bf16 tile (C a multiple of 8) into the core-matrix
// tiling, shared by NT threads, one block of 8 rows x 16 bytes per 8 lanes.
// The constructor works out, once per kernel, this thread's chunks: their
// offsets in elements from the tile's first row, their rows, and how many of
// their 8 columns lie within the `d` valid ones (0 to 8). Where every row
// starts 16-byte aligned (`vec`), a chunk is one cp.async that copies its
// valid columns and zero-fills the rest; otherwise it is copied element by
// element. Rows past the matrix are zero. The row stride `ld` times R must
// fit an int (the wrappers check).
template <int R, int C, int NT>
struct TileCopy {
  static constexpr int CC = C / 8;
  static constexpr int CHUNKS = R * CC;
  static constexpr int IT = (CHUNKS + NT - 1) / NT;
  int off[IT];
  int row[IT];
  int cols[IT];

  __device__ __forceinline__ TileCopy(int64_t ld, int d, int tid) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      const int rest = i >> 3;
      const int c = rest % CC;
      row[it] = (rest / CC) * 8 + (i & 7);
      off[it] = int(row[it] * ld) + c * 8;
      cols[it] = min(max(d - c * 8, 0), 8);
    }
  }

  // the tile whose first row is at `src`, `rows` of its rows in the matrix
  __device__ __forceinline__ void copy(uint32_t dst, const bf16* __restrict__ src, int rows,
                                       int tid, bool vec) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = tid + it * NT;
      if (CHUNKS % NT == 0 || i < CHUNKS) {
        const int n = row[it] < rows ? cols[it] : 0;
        if (vec) {
          cp_async16(dst + i * 16, src + (n ? off[it] : 0), 2 * n);
        } else {
          const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + off[it];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const unsigned short x = e < n ? s[e] : 0;
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst + i * 16 + 2 * e), "h"(x) : "memory");
          }
        }
      }
    }
  }
};

// whether every row of a [B, L, H, D] bf16 view starts 16-byte aligned
__host__ __forceinline__ bool rows_aligned(const void* p, int B, int L, int H, long long sb,
                                           long long sl, long long sh) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (B == 1 || sb % 8 == 0) &&
         (L == 1 || sl % 8 == 0) && (H == 1 || sh % 8 == 0);
}

// out[0], out[1] = a, b in bf16 (b only if `two`), as one 4-byte store where aligned
__device__ __forceinline__ void store_bf16_pair(bf16* out, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else {
    out[0] = __float2bfloat16(a);
    if (two) out[1] = __float2bfloat16(b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator columns 16k..16k+15 -> the bf16 A fragment of k-step k, for every k
template <int R>
__device__ __forceinline__ void to_a_frag(const float (&d)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int k = 0; k < R / 8; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[k][r] = pack_bf16(d[8 * k + 2 * r], d[8 * k + 2 * r + 1]);
}

// the row (0: l/4, 1: l/4 + 8, within the warp's 16) and column of accumulator element i
__device__ __forceinline__ constexpr int frag_row_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

// 2^x on the special-function unit, subnormal results flushed to zero (P
// below 2^-126 is 0 in bf16 products anyway); exp2f's subnormal handling
// costs three more instructions per score
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four lanes that share a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

#define SD_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SD_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SD_WGMMA_D8 SD_F8(0)
#define SD_WGMMA_D12 SD_F8(0), SD_F4(8)
#define SD_WGMMA_D20 SD_F8(0), SD_F8(8), SD_F4(16)
#define SD_WGMMA_D16 SD_F8(0), SD_F8(8)
#define SD_WGMMA_D24 SD_F8(0), SD_F8(8), SD_F8(16)
#define SD_WGMMA_D32 SD_F8(0), SD_F8(8), SD_F8(16), SD_F8(24)
#define SD_WGMMA_D40 SD_F8(0), SD_F8(8), SD_F8(16), SD_F8(24), SD_F8(32)
#define SD_WGMMA_D64 SD_F8(0), SD_F8(8), SD_F8(16), SD_F8(24), SD_F8(32), SD_F8(40), SD_F8(48), SD_F8(56)
#define SD_WGMMA_D80 \
  SD_F8(0), SD_F8(8), SD_F8(16), SD_F8(24), \
  SD_F8(32), SD_F8(40), SD_F8(48), SD_F8(56), \
  SD_F8(64), SD_F8(72)
#define SD_WGMMA_D128 \
  SD_F8(0), SD_F8(8), SD_F8(16), SD_F8(24), \
  SD_F8(32), SD_F8(40), SD_F8(48), SD_F8(56), \
  SD_F8(64), SD_F8(72), SD_F8(80), SD_F8(88), \
  SD_F8(96), SD_F8(104), SD_F8(112), SD_F8(120)

template <int N> struct Wgmma;

template <> struct Wgmma<16> {
  // D[64x16] = A[64x16] B[16x16] (+ D if scale_d); A and B K-major in shared memory (descriptors)
  __device__ static __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : SD_WGMMA_D8
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  // D[64x32] = A[64x16] B[16x32] (+ D if scale_d); A and B K-major in shared memory (descriptors)
  __device__ static __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : SD_WGMMA_D16
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // D[64x32] = A[64x16] B[16x32] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<48> {
  // D[64x48] = A[64x16] B[16x48] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D24
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  // D[64x64] = A[64x16] B[16x64] (+ D if scale_d); A and B K-major in shared memory (descriptors)
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : SD_WGMMA_D32
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // D[64x64] = A[64x16] B[16x64] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<80> {
  // D[64x80] = A[64x16] B[16x80] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D40
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  // D[64x128] = A[64x16] B[16x128] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<160> {
  // D[64x160] = A[64x16] B[16x160] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D80
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  // D[64x256] = A[64x16] B[16x256] (+ D if scale_d); A in registers, B MN-major in shared memory
  __device__ static __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : SD_WGMMA_D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// D[64xN] = A[64x16] B[16xN] (+ D if scale_d) with A and B both MN-major in
// shared memory (descriptors; wgmma's transpose bits for both): A's tile has
// the product's depth as its rows and its 64 output rows as columns, as an
// MN-major B tile has its N columns. The fused backward's dQ = dS K reads dS
// from the dS^T tile this way, and K from its resident tile.
template <int N> struct WgmmaTT;

template <> struct WgmmaTT<16> {
  __device__ static __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D8
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTT<24> {
  __device__ static __forceinline__ void ss(float (&d)[12], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D12
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTT<32> {
  __device__ static __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D16
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTT<40> {
  __device__ static __forceinline__ void ss(float (&d)[20], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D20
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTT<64> {
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D32
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTT<80> {
  __device__ static __forceinline__ void ss(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 1, 1;\n}\n"
        : SD_WGMMA_D40
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

}  // namespace sd_sm90
