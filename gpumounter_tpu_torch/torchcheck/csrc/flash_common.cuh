// Shared building blocks of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile sizes, shared-memory carving, global->shared tile
// copies, warp reductions, and a shared-memory GEMM. The bf16 forward and
// dk/dv kernels use hopper_common.cuh instead; what is here serves
// flash_bwd_dq and the f32 instances.
//
// Every kernel built on these works on tiles staged in shared memory:
//   * bf16 tiles multiply on the tensor cores through nvcuda::wmma
//     (m16n16k16, bf16 inputs, f32 accumulation);
//   * f32 tiles multiply on CUDA-core FMAs in full f32 (no TF32), so the
//     f32 instance agrees with a float32 reference to ~1e-6.
// Scores, softmax statistics and accumulators are always f32. Masked
// scores are exactly NEG_INF = -1e30 (never -inf): exp(NEG_INF - NEG_INF)
// is 1, not NaN, which is what a fully masked row relies on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NWARPS = NT / 32;
constexpr int PAD_T = 8;  // row padding of input-dtype tiles, in elements
constexpr int PAD_F = 4;  // row padding of f32 tiles, in elements

// Rows of a q tile and a k tile. f32 tiles are half as tall so that every
// kernel's shared memory stays under the 227 KB a block may use.
template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32;
};

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Hands out 128-byte aligned regions of the dynamic shared memory, in the
// order the kernel's Layout struct sums them.
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t count) {
    U* r = reinterpret_cast<U*>(p);
    p += round128(count * sizeof(U));
    return r;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

// Copies `rows` rows of a [*, D] row-major global tensor into a shared
// tile of row pitch D + PAD_T, 16 bytes per thread per step.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = D + PAD_T;
  for (int i = threadIdx.x; i < rows * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// C[M, N] (f32, row pitch ldc) = or += A[M, K] . B[K, N], all in shared
// memory. A_COL: A is stored column-major (a(i, k) = A[k * lda + i], i.e.
// the transpose of a row-major [K, M] tile); B_COL likewise for B
// (b(k, j) = B[j * ldb + k]). Each warp owns whole 16x16 output tiles.
template <int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm(float* C, int ldc,
                                     const __nv_bfloat16* A, int lda,
                                     const __nv_bfloat16* B, int ldb,
                                     bool accumulate) {
  using namespace nvcuda;
  using ALayout =
      typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using BLayout =
      typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "wmma tiles");
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += NWARPS) {
    const int i0 = (t / TN) * 16, j0 = (t % TN) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
      wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + i0 : A + i0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(b, B_COL ? B + j0 * ldb + k0 : B + k0 * ldb + j0,
                             ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, acc, ldc, wmma::mem_row_major);
  }
}

template <int M, int N, int K, bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A,
                                     int lda, const float* B, int ldb,
                                     bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += NT) {
    const int i = idx / N, j = idx % N;
    float s = accumulate ? C[i * ldc + j] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_COL ? A[k * lda + i] : A[i * lda + k];
      const float b = B_COL ? B[j * ldb + k] : B[k * ldb + j];
      s = fmaf(a, b, s);
    }
    C[i * ldc + j] = s;
  }
}

// Element-type codes of the C interface (kernels.py passes them).
enum DType : int { kBF16 = 0, kF32 = 1 };

}  // namespace flash
