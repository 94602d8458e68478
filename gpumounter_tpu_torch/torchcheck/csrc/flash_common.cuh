// Shared building blocks of the f32 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile sizes, shared-memory carving, global->shared tile
// copies, warp reductions, and a shared-memory GEMM on CUDA-core FMAs in
// full f32 (no TF32), so the f32 instances agree with a float32 reference
// to ~1e-6. They serve parity against float64, not speed; the bf16
// kernels use hopper_common.cuh instead.
//
// Scores, softmax statistics and accumulators are always f32. Masked
// scores are exactly NEG_INF = -1e30 (never -inf): exp(NEG_INF - NEG_INF)
// is 1, not NaN, which is what a fully masked row relies on.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;  // threads per block: 8 warps
constexpr int NWARPS = NT / 32;
constexpr int PAD_T = 8;  // row padding of input-dtype tiles, in elements
constexpr int PAD_F = 4;  // row padding of f32 tiles, in elements

// Rows of a q tile and a k tile, small enough that every kernel's shared
// memory stays under the 227 KB a block may use.
template <typename T>
struct Tiles;
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
// (b(k, j) = B[j * ldb + k]). Each thread owns output elements.
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
