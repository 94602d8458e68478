// RMSNorm forward and backward on Hopper (sm_90a), for the model's norms
// (model.py _rmsnorm: two a layer and the final one).
//
// Replaces no Pallas kernel: the JAX package writes the norm in plain jnp
// (gpumounter_tpu/jaxcheck/model.py _rmsnorm) and leaves it to XLA, which
// fuses it. The port's plain PyTorch version ran as a dozen separate
// elementwise kernels and reductions a norm, and saved an f32 copy of x and
// a bf16 product for its backward: norm_ms read 46.9 / 47.3 ms a training
// step of the 6.9B cells (33 norms at [8192, 4096] bf16 on an H100) against
// a byte bound of about 5 ms.
//
// What the plain version computes, per row of x [rows, d] with gain g [d]
// (model._rmsnorm_plain), and where it rounds to T, x's dtype:
//   r  = rsqrt(mean(f32(x)^2) + 1e-6)       f32
//   y  = T(T(x * T(r)) * g)
// A bf16 x bf16 product is exact in f32, so rounding at the same two
// points gives y bit for bit, except in a row whose f32 sum of squares,
// taken here in another order, moves T(r) across a rounding edge.
//
// Backward, with dn = dy * g (exact in f32 for bf16) and c = sum(dn * x):
//   dx = T(r) * dn - x * r^3 * c / d        f32, rounded once
//   dg = sum over rows of dy * T(x * T(r))  f32, rounded once
// The direct term uses the rounded rsqrt as the forward did, the variance
// term the f32 one; the plain autograd path rounds dn, c and both terms to
// bf16 on the way.
//
// Bound on the H100 (3.35 TB/s), at [8192, 4096] bf16: the forward reads x
// and writes y (134 MB, 40 us); the backward reads x and dy and writes dx
// (201 MB, 60 us). The rest is small: g, the 32 KB of f32 rsqrt the
// forward saves (all it saves), and the backward's partial gain gradients
// (a few MB, written and read back through L2).
//
// Design: a row lives in registers, loaded as 16-byte vectors, neighbouring
// threads on neighbouring vectors; its sums are taken in f32 by warp
// shuffles and, where a row spans several warps, through shared memory.
// The threads a row takes follow d (the least power of two, at least a
// warp and at most MAX_BLOCK, that holds the row at FWD_VPT / BWD_VPT
// vectors a thread), and a block of at least BLOCK threads holds several
// rows where they are short. Each x byte is read once by each kernel and
// each output written once.
//   * rmsnorm_fwd_kernel: one row per row group, one pass; writes y and
//     each row's f32 rsqrt. g is loaded with x, so that no load waits
//     behind the reduction.
//   * rmsnorm_bwd_kernel: a persistent grid, as many blocks as the SMs
//     hold at once (a multiple of the SM count): each row group walks its
//     own rows with g in registers, loading each row's x, dy and rsqrt
//     while the row before is reduced and written, and keeps its share of
//     dg in f32 registers; a block's row groups sum theirs in a fixed
//     order through shared memory and write one row of an f32 [grid, d]
//     scratch.
//   * rmsnorm_dg_kernel: sums the scratch over the grid in a fixed order
//     and writes dg in g's dtype. No atomics: two backward passes over the
//     same inputs agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace rmsnorm {

using flash::kBF16;
using flash::kF32;
using flash::warp_sum;

constexpr float EPS = 1e-6f;
constexpr int BLOCK = 256;      // least threads of a block
constexpr int MAX_BLOCK = 512;  // most threads of a block (128 registers)
// 16-byte vectors a thread holds where the row allows. Two was the fastest
// of 1, 2, 4 and 8 for both kernels at [8192, 4096] bf16 on an H100: more
// registers a thread leave fewer warps to keep loads in flight.
constexpr int FWD_VPT = 2;
constexpr int BWD_VPT = 2;
constexpr int MAX_D = 16384;
constexpr int DG_COLS = 32;     // columns of a rmsnorm_dg_kernel block
constexpr int DG_WARPS = 8;     // its warps, each over a share of the grid

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// x rounded to T and read back as f32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// The sum of v over the tpr threads of a row group (tpr a power of two,
// a multiple of 32), the same bits in every thread of the group. Every
// thread of the block calls it the same number of times: where a row
// spans several warps it waits at __syncthreads.
__device__ __forceinline__ float group_sum(float v, int tpr, float* red) {
  v = warp_sum(v);
  if (tpr == 32) return v;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const float* mine = red + (threadIdx.x / tpr) * (tpr / 32);
  float s = 0.0f;
  for (int w = 0; w < tpr / 32; ++w) s += mine[w];
  __syncthreads();  // red is free for the next call
  return s;
}

// Loads the vectors of row `row` of p [*, d] that this thread holds; none
// where `live` is false (a row past the end).
template <typename T, int VPT>
__device__ __forceinline__ void load_row(const T* __restrict__ p, long row,
                                         int d, int lane, int tpr, bool live,
                                         uint4 (&out)[VPT]) {
  const uint4* src = reinterpret_cast<const uint4*>(p + row * d);
  const int nv = d / Vec<T>::N;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + i * tpr;
    if (live && v < nv) out[i] = src[v];
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_BLOCK)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ y, float* __restrict__ rstd, int rows,
                       int d, int tpr) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[MAX_BLOCK / 32];
  const int nv = d / N, lane = threadIdx.x % tpr;
  const long row = (long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  // g is loaded with x, so that no load waits behind the reduction
  uint4 xv[VPT], gv[VPT];
  load_row<T, VPT>(x, row, d, lane, tpr, live, xv);
  load_row<T, VPT>(g, 0, d, lane, tpr, live, gv);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + i * tpr;
    if (live && v < nv) {
      float f[N];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  ss = group_sum(ss, tpr, red);
  if (!live) return;
  // the mean and the epsilon rounded apart, as the plain version adds them
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)d), EPS));
  const float rb = round_to<T>(r);
  if (lane == 0) rstd[row] = r;
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + i * tpr;
    if (v < nv) {
      float f[N], gf[N];
      unpack<T>(xv[i], f);
      unpack<T>(gv[i], gf);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = round_to<T>(f[j] * rb) * gf[j];
      yr[v] = pack<T>(f);
    }
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_BLOCK)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dg_partial, int rows, int d,
                       int tpr) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[MAX_BLOCK / 32];
  // the row groups' dg shares, where a block holds more than one row group
  // (then blockDim.x is BLOCK and each thread holds at most BWD_VPT * N)
  __shared__ float part[BLOCK * BWD_VPT * 8];
  const int nv = d / N, lane = threadIdx.x % tpr;
  const int group = threadIdx.x / tpr, rpb = blockDim.x / tpr;
  const long stride = (long)gridDim.x * rpb;
  const int iters = (int)((rows + stride - 1) / stride);  // the block's own
  uint4 gv[VPT];
  load_row<T, VPT>(g, 0, d, lane, tpr, true, gv);
  float acc[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
  // each row's x, dy and rsqrt are loaded while the row before is reduced
  // and written
  long row = (long)blockIdx.x * rpb + group;
  uint4 xv[VPT], dyv[VPT];
  load_row<T, VPT>(x, row, d, lane, tpr, row < rows, xv);
  load_row<T, VPT>(dy, row, d, lane, tpr, row < rows, dyv);
  float r = row < rows ? rstd[row] : 0.0f;
  for (int it = 0; it < iters; ++it, row += stride) {
    const bool live = row < rows, more = row + stride < rows;
    uint4 xn[VPT], dyn[VPT];
    load_row<T, VPT>(x, row + stride, d, lane, tpr, more, xn);
    load_row<T, VPT>(dy, row + stride, d, lane, tpr, more, dyn);
    const float rn = more ? rstd[row + stride] : 0.0f;
    float c = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = lane + i * tpr;
      if (live && v < nv) {
        float xf[N], df[N], gf[N];
        unpack<T>(xv[i], xf);
        unpack<T>(dyv[i], df);
        unpack<T>(gv[i], gf);
#pragma unroll
        for (int j = 0; j < N; ++j) c = fmaf(df[j] * gf[j], xf[j], c);
      }
    }
    c = group_sum(c, tpr, red);
    if (live) {
      const float rb = round_to<T>(r);
      const float k = r * r * r * c / (float)d;
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = lane + i * tpr;
        if (v < nv) {
          float xf[N], df[N], gf[N], out[N];
          unpack<T>(xv[i], xf);
          unpack<T>(dyv[i], df);
          unpack<T>(gv[i], gf);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            out[j] = rb * (df[j] * gf[j]) - xf[j] * k;
            acc[i][j] = fmaf(df[j], round_to<T>(xf[j] * rb), acc[i][j]);
          }
          dxr[v] = pack<T>(out);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      xv[i] = xn[i];
      dyv[i] = dyn[i];
    }
    r = rn;
  }
  // this block's dg share: row groups 1.. hand theirs to group 0 through
  // shared memory, which adds them in order and writes the scratch row
  if (rpb > 1) {
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = lane + i * tpr;
        if (v < nv) {
#pragma unroll
          for (int j = 0; j < N; ++j) part[(group - 1) * d + v * N + j] = acc[i][j];
        }
      }
    }
    __syncthreads();
    if (group > 0) return;
    for (int q = 0; q < rpb - 1; ++q) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = lane + i * tpr;
        if (v < nv) {
#pragma unroll
          for (int j = 0; j < N; ++j) acc[i][j] += part[q * d + v * N + j];
        }
      }
    }
  }
  float* out = dg_partial + (long)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = lane + i * tpr;
    if (v < nv) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(out + v * N + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
    }
  }
}

// dg[col] = T(sum over p < parts of dg_partial[p, col]): warp w of a block
// sums rows w, w + DG_WARPS, ... of DG_COLS columns, then warp 0 adds the
// warps' sums in order.
template <typename T>
__global__ void __launch_bounds__(DG_COLS* DG_WARPS)
    rmsnorm_dg_kernel(const float* __restrict__ dg_partial,
                      T* __restrict__ dg, int parts, int d) {
  __shared__ float sums[DG_WARPS][DG_COLS];
  const int lane = threadIdx.x % DG_COLS, warp = threadIdx.x / DG_COLS;
  const int col = blockIdx.x * DG_COLS + lane;
  float s = 0.0f;
  if (col < d) {
#pragma unroll 8
    for (int p = warp; p < parts; p += DG_WARPS)
      s += dg_partial[(long)p * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.0f;
    for (int w = 0; w < DG_WARPS; ++w) t += sums[w][lane];
    if constexpr (sizeof(T) == 2)
      dg[col] = __float2bfloat16_rn(t);
    else
      dg[col] = t;
  }
}

// How a row of d elements of N to a vector spreads over threads.
struct Layout {
  int tpr;    // threads a row takes
  int vpt;    // 16-byte vectors each of them holds, at most
  int block;  // threads of a block: BLOCK, or tpr where that is more
};

inline Layout layout_of(int d, int n, int max_vpt) {
  const int nv = d / n;
  int tpr = 32;
  while (tpr < MAX_BLOCK && tpr * max_vpt < nv) tpr *= 2;
  return {tpr, (nv + tpr - 1) / tpr, tpr > BLOCK ? tpr : BLOCK};
}

inline bool valid(int rows, int d) {
  return rows > 0 && d > 0 && d <= MAX_D && d % 8 == 0;
}

template <typename T, int VPT>
int fwd_vpt(const void* x, const void* g, void* y, void* rstd, int rows,
            int d, const Layout& L, cudaStream_t s) {
  const int rpb = L.block / L.tpr;
  rmsnorm_fwd_kernel<T, VPT><<<(rows + rpb - 1) / rpb, L.block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y),
      static_cast<float*>(rstd), rows, d, L.tpr);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int bwd_vpt(const void* x, const void* g, const void* rstd, const void* dy,
            void* dx, void* dg_partial, int rows, int d, int grid,
            const Layout& L, cudaStream_t s) {
  rmsnorm_bwd_kernel<T, VPT><<<grid, L.block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(rstd), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(dg_partial), rows, d, L.tpr);
  return (int)cudaGetLastError();
}

// The persistent grid: as many blocks as the SMs hold at once, and no more
// than there are rows for. Negative on a CUDA error.
template <typename T, int VPT>
int grid_vpt(int rows, const Layout& L) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rmsnorm_bwd_kernel<T, VPT>, L.block, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int rpb = L.block / L.tpr;
  const long need = ((long)rows + rpb - 1) / rpb;
  const long most = (long)sms * per_sm;
  return (int)(need < most ? need : most);
}

// Calls fn(std::integral_constant<int, vpt>()), for vpt up to MOST: the
// most a layout gives (max_vpt, or a MAX_BLOCK row of MAX_D elements).
template <int MOST, typename F>
int by_vpt(int vpt, F&& fn) {
  if (vpt == 1) return fn(std::integral_constant<int, 1>());
  if constexpr (MOST >= 2) if (vpt == 2) return fn(std::integral_constant<int, 2>());
  if constexpr (MOST >= 3) if (vpt == 3) return fn(std::integral_constant<int, 3>());
  if constexpr (MOST >= 4) if (vpt == 4) return fn(std::integral_constant<int, 4>());
  if constexpr (MOST >= 5) if (vpt == 5) return fn(std::integral_constant<int, 5>());
  if constexpr (MOST >= 6) if (vpt == 6) return fn(std::integral_constant<int, 6>());
  if constexpr (MOST >= 7) if (vpt == 7) return fn(std::integral_constant<int, 7>());
  if constexpr (MOST >= 8) if (vpt == 8) return fn(std::integral_constant<int, 8>());
  return (int)cudaErrorInvalidValue;
}

template <typename T>
constexpr int most_vpt(int max_vpt) {
  const int widest = MAX_D / Vec<T>::N / MAX_BLOCK;
  return max_vpt > widest ? max_vpt : widest;
}

template <typename T>
int fwd(const void* x, const void* g, void* y, void* rstd, int rows, int d,
        cudaStream_t s) {
  const Layout L = layout_of(d, Vec<T>::N, FWD_VPT);
  return by_vpt<most_vpt<T>(FWD_VPT)>(L.vpt, [&](auto vpt) {
    return fwd_vpt<T, decltype(vpt)::value>(x, g, y, rstd, rows, d, L, s);
  });
}

template <typename T>
int bwd(const void* x, const void* g, const void* rstd, const void* dy,
        void* dx, void* dg_partial, int rows, int d, int grid,
        cudaStream_t s) {
  const Layout L = layout_of(d, Vec<T>::N, BWD_VPT);
  return by_vpt<most_vpt<T>(BWD_VPT)>(L.vpt, [&](auto vpt) {
    return bwd_vpt<T, decltype(vpt)::value>(x, g, rstd, dy, dx, dg_partial,
                                            rows, d, grid, L, s);
  });
}

template <typename T>
int bwd_grid(int rows, int d) {
  const Layout L = layout_of(d, Vec<T>::N, BWD_VPT);
  return by_vpt<most_vpt<T>(BWD_VPT)>(L.vpt, [&](auto vpt) {
    return grid_vpt<T, decltype(vpt)::value>(rows, L);
  });
}

}  // namespace rmsnorm

// y [rows, d] and rstd [rows] (f32) of x [rows, d] with gain g [d].
extern "C" int rmsnorm_fwd(const void* x, const void* g, void* y, void* rstd,
                           int rows, int d, int dtype, void* stream) {
  using namespace rmsnorm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(rows, d)) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return fwd<__nv_bfloat16>(x, g, y, rstd, rows, d, s);
  if (dtype == kF32) return fwd<float>(x, g, y, rstd, rows, d, s);
  return (int)cudaErrorInvalidValue;
}

// The grid rmsnorm_bwd takes for these rows and width (the rows of its
// dg_partial scratch); a negative CUDA error code where none can be found.
extern "C" int rmsnorm_bwd_grid(int rows, int d, int dtype) {
  using namespace rmsnorm;
  if (!valid(rows, d)) return -(int)cudaErrorInvalidValue;
  if (dtype == kBF16) return bwd_grid<__nv_bfloat16>(rows, d);
  if (dtype == kF32) return bwd_grid<float>(rows, d);
  return -(int)cudaErrorInvalidValue;
}

// dx [rows, d] and dg_partial [grid, d] (f32) from x, dy [rows, d], g [d]
// and the forward's rstd [rows]; grid from rmsnorm_bwd_grid.
extern "C" int rmsnorm_bwd(const void* x, const void* g, const void* rstd,
                           const void* dy, void* dx, void* dg_partial,
                           int rows, int d, int grid, int dtype,
                           void* stream) {
  using namespace rmsnorm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(rows, d) || grid < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return bwd<__nv_bfloat16>(x, g, rstd, dy, dx, dg_partial, rows, d, grid,
                              s);
  if (dtype == kF32)
    return bwd<float>(x, g, rstd, dy, dx, dg_partial, rows, d, grid, s);
  return (int)cudaErrorInvalidValue;
}

// dg [d] in g's dtype: dg_partial [grid, d] summed over its rows in order.
extern "C" int rmsnorm_dg(const void* dg_partial, void* dg, int grid, int d,
                          int dtype, void* stream) {
  using namespace rmsnorm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || !valid(1, d)) return (int)cudaErrorInvalidValue;
  const int blocks = (d + DG_COLS - 1) / DG_COLS;
  if (dtype == kBF16)
    rmsnorm_dg_kernel<__nv_bfloat16><<<blocks, DG_COLS * DG_WARPS, 0, s>>>(
        static_cast<const float*>(dg_partial),
        static_cast<__nv_bfloat16*>(dg), grid, d);
  else if (dtype == kF32)
    rmsnorm_dg_kernel<float><<<blocks, DG_COLS * DG_WARPS, 0, s>>>(
        static_cast<const float*>(dg_partial), static_cast<float*>(dg), grid,
        d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
