// Causal flash-attention backward on Hopper (sm_90a): dq, and dk with dv.
//
// Replaces the fused Pallas backward pair of
// gpumounter_tpu/jaxcheck/pallas_attention.py (flash_backward_fused,
// lines 411-469):
//   * flash_bwd_dq   <- _dq_kernel   (lines 332-365, pallas_call at 427);
//   * flash_bwd_dkdv <- _dkdv_kernel (lines 368-408, pallas_call at 445).
// Inputs q, k, v, do [BH, T, D] in the model dtype, lse = m + log l and
// drow = rowsum(do * out) [BH, T] f32 (both formed outside, in plain torch,
// as the JAX package forms them); offsets are 0 (one causal sequence).
// With scale = 1/sqrt(D) and s the masked scaled scores:
//   p = exp(s - lse)    dp = do . v^T    ds = p * (dp - drow)
//   dq = ds . k * scale   dk = ds^T . q * scale   dv = p^T . do
// ds is cast to the input dtype before the dq and dk products, and p
// before the dv product, as the reference rounds them. Outputs are f32.
//
// Design: both kernels recompute s and p from q and k (nothing [T, T]
// touches device memory) and neither needs atomics:
//   * dq: one block per (bh, q tile), looping over K tiles up to the
//     causal edge, the dq tile accumulating in shared memory;
//   * dkdv: one block per (bh, k tile), looping over q tiles from the
//     causal edge to the end, dk and dv accumulating in shared memory.
// A tile wholly in the causal future contributes exactly 0 (p underflows
// to 0 there), so skipping it changes nothing.
//
// Bound on the H100 (flagship shape BH=256, T=1024, D=128, bf16, causal):
//   dq:   ~103 GFLOP (~104 us at 989 TF/s) vs ~0.40 GB (~120 us at
//         3.35 TB/s), the f32 dq output half of it: memory-bound;
//   dkdv: ~137 GFLOP (~139 us) vs ~0.54 GB (~160 us): memory-bound.
// This first version stages tiles through shared memory with wmma and runs
// well above those bounds; wgmma/TMA and bf16 outputs are later work.

#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
struct BwdLayout {
  static constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  static constexpr int LDT = D + PAD_T;   // q, k, v, do tiles
  static constexpr int LDP = BK + PAD_T;  // p / ds tiles (input dtype)
  static constexpr int LDS = BK + PAD_F;  // s / dp tiles (f32)
  static constexpr int LDO = D + PAD_F;   // dq / dk / dv accumulators (f32)
  static constexpr size_t t_tile = round128(sizeof(T) * BQ * LDT);
  static constexpr size_t p_tile = round128(sizeof(T) * BQ * LDP);
  static constexpr size_t s_tile = round128(sizeof(float) * BQ * LDS);
  static constexpr size_t o_tile = round128(sizeof(float) * BQ * LDO);
  static constexpr size_t row = round128(sizeof(float) * BQ);
  // dq: q, do, k, v | s, dp | ds | dq | lse, drow
  static constexpr size_t dq_bytes = 4 * t_tile + 2 * s_tile + p_tile +
                                     o_tile + 2 * row;
  // dkdv: k, v, q, do | s(p), dp | p, ds | dk, dv | lse, drow
  static constexpr size_t dkdv_bytes = 4 * t_tile + 2 * s_tile + 2 * p_tile +
                                       2 * o_tile + 2 * row;
  static_assert(BQ == BK, "one tile height for q and k");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ drow, float* __restrict__ dq,
                        int t, float scale) {
  using L = BwdLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver c{smem};
  T* qs = c.take<T>(BQ * L::LDT);
  T* dos = c.take<T>(BQ * L::LDT);
  T* ks = c.take<T>(BK * L::LDT);
  T* vs = c.take<T>(BK * L::LDT);
  float* ss = c.take<float>(BQ * L::LDS);
  float* dps = c.take<float>(BQ * L::LDS);
  T* dss = c.take<T>(BQ * L::LDP);
  float* dqs = c.take<float>(BQ * L::LDO);
  float* lse_s = c.take<float>(BQ);
  float* drow_s = c.take<float>(BQ);

  // late q tiles loop over the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  load_tile<T, D>(qs, q + base + (size_t)q0 * D, BQ);
  load_tile<T, D>(dos, dout + base + (size_t)q0 * D, BQ);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    lse_s[i] = lse[(size_t)bh * t + q0 + i];
    drow_s[i] = drow[(size_t)bh * t + q0 + i];
  }
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NT) dqs[i] = 0.0f;

  for (int k0 = 0; k0 < q0 + BQ; k0 += BK) {  // up to the causal edge
    __syncthreads();
    load_tile<T, D>(ks, k + base + (size_t)k0 * D, BK);
    load_tile<T, D>(vs, v + base + (size_t)k0 * D, BK);
    __syncthreads();
    gemm<BQ, BK, D, false, true>(ss, L::LDS, qs, L::LDT, ks, L::LDT, false);
    gemm<BQ, BK, D, false, true>(dps, L::LDS, dos, L::LDT, vs, L::LDT, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += NT) {
      const int r = i / BK, j = i % BK;
      const float s =
          q0 + r >= k0 + j ? ss[r * L::LDS + j] * scale : NEG_INF;
      const float p = expf(s - lse_s[r]);
      dss[r * L::LDP + j] =
          from_f32<T>(p * (dps[r * L::LDS + j] - drow_s[r]));
    }
    __syncthreads();
    gemm<BQ, D, BK, false, false>(dqs, L::LDO, dss, L::LDP, ks, L::LDT, true);
  }
  __syncthreads();
  float* dqb = dq + base + (size_t)q0 * D;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, j = i % D;
    dqb[(size_t)r * D + j] = dqs[r * L::LDO + j] * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ drow,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int t, float scale) {
  using L = BwdLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver c{smem};
  T* ks = c.take<T>(BK * L::LDT);
  T* vs = c.take<T>(BK * L::LDT);
  T* qs = c.take<T>(BQ * L::LDT);
  T* dos = c.take<T>(BQ * L::LDT);
  float* ss = c.take<float>(BQ * L::LDS);  // p in f32
  float* dps = c.take<float>(BQ * L::LDS);
  T* pts = c.take<T>(BQ * L::LDP);  // p in the input dtype
  T* dss = c.take<T>(BQ * L::LDP);
  float* dks = c.take<float>(BK * L::LDO);
  float* dvs = c.take<float>(BK * L::LDO);
  float* lse_s = c.take<float>(BQ);
  float* drow_s = c.take<float>(BQ);

  const int k0 = blockIdx.x * BK;  // early k tiles see the most queries
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * t * D;
  load_tile<T, D>(ks, k + base + (size_t)k0 * D, BK);
  load_tile<T, D>(vs, v + base + (size_t)k0 * D, BK);
  for (int i = threadIdx.x; i < BK * L::LDO; i += NT) {
    dks[i] = 0.0f;
    dvs[i] = 0.0f;
  }

  for (int q0 = k0 / BQ * BQ; q0 < t; q0 += BQ) {  // from the causal edge
    __syncthreads();
    load_tile<T, D>(qs, q + base + (size_t)q0 * D, BQ);
    load_tile<T, D>(dos, dout + base + (size_t)q0 * D, BQ);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      lse_s[i] = lse[(size_t)bh * t + q0 + i];
      drow_s[i] = drow[(size_t)bh * t + q0 + i];
    }
    __syncthreads();
    gemm<BQ, BK, D, false, true>(ss, L::LDS, qs, L::LDT, ks, L::LDT, false);
    gemm<BQ, BK, D, false, true>(dps, L::LDS, dos, L::LDT, vs, L::LDT, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += NT) {
      const int r = i / BK, j = i % BK;
      const float s =
          q0 + r >= k0 + j ? ss[r * L::LDS + j] * scale : NEG_INF;
      const float p = expf(s - lse_s[r]);
      pts[r * L::LDP + j] = from_f32<T>(p);
      dss[r * L::LDP + j] =
          from_f32<T>(p * (dps[r * L::LDS + j] - drow_s[r]));
    }
    __syncthreads();
    // dv += p^T . do and dk += ds^T . q: p and ds are [BQ, BK] row-major,
    // so their transposes are column-major [BK, BQ] operands.
    gemm<BK, D, BQ, true, false>(dvs, L::LDO, pts, L::LDP, dos, L::LDT, true);
    gemm<BK, D, BQ, true, false>(dks, L::LDO, dss, L::LDP, qs, L::LDT, true);
  }
  __syncthreads();
  float* dkb = dk + base + (size_t)k0 * D;
  float* dvb = dv + base + (size_t)k0 * D;
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, j = i % D;
    dkb[(size_t)r * D + j] = dks[r * L::LDO + j] * scale;
    dvb[(size_t)r * D + j] = dvs[r * L::LDO + j];
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* drow, void* dq, int bh, int t,
              float scale, cudaStream_t stream) {
  using L = BwdLayout<T, D>;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(t / L::BQ, bh);
  kern<<<grid, NT, L::dq_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<float*>(dq), t, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* drow, void* dk, void* dv, int bh,
                int t, float scale, cudaStream_t stream) {
  using L = BwdLayout<T, D>;
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(t / L::BK, bh);
  kern<<<grid, NT, L::dkdv_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<float*>(dk), static_cast<float*>(dv), t, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// C interface, bound with ctypes by kernels.py, which validates every
// argument first. Each returns the launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* drow, void* dq, int bh, int t, int d,
                            float scale, int dtype, void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, drow, dq, bh, t,
                                         scale, s);
  if (dtype == kBF16 && d == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, drow, dq, bh, t,
                                        scale, s);
  if (dtype == kF32 && d == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, drow, dq, bh, t, scale,
                                 s);
  if (dtype == kF32 && d == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, drow, dq, bh, t, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* drow, void* dk, void* dv, int bh,
                              int t, int d, float scale, int dtype,
                              void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d == 128)
    return launch_dkdv<__nv_bfloat16, 128>(q, k, v, dout, lse, drow, dk, dv,
                                           bh, t, scale, s);
  if (dtype == kBF16 && d == 64)
    return launch_dkdv<__nv_bfloat16, 64>(q, k, v, dout, lse, drow, dk, dv,
                                          bh, t, scale, s);
  if (dtype == kF32 && d == 128)
    return launch_dkdv<float, 128>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                   scale, s);
  if (dtype == kF32 && d == 64)
    return launch_dkdv<float, 64>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                  scale, s);
  return (int)cudaErrorInvalidValue;
}
