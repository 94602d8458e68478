// Causal flash-attention forward statistics on Hopper (sm_90a).
//
// Replaces both Pallas forward kernels of
// gpumounter_tpu/jaxcheck/pallas_attention.py:
//   * _block_kernel      (lines 60-82,   launched by flash_block at 146):
//     the whole-K contract, skip_tq == 0;
//   * _fwd_fused_kernel  (lines 273-314, launched by flash_block at 120):
//     the K-blocked contract, skip_tq/skip_tk = its (tile_q, k_block).
// Per row of q [BH, TQ, D] against k, v [BH, TK, D], with the causal mask in
// global coordinates (q_offset + row >= k_offset + col) and the runtime
// scale (flash_block passes 1/sqrt(D)):
//   m  = rowmax(s)   l = rowsum(exp(s - m))   pv = exp(s - m) . v
// unnormalised, all three f32; p is cast to v's dtype before the PV product.
//
// Design: one thread block per (bh, q tile of BQ rows). A loop over K tiles
// inside the block takes the place of the TPU's sequential k-block grid
// axis; the online-softmax state (m, l, the [BQ, D] accumulator) stays in
// shared memory for the whole loop, so scores never reach device memory.
// Both contracts are the same loop:
//   * whole-K: every K tile is visited, except tiles wholly in the future
//     of a block whose rows all see key 0 (they add exactly 0, see the
//     loop). A row with no visible key keeps m = NEG_INF and gets
//     p = exp(0) = 1 for every key, so l = TK and pv = sum(v), exactly as
//     _block_kernel's single softmax gives;
//   * K-blocked: a K tile is skipped when the Pallas (tile_q x k_block)
//     block holding it lies wholly in the causal future of the Pallas q
//     tile holding this block's rows. That reproduces _fwd_fused_kernel's
//     skip decisions exactly; rows whose every block was skipped leave
//     m = NEG_INF, l = 0, pv = 0.
//
// Bound on the H100 (flagship shape BH=256, T=1024, D=128, bf16, causal):
// ~69 GFLOP of tensor work (~70 us at 989 TF/s) against ~0.34 GB moved,
// most of it the f32 pv output (~100 us at 3.35 TB/s): memory-bound. This
// first version stages every tile through shared memory and uses wmma, so
// it runs well above that bound; the fast version (TMA + wgmma, bf16
// output) is later work.

#include "flash_common.cuh"

namespace flash {

template <typename T, int D>
struct FwdLayout {
  static constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  static constexpr int LDT = D + PAD_T;   // q, k, v tiles
  static constexpr int LDP = BK + PAD_T;  // p tile (input dtype)
  static constexpr int LDS = BK + PAD_F;  // score tile (f32)
  static constexpr int LDO = D + PAD_F;   // accumulator (f32)
  static constexpr size_t bytes =
      3 * round128(sizeof(T) * BQ * LDT) +  // q (BQ == BK for k, v)
      round128(sizeof(T) * BQ * LDP) + round128(sizeof(float) * BQ * LDS) +
      round128(sizeof(float) * BQ * LDO) + 3 * round128(sizeof(float) * BQ);
  static_assert(BQ == BK, "one tile height for q and k");
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ pv,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int tq, int tk, int q_offset, int k_offset, float scale,
                     int skip_tq, int skip_tk) {
  using L = FwdLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver c{smem};
  T* qs = c.take<T>(BQ * L::LDT);
  T* ks = c.take<T>(BK * L::LDT);
  T* vs = c.take<T>(BK * L::LDT);
  T* ps = c.take<T>(BQ * L::LDP);
  float* ss = c.take<float>(BQ * L::LDS);
  float* os = c.take<float>(BQ * L::LDO);
  float* ms = c.take<float>(BQ);
  float* ls = c.take<float>(BQ);
  float* cs = c.take<float>(BQ);

  // The last q tiles see the most keys under the K-blocked skip: start them
  // first so the heaviest blocks do not form the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  load_tile<T, D>(qs, q + ((size_t)bh * tq + q0) * D, BQ);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NT) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    ms[i] = NEG_INF;
    ls[i] = 0.0f;
  }
  // global position of the last row of the Pallas q tile holding row q0
  const int q_tile_last =
      skip_tq ? q_offset + (q0 / skip_tq + 1) * skip_tq - 1 : 0;
  // Whole-K contract: when every row of this block sees key 0 of the
  // block, every row's m is a real score after the first tile, and a tile
  // wholly in the rows' future then adds exp(NEG_INF - m) = 0 to l and pv
  // and leaves m (so corr = 1) unchanged: skipping it is bit-exact.
  const bool exact_skip = !skip_tq && q_offset + q0 >= k_offset;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    // key positions only grow with k0: once one block is in the future,
    // every later one is too
    if (skip_tq && q_tile_last < k_offset + (k0 / skip_tk) * skip_tk) break;
    if (exact_skip && q_offset + q0 + BQ - 1 < k_offset + k0) break;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, kb + (size_t)k0 * D, BK);
    load_tile<T, D>(vs, vb + (size_t)k0 * D, BK);
    __syncthreads();
    gemm<BQ, BK, D, false, true>(ss, L::LDS, qs, L::LDT, ks, L::LDT, false);
    __syncthreads();
    for (int r = warp; r < BQ; r += NWARPS) {
      const int q_pos = q_offset + q0 + r;
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) {
        const float s = q_pos >= k_offset + k0 + j ? ss[r * L::LDS + j] * scale
                                                   : NEG_INF;
        ss[r * L::LDS + j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(ss[r * L::LDS + j] - m_new);
        sum += p;
        ps[r * L::LDP + j] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += NT) {
      const int r = i / D, j = i % D;
      os[r * L::LDO + j] *= cs[r];
    }
    __syncthreads();
    gemm<BQ, D, BK, false, false>(os, L::LDO, ps, L::LDP, vs, L::LDT, true);
  }
  __syncthreads();

  float* pvb = pv + ((size_t)bh * tq + q0) * D;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, j = i % D;
    pvb[(size_t)r * D + j] = os[r * L::LDO + j];
  }
  for (int i = threadIdx.x; i < BQ; i += NT) {
    m_out[(size_t)bh * tq + q0 + i] = ms[i];
    l_out[(size_t)bh * tq + q0 + i] = ls[i];
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* pv, void* m,
               void* l, int bh, int tq, int tk, int q_offset, int k_offset,
               float scale, int skip_tq, int skip_tk, cudaStream_t stream) {
  using L = FwdLayout<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tq / L::BQ, bh);
  kern<<<grid, NT, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(pv),
      static_cast<float*>(m), static_cast<float*>(l), tq, tk, q_offset,
      k_offset, scale, skip_tq, skip_tk);
  return (int)cudaGetLastError();
}

}  // namespace flash

// C interface, bound with ctypes by kernels.py, which validates every
// argument first. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* pv,
                         void* m, void* l, int bh, int tq, int tk, int d,
                         int q_offset, int k_offset, float scale, int skip_tq,
                         int skip_tk, int dtype, void* stream) {
  using namespace flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, pv, m, l, bh, tq, tk,
                                          q_offset, k_offset, scale, skip_tq,
                                          skip_tk, s);
  if (dtype == kBF16 && d == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, pv, m, l, bh, tq, tk,
                                         q_offset, k_offset, scale, skip_tq,
                                         skip_tk, s);
  if (dtype == kF32 && d == 128)
    return launch_fwd<float, 128>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                  k_offset, scale, skip_tq, skip_tk, s);
  if (dtype == kF32 && d == 64)
    return launch_fwd<float, 64>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                 k_offset, scale, skip_tq, skip_tk, s);
  return (int)cudaErrorInvalidValue;
}
