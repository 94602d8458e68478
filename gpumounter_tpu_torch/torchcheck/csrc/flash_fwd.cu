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
// Which K tiles a block visits (both instances):
//   * K-blocked: a K tile is skipped when the Pallas (tile_q x k_block)
//     block holding it lies wholly in the causal future of the Pallas q
//     tile holding this block's rows. That reproduces _fwd_fused_kernel's
//     skip decisions exactly; rows whose every block was skipped leave
//     m = NEG_INF, l = 0, pv = 0;
//   * whole-K: every K tile. A row with no visible key keeps m = NEG_INF and
//     gets p = exp(0) = 1 for every key, so l = TK and pv = sum(v), exactly
//     as _block_kernel's single softmax gives;
//   * both: when every row of the block sees key k_offset, every row's m is
//     a real score after the first tile, and a tile wholly in the rows'
//     future then adds exp(NEG_INF - m) = 0 to l and pv and leaves m (so
//     corr = 1): the loop stops at the causal edge, bit-exact. At offsets 0
//     both contracts run exactly the causal tiles.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 989 TFLOP/s bf16, 3.35 TB/s):
// at the flagship shape (BH=256, T=1024, D=128, causal) ~69 GFLOP (70 us)
// against ~0.34 GB, most of it the f32 pv output (101 us): bytes-bound; at
// the long-context shape (BH=64, T=4096) ~275 GFLOP (278 us) against
// ~0.24 GB: operations-bound.
//
// bf16 design (flash_fwd_wgmma_kernel): one block of two consumer
// warpgroups per (bh, 128 q rows), 64 rows each. Q arrives once by TMA; K
// and V tiles of 128 keys stream through a 2-stage TMA/mbarrier ring, the
// next tile's load started by one thread before the current tile's math.
// S = Q.K^T is a wgmma from shared memory into registers; the online
// softmax runs on those registers (row max and sum across each quad with
// shuffles); P packs in place into bf16 A fragments, and O += P.V is a
// wgmma with A in registers and V read MN-major, so the [64, D] f32
// accumulator never leaves registers. Only tiles that cross the diagonal
// build a mask. The f32 instance (parity against float64, not speed) keeps
// the CUDA-core path below: shared-memory tiles and FMA products.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash {

// -- f32: CUDA-core FMAs on shared-memory tiles -------------------------------
// (templated on the element type, instantiated for f32 only)

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
  // the exact causal stop (header comment)
  const bool exact_skip = q_offset + q0 >= k_offset;

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


// -- bf16: wgmma + TMA --------------------------------------------------------

template <int D>
struct WgFwd {
  static constexpr int BQ = 128, BK = 128, NT = 256, STAGES = 2;
  static constexpr uint32_t BOX = 128 * hopper::ROW_BYTES;  // [128][64] bf16
  static constexpr uint32_t TILE = (D / hopper::BOX_COLS) * BOX;  // [128, D]
  // 1024 bytes of slack to align the base | q | k ring | v ring | barriers
  static constexpr size_t bytes = 1024 + (1 + 2 * STAGES) * TILE + 64;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           float* __restrict__ pv, float* __restrict__ m_out,
                           float* __restrict__ l_out, int tq, int tk,
                           int q_offset, int k_offset, float scale,
                           int skip_tq, int skip_tk) {
  using namespace hopper;
  using L = WgFwd<D>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + L::TILE;      // stage s at ks + s * TILE
  unsigned char* vs = ks + S * L::TILE;  // stage s at vs + s * TILE
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vs + S * L::TILE);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32;
  const int lane = tid % 32;
  // The last q tiles see the most keys: start them first so the heaviest
  // blocks do not form the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;

  long long kend = tk;  // keys [0, kend) of this block's loop
  if (skip_tq) {        // the Pallas skip: whole k blocks in the future
    const long long q_tile_last =
        q_offset + (long long)(q0 / skip_tq + 1) * skip_tq - 1;
    const long long blocks =
        q_tile_last < k_offset ? 0 : (q_tile_last - k_offset) / skip_tk + 1;
    kend = min(kend, blocks * skip_tk);
  }
  if ((long long)q_offset + q0 >= k_offset) {  // the exact causal stop
    const long long seen = (long long)q_offset + q0 + BQ - k_offset;
    kend = min(kend, (seen + BK - 1) / BK * BK);
  }
  const int n = (int)(kend / BK);

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int k_row = bh * tk;
  auto load_kv = [&](int j) {  // K/V tile j into stage j % S
    const int s = j % S;
    mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b) {
      tma_load(ks + s * L::TILE + b * L::BOX, &k_map, &full[s], b * BOX_COLS,
               k_row + j * BK);
      tma_load(vs + s * L::TILE + b * L::BOX, &v_map, &full[s], b * BOX_COLS,
               k_row + j * BK);
    }
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(q_bar, L::TILE);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b)
      tma_load(qs + b * L::BOX, &q_map, q_bar, b * BOX_COLS, bh * tq + q0);
    for (int j = 0; j < S - 1 && j < n; ++j) load_kv(j);
  }

  // this thread's two rows (wgmma accumulator layout)
  const int r = 64 * wg + 16 * warp + lane / 4;
  const long long q_pos = (long long)q_offset + q0 + r;
  const int col = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  if (n > 0) mbar_wait(q_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % S;
    if (tid == 0 && j + S - 1 < n) {
      // stage (j - 1) % S is free once both warpgroups finished tile j - 1
      if (j >= 1) mbar_wait(&empty[(j - 1) % S], ((j - 1) / S) & 1);
      load_kv(j + S - 1);
    }
    mbar_wait(&full[s], (j / S) & 1);
    const unsigned char* kt = ks + s * L::TILE;
    const unsigned char* vt = vs + s * L::TILE;

    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k(qs, L::BOX, 64 * wg, kk), desc_k(kt, L::BOX, 0, kk),
               kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, mask (tiles that cross this warpgroup's diagonal only), max
    const long long k_pos = (long long)k_offset + (long long)j * BK + col;
    const bool masked = (long long)q_offset + q0 + 64 * wg <
                        (long long)k_offset + (long long)j * BK + BK - 1;
    // column c of the tile is visible to the first row iff c <= vis0
    const int vis0 = (int)max(-1LL, min((long long)BK, q_pos - k_pos));
    const int vis1 = (int)max(-1LL, min((long long)BK, q_pos + 8 - k_pos));
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * i + e] * scale, x1 = sc[4 * i + 2 + e] * scale;
        if (masked) {
          x0 = 8 * i + e <= vis0 ? x0 : NEG_INF;
          x1 = 8 * i + e <= vis1 ? x1 : NEG_INF;
        }
        sc[4 * i + e] = x0;
        sc[4 * i + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // (a - b) first, then the log2(e) factor: for a fully masked row both
    // are exactly NEG_INF and the difference is exactly 0
    const float c0 = exp2f((m0 - mn0) * LOG2E);
    const float c1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[BK / 4];  // P as bf16 A fragments, 4 per k16 step
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p00 = exp2f((sc[4 * i] - mn0) * LOG2E);
      const float p01 = exp2f((sc[4 * i + 1] - mn0) * LOG2E);
      const float p10 = exp2f((sc[4 * i + 2] - mn1) * LOG2E);
      const float p11 = exp2f((sc[4 * i + 3] - mn1) * LOG2E);
      ls0 += p00 + p01;
      ls1 += p10 + p11;
      pf[i / 2 * 4 + i % 2 * 2] = pack_bf16(p00, p01);
      pf[i / 2 * 4 + i % 2 * 2 + 1] = pack_bf16(p10, p11);
    }
    // per-thread partial row sums; the quad's corr is the same
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= c0;
      o[4 * i + 1] *= c0;
      o[4 * i + 2] *= c1;
      o[4 * i + 3] *= c1;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pf + 4 * kk, desc_mn(vt, L::BOX, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t row = (size_t)bh * tq + q0 + r;
  float* out = pv + row * D + col;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<float2*>(out + 8 * i) =
        make_float2(o[4 * i], o[4 * i + 1]);
    *reinterpret_cast<float2*>(out + 8 * D + 8 * i) =
        make_float2(o[4 * i + 2], o[4 * i + 3]);
  }
  if (lane % 4 == 0) {
    m_out[row] = m0;
    m_out[row + 8] = m1;
    l_out[row] = l0;
    l_out[row + 8] = l1;
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* pv,
                     void* m, void* l, int bh, int tq, int tk, int q_offset,
                     int k_offset, float scale, int skip_tq, int skip_tk,
                     cudaStream_t stream) {
  using namespace hopper;
  using L = WgFwd<D>;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap q_map, k_map, v_map;
  int err = make_tile_map(&q_map, q, (uint64_t)bh * tq, D, L::BQ);
  if (!err) err = make_tile_map(&k_map, k, (uint64_t)bh * tk, D, L::BK);
  if (!err) err = make_tile_map(&v_map, v, (uint64_t)bh * tk, D, L::BK);
  if (err) return err;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tq / L::BQ, bh);
  kern<<<grid, L::NT, L::bytes, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(pv), static_cast<float*>(m),
      static_cast<float*>(l), tq, tk, q_offset, k_offset, scale, skip_tq,
      skip_tk);
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
    return launch_fwd_wgmma<128>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                 k_offset, scale, skip_tq, skip_tk, s);
  if (dtype == kBF16 && d == 64)
    return launch_fwd_wgmma<64>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                k_offset, scale, skip_tq, skip_tk, s);
  if (dtype == kF32 && d == 128)
    return launch_fwd<float, 128>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                  k_offset, scale, skip_tq, skip_tk, s);
  if (dtype == kF32 && d == 64)
    return launch_fwd<float, 64>(q, k, v, pv, m, l, bh, tq, tk, q_offset,
                                 k_offset, scale, skip_tq, skip_tk, s);
  return (int)cudaErrorInvalidValue;
}
