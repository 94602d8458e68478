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
// Both kernels recompute s and p from q and k (nothing [T, T] touches
// device memory) and neither needs atomics. A tile wholly in the causal
// future contributes exactly 0 (p underflows to 0 there), so skipping it
// changes nothing.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 989 TFLOP/s bf16, 3.35 TB/s),
// flagship shape BH=256, T=1024, D=128, causal:
//   dq:   ~103 GFLOP (104 us) vs ~0.40 GB (121 us): bytes-bound;
//   dkdv: ~137 GFLOP (139 us) vs ~0.54 GB (161 us): bytes-bound;
// at the long-context shape (BH=64, T=4096) both are operations-bound
// (dq 417 us, dkdv 556 us).
//
// flash_bwd_dkdv, bf16 (flash_bwd_dkdv_wgmma_kernel): one block of two
// consumer warpgroups per (bh, 128 keys), 64 keys each; the K and V tiles
// stay in shared memory, and q, do, lse and drow tiles of 64 queries stream
// through a 3-stage TMA/mbarrier ring from the causal edge to the end. The
// block computes the transposed tiles S^T = K.Q^T and dP^T = V.dO^T (wgmma,
// every operand K-major), so that P^T = exp(S^T * scale - lse) and
// dS^T = P^T * (dP^T - drow) are rows of keys in registers, and packs them
// in place into bf16 A fragments: dV += P^T.dO and dK += dS^T.Q are wgmmas
// with A in registers and dO, Q read MN-major. The f32 dK and dV
// accumulators stay in registers for the whole loop and are written once.
//
// flash_bwd_dq, bf16 (flash_bwd_dq_wgmma_kernel): the same design turned
// around. One block of two consumer warpgroups per (bh, 128 queries), 64
// queries each; the Q and dO tiles stay in shared memory, lse and drow of
// the thread's two rows in registers, and K and V tiles of 128 keys stream
// through a TMA/mbarrier ring from key 0 to the causal edge. S = Q.K^T
// and dP = dO.V^T are wgmmas into registers (every operand K-major);
// P = exp(S * scale - lse) and dS = P * (dP - drow) stay in registers, dS
// packs in place into bf16 A fragments, and dQ += dS.K is a wgmma with K
// read MN-major (the same K tile S read K-major). Only the block's last
// key tile, on the diagonal, builds a mask (in both warpgroups; half of it
// is warpgroup 0's future and adds 0). The f32 dQ accumulator stays in
// registers and is written once, so the result is bitwise deterministic.
//
// The f32 instances of both (parity against float64, not speed) keep the
// first design: one block per (bh, tile), tiles staged in shared memory,
// CUDA-core FMAs, the accumulator in shared memory.

#include <initializer_list>

#include "flash_common.cuh"
#include "hopper_common.cuh"

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

// Instantiated for f32 only: bf16 runs flash_bwd_dq_wgmma_kernel.
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

// Instantiated for f32 only: bf16 runs flash_bwd_dkdv_wgmma_kernel.
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


// -- flash_bwd_dq, bf16: wgmma + TMA ------------------------------------------

// The ring holds as many stages as fit in the 227 KB (232,448 bytes) a
// block may use, up to 4: 2 at D = 128, 4 at D = 64.
template <int D>
struct WgDq {
  static constexpr int BQ = 128, BK = 128, NT = 256;
  static constexpr uint32_t QBOX = BQ * hopper::ROW_BYTES;  // [128][64] bf16
  static constexpr uint32_t KBOX = BK * hopper::ROW_BYTES;  // [128][64] bf16
  static constexpr uint32_t QTILE = (D / hopper::BOX_COLS) * QBOX;
  static constexpr uint32_t KTILE = (D / hopper::BOX_COLS) * KBOX;
  static constexpr uint32_t STAGE = 2 * KTILE;  // one ring stage: k | v
  static constexpr int FIT = (232448 - 1024 - 2 * QTILE - 128) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // 1024 bytes of slack to align the base | q | do | ring | barriers
  static constexpr size_t bytes =
      1024 + 2 * QTILE + STAGES * STAGE + 8 * (1 + 2 * STAGES);
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ drow,
                              float* __restrict__ dq, int t, float scale) {
  using namespace hopper;
  using L = WgDq<D>;
  constexpr int BQ = L::BQ, BK = L::BK, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + L::QTILE;
  unsigned char* ring = dos + L::QTILE;  // stage s at ring + s * STAGE
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(ring + S * L::STAGE);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32;
  const int lane = tid % 32;
  // late q tiles loop over the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int n = (q0 + BQ) / BK;  // k tiles from key 0 to the causal edge

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto load_kv = [&](int j) {  // k/v tile j into stage j % S
    const int s = j % S;
    unsigned char* st = ring + s * L::STAGE;
    const int row = bh * t + j * BK;
    mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b) {
      tma_load(st + b * L::KBOX, &k_map, &full[s], b * BOX_COLS, row);
      tma_load(st + L::KTILE + b * L::KBOX, &v_map, &full[s], b * BOX_COLS,
               row);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * L::QTILE);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b) {
      tma_load(qs + b * L::QBOX, &q_map, q_bar, b * BOX_COLS, bh * t + q0);
      tma_load(dos + b * L::QBOX, &do_map, q_bar, b * BOX_COLS, bh * t + q0);
    }
    for (int j = 0; j < S - 1 && j < n; ++j) load_kv(j);
  }

  // this thread's two query rows (wgmma accumulator rows), first key column
  const int qw = q0 + 64 * wg;  // first query of this warpgroup
  const int rw = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const size_t row0 = (size_t)bh * t + qw + rw;
  const float ls0 = lse[row0], ls1 = lse[row0 + 8];
  const float dr0 = drow[row0], dr1 = drow[row0 + 8];
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.0f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % S;
    const int k0 = j * BK;
    if (tid == 0 && j + S - 1 < n) {
      // stage (j - 1) % S is free once both warpgroups finished tile j - 1
      if (j >= 1) mbar_wait(&empty[(j - 1) % S], ((j - 1) / S) & 1);
      load_kv(j + S - 1);
    }
    mbar_wait(&full[s], (j / S) & 1);
    const unsigned char* kt = ring + s * L::STAGE;
    const unsigned char* vt = kt + L::KTILE;

    float st[BK / 2], dpt[BK / 2];  // S, dP: rows queries, columns keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, desc_k(qs, L::QBOX, 64 * wg, kk),
               desc_k(kt, L::KBOX, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, desc_k(dos, L::QBOX, 64 * wg, kk),
               desc_k(vt, L::KBOX, 0, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // only a tile that crosses this warpgroup's diagonal builds a mask:
    // key column c is visible to the first row iff c <= need
    const bool masked = k0 + BK - 1 > qw;
    const int need = qw + rw - k0;
    uint32_t dsf[BK / 4];  // dS as bf16 A fragments, 4 per k16 step
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (first row, second row) x 2 columns
        const int c = 8 * i + col + (e & 1);
        float x = st[4 * i + e] * scale;
        if (masked && c > need + (e >> 1) * 8) x = NEG_INF;
        const float p = exp2f((x - ((e >> 1) ? ls1 : ls0)) * LOG2E);
        ds[e] = p * (dpt[4 * i + e] - ((e >> 1) ? dr1 : dr0));
      }
      dsf[i / 2 * 4 + i % 2 * 2] = pack_bf16(ds[0], ds[1]);
      dsf[i / 2 * 4 + i % 2 * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(dqa, dsf + 4 * kk, desc_mn(kt, L::KBOX, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
    fence_regs(dsf);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float* out = dq + row0 * D + col;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<float2*>(out + 8 * i) =
        make_float2(dqa[4 * i] * scale, dqa[4 * i + 1] * scale);
    *reinterpret_cast<float2*>(out + 8 * D + 8 * i) =
        make_float2(dqa[4 * i + 2] * scale, dqa[4 * i + 3] * scale);
  }
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* drow,
                    void* dq, int bh, int t, float scale,
                    cudaStream_t stream) {
  using namespace hopper;
  using L = WgDq<D>;
  for (const void* p : {q, k, v, dout, lse, drow})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  CUtensorMap q_map, k_map, v_map, do_map;
  const uint64_t rows = (uint64_t)bh * t;
  int err = make_tile_map(&q_map, q, rows, D, L::BQ);
  if (!err) err = make_tile_map(&k_map, k, rows, D, L::BK);
  if (!err) err = make_tile_map(&v_map, v, rows, D, L::BK);
  if (!err) err = make_tile_map(&do_map, dout, rows, D, L::BQ);
  if (err) return err;
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(t / L::BQ, bh);
  kern<<<grid, L::NT, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<float*>(dq), t, scale);
  return (int)cudaGetLastError();
}


// -- flash_bwd_dkdv, bf16: wgmma + TMA ----------------------------------------

template <int D>
struct WgDkdv {
  static constexpr int BK = 128, BQ = 64, NT = 256, STAGES = 3;
  static constexpr uint32_t KBOX = BK * hopper::ROW_BYTES;  // [128][64] bf16
  static constexpr uint32_t QBOX = BQ * hopper::ROW_BYTES;  // [64][64] bf16
  static constexpr uint32_t KTILE = (D / hopper::BOX_COLS) * KBOX;
  static constexpr uint32_t QTILE = (D / hopper::BOX_COLS) * QBOX;
  static constexpr uint32_t ROW = BQ * sizeof(float);  // lse or drow tile
  // one ring stage: q | do | lse | drow, kept 1024-byte aligned
  static constexpr uint32_t STAGE =
      (2 * QTILE + 2 * ROW + hopper::ATOM_BYTES - 1) / hopper::ATOM_BYTES *
      hopper::ATOM_BYTES;
  // 1024 bytes of slack to align the base | k | v | ring | barriers
  static constexpr size_t bytes = 1024 + 2 * KTILE + STAGES * STAGE + 64;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const float* __restrict__ lse,
                                const float* __restrict__ drow,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int t, float scale) {
  using namespace hopper;
  using L = WgDkdv<D>;
  constexpr int BK = L::BK, BQ = L::BQ, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + L::KTILE;
  unsigned char* ring = vs + L::KTILE;  // stage s at ring + s * STAGE
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(ring + S * L::STAGE);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * BK;  // early k tiles see the most queries
  const int bh = blockIdx.y;
  const int n = (t - k0) / BQ;     // q tiles from the causal edge to the end

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto load_q = [&](int j) {  // q tile j into stage j % S
    const int s = j % S;
    unsigned char* st = ring + s * L::STAGE;
    const int row = bh * t + k0 + j * BQ;
    mbar_expect_tx(&full[s], 2 * L::QTILE + 2 * L::ROW);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b) {
      tma_load(st + b * L::QBOX, &q_map, &full[s], b * BOX_COLS, row);
      tma_load(st + L::QTILE + b * L::QBOX, &do_map, &full[s], b * BOX_COLS,
               row);
    }
    bulk_load(st + 2 * L::QTILE, lse + row, L::ROW, &full[s]);
    bulk_load(st + 2 * L::QTILE + L::ROW, drow + row, L::ROW, &full[s]);
  };
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * L::KTILE);
#pragma unroll
    for (int b = 0; b < D / BOX_COLS; ++b) {
      tma_load(ks + b * L::KBOX, &k_map, kv_bar, b * BOX_COLS, bh * t + k0);
      tma_load(vs + b * L::KBOX, &v_map, kv_bar, b * BOX_COLS, bh * t + k0);
    }
    for (int j = 0; j < S - 1 && j < n; ++j) load_q(j);
  }

  // this thread's two keys (wgmma accumulator rows) and first query column
  const int kw = k0 + 64 * wg;  // first key of this warpgroup
  const int kr = kw + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(kv_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % S;
    const int q0 = k0 + j * BQ;
    if (tid == 0 && j + S - 1 < n) {
      // stage (j - 1) % S is free once both warpgroups finished tile j - 1
      if (j >= 1) mbar_wait(&empty[(j - 1) % S], ((j - 1) / S) & 1);
      load_q(j + S - 1);
    }
    mbar_wait(&full[s], (j / S) & 1);
    if (q0 + BQ <= kw) {  // wholly in the future of these keys: adds 0
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* qt = ring + s * L::STAGE;
    const unsigned char* dot = qt + L::QTILE;
    const float* lse_t = reinterpret_cast<const float*>(qt + 2 * L::QTILE);
    const float* drow_t = lse_t + BQ;

    float st[BQ / 2], dpt[BQ / 2];  // S^T, dP^T: rows keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, desc_k(ks, L::KBOX, 64 * wg, kk),
               desc_k(qt, L::QBOX, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, desc_k(vs, L::KBOX, 64 * wg, kk),
               desc_k(dot, L::QBOX, 0, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // only the tile on this warpgroup's diagonal builds a mask: query
    // column c is visible to the first key iff c >= need
    const bool masked = q0 < kw + 63;
    const int need = kr - q0 - col;
    uint32_t pf[BQ / 4], dsf[BQ / 4];  // P^T, dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_t + 8 * i + col);
      const float2 dr = *reinterpret_cast<const float2*>(drow_t + 8 * i + col);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (first key, second key) x 2 columns
        const int c = 8 * i + (e & 1);
        float x = st[4 * i + e] * scale;
        if (masked && c < need + (e >> 1) * 8) x = NEG_INF;
        p[e] = exp2f((x - ((e & 1) ? ls.y : ls.x)) * LOG2E);
        ds[e] = p[e] * (dpt[4 * i + e] - ((e & 1) ? dr.y : dr.x));
      }
      pf[i / 2 * 4 + i % 2 * 2] = pack_bf16(p[0], p[1]);
      pf[i / 2 * 4 + i % 2 * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[i / 2 * 4 + i % 2 * 2] = pack_bf16(ds[0], ds[1]);
      dsf[i / 2 * 4 + i % 2 * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dva, pf + 4 * kk, desc_mn(dot, L::QBOX, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dka, dsf + 4 * kk, desc_mn(qt, L::QBOX, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pf);
    fence_regs(dsf);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t off = ((size_t)bh * t + kr) * D + col;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<float2*>(dk + off + 8 * i) =
        make_float2(dka[4 * i] * scale, dka[4 * i + 1] * scale);
    *reinterpret_cast<float2*>(dk + off + 8 * D + 8 * i) =
        make_float2(dka[4 * i + 2] * scale, dka[4 * i + 3] * scale);
    *reinterpret_cast<float2*>(dv + off + 8 * i) =
        make_float2(dva[4 * i], dva[4 * i + 1]);
    *reinterpret_cast<float2*>(dv + off + 8 * D + 8 * i) =
        make_float2(dva[4 * i + 2], dva[4 * i + 3]);
  }
}

template <int D>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* drow,
                      void* dk, void* dv, int bh, int t, float scale,
                      cudaStream_t stream) {
  using namespace hopper;
  using L = WgDkdv<D>;
  for (const void* p : {q, k, v, dout, lse, drow})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  CUtensorMap q_map, k_map, v_map, do_map;
  const uint64_t rows = (uint64_t)bh * t;
  int err = make_tile_map(&q_map, q, rows, D, L::BQ);
  if (!err) err = make_tile_map(&k_map, k, rows, D, L::BK);
  if (!err) err = make_tile_map(&v_map, v, rows, D, L::BK);
  if (!err) err = make_tile_map(&do_map, dout, rows, D, L::BQ);
  if (err) return err;
  auto kern = flash_bwd_dkdv_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(t / L::BK, bh);
  kern<<<grid, L::NT, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<float*>(dk),
      static_cast<float*>(dv), t, scale);
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
    return launch_dq_wgmma<128>(q, k, v, dout, lse, drow, dq, bh, t, scale,
                                s);
  if (dtype == kBF16 && d == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, drow, dq, bh, t, scale, s);
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
    return launch_dkdv_wgmma<128>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                  scale, s);
  if (dtype == kBF16 && d == 64)
    return launch_dkdv_wgmma<64>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                 scale, s);
  if (dtype == kF32 && d == 128)
    return launch_dkdv<float, 128>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                   scale, s);
  if (dtype == kF32 && d == 64)
    return launch_dkdv<float, 64>(q, k, v, dout, lse, drow, dk, dv, bh, t,
                                  scale, s);
  return (int)cudaErrorInvalidValue;
}
