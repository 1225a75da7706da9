// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels torchft_tpu/ops/attention.py:_fa_bwd_dkdv_kernel
// (its merged form, which also emits per-kv-block dq partials) and
// _fa_bwd_dq_kernel (the long-context dq pass), both launched by
// _fa_bwd_pallas, with the shared tile body _bwd_block.
//
// A GPU grid runs in no order, so the TPU kernel's trick of carrying dq
// partials through a sequential grid axis does not carry over.  The port
// splits the backward by output instead, with no atomics (results are
// deterministic):
//   flash_bwd_dkdv: one block per (bh, 64-row kv tile), a loop over the q
//                   tiles at or below the diagonal; dK and dV accumulate in
//                   f32 shared memory.
//   flash_bwd_dq:   one block per (bh, 64-row q tile), a loop over the kv
//                   tiles up to the diagonal; dQ accumulates in f32 shared
//                   memory.
// Both recompute the (q tile, kv tile) pair through one device function,
// bwd_tile: S = Q K^T, P = exp(S * scale - lse), dP = dO V^T,
// dS = P (dP - delta) scale, with delta = rowsum(dO * O) computed outside
// the kernels as on the TPU.
//
// What bounds it on the card: at the flagship shape (BH 96, S 1024, D 128,
// causal) the backward needs five products, 64.4 GFLOP of bf16 work against
// 177 MB of tensors: compute-bound, 0.065 ms at the tensor-core peak.  The
// split design recomputes S and dP in both kernels (seven products in
// all, 1.4x the minimum) to keep every accumulator on chip and the two
// passes independent; tiles and accumulators live in shared memory (187 KB
// for dK/dV, 146 KB for dQ at D 128) and products go through wmma
// fragments.  A fast version keeps the accumulators in registers and
// overlaps the tile loads (TMA, wgmma); that is later work.
#include "common.cuh"

namespace tft {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

template <int D>
struct BwdLayout {
  static constexpr int LDH = D + 8;   // bf16 [64][D] tiles
  static constexpr int LDS = BK + 4;  // f32 [64][64] tiles
  static constexpr int LDP = BK + 8;  // bf16 [64][64] tiles
  static constexpr int LDO = D + 4;   // f32 [64][D] accumulators
  static constexpr size_t tile_h = BQ * LDH * sizeof(bf16);
  static constexpr size_t tile_s = BQ * LDS * sizeof(float);
  static constexpr size_t tile_p = BQ * LDP * sizeof(bf16);
  static constexpr size_t tile_o = BQ * LDO * sizeof(float);
  static constexpr size_t rows = 2 * BQ * sizeof(float);
  // dkdv: K V Q dO | S dP | P dS | dK dV | lse delta
  static constexpr size_t dkdv_bytes = 4 * tile_h + 2 * tile_s + 2 * tile_p + 2 * tile_o + rows;
  // dq: Q dO K V | S dP | dS | dQ | lse delta
  static constexpr size_t dq_bytes = 4 * tile_h + 2 * tile_s + tile_p + tile_o + rows;
};

// The shared (q tile, kv tile) body.  Each warp handles its 16 q rows
// (r0 = 16 * warp): writes P (bf16, when sPb is not null) and dS (bf16) for
// those rows.  Rows past S, columns past S and (causal) columns above the
// diagonal get P = dS = 0.
template <int D>
__device__ __forceinline__ void bwd_tile(const bf16* sQ, const bf16* sK, const bf16* sV,
                                         const bf16* sDO, const float* sLse,
                                         const float* sDelta, float* sS, float* sDP,
                                         bf16* sPb, bf16* sDS, int q0, int k0, int S,
                                         float scale, int causal, int r0, int lane) {
  using L = BwdLayout<D>;
  for (int n = 0; n < BK / 16; ++n) {
    FragAcc acc_s, acc_dp;
    wmma::fill_fragment(acc_s, 0.f);
    wmma::fill_fragment(acc_dp, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      FragARow a;
      FragBCol b;
      wmma::load_matrix_sync(a, sQ + r0 * L::LDH + kk * 16, L::LDH);
      wmma::load_matrix_sync(b, sK + n * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc_s, a, b, acc_s);
      wmma::load_matrix_sync(a, sDO + r0 * L::LDH + kk * 16, L::LDH);
      wmma::load_matrix_sync(b, sV + n * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc_dp, a, b, acc_dp);
    }
    wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc_s, L::LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(sDP + r0 * L::LDS + n * 16, acc_dp, L::LDS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    const float lse_r = sLse[r];
    const float delta_r = sDelta[r];
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      const int kj = k0 + c;
      const bool valid = qi < S && kj < S && (!causal || kj <= qi);
      const float p = valid ? __expf(sS[r * L::LDS + c] * scale - lse_r) : 0.f;
      const float ds = p * (sDP[r * L::LDS + c] - delta_r) * scale;
      if (sPb != nullptr) sPb[r * L::LDP + c] = __float2bfloat16(p);
      sDS[r * L::LDP + c] = __float2bfloat16(ds);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void load_rows(float* sLse, float* sDelta, const float* lse,
                                          const float* delta, long long row_base, int q0,
                                          int S) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    sLse[threadIdx.x] = qi < S ? lse[row_base + qi] : 0.f;
    sDelta[threadIdx.x] = qi < S ? delta[row_base + qi] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                          int causal) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * L::LDH;
  bf16* sQ = sV + BK * L::LDH;
  bf16* sDO = sQ + BQ * L::LDH;
  float* sS = reinterpret_cast<float*>(sDO + BQ * L::LDH);
  float* sDP = sS + BQ * L::LDS;
  bf16* sPb = reinterpret_cast<bf16*>(sDP + BQ * L::LDS);
  bf16* sDS = sPb + BQ * L::LDP;
  float* sDK = reinterpret_cast<float*>(sDS + BQ * L::LDP);
  float* sDV = sDK + BK * L::LDO;
  float* sLse = sDV + BK * L::LDO;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const long long base = static_cast<long long>(bh) * S * D;
  const long long row_base = static_cast<long long>(bh) * S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile(sK, L::LDH, k + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
  load_tile(sV, L::LDH, v + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
  for (int i = threadIdx.x; i < BK * L::LDO; i += THREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  const int n_q = (S + BQ - 1) / BQ;
  for (int t = causal ? k0 / BQ : 0; t < n_q; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous q tile's products are done
    load_tile(sQ, L::LDH, q + base + static_cast<long long>(q0) * D, D, BQ, D, S - q0, D);
    load_tile(sDO, L::LDH, dout + base + static_cast<long long>(q0) * D, D, BQ, D, S - q0, D);
    load_rows(sLse, sDelta, lse, delta, row_base, q0, S);
    __syncthreads();
    bwd_tile<D>(sQ, sK, sV, sDO, sLse, sDelta, sS, sDP, sPb, sDS, q0, k0, S, scale, causal,
                r0, lane);
    __syncthreads();  // dK/dV products read every q row of P and dS

    // This warp owns kv rows [r0, r0 + 16) of dV += P^T dO and dK += dS^T Q.
    for (int n = 0; n < D / 16; ++n) {
      FragAcc acc_v, acc_k;
      wmma::load_matrix_sync(acc_v, sDV + r0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
      wmma::load_matrix_sync(acc_k, sDK + r0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BQ / 16; ++kk) {
        FragACol a;
        FragBRow b;
        wmma::load_matrix_sync(a, sPb + kk * 16 * L::LDP + r0, L::LDP);
        wmma::load_matrix_sync(b, sDO + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc_v, a, b, acc_v);
        wmma::load_matrix_sync(a, sDS + kk * 16 * L::LDP + r0, L::LDP);
        wmma::load_matrix_sync(b, sQ + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc_k, a, b, acc_k);
      }
      wmma::store_matrix_sync(sDV + r0 * L::LDO + n * 16, acc_v, L::LDO, wmma::mem_row_major);
      wmma::store_matrix_sync(sDK + r0 * L::LDO + n * 16, acc_k, L::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int kj = k0 + r;
    if (kj >= S) break;
    const long long off = base + static_cast<long long>(kj) * D;
    for (int c = lane; c < D; c += 32) {
      dk[off + c] = __float2bfloat16(sDK[r * L::LDO + c]);
      dv[off + c] = __float2bfloat16(sDV[r * L::LDO + c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, float scale, int causal) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BQ * L::LDH;
  bf16* sK = sDO + BQ * L::LDH;
  bf16* sV = sK + BK * L::LDH;
  float* sS = reinterpret_cast<float*>(sV + BK * L::LDH);
  float* sDP = sS + BQ * L::LDS;
  bf16* sDS = reinterpret_cast<bf16*>(sDP + BQ * L::LDS);
  float* sDQ = reinterpret_cast<float*>(sDS + BQ * L::LDP);
  float* sLse = sDQ + BQ * L::LDO;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long base = static_cast<long long>(bh) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile(sQ, L::LDH, q + base + static_cast<long long>(q0) * D, D, BQ, D, S - q0, D);
  load_tile(sDO, L::LDH, dout + base + static_cast<long long>(q0) * D, D, BQ, D, S - q0, D);
  load_rows(sLse, sDelta, lse, delta, static_cast<long long>(bh) * S, q0, S);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) sDQ[i] = 0.f;

  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, L::LDH, k + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
    load_tile(sV, L::LDH, v + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
    __syncthreads();
    bwd_tile<D>(sQ, sK, sV, sDO, sLse, sDelta, sS, sDP, nullptr, sDS, q0, k0, S, scale,
                causal, r0, lane);
    // dQ += dS K over this warp's own rows.
    for (int n = 0; n < D / 16; ++n) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, sDQ + r0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragARow a;
        FragBRow b;
        wmma::load_matrix_sync(a, sDS + r0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sK + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sDQ + r0 * L::LDO + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    if (qi >= S) break;
    const long long off = base + static_cast<long long>(qi) * D;
    for (int c = lane; c < D; c += 32) dq[off + c] = __float2bfloat16(sDQ[r * L::LDO + c]);
  }
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int bh, int S,
                        float scale, int causal, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::dkdv_bytes;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BK - 1) / BK, bh);
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int S, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::dq_bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tft

// q, k, v, dout, dk, dv: [bh, s, d] bf16 contiguous; lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int bh,
                                 int s, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return tft::launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, dout, dq: [bh, s, d] bf16 contiguous; lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int s, int d,
                               float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return tft::launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, s, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
