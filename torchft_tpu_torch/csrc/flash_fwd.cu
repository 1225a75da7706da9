// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchft_tpu/ops/attention.py:_fa_kernel (launched
// by _fa_pallas_call): O = softmax(Q K^T * scale) V over [BH, S, D] bf16,
// with an online softmax over kv tiles, and the per-row f32
// lse = m + log(l) the backward needs.  Causal kv tiles strictly above the
// diagonal are skipped.
//
// What bounds it on the card: at the flagship shape (BH 96, S 1024, D 128,
// causal) the work is 25.8 GFLOP of bf16 products against 101 MB of
// input/output, 0.026 ms at the tensor-core peak and 0.030 ms at the memory
// rate, so a fast kernel is bound by both.  This design is the simple one:
// one block of four warps per (bh, 64-row q tile); Q, K, V, the score tile
// S, the probabilities P and the f32 output accumulator O all live in shared
// memory (110 KB at D 128), and products go through wmma fragments.  The
// score matrix never reaches device memory (the O(S^2) term of plain
// attention); what it gives up is the register-resident accumulator and the
// copy/compute overlap (TMA, wgmma, warp specialisation) of a fast kernel.
#include "common.cuh"

namespace tft {
namespace {

constexpr int BQ = 64;  // q rows per block (16 per warp)
constexpr int BK = 64;  // kv rows per tile
constexpr int THREADS = 128;

template <int D>
struct FwdSmem {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V row stride
  static constexpr int LDS = BK + 4;  // f32 score row stride
  static constexpr int LDP = BK + 8;  // bf16 probability row stride
  static constexpr int LDO = D + 4;   // f32 accumulator row stride
  static constexpr size_t bytes = 3 * BQ * LDH * sizeof(bf16) + BQ * LDS * sizeof(float) +
                                  BQ * LDP * sizeof(bf16) + BQ * LDO * sizeof(float) +
                                  2 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * L::LDH;
  bf16* sV = sK + BK * L::LDH;
  float* sS = reinterpret_cast<float*>(sV + BK * L::LDH);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * L::LDS);
  float* sO = reinterpret_cast<float*>(sP + BQ * L::LDP);
  float* sM = sO + BQ * L::LDO;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long base = static_cast<long long>(bh) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's rows of the q tile

  load_tile(sQ, L::LDH, q + base + static_cast<long long>(q0) * D, D, BQ, D, S - q0, D);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }

  int n_kv = (S + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, L::LDH, k + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
    load_tile(sV, L::LDH, v + base + static_cast<long long>(k0) * D, D, BK, D, S - k0, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    for (int n = 0; n < BK / 16; ++n) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        FragARow a;
        FragBCol b;
        wmma::load_matrix_sync(a, sQ + r0 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(b, sK + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the tile, one row at a time, two columns a lane.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qi = q0 + r;
      const float m_old = sM[r];
      const float l_old = sL[r];
      float s[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        const int kj = k0 + c;
        const bool valid = kj < S && (!causal || kj <= qi);
        s[j] = valid ? sS[r * L::LDS + c] * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = s[j] == -INFINITY ? 0.f : __expf(s[j] - m_new);
        sP[r * L::LDP + lane + 32 * j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = __expf(m_old - m_new);  // 0 on the first tile
      for (int c = lane; c < D; c += 32) sO[r * L::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = alpha * l_old + sum;
      }
    }
    __syncwarp();

    // O += P V (P in bf16, as the TPU kernel feeds its product).
    for (int n = 0; n < D / 16; ++n) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, sO + r0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragARow a;
        FragBRow b;
        wmma::load_matrix_sync(a, sP + r0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + r0 * L::LDO + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    if (qi >= S) break;
    const float l = sL[r] == 0.f ? 1.f : sL[r];
    const float inv = 1.f / l;
    bf16* orow = o + base + static_cast<long long>(qi) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(sO[r * L::LDO + c] * inv);
    if (lane == 0) lse[static_cast<long long>(bh) * S + qi] = sM[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int S, float scale, int causal, cudaStream_t stream) {
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tft

// q, k, v, o: [bh, s, d] bf16 contiguous; lse: [bh, s] f32.  d is 128, the
// only head dim a configuration of the port runs.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int s, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return tft::launch<128>(q, k, v, o, lse, bh, s, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
