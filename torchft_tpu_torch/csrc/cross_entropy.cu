// Fused lm-head cross-entropy for Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels torchft_tpu/ops/cross_entropy.py:_ce_lse_kernel
// (launched by _ce_lse_pallas) and _ce_dlogits_kernel (launched by
// _ce_dlogits_pallas).  Both take x [N, E] and w [E, V] in bf16 and never
// write the f32 [N, V] logits to device memory:
//   ce_lse:      the log-sum-exp over one vocab slice of (x w) for a
//                128-row tile: a loop over the slice's 64-column vocab tiles
//                with an online max and sum-exp in f32.  The grid is
//                (row tiles, vocab slices), so the flagship shape fills the
//                card (128 row tiles alone would leave SMs idle); only the
//                [slices, N] partial results reach memory, and the wrapper
//                folds them with one logsumexp over the slice axis.
//   ce_dlogits:  dl = (softmax(x w) - onehot(t)) * scale in bf16, one block
//                per (128-row tile, 64-column vocab tile): the block
//                recomputes its logits tile, subtracts 1 at the target
//                column and writes the tile once.  scale (g / N) is read
//                from device memory, so the backward never syncs the host.
// The target logit (a gather) and dx = dl w^T, dw = x^T dl stay outside
// the kernels, as on the TPU.
//
// What bounds them on the card: at the flagship shape (N 16384, E 768,
// V 32000) each kernel does 805 GFLOP of bf16 products, 0.81 ms at the
// tensor-core peak; ce_lse moves 74 MB and ce_dlogits 1.12 GB (0.33 ms at
// the memory rate), so both are compute-bound.  This design streams x and w
// in 64-wide chunks of E through shared memory and runs the products on
// wmma fragments that stay in registers across the E loop; it re-reads w
// once per row tile (from L2) and does not overlap loads with products.
// A fast version would use wgmma with TMA-fed multi-stage pipelines.
#include "common.cuh"

namespace tft {
namespace {

constexpr int BM = 128;  // rows per block (16 per warp)
constexpr int BN = 64;   // vocab columns per tile
constexpr int BE = 64;   // E chunk
constexpr int THREADS = 256;
constexpr int LDX = BE + 8;
constexpr int LDW = BN + 8;
constexpr int LDS = BN + 4;
constexpr size_t TILE_BYTES =
    BM * LDX * sizeof(bf16) + BE * LDW * sizeof(bf16) + BM * LDS * sizeof(float);
constexpr size_t LSE_SMEM = TILE_BYTES + 2 * BM * sizeof(float);

// The f32 logits tile x[row0 : row0+128] @ w[:, col0 : col0+64] into sS
// (rows past N and columns past V come out as 0).  Each warp computes its
// 16 rows; called by the whole block.
__device__ __forceinline__ void logits_tile(const bf16* __restrict__ x,
                                            const bf16* __restrict__ w, int N, int E, int V,
                                            int row0, int col0, bf16* sX, bf16* sW, float* sS,
                                            int r0) {
  FragAcc acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int e0 = 0; e0 < E; e0 += BE) {
    __syncthreads();  // every warp is done with the previous chunk
    load_tile(sX, LDX, x + static_cast<long long>(row0) * E + e0, E, BM, BE, N - row0, E - e0);
    load_tile(sW, LDW, w + static_cast<long long>(e0) * V + col0, V, BE, BN, E - e0, V - col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BE / 16; ++kk) {
      FragARow a;
      wmma::load_matrix_sync(a, sX + r0 * LDX + kk * 16, LDX);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        FragBRow b;
        wmma::load_matrix_sync(b, sW + kk * 16 * LDW + n * 16, LDW);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) {
    wmma::store_matrix_sync(sS + r0 * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
    ce_lse_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  float* __restrict__ part, int N, int E, int V, int v_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = sX + BM * LDX;
  float* sS = reinterpret_cast<float*>(sW + BE * LDW);
  float* sM = sS + BM * LDS;
  float* sL = sM + BM;

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  if (threadIdx.x < BM) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }
  const int v_begin = blockIdx.y * v_per_split;
  const int v_end = min(V, v_begin + v_per_split);
  for (int col0 = v_begin; col0 < v_end; col0 += BN) {
    logits_tile(x, w, N, E, V, row0, col0, sX, sW, sS, r0);
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float m_old = sM[r];
      const float l_old = sL[r];
      float s[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int c = lane + 32 * j;
        s[j] = col0 + c < v_end ? sS[r * LDS + c] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) sum += s[j] == -INFINITY ? 0.f : __expf(s[j] - m_new);
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = l_old * __expf(m_old - m_new) + sum;
      }
    }
    __syncwarp();
  }
  __syncthreads();  // row r's statistics were written by warp r / 16
  if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < N) {
    part[static_cast<long long>(blockIdx.y) * N + row0 + threadIdx.x] =
        sM[threadIdx.x] + logf(sL[threadIdx.x]);
  }
}

__global__ void __launch_bounds__(THREADS)
    ce_dlogits_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const int* __restrict__ targets, const float* __restrict__ lse,
                      const float* __restrict__ scale, bf16* __restrict__ dl, int N, int E,
                      int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = sX + BM * LDX;
  float* sS = reinterpret_cast<float*>(sW + BE * LDW);

  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  logits_tile(x, w, N, E, V, row0, col0, sX, sW, sS, r0);
  const float g = *scale;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int row = row0 + r;
    if (row >= N) break;
    const float l = lse[row];
    const int t = targets[row];
    bf16* out = dl + static_cast<long long>(row) * V;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int c = lane + 32 * j;
      const int col = col0 + c;
      if (col < V) {
        float p = __expf(sS[r * LDS + c] - l);
        if (col == t) p -= 1.f;
        out[col] = __float2bfloat16(p * g);
      }
    }
  }
}

}  // namespace
}  // namespace tft

// x: [n, e] bf16, w: [e, v] bf16 (both contiguous); part: [splits, n] f32
// receives each vocab slice's log-sum-exp, slice s covering columns
// [s * v_per_split, min(v, (s + 1) * v_per_split)).  e % 16 == 0,
// v % 8 == 0, v_per_split % 64 == 0, and every slice non-empty.
extern "C" int tf_ce_lse(const void* x, const void* w, void* part, int n, int e, int v,
                         int v_per_split, int splits, void* stream) {
  using namespace tft;
  cudaError_t err = allow_smem(ce_lse_kernel, LSE_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM, splits);
  ce_lse_kernel<<<grid, THREADS, LSE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(part), n, e,
      v, v_per_split);
  return static_cast<int>(cudaGetLastError());
}

// targets: [n] int32; lse: [n] f32; scale: one f32 on the device;
// dl: [n, v] bf16.
extern "C" int tf_ce_dlogits(const void* x, const void* w, const void* targets, const void* lse,
                             const void* scale, void* dl, int n, int e, int v, void* stream) {
  using namespace tft;
  cudaError_t err = allow_smem(ce_dlogits_kernel, TILE_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((v + BN - 1) / BN, (n + BM - 1) / BM);
  ce_dlogits_kernel<<<grid, THREADS, TILE_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(scale), static_cast<bf16*>(dl),
      n, e, v);
  return static_cast<int>(cudaGetLastError());
}
