// Fused lm-head cross-entropy for Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels torchft_tpu/ops/cross_entropy.py:_ce_lse_kernel
// (launched by _ce_lse_pallas) and _ce_dlogits_kernel (launched by
// _ce_dlogits_pallas).  Both take x [N, E] and w [E, V] in bf16 and never
// write the f32 [N, V] logits to device memory:
//   ce_lse:      the log-sum-exp of each row of (x w) over each vocab
//                slice, a whole number of 256-column tiles: only the
//                [slices, N] partial results reach memory, and a second,
//                small kernel folds them over the slices in a fixed order.
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
// the memory rate), so both are compute-bound.
//
// ce_lse is a warp-specialised GEMM with the log-sum-exp in its epilogue:
//  - persistent: one block per SM walks the (128-row tile, vocab slice)
//    items, row tiles fastest, so the blocks running together read the
//    same w tiles from L2; a block pays its pipeline fill once, and the
//    next item's loads run under the current item's epilogue;
//  - one producer thread streams (x, w) chunks of 64 along E by TMA
//    (128-byte swizzle, zero fill past N, E and V) through a 4-stage
//    full/empty mbarrier ring; two consumer warpgroups own 64 rows each of
//    the tile;
//  - logits tile = x w by wgmma m64n256k16, x K-major and w MN-major
//    (transposed B), both from shared memory; each chunk's stage is freed
//    as soon as the next chunk's products are issued (wait_group 1);
//  - the epilogue runs on the 128 accumulator registers: the row max over
//    the thread's values and its quad (2 shuffles), the online (m, l)
//    update in base 2 with ex2; columns past V are masked on the ragged
//    tile only.
// ce_dlogits is still the simple form: x and w chunks streamed through
// shared memory by synchronous copies, products on wmma fragments.
#include "common.cuh"
#include "hopper.cuh"

namespace tft {
namespace lse {

using namespace hopper;

constexpr int BM = 128;  // rows per tile: 64 per consumer warpgroup
constexpr int BN = 256;  // vocab columns per tile
constexpr int BK = 64;   // E per stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr uint32_t X_BYTES = BM * BK * 2;
constexpr uint32_t W_BLOCK = BK * 64 * 2;  // one 64-column block of a w chunk
constexpr uint32_t CONSUMER_ROWS = 64 * BK * 2;

struct Smem {
  bf16 x[STAGES][BM * BK];
  bf16 w[STAGES][BN / 64][BK * 64];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

// Item i of the persistent walk: its rows and its slice's columns.
struct Item {
  int row0, slice, col_begin, col_end;
  __device__ __forceinline__ Item(int i, int row_tiles, int V, int v_per_split) {
    row0 = (i % row_tiles) * BM;
    slice = i / row_tiles;
    col_begin = slice * v_per_split;
    col_end = min(V, col_begin + v_per_split);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    ce_lse_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w, float* __restrict__ part, int N,
                  int E, int V, int v_per_split, int n_items) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int wg = threadIdx.x / 128;
  const int row_tiles = (N + BM - 1) / BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread streams every chunk of every item of this block.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item item(i, row_tiles, V, v_per_split);
        for (int v0 = item.col_begin; v0 < item.col_end; v0 += BN) {
          for (int e0 = 0; e0 < E; e0 += BK, ++it) {
            const int s = it % STAGES;
            mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&sm.full[s], X_BYTES + BN / 64 * W_BLOCK);
            tma_load_2d(sm.x[s], &tm_x, &sm.full[s], e0, item.row0);
            for (int b = 0; b < BN / 64; ++b) {
              tma_load_2d(sm.w[s][b], &tm_w, &sm.full[s], v0 + 64 * b, e0);
            }
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns rows row0 + 64 c .. row0 + 64 c + 63.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_local = 16 * (t / 32) + lane / 4;  // this thread's rows: r_local, r_local + 8
    const int col0 = 2 * (lane % 4);
    int it = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item item(i, row_tiles, V, v_per_split);
      float m[2] = {-INFINITY, -INFINITY};  // running max of the logits * log2(e)
      float l[2] = {0.f, 0.f};              // this thread's share of the row sum
      for (int v0 = item.col_begin; v0 < item.col_end; v0 += BN) {
        float acc[BN / 2];
        for (int e0 = 0; e0 < E; e0 += BK, ++it) {
          const int s = it % STAGES;
          mbar_wait(&sm.full[s], (it / STAGES) & 1);
          const uint32_t x_base = smem_u32(sm.x[s]) + c * CONSUMER_ROWS;
          const uint32_t w_base = smem_u32(sm.w[s][0]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            wgmma_m64n256k16_ss_tb(acc, make_desc(x_base + 32 * kk, 16, 1024),
                                   make_desc(w_base + 2048 * kk, W_BLOCK, 1024), e0 | kk);
          }
          wgmma_commit();
          // The previous chunk's products are done: its stage is free.
          wgmma_wait<1>();
          if (e0 != 0 && lane == 0) mbar_arrive(&sm.empty[(it + STAGES - 1) % STAGES]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&sm.empty[(it + STAGES - 1) % STAGES]);

        // Online log-sum-exp over the tile, on the accumulator fragment.
        const bool ragged = v0 + BN > V;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const bool out = ragged && v0 + 8 * (j / 4) + col0 + (j & 1) >= V;
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], out ? -INFINITY : acc[j]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * kLog2e);  // the tile has a column < V
          l[r] *= ex2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const bool out = ragged && v0 + 8 * (j / 4) + col0 + (j & 1) >= V;
          const int r = (j >> 1) & 1;
          l[r] += out ? 0.f : ex2(fmaf(acc[j], kLog2e, -m[r]));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = item.row0 + 64 * c + r_local + 8 * r;
        if (lane % 4 == 0 && row < N) {
          part[static_cast<long long>(item.slice) * N + row] = m[r] + log2f(l[r]);
        }
      }
    }
  }
}

// lse[row] = the log-sum-exp of the slices' partial results (base 2) for
// the row, summed in slice order, in natural log.
__global__ void ce_lse_fold_kernel(const float* __restrict__ part, float* __restrict__ lse, int N,
                                   int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[static_cast<long long>(s) * N + row]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += exp2f(part[static_cast<long long>(s) * N + row] - m);
  lse[row] = (m + log2f(l)) * kLn2;
}

}  // namespace lse

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

// x: [n, e] bf16, w: [e, v] bf16, both contiguous and 16-byte aligned;
// out: [n] f32 receives the log-sum-exp of each row of x w; part: [splits,
// n] f32 scratch for each vocab slice's, slice s covering columns
// [s * v_per_split, min(v, (s + 1) * v_per_split)).  e % 16 == 0,
// v % 8 == 0, v_per_split % 256 == 0, every slice non-empty; blocks: the
// persistent grid (one block per SM).
extern "C" int tf_ce_lse(const void* x, const void* w, void* part, void* out, int n, int e, int v,
                         int v_per_split, int splits, int blocks, void* stream) {
  using namespace tft;
  CUtensorMap tm_x, tm_w;
  cudaError_t err;
  if ((err = make_map_2d(&tm_x, x, n, e, lse::BM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = make_map_2d(&tm_w, w, e, v, lse::BK)) != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(lse::ce_lse_kernel, lse::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (n + lse::BM - 1) / lse::BM * splits;
  lse::ce_lse_kernel<<<blocks < n_items ? blocks : n_items, lse::THREADS, lse::SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<float*>(part), n, e, v, v_per_split, n_items);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lse::ce_lse_fold_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
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
