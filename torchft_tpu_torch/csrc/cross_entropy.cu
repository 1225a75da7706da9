// Fused lm-head cross-entropy for Hopper (sm_90a): two kernels on one GEMM.
//
// Replace the TPU kernels torchft_tpu/ops/cross_entropy.py:_ce_lse_kernel
// (launched by _ce_lse_pallas) and _ce_dlogits_kernel (launched by
// _ce_dlogits_pallas).  Both take x [N, E] and w [E, V] in bf16 and never
// write the f32 [N, V] logits to device memory:
//   ce_lse:      the log-sum-exp of each row of (x w) over each vocab
//                slice, a whole number of 256-column tiles: only the
//                [slices, N] partial results reach memory, and a second,
//                small kernel folds them over the slices in a fixed order.
//   ce_dlogits:  dl = (softmax(x w) - onehot(t)) * scale in bf16, each
//                element written once; scale (g / N) is read from device
//                memory, so the backward never syncs the host.
// The target logit (a gather) and dx = dl w^T, dw = x^T dl stay outside
// the kernels, as on the TPU.
//
// What bounds them on the card: at the flagship shape (N 16384, E 768,
// V 32000) each kernel does 805 GFLOP of bf16 products, 0.81 ms at the
// tensor-core peak; ce_lse moves 74 MB and ce_dlogits 1.12 GB (0.33 ms at
// the memory rate), so both are compute-bound.
//
// Both are the same warp-specialised GEMM (gemm::Ring) with their own
// epilogue:
//  - persistent: one block per SM walks the kernel's items, row tiles
//    fastest, so the blocks running together read the same w tiles from L2
//    while x (25 MB at the flagship) stays in it; a block pays its pipeline
//    fill once, and the next item's loads run under the current epilogue;
//  - one producer thread streams (x, w) chunks of 64 along E by TMA
//    (128-byte swizzle, zero fill past N, E and V) through a full/empty
//    mbarrier ring; two consumer warpgroups own 64 rows each of the
//    128 x 256 tile;
//  - logits tile = x w by wgmma m64n256k16, x K-major and w MN-major
//    (transposed B), both from shared memory, into 128 f32 accumulator
//    registers a thread; each chunk's stage is freed as soon as the next
//    chunk's products are issued (wait_group 1); setmaxnreg gives the
//    consumers 232 registers and the producer 40; 4 stages.
// ce_lse's items are (row tile, vocab slice); its epilogue runs on the
// accumulators: the row max over the thread's values and its quad (2
// shuffles), the online (m, l) update in base 2 with ex2; columns past V
// are masked on the ragged tile only.
// ce_dlogits's items are (row tile, 256-column tile), each independent.
// Its epilogue turns the accumulators into p = 2^(logit log2(e) - lse
// log2(e)), subtracts 1 at the row's target column, scales, and rounds to
// bf16 pairs into a 128-byte-swizzled staging tile in shared memory, 128
// columns at a time; one thread of each warpgroup stores each half by TMA,
// which clips rows past N and columns past V.  The staging tile is waited
// for (wait_group.read) only before it is rewritten, so the second half's
// store runs under the next item's mainloop.  The ring keeps K4's 4 stages
// beside the 2 x 16 KB of staging (226 KB in all): a full 64 KB staging
// tile would leave room for 3 stages only, and measured slower.
#include "hopper.cuh"

namespace tft {
namespace gemm {

using namespace hopper;

constexpr int BM = 128;  // rows per tile: 64 per consumer warpgroup
constexpr int BN = 256;  // vocab columns per tile
constexpr int BK = 64;   // E per stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr uint32_t X_BYTES = BM * BK * 2;
constexpr uint32_t W_BLOCK = BK * 64 * 2;  // one 64-column block of a w chunk
constexpr uint32_t CONSUMER_ROWS = 64 * BK * 2;

// The mainloop of both kernels: a ring of (x, w) chunks in shared memory,
// filled by the producer thread and drained by the two consumer warpgroups.
// `it` counts the chunks a block has passed through the ring over all its
// tiles; producer and consumers each keep their own.
struct Ring {
  bf16 x[STAGES][BM * BK];
  bf16 w[STAGES][BN / 64][BK * 64];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];

  // By one thread, before the block's __syncthreads.
  __device__ __forceinline__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }

  // Producer: streams the E chunks of the tile x[row0 : row0 + 128] and
  // w[:, v0 : v0 + 256].
  __device__ __forceinline__ void load(const CUtensorMap* tm_x, const CUtensorMap* tm_w, int row0,
                                       int v0, int E, int& it) {
    for (int e0 = 0; e0 < E; e0 += BK, ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], X_BYTES + BN / 64 * W_BLOCK);
      tma_load_2d(x[s], tm_x, &full[s], e0, row0);
      for (int b = 0; b < BN / 64; ++b) {
        tma_load_2d(w[s][b], tm_w, &full[s], v0 + 64 * b, e0);
      }
    }
  }

  // Consumer warpgroup c: acc = the tile's logits in rows 64 c .. 64 c + 63,
  // complete and in registers on return, every stage released.
  __device__ __forceinline__ void mma(float (&acc)[BN / 2], int c, int lane, int E, int& it) {
    for (int e0 = 0; e0 < E; e0 += BK, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t x_base = smem_u32(x[s]) + c * CONSUMER_ROWS;
      const uint32_t w_base = smem_u32(w[s][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64n256k16_ss_tb(acc, make_desc(x_base + 32 * kk, 16, 1024),
                               make_desc(w_base + 2048 * kk, W_BLOCK, 1024), e0 | kk);
      }
      wgmma_commit();
      // The previous chunk's products are done: its stage is free.
      wgmma_wait<1>();
      if (e0 != 0 && lane == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
  }
};

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                  ~static_cast<uintptr_t>(1023));
}

}  // namespace gemm

namespace lse {

using namespace gemm;

constexpr size_t SMEM_BYTES = sizeof(Ring) + 1024;

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
  Ring& ring = aligned_smem<Ring>(smem_raw);

  const int wg = threadIdx.x / 128;
  const int row_tiles = (N + BM - 1) / BM;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread streams every chunk of every item of this block.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item item(i, row_tiles, V, v_per_split);
        for (int v0 = item.col_begin; v0 < item.col_end; v0 += BN) {
          ring.load(&tm_x, &tm_w, item.row0, v0, E, it);
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
        ring.mma(acc, c, lane, E, it);

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

namespace dlogits {

using namespace gemm;

constexpr int HALF = BN / 2;                 // columns of one staging pass
constexpr uint32_t OUT_BLOCK = 64 * 64 * 2;  // one 64 x 64 box of a staging tile

struct Smem {
  Ring ring;
  // Each consumer warpgroup's 64 x 128 bf16 staging tile: two 64-column
  // blocks, 128-byte swizzled, one TMA store box each.
  alignas(1024) bf16 out[2][64 * HALF];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

__global__ void __launch_bounds__(THREADS, 1)
    ce_dlogits_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_dl, const int* __restrict__ targets,
                      const float* __restrict__ lse, const float* __restrict__ scale, int N, int E,
                      int V, int n_items) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);

  const int wg = threadIdx.x / 128;
  const int row_tiles = (N + BM - 1) / BM;

  if (threadIdx.x == 0) sm.ring.init();
  __syncthreads();

  if (wg == 0) {
    // Producer: item i is row tile i % row_tiles of column tile i / row_tiles.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        sm.ring.load(&tm_x, &tm_w, (i % row_tiles) * BM, (i / row_tiles) * BN, E, it);
      }
    }
  } else {
    // Consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each item.
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_local = 16 * (t / 32) + lane / 4;  // this thread's rows: r_local, r_local + 8
    const int col0 = 2 * (lane % 4);
    unsigned char* out = reinterpret_cast<unsigned char*>(sm.out[c]);
    const float g = *scale;
    int it = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const int row0 = (i % row_tiles) * BM + 64 * c;  // this warpgroup's first row
      const int v0 = (i / row_tiles) * BN;
      // The rows' lse (base 2) and target column relative to the thread's
      // first column, loaded before the mainloop so it hides their latency.
      float lse2[2];
      int tcol[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r_local + 8 * r;
        lse2[r] = row < N ? lse[row] * kLog2e : 0.f;
        tcol[r] = row < N ? targets[row] - v0 - col0 : -1;
      }
      float acc[BN / 2];
      sm.ring.mma(acc, c, lane, E, it);

      // The tile goes out in two 128-column halves through the staging
      // tile, which is rewritten only once the store before has read it.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t == 0) tma_store_wait_read();
        named_barrier_sync(1 + c, 128);
#pragma unroll
        for (int jn = 0; jn < HALF / 8; ++jn) {
          const int j = h * (HALF / 8) + jn;  // the tile's 8-column group
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p0 = ex2(fmaf(acc[4 * j + 2 * r], kLog2e, -lse2[r]));
            float p1 = ex2(fmaf(acc[4 * j + 2 * r + 1], kLog2e, -lse2[r]));
            if (tcol[r] == 8 * j) p0 -= 1.f;
            if (tcol[r] == 8 * j + 1) p1 -= 1.f;
            *reinterpret_cast<uint32_t*>(out + sw128_offset(r_local + 8 * r, 8 * jn + col0,
                                                            OUT_BLOCK)) = pack_bf16(p0 * g, p1 * g);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1 + c, 128);
        if (t == 0) {
          for (int b = 0; b < HALF / 64; ++b) {
            const int col = v0 + h * HALF + 64 * b;
            if (row0 < N && col < V) tma_store_2d(&tm_dl, out + b * OUT_BLOCK, col, row0);
          }
          tma_store_commit();
        }
      }
    }
    // The staging tile stays in place until the last store has read it.
    if (t == 0) tma_store_wait_read();
  }
}

}  // namespace dlogits
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
  if ((err = make_map_2d(&tm_x, x, n, e, gemm::BM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = make_map_2d(&tm_w, w, e, v, gemm::BK)) != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(lse::ce_lse_kernel, lse::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (n + gemm::BM - 1) / gemm::BM * splits;
  lse::ce_lse_kernel<<<blocks < n_items ? blocks : n_items, gemm::THREADS, lse::SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<float*>(part), n, e, v, v_per_split, n_items);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lse::ce_lse_fold_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// x, w as for tf_ce_lse; targets: [n] int32; lse: [n] f32 (natural log);
// scale: one f32 on the device; dl: [n, v] bf16, 16-byte aligned; blocks:
// the persistent grid (one block per SM).
extern "C" int tf_ce_dlogits(const void* x, const void* w, const void* targets, const void* lse,
                             const void* scale, void* dl, int n, int e, int v, int blocks,
                             void* stream) {
  using namespace tft;
  CUtensorMap tm_x, tm_w, tm_dl;
  cudaError_t err;
  if ((err = make_map_2d(&tm_x, x, n, e, gemm::BM)) != cudaSuccess) return static_cast<int>(err);
  if ((err = make_map_2d(&tm_w, w, e, v, gemm::BK)) != cudaSuccess) return static_cast<int>(err);
  if ((err = make_map_2d(&tm_dl, dl, n, v, 64)) != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(dlogits::ce_dlogits_kernel, dlogits::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (n + gemm::BM - 1) / gemm::BM * ((v + gemm::BN - 1) / gemm::BN);
  dlogits::ce_dlogits_kernel<<<blocks < n_items ? blocks : n_items, gemm::THREADS, dlogits::SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, tm_dl, static_cast<const int*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(scale), n, e, v, n_items);
  return static_cast<int>(cudaGetLastError());
}
