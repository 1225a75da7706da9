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
// deterministic: each output tile is written by exactly one block):
//   flash_bwd_dkdv: one block per (bh, 128-row kv tile), a loop over the
//                   64-row q tiles at or below the diagonal; dK and dV
//                   accumulate in registers.
//   flash_bwd_dq:   one block per (bh, 128-row q tile), a loop over the
//                   64-row kv tiles up to the diagonal; dQ accumulates in
//                   registers.
// Both recompute P = exp(S * scale - lse) and dS = P (dP - delta) scale,
// with delta = rowsum(dO * O) computed outside the kernels as on the TPU.
//
// What bounds it on the card: at the flagship shape (BH 96, S 1024, D 128,
// causal) the backward needs five products, 64.4 GFLOP of bf16 work against
// 177 MB of tensors: compute-bound, 0.065 ms at the tensor-core peak.  The
// split recomputes S and dP in both kernels (seven products in all, 1.4x
// the minimum) to keep every accumulator on chip and the two passes
// independent.  The dK/dV kernel's own share is four products, 51.6 GFLOP,
// the dQ kernel's three, 38.7 GFLOP: 0.052 and 0.039 ms at the tensor-core
// peak, so each is bound by how busy it keeps the tensor cores.
//
// Both are designed for the card after FlashAttention-3.  flash_bwd_dkdv:
//  - warp specialisation: a producer warpgroup loads the block's K and V
//    once, then streams Q, dO (TMA, 128-byte swizzle) and lse, delta (plain
//    loads by the producer warp, lse prescaled by log2 e) for each q tile
//    through a 2-stage ring guarded by full/empty mbarriers; two consumer
//    warpgroups own 64 kv rows each; setmaxnreg moves registers to them;
//  - the kv rows sit in wgmma's M dimension, so the transposed tiles come
//    out directly: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//    operands K-major from shared memory), P^T = exp2(S^T scale log2 e -
//    lse2[col]), dS^T = P^T (dP^T - delta[col]) scale on the accumulator
//    fragments, masked only on the diagonal and at the ragged edge;
//  - dV += P^T dO and dK += dS^T Q by wgmma m64n128k16 with P^T and dS^T as
//    bf16 register A operands and the same swizzled dO and Q tiles as
//    MN-major B: exactly the 4 products of the kernel's bound, P and dS
//    never touch shared memory, dK and dV (64 + 64 f32 a thread) stay in
//    registers across the q loop;
//  - kv tiles with the most q tiles launch first; the epilogue writes dK and
//    dV as bf16 into the consumer's own K and V rows and stores them by TMA.
// flash_bwd_dq is the same design with the roles of q and kv swapped:
//  - the producer loads the block's Q and dO once and streams 64-row K and
//    V tiles through the ring; each consumer warpgroup owns 64 q rows and
//    holds their lse (prescaled by log2 e) and delta in registers;
//  - the q rows sit in wgmma's M dimension: S = Q K^T and dP = dO V^T by
//    wgmma m64n64k16 (both operands K-major), P and dS on the accumulator
//    fragments, dQ += dS K by wgmma m64n128k16 with dS as the bf16 register
//    A operand and the swizzled K tile as MN-major B: exactly the 3 products
//    of its bound, dS never touches shared memory, dQ (64 f32 a thread)
//    stays in registers across the kv loop;
//  - a tile's dQ product is left in flight while the next tile's S and dP
//    are issued (wgmma wait_group 1), so a warpgroup's products reach the
//    tensor cores back to back;
//  - q tiles with the most kv tiles launch first; dQ leaves through the
//    consumer's own Q rows and a TMA store.
#include "hopper.cuh"

namespace tft {
namespace dkdv {

using namespace hopper;

constexpr int D = 128;
constexpr int BN = 128;   // kv rows per block: 64 per consumer warpgroup
constexpr int BM = 64;    // q rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr uint32_t KV_HALF = BN * 64 * 2;  // one 64-column half of the K or V tile
constexpr uint32_t Q_HALF = BM * 64 * 2;   // one 64-column half of a Q or dO tile
constexpr uint32_t CONSUMER_ROWS = 64 * 128;

struct Smem {
  bf16 k[2][BN * 64];
  bf16 v[2][BN * 64];
  bf16 q[STAGES][2][BM * 64];
  bf16 dout[STAGES][2][BM * 64];
  float lse2[STAGES][BM];   // lse * log2(e); 0 past S
  float delta[STAGES][BM];  // 0 past S
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

// This block's (bh, kv tile) and q-tile range.  Each role computes it after
// its setmaxnreg: values live across the register reallocation get spilled.
struct Work {
  int bh, k0, qt_begin, n_q;
  __device__ __forceinline__ Work(int BH, int S, int causal) {
    const int kt = static_cast<int>(blockIdx.x) / BH;  // kv tile 0 has the most q tiles
    bh = static_cast<int>(blockIdx.x) % BH;
    k0 = kt * BN;
    n_q = (S + BM - 1) / BM;
    qt_begin = causal ? k0 / BM : 0;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ lse, const float* __restrict__ delta, int BH,
                          int S, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: warp 0 streams the q tiles.
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const Work w(BH, S, causal);
      const int bh = w.bh, k0 = w.k0, q0_end = w.n_q * BM;
      const int lane = threadIdx.x;
      const long long row_base = static_cast<long long>(bh) * S;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 4 * KV_HALF);
        for (int h = 0; h < 2; ++h) {
          tma_load_3d(sm.k[h], &tm_k, &sm.kv_full, 64 * h, k0, bh);
          tma_load_3d(sm.v[h], &tm_v, &sm.kv_full, 64 * h, k0, bh);
        }
      }
      for (int q0 = w.qt_begin * BM, it = 0; q0 < q0_end; q0 += BM, ++it) {
        const int s = it % STAGES;
        mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
        for (int r = lane; r < BM; r += 32) {
          const bool in = q0 + r < S;
          sm.lse2[s][r] = in ? lse[row_base + q0 + r] * kLog2e : 0.f;
          sm.delta[s][r] = in ? delta[row_base + q0 + r] : 0.f;
        }
        if (lane != 0) {
          mbar_arrive(&sm.full[s]);
        } else {
          mbar_arrive_expect_tx(&sm.full[s], 4 * Q_HALF);
          for (int h = 0; h < 2; ++h) {
            tma_load_3d(sm.q[s][h], &tm_q, &sm.full[s], 64 * h, q0, bh);
            tma_load_3d(sm.dout[s][h], &tm_do, &sm.full[s], 64 * h, q0, bh);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns kv rows k0 + 64 c .. k0 + 64 c + 63.
    setmaxnreg_inc<240>();
    const Work w(BH, S, causal);
    const int bh = w.bh, k0 = w.k0;
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_local = 16 * (t / 32) + lane / 4;  // this thread's kv rows: r_local, + 8
    const int kv_lo = k0 + 64 * c;
    const int kv0 = kv_lo + r_local;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint32_t k_base = smem_u32(sm.k[0]) + c * CONSUMER_ROWS;
    const uint32_t v_base = smem_u32(sm.v[0]) + c * CONSUMER_ROWS;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    mbar_wait(&sm.kv_full, 0);
    for (int qt = w.qt_begin, it = 0; qt < w.n_q; ++qt, ++it) {
      const int s = it % STAGES;
      const int q0 = qt * BM;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);
      if (causal && q0 + BM - 1 < kv_lo) {  // every q row of the tile is above these keys
        if (lane == 0) mbar_arrive(&sm.empty[s]);
        continue;
      }
      const uint32_t q_base = smem_u32(sm.q[s][0]);
      const uint32_t do_base = smem_u32(sm.dout[s][0]);

      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(st, make_desc(k_base + h * KV_HALF + 32 * kk, 16, 1024),
                             make_desc(q_base + h * Q_HALF + 32 * kk, 16, 1024), h | kk);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(dpt, make_desc(v_base + h * KV_HALF + 32 * kk, 16, 1024),
                             make_desc(do_base + h * Q_HALF + 32 * kk, 16, 1024), h | kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool mask = (causal && q0 < kv_lo + 63) || q0 + BM > S || kv_lo + 64 > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + col0 + (i & 1);
        float p = ex2(fmaf(st[i], scale_log2, -sm.lse2[s][qc]));
        if (mask) {
          const int q = q0 + qc;
          const int kv = kv0 + ((i & 2) ? 8 : 0);
          if (q >= S || kv >= S || (causal && q < kv)) p = 0.f;
        }
        st[i] = p;
        dpt[i] = p * (dpt[i] - sm.delta[s][qc]) * scale;
      }
      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pf[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
        dsf[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_rs_tb(dv, pf + 4 * kk, make_desc(do_base + 2048 * kk, Q_HALF, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_rs_tb(dk, dsf + 4 * kk, make_desc(q_base + 2048 * kk, Q_HALF, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    // Epilogue: dK and dV as bf16 into this warpgroup's K and V rows, then TMA.
    unsigned char* k_bytes = reinterpret_cast<unsigned char*>(sm.k[0]) + c * CONSUMER_ROWS;
    unsigned char* v_bytes = reinterpret_cast<unsigned char*>(sm.v[0]) + c * CONSUMER_ROWS;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128_offset(r_local + 8 * r, 8 * jn + col0, KV_HALF);
        *reinterpret_cast<uint32_t*>(k_bytes + off) =
            pack_bf16(dk[4 * jn + 2 * r], dk[4 * jn + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(v_bytes + off) =
            pack_bf16(dv[4 * jn + 2 * r], dv[4 * jn + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
    if (t == 0) {
      for (int h = 0; h < 2; ++h) {
        tma_store_3d(&tm_dk, k_bytes + h * KV_HALF, 64 * h, kv_lo, bh);
        tma_store_3d(&tm_dv, v_bytes + h * KV_HALF, 64 * h, kv_lo, bh);
      }
      tma_store_commit_and_wait();
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bh, int S,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  cudaError_t err;
  if ((err = make_map_bsd(&tm_q, q, bh, S, BM)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_do, dout, bh, S, BM)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_k, k, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_v, v, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_dk, dk, bh, S, 64)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_dv, dv, bh, S, 64)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int n_kt = (S + BN - 1) / BN;
  flash_bwd_dkdv_kernel<<<n_kt * bh, THREADS, SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), bh, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace dkdv

namespace dq {

using namespace hopper;

constexpr int D = 128;
constexpr int BM = 128;   // q rows per block: 64 per consumer warpgroup
constexpr int BN = 64;    // kv rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr uint32_t Q_HALF = BM * 64 * 2;   // one 64-column half of the Q or dO tile
constexpr uint32_t KV_HALF = BN * 64 * 2;  // one 64-column half of a K or V tile
constexpr uint32_t CONSUMER_ROWS = 64 * 128;

struct Smem {
  bf16 q[2][BM * 64];
  bf16 dout[2][BM * 64];
  bf16 k[STAGES][2][BN * 64];
  bf16 v[STAGES][2][BN * 64];
  uint64_t q_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

// This block's (bh, q tile) and kv-tile count.  Each role computes it after
// its setmaxnreg: values live across the register reallocation get spilled.
struct Work {
  int bh, q0, n_kv;
  __device__ __forceinline__ Work(int BH, int S, int causal) {
    const int n_qt = (S + BM - 1) / BM;
    const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // longest causal tiles first
    bh = static_cast<int>(blockIdx.x) % BH;
    q0 = qt * BM;
    n_kv = (S + BN - 1) / BN;
    if (causal) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const float* __restrict__ lse, const float* __restrict__ delta, int BH,
                        int S, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads Q and dO once, then streams the kv tiles.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const Work w(BH, S, causal);
      const int bh = w.bh, n_kv = w.n_kv;
      mbar_arrive_expect_tx(&sm.q_full, 4 * Q_HALF);
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(sm.q[h], &tm_q, &sm.q_full, 64 * h, w.q0, bh);
        tma_load_3d(sm.dout[h], &tm_do, &sm.q_full, 64 * h, w.q0, bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 4 * KV_HALF);
        for (int h = 0; h < 2; ++h) {
          tma_load_3d(sm.k[s][h], &tm_k, &sm.full[s], 64 * h, j * BN, bh);
          tma_load_3d(sm.v[s][h], &tm_v, &sm.full[s], 64 * h, j * BN, bh);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows q0 + 64 c .. q0 + 64 c + 63.
    setmaxnreg_inc<240>();
    const Work w(BH, S, causal);
    const int bh = w.bh, n_kv = w.n_kv;
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_local = 16 * (t / 32) + lane / 4;  // this thread's q rows: r_local, + 8
    const int q_lo = w.q0 + 64 * c;
    const int row0 = q_lo + r_local;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_base = smem_u32(sm.q[0]) + c * CONSUMER_ROWS;
    const uint32_t do_base = smem_u32(sm.dout[0]) + c * CONSUMER_ROWS;

    // The two rows' statistics, once: lse * log2(e) and delta, 0 past S.
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long i = static_cast<long long>(bh) * S + row;
      lse2[r] = row < S ? lse[i] * kLog2e : 0.f;
      dlt[r] = row < S ? delta[i] : 0.f;
    }

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    uint32_t dsf[16];
    int pending = -1;  // the stage whose dQ product is still in flight
    mbar_wait(&sm.q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BN;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      if (causal && k0 > q_lo + 63) {  // every key of the tile is above these q rows
        if (lane == 0) mbar_arrive(&sm.empty[s]);
        continue;
      }
      const uint32_t k_base = smem_u32(sm.k[s][0]);
      const uint32_t v_base = smem_u32(sm.v[s][0]);

      float sacc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(sacc, make_desc(q_base + h * Q_HALF + 32 * kk, 16, 1024),
                             make_desc(k_base + h * KV_HALF + 32 * kk, 16, 1024), h | kk);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(dp, make_desc(do_base + h * Q_HALF + 32 * kk, 16, 1024),
                             make_desc(v_base + h * KV_HALF + 32 * kk, 16, 1024), h | kk);
        }
      }
      wgmma_commit();
      // The previous tile's dQ product (issued before S and dP) is done.
      wgmma_wait<1>();
      fence_regs(dsf);
      if (pending >= 0 && lane == 0) mbar_arrive(&sm.empty[pending]);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dp);

      const bool mask = (causal && k0 + BN - 1 > q_lo) || k0 + BN > S || q_lo + 64 > S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sacc[i], scale_log2, -lse2[r]));
        if (mask) {
          const int q = row0 + 8 * r;
          const int kv = k0 + 8 * (i / 4) + col0 + (i & 1);
          if (q >= S || kv >= S || (causal && kv > q)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dlt[r]) * scale;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) dsf[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_rs_tb(dq, dsf + 4 * kk, make_desc(k_base + 2048 * kk, KV_HALF, 1024));
      }
      wgmma_commit();  // left in flight under the next tile's S and dP
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsf);
    if (pending >= 0 && lane == 0) mbar_arrive(&sm.empty[pending]);

    // Epilogue: dQ as bf16 into this warpgroup's Q rows, then TMA.
    unsigned char* q_bytes = reinterpret_cast<unsigned char*>(sm.q[0]) + c * CONSUMER_ROWS;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128_offset(r_local + 8 * r, 8 * jn + col0, Q_HALF);
        *reinterpret_cast<uint32_t*>(q_bytes + off) =
            pack_bf16(dq[4 * jn + 2 * r], dq[4 * jn + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
    if (t == 0) {
      tma_store_3d(&tm_dq, q_bytes, 0, q_lo, bh);
      tma_store_3d(&tm_dq, q_bytes + Q_HALF, 64, q_lo, bh);
      tma_store_commit_and_wait();
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int S, float scale,
                   int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  cudaError_t err;
  if ((err = make_map_bsd(&tm_q, q, bh, S, BM)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_do, dout, bh, S, BM)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_k, k, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_v, v, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_dq, dq, bh, S, 64)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int n_qt = (S + BM - 1) / BM;
  flash_bwd_dq_kernel<<<n_qt * bh, THREADS, SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), bh, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace dq
}  // namespace tft

// q, k, v, dout, dk, dv: [bh, s, d] bf16 contiguous, 16-byte aligned;
// lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int bh,
                                 int s, int d, float scale, int causal, void* stream) {
  if (d != tft::dkdv::D) return static_cast<int>(cudaErrorInvalidValue);
  return tft::dkdv::launch(q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal,
                           static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, dq: [bh, s, d] bf16 contiguous, 16-byte aligned;
// lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int s, int d,
                               float scale, int causal, void* stream) {
  if (d != tft::dq::D) return static_cast<int>(cudaErrorInvalidValue);
  return tft::dq::launch(q, k, v, dout, lse, delta, dq, bh, s, scale, causal,
                         static_cast<cudaStream_t>(stream));
}
