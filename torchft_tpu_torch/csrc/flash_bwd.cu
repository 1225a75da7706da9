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
//   flash_bwd_dq:   one block per (bh, 64-row q tile), a loop over the kv
//                   tiles up to the diagonal; dQ accumulates in f32 shared
//                   memory.
// Both recompute P = exp(S * scale - lse) and dS = P (dP - delta) scale,
// with delta = rowsum(dO * O) computed outside the kernels as on the TPU.
//
// What bounds it on the card: at the flagship shape (BH 96, S 1024, D 128,
// causal) the backward needs five products, 64.4 GFLOP of bf16 work against
// 177 MB of tensors: compute-bound, 0.065 ms at the tensor-core peak.  The
// split recomputes S and dP in both kernels (seven products in all, 1.4x
// the minimum) to keep every accumulator on chip and the two passes
// independent.  The dK/dV kernel's own share is four products, 51.6 GFLOP:
// 0.052 ms at the tensor-core peak, so it is bound by how busy it keeps the
// tensor cores.
//
// flash_bwd_dkdv is designed for the card (FlashAttention-3's layout):
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
// flash_bwd_dq is the simple form: tiles and its accumulator in shared
// memory (146 KB at D 128), products through wmma fragments.
#include "common.cuh"
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
      wgmma_wait_all();
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
      wgmma_wait_all();
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
  // dq: Q dO K V | S dP | dS | dQ | lse delta
  static constexpr size_t dq_bytes = 4 * tile_h + 2 * tile_s + tile_p + tile_o + rows;
};

// The dQ kernel's (q tile, kv tile) body.  Each warp handles its 16 q rows
// (r0 = 16 * warp): writes dS (bf16) for those rows.  Rows past S, columns
// past S and (causal) columns above the diagonal get dS = 0.
template <int D>
__device__ __forceinline__ void bwd_tile(const bf16* sQ, const bf16* sK, const bf16* sV,
                                         const bf16* sDO, const float* sLse,
                                         const float* sDelta, float* sS, float* sDP,
                                         bf16* sDS, int q0, int k0, int S,
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
    bwd_tile<D>(sQ, sK, sV, sDO, sLse, sDelta, sS, sDP, sDS, q0, k0, S, scale,
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

// q, k, v, dout, dk, dv: [bh, s, d] bf16 contiguous, 16-byte aligned;
// lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int bh,
                                 int s, int d, float scale, int causal, void* stream) {
  if (d != tft::dkdv::D) return static_cast<int>(cudaErrorInvalidValue);
  return tft::dkdv::launch(q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal,
                           static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, dq: [bh, s, d] bf16 contiguous; lse, delta: [bh, s] f32.
extern "C" int tf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int s, int d,
                               float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return tft::launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, s, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
