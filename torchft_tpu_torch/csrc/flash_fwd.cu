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
// rate, so a fast kernel is bound by both: the tensor cores have to be fed
// without pause, and every byte read once.  The design (FlashAttention-3's):
//  - one block per (bh, 128-row q tile), longest causal tiles launched first;
//  - warp specialisation: a producer warpgroup starts the TMA loads (Q once, then
//    128-row K/V tiles into a 2-stage ring guarded by full/empty mbarriers),
//    two consumer warpgroups of 64 q rows each compute; setmaxnreg moves
//    registers from the producer to the consumers;
//  - S = Q K^T by wgmma m64n128k16 from 128-byte-swizzled shared memory into
//    registers; the online softmax runs on the accumulator fragment (a row
//    lives on the 4 threads of a quad: 2 shuffles a reduction), in base 2
//    with scale * log2(e) folded in;
//  - P goes to bf16 in registers and is the register A operand of
//    O += P V (wgmma, V MN-major); O (64 x 128 f32 per warpgroup) stays in
//    registers for the whole kv loop;
//  - only the diagonal tile and the ragged sequence edge are masked;
//  - the epilogue writes O / l as bf16 into the consumer's own Q rows of
//    shared memory and stores them with TMA (rows past S are not written).
#include "hopper.cuh"

namespace tft {
namespace {

using namespace hopper;

constexpr int D = 128;
constexpr int BM = 128;   // q rows per block: 64 per consumer warpgroup
constexpr int BN = 128;   // kv rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr uint32_t HALF = 128 * 64 * 2;  // one 64-column half of a 128-row tile
constexpr uint32_t CONSUMER_ROWS = 64 * 128;  // byte offset of consumer 1's rows in a half

struct FwdSmem {
  bf16 q[2][BM * 64];
  bf16 k[STAGES][2][BN * 64];
  bf16 v[STAGES][2][BN * 64];
  uint64_t q_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(FwdSmem) + 1024;  // + alignment slack

// This block's (bh, q tile) and kv-tile count.  Each role computes it after
// its setmaxnreg: values live across the register reallocation get spilled.
struct Work {
  int bh, q0, n_kv;
  __device__ __forceinline__ Work(int BH, int S, int causal) {
    const int n_qt = (S + BM - 1) / BM;
    const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // longest causal tiles first
    bh = static_cast<int>(blockIdx.x) % BH;
    q0 = qt * BM;
    n_kv = causal ? qt + 1 : (S + BN - 1) / BN;  // BM == BN
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int BH,
                     int S, float scale_log2, int causal) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
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
    // Producer.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const Work w(BH, S, causal);
      const int bh = w.bh, q0 = w.q0, n_kv = w.n_kv;
      mbar_arrive_expect_tx(&sm.q_full, 2 * HALF);
      tma_load_3d(sm.q[0], &tm_q, &sm.q_full, 0, q0, bh);
      tma_load_3d(sm.q[1], &tm_q, &sm.q_full, 64, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 4 * HALF);
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
    const int bh = w.bh, q0 = w.q0, n_kv = w.n_kv;
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_local = 16 * (t / 32) + lane / 4;  // this thread's rows: r_local, r_local + 8
    const int row0 = q0 + 64 * c + r_local;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(sm.q[0]) + c * CONSUMER_ROWS;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of S * scale * log2(e)
    float l[2] = {0.f, 0.f};              // this thread's share of the row sum

    mbar_wait(&sm.q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      const uint32_t k_base = smem_u32(sm.k[s][0]);
      const uint32_t v_base = smem_u32(sm.v[s][0]);

      float sacc[64];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_ss(sacc, make_desc(q_base + h * HALF + 32 * kk, 16, 1024),
                              make_desc(k_base + h * HALF + 32 * kk, 16, 1024), h | kk);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      const int k0 = j * BN;
      if ((causal && j == n_kv - 1) || k0 + BN > S) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int row = row0 + ((i & 2) ? 8 : 0);
          if (col >= S || (causal && col > row)) sacc[i] = -INFINITY;
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m[r] - m_use[r]);  // 0 while the row had no valid column
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        const float p = ex2(fmaf(sacc[i], scale_log2, -m_use[r]));
        l[r] += p;
        sacc[i] = p;
        o[i] *= alpha[r];
      }
      uint32_t pf[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pf[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n128k16_rs_tb(o, pf + 4 * kk, make_desc(v_base + 2048 * kk, HALF, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    // Epilogue: O / l as bf16 into this warpgroup's Q rows, then TMA.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    unsigned char* q_bytes = reinterpret_cast<unsigned char*>(sm.q[0]) + c * CONSUMER_ROWS;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128_offset(r_local + 8 * r, 8 * jn + col0, HALF);
        *reinterpret_cast<uint32_t*>(q_bytes + off) =
            pack_bf16(o[4 * jn + 2 * r] * inv[r], o[4 * jn + 2 * r + 1] * inv[r]);
      }
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S) lse[static_cast<long long>(bh) * S + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
    if (t == 0) {
      tma_store_3d(&tm_o, q_bytes, 0, q0 + 64 * c, bh);
      tma_store_3d(&tm_o, q_bytes + HALF, 64, q0 + 64 * c, bh);
      tma_store_commit_and_wait();
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int S,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  cudaError_t err;
  if ((err = make_map_bsd(&tm_q, q, bh, S, BM)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_k, k, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_v, v, bh, S, BN)) != cudaSuccess) return err;
  if ((err = make_map_bsd(&tm_o, o, bh, S, 64)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int n_qt = (S + BM - 1) / BM;
  flash_fwd_kernel<<<n_qt * bh, THREADS, SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), bh, S, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tft

// q, k, v, o: [bh, s, d] bf16 contiguous, 16-byte aligned; lse: [bh, s] f32.
// d is 128, the only head dim a configuration of the port runs.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int bh, int s, int d, float scale, int causal, void* stream) {
  if (d != tft::D) return static_cast<int>(cudaErrorInvalidValue);
  return tft::launch(q, k, v, o, lse, bh, s, scale, causal, static_cast<cudaStream_t>(stream));
}
