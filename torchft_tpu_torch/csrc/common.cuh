// Helpers for the port's remaining wmma kernel (sm_90a): the cross-entropy
// dlogits kernel.
//
// Matrix products use the tensor cores through nvcuda::wmma 16x16x16 bf16
// fragments with f32 accumulation.  Tiles live in shared memory with padded
// row strides (bf16 rows + 8 elements, f32 rows + 4) to spread the rows over
// the 32 banks; every fragment pointer stays 32-byte aligned because
// fragment tiles start at multiples of 16 rows and 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tft {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// Copies a rows x cols bf16 tile from global memory (row stride ld_g
// elements) into shared memory (row stride ld_s), zero-filling rows >=
// rows_valid and columns >= cols_valid.  16-byte vector accesses: cols,
// cols_valid, ld_g and ld_s must be multiples of 8 and the global tile
// 16-byte aligned (the wrappers check what they pass in).
__device__ __forceinline__ void load_tile(bf16* __restrict__ s, int ld_s,
                                          const bf16* __restrict__ g, long long ld_g,
                                          int rows, int cols, int rows_valid,
                                          int cols_valid) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < cols_valid) {
      v = *reinterpret_cast<const uint4*>(g + r * ld_g + c);
    }
    *reinterpret_cast<uint4*>(s + r * ld_s + c) = v;
  }
}

// Kernels needing more than 48 KB of shared memory must opt in.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tft
