// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchft_tpu/ops/rmsnorm.py:_rms_kernel (launched
// by _rms_pallas, reached through rms_norm_pallas):
//   out = x * rsqrt(mean(x^2, last axis) + eps) * w
// with the statistics and the scaling in f32 and one rounding to x's dtype.
// x is [rows, d] (the wrapper flattens the leading axes), w is [d] f32.
//
// What bounds it on the card: it does ~4 operations per element and moves
// each element twice (read x, write out), so it is bound by bytes: at the
// flagship width (x [16384, 768] bf16) 50.3 MB, 0.0150 ms at 3.35 TB/s.
// The design reads each input once and writes each output once: one warp
// per row, 16-byte vector loads, the row's vectors kept in registers between
// the sum of squares (reduced by warp shuffle) and the scaled write.  Rows
// wider than 32 x kCache vectors (2048 bf16 / 1024 f32 elements) re-read the
// rest from L2 in the second pass; d that is not a multiple of the vector
// width takes a scalar path that also re-reads.  The TPU kernel's 512-row
// blocks have no counterpart: 8 rows per 256-thread block give the flagship
// shape 2048 blocks over 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kCache = 8;  // 16-byte vectors a lane keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A 16-byte vector of T unpacked to f32 and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float f) { *p = f; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
  __device__ static float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store1(__nv_bfloat16* p, float f) { *p = __float2bfloat16(f); }
};

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& v) {
  float f[Vec<T>::kN];
  Vec<T>::unpack(v, f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) s += f[i] * f[i];
  return s;
}

// out[e] = x[e] * inv * w[e] for the kN elements of vector number vi.
template <typename T>
__device__ __forceinline__ uint4 scale(const uint4& v, const float* __restrict__ w, int vi,
                                       float inv) {
  constexpr int N = Vec<T>::kN;
  float f[N];
  Vec<T>::unpack(v, f);
  const float4* w4 = reinterpret_cast<const float4*>(w + vi * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 wv = w4[i];
    f[4 * i] = f[4 * i] * inv * wv.x;
    f[4 * i + 1] = f[4 * i + 1] * inv * wv.y;
    f[4 * i + 2] = f[4 * i + 2] * inv * wv.z;
    f[4 * i + 3] = f[4 * i + 3] * inv * wv.w;
  }
  return Vec<T>::pack(f);
}

// kVec: d is a multiple of the vector width (every row starts 16-byte
// aligned); otherwise one element per lane per iteration.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rms_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
               int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together: no shuffle is cut
  const T* xr = x + static_cast<long long>(row) * d;
  T* orow = out + static_cast<long long>(row) * d;
  float ss = 0.f;
  if constexpr (kVec) {
    constexpr int N = Vec<T>::kN;
    const int nv = d / N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    uint4 cache[kCache];
#pragma unroll
    for (int c = 0; c < kCache; ++c) {
      const int vi = lane + 32 * c;
      if (vi < nv) {
        cache[c] = xv[vi];
        ss += sum_sq<T>(cache[c]);
      }
    }
    for (int vi = lane + 32 * kCache; vi < nv; vi += 32) ss += sum_sq<T>(xv[vi]);
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
    for (int c = 0; c < kCache; ++c) {
      const int vi = lane + 32 * c;
      if (vi < nv) ov[vi] = scale<T>(cache[c], w, vi, inv);
    }
    for (int vi = lane + 32 * kCache; vi < nv; vi += 32) ov[vi] = scale<T>(xv[vi], w, vi, inv);
  } else {
    for (int e = lane; e < d; e += 32) {
      const float f = Vec<T>::load1(xr + e);
      ss += f * f;
    }
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    for (int e = lane; e < d; e += 32) {
      Vec<T>::store1(orow + e, Vec<T>::load1(xr + e) * inv * w[e]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps, void* stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d % Vec<T>::kN == 0) {
    rms_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
  } else {
    rms_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, d] contiguous, 16-byte aligned; w: [d] f32, 16-byte
// aligned.  x_is_bf16 selects x and out in bf16 (else f32), the two dtype
// pairs the wrapper admits.  rows >= 1, d >= 1.
extern "C" int tf_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                           int x_is_bf16, void* stream) {
  if (x_is_bf16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, stream);
  return launch<float>(x, w, out, rows, d, eps, stream);
}
