// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel torchft_tpu/ops/rmsnorm.py:_rms_kernel (launched
// by _rms_pallas, reached through rms_norm_pallas):
//   out = x * rsqrt(mean(x^2, last axis) + eps) * w
// with the statistics and the scaling in f32 and one rounding to x's dtype.
// x is [rows, d] (the wrapper flattens the leading axes), w is [d] f32.
//
// What bounds it on the card: about 4 operations an element against the
// element's bytes moved twice (x read, out written), so bytes: at the
// flagship width (x [16384, 768] bf16) 50.3 MB, 0.0150 ms at 3.35 TB/s; at
// large_config's (x [8192, 2048] f32) 134.2 MB, 0.0401 ms.
//
// The design (path "tma": every d whose row is a multiple of 16 bytes and
// whose rings fit).  A persistent grid; a block's 8 warps form groups of
// warps_per_row warps (one where a lane's registers hold its share of a
// row, 8 vectors of 16 bytes at most, more for wider rows), and each group
// owns a ring of `stages` slots in dynamic shared memory and walks tiles of
// R contiguous rows in grid-stride order.  A tile is one contiguous run of
// R * row bytes, so the group's first thread brings it in with one 1-D bulk
// copy (cp.async.bulk, no tensor map; L2 evict-first, as x is read once)
// that completes on the slot's mbarrier.  The group takes the tile's rows
// from the slot into registers one at a time and hands the slot back as
// soon as the last is in registers (after its writes, for a row wider than
// the registers hold), so the next tiles' copies are in flight while a row
// is reduced in f32 (warp shuffles, then through shared memory across the
// group's warps), scaled by w and written from registers with 16-byte
// stores (streaming, st.global.cs, for f32 rows: kStreamStore).  w is read
// once per block into shared memory for bf16 rows; f32 rows read it
// through L1 (kWShared).  Each byte
// of x is read from device memory once at every width the rings hold, and
// each byte of out is written once.  Tile number `it` of a group waits on
// slot it % stages with parity (it / stages) & 1; a partial last tile
// copies and expects only its own rows' bytes.
//
// Sizes (ops/rmsnorm.py rms_plan; shared memory = 640 B of barriers and
// partial sums + w rounded up to 128 B for bf16 rows + groups x stages x R
// x row; the registers allow 4 blocks an SM with up to 6 vectors of a row
// a lane, 62-64 a thread, and 3 with 8, 79-80):
//   flagship x [16384, 768] bf16: 1,536 B rows, one warp a row (3 vectors
//     a lane), R = 2 (3,072 B tiles), 2 stages: 8 x 2 x 3,072 = 49,152 B +
//     3,072 B of w + 640 = 52,864 B; 4 blocks an SM (4 x (52,864 + 1,024
//     reserved) <= 233,472 B), 528 blocks, 4,224 rings walk 8,192 tiles
//     (at most 2 each).
//   large_config x [8192, 2048] f32: 8,192 B rows, two warps a row (8
//     vectors a lane), R = 1, 2 stages (enough where several warps share
//     a row): 4 x 2 x 8,192 = 65,536 B + 640 = 66,176 B; 3 blocks an SM
//     (3 x (66,176 + 1,024) = 201,600 <= 233,472 B), 396 blocks, 1,584
//     rings walk 8,192 tiles (at most 6 each).
//
// Other paths, chosen by the wrapper from the shape alone (its plan has 0
// stages, and the row's alignment picks which): a row that is not a
// multiple of 16 bytes (d 1001) cannot be bulk-copied and takes
// "scalar" (one warp a row, one element a lane, x read twice, the second
// time mostly from L1); an aligned row too wide for a ring of two stages of
// one row (plus w for bf16: d above 28,976 f32 or 28,960 bf16) takes
// "vector" (one warp a row, 16-byte loads, kCache vectors a lane kept in
// registers, the rest of the row read again).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tft::hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = kWarps;  // vector and scalar paths: one warp a row
constexpr int kCache = 8;              // 16-byte vectors of a row a lane keeps in registers
constexpr int kMaxStages = 8;
constexpr int kHeadBytes = 640;        // the rings' mbarriers and partial sums, ahead of w
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use

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

// -- path "tma": the row rings -------------------------------------------------

// Where a lane reads w: bf16 rows read 32 bytes of w for each 16 bytes of
// x, and take them from a copy in shared memory; f32 rows read 16 and take
// them through L1, which leaves shared memory to the ring (PERF.md gives
// both on the card).
template <typename T>
constexpr bool kWShared = sizeof(T) == 2;

template <typename T>
__host__ __device__ __forceinline__ size_t w_bytes(int d) {
  return kWShared<T> ? (static_cast<size_t>(d) * 4 + 127) / 128 * 128 : 0;
}

template <typename T>
__host__ __forceinline__ size_t ring_smem_bytes(int d, int rows_per_tile, int stages,
                                                int warps_per_row) {
  return kHeadBytes + w_bytes<T>(d) + static_cast<size_t>(kWarps / warps_per_row) * stages *
                                          rows_per_tile * d * sizeof(T);
}

// The scaled row goes out from registers, 16 bytes a lane: streaming
// (st.global.cs) for f32 rows, plain for bf16 rows (PERF.md gives both on
// the card).
template <typename T>
constexpr bool kStreamStore = sizeof(T) == 4;

template <typename T>
__device__ __forceinline__ void store_out(uint4* p, const uint4& v) {
  if constexpr (kStreamStore<T>) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// kCacheV: 16-byte vectors of a row each lane keeps in registers; up to 6
// leave registers for four blocks an SM.
template <typename T, int kCacheV>
__global__ void __launch_bounds__(kThreads, kCacheV <= 6 ? 4 : 3)
    rms_ring_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                    int rows, int d, float eps, int rows_per_tile, int stages,
                    int warps_per_row) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int R = rows_per_tile;
  const int gw = warps_per_row;
  const int groups = kWarps / gw;
  const int group = warp / gw;
  const int gl = (warp % gw) * 32 + lane;  // thread within the group
  const int gt = gw * 32;
  const int nv = d / Vec<T>::kN;  // 16-byte vectors a row
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const size_t tile_bytes = R * row_bytes;
  const int ntiles = (rows + R - 1) / R;
  const int walkers = gridDim.x * groups;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + group * kMaxStages;
  float* partial = reinterpret_cast<float*>(smem + 8 * kWarps * kMaxStages);  // [2][kWarps]
  float* ws_copy = reinterpret_cast<float*>(smem + kHeadBytes);
  const float* ws = kWShared<T> ? ws_copy : w;
  unsigned char* ring = smem + kHeadBytes + w_bytes<T>(d) + group * stages * tile_bytes;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // The group's first thread is its producer: a tile's copy expects exactly
  // the bytes of that tile's rows (fewer on a partial last tile).
  auto issue = [&](int tile, int slot) {
    const uint32_t bytes = static_cast<uint32_t>(min(R, rows - tile * R) * row_bytes);
    mbar_arrive_expect_tx(&bars[slot], bytes);
    bulk_load(ring + slot * tile_bytes, xb + static_cast<size_t>(tile) * tile_bytes, bytes,
              &bars[slot], l2_evict_first());
  };
  auto group_sync = [&]() {
    if (gw == 1) {
      __syncwarp();
    } else {
      named_barrier_sync(1 + group, gt);
    }
  };

  const int first = blockIdx.x * groups + group;
  if (gl == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
    for (int s = 0; s < stages; ++s) {
      if (first + s * walkers < ntiles) issue(first + s * walkers, s);
    }
  }
  if constexpr (kWShared<T>) {
    for (int i = threadIdx.x; i < d / 4; i += kThreads) {
      reinterpret_cast<float4*>(ws_copy)[i] = reinterpret_cast<const float4*>(w)[i];
    }
  }
  __syncthreads();

  // A row that fits the lanes' register cache is read from shared memory
  // once, and the slot goes back to the producer as soon as the last row
  // is in registers, before its sum is reduced and it is scaled and
  // written.
  const bool fits = nv <= kCacheV * gt;
  auto release = [&](int tile, int slot) {
    group_sync();
    if (gl == 0 && tile + stages * walkers < ntiles) issue(tile + stages * walkers, slot);
  };

  int it = 0;
  int j = 0;  // rows this group has reduced: the parity of its partial-sum buffer
  for (int tile = first; tile < ntiles; tile += walkers, ++it) {
    const int slot = it % stages;
    mbar_wait(&bars[slot], (it / stages) & 1);
    const int n = min(R, rows - tile * R);
    const unsigned char* base = ring + slot * tile_bytes;
    for (int r = 0; r < n; ++r, ++j) {
      const uint4* xv = reinterpret_cast<const uint4*>(base + r * row_bytes);
      uint4 cache[kCacheV];
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < kCacheV; ++c) {
        const int vi = gl + c * gt;
        if (vi < nv) {
          cache[c] = xv[vi];
          ss += sum_sq<T>(cache[c]);
        }
      }
      for (int vi = gl + kCacheV * gt; vi < nv; vi += gt) ss += sum_sq<T>(xv[vi]);
      if (fits && r == n - 1) release(tile, slot);
      ss = warp_sum(ss);
      if (gw > 1) {
        // Two buffers: a warp writes row j + 1's sum only after every warp
        // of its group has passed row j's barrier, so after their reads of
        // row j - 1's.
        if (lane == 0) partial[(j & 1) * kWarps + warp] = ss;
        named_barrier_sync(1 + group, gt);
        ss = 0.f;
        for (int k = 0; k < gw; ++k) ss += partial[(j & 1) * kWarps + group * gw + k];
      }
      const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
      uint4* ov = reinterpret_cast<uint4*>(out + (static_cast<size_t>(tile) * R + r) * d);
#pragma unroll
      for (int c = 0; c < kCacheV; ++c) {
        const int vi = gl + c * gt;
        if (vi < nv) store_out<T>(ov + vi, scale<T>(cache[c], ws, vi, inv));
      }
      for (int vi = gl + kCacheV * gt; vi < nv; vi += gt) {
        store_out<T>(ov + vi, scale<T>(xv[vi], ws, vi, inv));
      }
    }
    if (!fits) release(tile, slot);
  }
}

// -- paths "vector" and "scalar": one warp a row from device memory -------------

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

template <typename T, int kCacheV>
int launch_ring(const T* x, const float* w, T* out, int rows, int d, float eps,
                int rows_per_tile, int stages, int warps_per_row, int blocks, int smem_bytes,
                cudaStream_t s) {
  // The opt-in above 48 KB, once per device for the largest size asked.
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_bytes > allowed[dev]) {
    err = tft::allow_smem(rms_ring_kernel<T, kCacheV>, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = smem_bytes;
  }
  rms_ring_kernel<T, kCacheV><<<blocks, kThreads, smem_bytes, s>>>(
      x, w, out, rows, d, eps, rows_per_tile, stages, warps_per_row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           int rows_per_tile, int stages, int warps_per_row, int blocks, void* stream) {
  const auto* xp = static_cast<const T*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* op = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = d % Vec<T>::kN == 0;
  if (stages == 0) {
    const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    if (aligned) {
      rms_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
    } else {
      rms_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, wp, op, rows, d, eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = ring_smem_bytes<T>(d, rows_per_tile, stages, warps_per_row);
  if (!aligned || rows_per_tile < 1 || stages < 2 || stages > kMaxStages || blocks < 1 ||
      (warps_per_row != 1 && warps_per_row != 2 && warps_per_row != 4 && warps_per_row != 8) ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_lane = (d / Vec<T>::kN + 32 * warps_per_row - 1) / (32 * warps_per_row);
  if (per_lane <= 4) {
    return launch_ring<T, 4>(xp, wp, op, rows, d, eps, rows_per_tile, stages, warps_per_row,
                             blocks, static_cast<int>(smem), s);
  }
  if (per_lane <= 6) {
    return launch_ring<T, 6>(xp, wp, op, rows, d, eps, rows_per_tile, stages, warps_per_row,
                             blocks, static_cast<int>(smem), s);
  }
  return launch_ring<T, 8>(xp, wp, op, rows, d, eps, rows_per_tile, stages, warps_per_row,
                           blocks, static_cast<int>(smem), s);
}

}  // namespace

// x, out: [rows, d] contiguous, 16-byte aligned; w: [d] f32, 16-byte
// aligned.  x_is_bf16 selects x and out in bf16 (else f32), the two dtype
// pairs the wrapper admits.  rows >= 1, d >= 1.  rows_per_tile, stages,
// warps_per_row and blocks are ops/rmsnorm.py rms_plan's: stages 0 takes
// the one-warp-a-row kernel ("vector" where a row is a multiple of 16
// bytes, else "scalar"), stages >= 2 the row rings, whose shared memory
// this file works out (cudaErrorInvalidValue where it does not fit, or
// for a ring plan on a row that is not a multiple of 16 bytes).
extern "C" int tf_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                           int x_is_bf16, int rows_per_tile, int stages, int warps_per_row,
                           int blocks, void* stream) {
  if (x_is_bf16) {
    return launch<__nv_bfloat16>(x, w, out, rows, d, eps, rows_per_tile, stages, warps_per_row,
                                 blocks, stream);
  }
  return launch<float>(x, w, out, rows, d, eps, rows_per_tile, stages, warps_per_row, blocks,
                       stream);
}
