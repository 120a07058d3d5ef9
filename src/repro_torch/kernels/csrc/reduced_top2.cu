// reduced_top2: per-row (min, first-index argmin, second min) of cost + prices.
//
// Replaces the Pallas kernel reduced_top2_pallas
// (src/repro/kernels/reduced_top2.py:38, pallas_call at :53).  It is the
// inner op of every auction sweep and of the forced dual bounds
// (core/engine/auction.py), so it runs 7 times per search iteration at the
// default sweeps=8, on both engine backends.
//
// Bound on the H100: bytes.  One call reads cost (B*N*N f32) and prices
// (B*N f32) once and writes three (B, N) vectors; at the main path's shape
// (B = 2048 states, N = 32) that is ~8.4 MB, about 2.5 us at 3.35 TB/s,
// which is at or below the launch latency.  The arithmetic (two adds and
// two compares per element) is negligible.
//
// Design: one warp per row, so B*N rows and 8 rows per 256-thread block.
// Lanes stride the N columns (neighbouring lanes read neighbouring
// columns: coalesced); each lane keeps its running (value, index) minimum,
// visiting its columns in increasing order, and a warp-shuffle butterfly
// combines lanes, breaking ties by the lower index, as jnp.argmin does.
// A second pass over the same (L1-resident) row takes
//     m2 = min_j (j == a1 ? red_j + 1e7f : red_j)
// exactly as the reference computes it, in f32, without skipping the
// argmin column, so a tied minimum gives m2 == m1 and a one-column row
// gives m2 = red_0 + 1e7.  Any N >= 1 works: rows shorter than the warp
// leave lanes idle, longer rows loop.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void reduced_top2_kernel(const float* __restrict__ cost,
                                    const float* __restrict__ prices,
                                    float* __restrict__ m1, int* __restrict__ a1,
                                    float* __restrict__ m2, long long rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* c = cost + row * n;
  const float* p = prices + (row / n) * n;

  // pass 1: running minimum; index n marks "no column seen yet", so a row
  // of +inf still reports its first column, like jnp.argmin
  float best = INFINITY;
  int arg = n;
  for (int j = lane; j < n; j += 32) {
    const float v = __fadd_rn(c[j], p[j]);
    if (arg == n || v < best) {
      best = v;
      arg = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, best, off);
    const int oi = __shfl_xor_sync(kFullMask, arg, off);
    take_min(best, arg, ov, oi);
  }

  // pass 2: second minimum with only the argmin column pushed up by BIG
  float second = INFINITY;
  for (int j = lane; j < n; j += 32) {
    float v = __fadd_rn(c[j], p[j]);
    if (j == arg) v = __fadd_rn(v, repro::kBig);
    second = fminf(second, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    second = fminf(second, __shfl_xor_sync(kFullMask, second, off));

  if (lane == 0) {
    m1[row] = best;
    a1[row] = arg;
    m2[row] = second;
  }
}

}  // namespace

// cost (batch, n, n) f32, prices (batch, n) f32 -> m1, m2 (batch, n) f32,
// a1 (batch, n) int32.  All contiguous, on `device`.
REPRO_EXPORT int repro_reduced_top2(const float* cost, const float* prices, float* m1, int* a1,
                                    float* m2, long long batch, int n, int device,
                                    void* stream) {
  const long long rows = batch * n;
  if (rows == 0) return 0;
  return repro::launch_on(device, [&] {
    const unsigned blocks = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    reduced_top2_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        cost, prices, m1, a1, m2, rows, n);
    return cudaSuccess;
  });
}

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
