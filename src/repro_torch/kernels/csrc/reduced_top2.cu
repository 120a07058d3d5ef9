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
// (B = 2048 states, N = 32) that is ~9.4 MB, 2.82 us at 3.35 TB/s.  The
// arithmetic (one add and a few compares per element) is far below it, so
// the design keeps every lane loading and issues few shuffles.
//
// Design: one pass over each row.  A row is split among G lanes (G the
// power of two that leaves each lane at most kCols columns: G = 4 at
// N = 32, 8 at N = 64, 1 for N <= 8); each lane folds its columns into a
// triple (m1, a1, second), a log2(G)-step segmented shuffle merges the
// triples (winner by value, then by the lower index; the loser's m1 folds
// into second), and then
//     m2 = fminf(second, m1 + 1e7)
// which is the reference's masked minimum min_j(red_j + (j == a1) * 1e7)
// bit for bit: the argmin column's reduced value is m1 itself, so a tied
// minimum gives m2 == m1 and a one-column row gives red_0 + 1e7.  Every
// add is __fadd_rn (the build adds --fmad=false), ties go to the first
// index, and an all-+inf row reports column 0, as jnp.argmin does.
//
// Layout by state: a warp works on rows of one state (or, when N is below
// the warp's 32 / G row slots, on several whole states), so each lane loads
// its columns' prices once into registers and reuses them for every row it
// takes; no 64-bit division.  A warp takes at most two rounds of rows
// (kRounds), and a state with more rows is shared among several warps, so
// enough loads are in flight to cover the memory latency.  Where N % 4 == 0
// and both inputs are 16-byte aligned, a lane reads its columns as float4
// (neighbouring lanes on neighbouring 16 bytes); otherwise as floats.
// Lane 0 of each row group writes the row's three results, and neighbouring
// row groups write neighbouring rows.  Rows longer than G * kCols = 256
// columns take a second kernel: one warp per row, prices read per column.

#include <stdint.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCols = 8;    // columns per lane at most (register-resident prices)
constexpr int kRounds = 2;  // rounds of rows a warp takes at most
constexpr unsigned kFullMask = 0xffffffffu;

struct Top2 {
  float m1;      // least value so far
  int a1;        // its column (INT_MAX: none yet)
  float second;  // least value among the other columns
};

__device__ __forceinline__ Top2 empty_top2() { return {INFINITY, INT_MAX, INFINITY}; }

// fold one column (value v at index j) into t
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  if (v < t.m1 || (v == t.m1 && j < t.a1)) {
    t.second = fminf(t.second, t.m1);
    t.m1 = v;
    t.a1 = j;
  } else {
    t.second = fminf(t.second, v);
  }
}

// merge another lane's triple into t (winner by value, then lower index)
__device__ __forceinline__ void merge(Top2& t, const Top2& o) {
  const bool take = o.m1 < t.m1 || (o.m1 == t.m1 && o.a1 < t.a1);
  const float loser = take ? t.m1 : o.m1;
  if (take) {
    t.m1 = o.m1;
    t.a1 = o.a1;
  }
  t.second = fminf(fminf(t.second, o.second), loser);
}

template <int G>
__device__ __forceinline__ void reduce_group(Top2& t) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(kFullMask, t.m1, off, G);
    o.a1 = __shfl_xor_sync(kFullMask, t.a1, off, G);
    o.second = __shfl_xor_sync(kFullMask, t.second, off, G);
    merge(t, o);
  }
}

__device__ __forceinline__ void store(const Top2& t, long long row, float* __restrict__ m1,
                                      int* __restrict__ a1, float* __restrict__ m2) {
  m1[row] = t.m1;
  a1[row] = t.a1;
  m2[row] = fminf(t.second, __fadd_rn(t.m1, repro::kBig));
}

// G lanes per row; V = 4 (float4 loads) or 1.  With spw > 1 a warp takes
// spw whole states, one row per row slot; otherwise wps warps share a
// state, and warp part p takes rows slot + R * (p + wps * i), i < rounds,
// R = 32 / G row slots per warp.
template <int G, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    reduced_top2_kernel(const float* __restrict__ cost, const float* __restrict__ prices,
                        float* __restrict__ m1, int* __restrict__ a1, float* __restrict__ m2,
                        int batch, int n, int spw, int wps, int rounds) {
  constexpr int R = 32 / G;
  constexpr int K = kCols / V;  // loads of V columns per lane and row
  const int lane = threadIdx.x & 31;
  const int slot = lane / G, sub = lane % G;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int state, row0, row_step;
  bool state_live;
  if (spw > 1) {
    state = warp * spw + slot / n;
    row0 = slot % n;
    row_step = n;  // one round
    state_live = slot < spw * n && state < batch;
  } else {
    state = warp / wps;
    row0 = slot + R * (warp % wps);
    row_step = R * wps;
    state_live = state < batch;
  }

  // this lane's columns: V-wide chunks sub, sub + G, ...; their prices
  float pr[kCols];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int col = (sub + G * k) * V;
    if (state_live && col < n) {
      const float* p = prices + static_cast<long long>(state) * n + col;
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        pr[4 * k] = q.x;
        pr[4 * k + 1] = q.y;
        pr[4 * k + 2] = q.z;
        pr[4 * k + 3] = q.w;
      } else {
        pr[k] = __ldg(p);
      }
    }
  }

  for (int i = 0; i < rounds; ++i) {
    const int r = row0 + i * row_step;
    const bool live = state_live && r < n;
    const long long row = static_cast<long long>(state) * n + r;
    Top2 t = empty_top2();
    if (live) {
      const float* c = cost + row * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = (sub + G * k) * V;
        if (col < n) {
          if constexpr (V == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(c + col));
            push(t, __fadd_rn(q.x, pr[4 * k]), col);
            push(t, __fadd_rn(q.y, pr[4 * k + 1]), col + 1);
            push(t, __fadd_rn(q.z, pr[4 * k + 2]), col + 2);
            push(t, __fadd_rn(q.w, pr[4 * k + 3]), col + 3);
          } else {
            push(t, __fadd_rn(__ldg(c + col), pr[k]), col);
          }
        }
      }
    }
    reduce_group<G>(t);  // every lane of the warp takes part
    if (live && sub == 0) store(t, row, m1, a1, m2);
  }
}

// N > G * kCols: one warp per row, lanes stride the columns.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    reduced_top2_wide_kernel(const float* __restrict__ cost, const float* __restrict__ prices,
                             float* __restrict__ m1, int* __restrict__ a1,
                             float* __restrict__ m2, long long rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float* c = cost + row * n;
  const float* p = prices + (row / n) * n;
  Top2 t = empty_top2();
  for (int j = lane; j < n; j += 32) push(t, __fadd_rn(__ldg(c + j), __ldg(p + j)), j);
  reduce_group<32>(t);
  if (lane == 0) store(t, row, m1, a1, m2);
}

template <int G, int V>
cudaError_t launch_narrow(const float* cost, const float* prices, float* m1, int* a1,
                          float* m2, long long batch, int n, cudaStream_t stream) {
  constexpr int R = 32 / G;
  long long warps;
  int spw = 1, wps = 1, rounds = 1;
  if (n < R && R / n > 1) {
    spw = R / n;
    warps = (batch + spw - 1) / spw;
  } else {
    const int row_rounds = (n + R - 1) / R;
    wps = (row_rounds + kRounds - 1) / kRounds;
    rounds = (row_rounds + wps - 1) / wps;
    warps = batch * wps;
  }
  if (batch > INT_MAX || warps > INT_MAX - kWarpsPerBlock) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  reduced_top2_kernel<G, V><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      cost, prices, m1, a1, m2, static_cast<int>(batch), n, spw, wps, rounds);
  return cudaSuccess;
}

template <int G>
cudaError_t launch_g(bool vec4, const float* cost, const float* prices, float* m1, int* a1,
                     float* m2, long long batch, int n, cudaStream_t stream) {
  return vec4 ? launch_narrow<G, 4>(cost, prices, m1, a1, m2, batch, n, stream)
              : launch_narrow<G, 1>(cost, prices, m1, a1, m2, batch, n, stream);
}

}  // namespace

// cost (batch, n, n) f32, prices (batch, n) f32 -> m1, m2 (batch, n) f32,
// a1 (batch, n) int32.  All contiguous, on `device`.
REPRO_EXPORT int repro_reduced_top2(const float* cost, const float* prices, float* m1, int* a1,
                                    float* m2, long long batch, int n, int device,
                                    void* stream) {
  const long long rows = batch * n;
  if (rows == 0) return 0;
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(prices) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::launch_on(device, [&]() -> cudaError_t {
    if (n <= 1 * kCols) return launch_g<1>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    if (n <= 2 * kCols) return launch_g<2>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    if (n <= 4 * kCols) return launch_g<4>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    if (n <= 8 * kCols) return launch_g<8>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    if (n <= 16 * kCols) return launch_g<16>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    if (n <= 32 * kCols) return launch_g<32>(vec4, cost, prices, m1, a1, m2, batch, n, s);
    const unsigned blocks = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    reduced_top2_wide_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(cost, prices, m1, a1, m2,
                                                                   rows, n);
    return cudaSuccess;
  });
}

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
