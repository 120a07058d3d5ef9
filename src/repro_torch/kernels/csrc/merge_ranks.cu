// merge_ranks: the two rank-count vectors of the search's pool merge.
//
// Replaces the Pallas kernels rank_counts_pallas / merge_ranks_pallas
// (src/repro/kernels/merge_topk.py:48 and :74, pallas_call at :61), behind
// KernelDispatch.merge_fused; one launch per search iteration when the
// merge runs fused.  For each pair b:
//
//   count_a[b, i] = #{j : keys_b[b, j] <  keys_a[b, i]}   (b, NA) int32
//   count_b[b, j] = #{i : keys_a[b, i] <= keys_b[b, j]}   (b, NB) int32
//
// These are plain comparison counts, as in the Pallas kernel, and the
// kernel equals the plain twin (ref.merge_ranks_ref) on any input: sorted
// or not, ties, +inf and -0.0 == 0.0 included (IEEE compares).
//
// Bound on the H100: bytes.  The least work reads both runs once and
// writes both count vectors once: 8 * B * (NA + NB) bytes, 2.6 MB (0.78 us
// at 3.35 TB/s) for B = 256 pairs at the second escalation rung (NA =
// 1016, NB = 256).  The engine's runs are key-sorted, so the counts are
// binary-search ranks: O((NA + NB) log) compares, far below the bytes.
// (The design before this one compared every element with the whole other
// run, 2 * B * NA * NB compares, and was 30-50x its bound.)
//
// Design: one launch for both outputs (the reference's two launches exist
// only for the TPU's output-revisit rule, merge_topk.py:80-84).  Grid x is
// the pair, grid y a tile of kTile elements of B (the first tiles_b tiles:
// they stage the long pool run, so they start first) or of A (the rest),
// so a tile never straddles the two runs and every block's branch is
// uniform; each thread takes kPerThread elements of its tile, kThreads
// apart (coalesced loads and stores).
//  1. The block stages the *other* run of its pair in shared memory (at
//     most kStageCap floats, 48 KB; the largest rung's pool, 4088 keys,
//     takes 16 KB), then decides with __syncthreads_and whether the run is
//     sorted: x[k] <= x[k+1] for every k (a NaN makes it unsorted).
//     count_a needs only keys_b sorted, count_b only keys_a.  A longer run
//     is not staged: the block reads it from device memory through __ldg.
//  2. Sorted other run: each thread binary-searches its elements, its
//     searches interleaved step by step (at most 12 steps at NA = 4088):
//     the strict lower bound for count_a (#{b < a_i}), the upper bound for
//     count_b (#{a <= b_j}).  On a run that is non-decreasing under IEEE
//     <=, the predicate is monotone, so the search's position is exactly
//     the count: +inf, the engine's INF = 3e8 and -0.0 / 0.0 in either
//     order included; an element that is NaN compares false everywhere
//     and gets 0, as in the count.
//  3. Unsorted other run: each thread counts, element by element, over the
//     staged (or global) run, in the same launch.  This is the reference's
//     own contract (sortedness is not required for correctness,
//     merge_topk.py:49-54), not a fallback: nothing leaves the kernel, and
//     the wrapper does no host-side sortedness test (that would sync the
//     host every iteration).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;  // elements of one run per block
constexpr int kStageCap = 12288;              // floats staged at most (48 KB)
constexpr int kStageUnroll = 8;               // staging loads in flight per thread

template <bool kStrict>
__device__ __forceinline__ bool pred(float v, float key) {
  return kStrict ? v < key : v <= key;
}

// count[e] = #{k < n : pred(load(k), x[e])} for the thread's first `live`
// elements, pred `<` (strict) or `<=`; `load(k)` reads the other run from
// shared or device memory.
template <bool kStrict, typename Load>
__device__ __forceinline__ void ranks(Load load, int n, bool sorted, int live,
                                      const float (&x)[kPerThread], int (&count)[kPerThread]) {
  if (sorted) {
    // the length of the prefix where pred holds (monotone on a sorted
    // run): branch-free binary search, steps of decreasing powers of two,
    // the thread's searches interleaved step by step
    int step = 1;
    while (step * 2 <= n) step *= 2;
    for (; n > 0 && step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        const int p = count[e] + step;
        if (e < live && p <= n && pred<kStrict>(load(p - 1), x[e])) count[e] = p;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (e >= live) break;
      int c = 0;
#pragma unroll 8
      for (int k = 0; k < n; ++k) c += pred<kStrict>(load(k), x[e]) ? 1 : 0;
      count[e] = c;
    }
  }
}

template <bool kStrict>
__device__ __forceinline__ void rank_tile(const float* __restrict__ self,
                                          const float* __restrict__ run,
                                          int* __restrict__ out, int n_self,
                                          int n_other, int tile, float* stage) {
  // the thread's elements, kThreads apart; the live ones are a prefix
  const int first = tile * kTile + threadIdx.x;
  const int live = min(kPerThread, max(0, (n_self - first + kThreads - 1) / kThreads));
  float x[kPerThread];
  int count[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    x[e] = e < live ? __ldg(self + first + e * kThreads) : 0.0f;
    count[e] = 0;
  }

  // stage the other run (kStageUnroll loads of each thread in flight at
  // once), then test it for order: x[k] <= x[k+1] for every k; a NaN
  // compares false, so a run holding one is unsorted
  const bool staged = n_other <= kStageCap;
  int ok = 1;
  if (staged) {
    for (int base = threadIdx.x; base < n_other; base += kThreads * kStageUnroll) {
      float v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = base + u * kThreads;
        v[u] = k < n_other ? __ldg(run + k) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = base + u * kThreads;
        if (k < n_other) stage[k] = v[u];
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k + 1 < n_other; k += kThreads)
      ok &= stage[k] <= stage[k + 1] ? 1 : 0;
  } else {
    for (int k = threadIdx.x; k + 1 < n_other; k += kThreads)
      ok &= __ldg(run + k) <= __ldg(run + k + 1) ? 1 : 0;
  }
  const bool sorted = __syncthreads_and(ok) != 0;

  if (staged) {
    ranks<kStrict>([stage](int k) { return stage[k]; }, n_other, sorted, live, x, count);
  } else {
    ranks<kStrict>([run](int k) { return __ldg(run + k); }, n_other, sorted, live, x,
                   count);
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    if (e < live) out[first + e * kThreads] = count[e];
}

// Grid y: the tiles of B first (each stages the longer pool run, so they
// start first), then the tiles of A.
__global__ void __launch_bounds__(kThreads)
    merge_ranks_kernel(const float* __restrict__ keys_a, const float* __restrict__ keys_b,
                       int* __restrict__ count_a, int* __restrict__ count_b, int na,
                       int nb, int tiles_b) {
  extern __shared__ float stage[];
  const long long pair = blockIdx.x;
  const float* a = keys_a + pair * na;
  const float* b = keys_b + pair * nb;
  if (static_cast<int>(blockIdx.y) < tiles_b) {
    rank_tile<false>(b, a, count_b + pair * nb, nb, na, blockIdx.y, stage);
  } else {
    rank_tile<true>(a, b, count_a + pair * na, na, nb, blockIdx.y - tiles_b, stage);
  }
}

}  // namespace

// keys_a (batch, na) f32, keys_b (batch, nb) f32 -> count_a (batch, na)
// int32, count_b (batch, nb) int32.  All contiguous, on `device`.
REPRO_EXPORT int repro_merge_ranks(const float* keys_a, const float* keys_b, int* count_a,
                                   int* count_b, long long batch, int na, int nb, int device,
                                   void* stream) {
  const int tiles_a = (na + kTile - 1) / kTile;
  const int tiles_b = (nb + kTile - 1) / kTile;
  if (batch == 0 || tiles_a + tiles_b == 0) return 0;
  if (tiles_a + tiles_b > 65535 || batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // shared memory for the longest other run that is staged
  int staged = 0;
  if (na <= kStageCap) staged = na;
  if (nb <= kStageCap && nb > staged) staged = nb;
  const size_t smem = static_cast<size_t>(staged) * sizeof(float);
  return repro::launch_on(device, [&] {
    const dim3 grid(static_cast<unsigned>(batch), static_cast<unsigned>(tiles_a + tiles_b));
    merge_ranks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        keys_a, keys_b, count_a, count_b, na, nb, tiles_b);
    return cudaSuccess;
  });
}
