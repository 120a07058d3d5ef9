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
// These are plain comparison counts, as in the Pallas kernel: on sorted
// runs they equal searchsorted "left" / "right", but sortedness is not
// needed for them to equal the plain twin (ref.merge_ranks_ref) on any
// input, ties, +inf and -0.0 == 0.0 included (IEEE compares).
//
// Bound on the H100: bytes.  The least work for this function is a merge
// path, which reads both runs once and writes both count vectors once:
// 8 * B * (NA + NB) bytes, 2.6 MB (0.78 us at 3.35 TB/s) for B = 256 pairs
// at the second escalation rung (NA = 1016, NB = 256).  This kernel does
// not reach that bound: it compares every element with the whole other
// run, 2 * B * NA * NB compares (133 M at that shape), so it is bound by
// those operations.  It is the simple, right first design; a merge-path
// (binary search on sorted runs) kernel is later work.
//
// Design: one launch for both outputs (the reference's two launches exist
// only for the TPU's output-revisit rule, merge_topk.py:80-84).  Grid x is
// the pair, grid y a tile of 256 elements of A (the first tiles_a tiles)
// or of B (the rest), so a tile never straddles the two runs and every
// block's branch is uniform.  The block stages the *other* run of its pair
// in shared memory, kChunk floats at a time (a pool of 4088 fits whole),
// and each thread counts for its element with the strictness of its run;
// every thread reads the same shared word at once (a broadcast, no bank
// conflicts).  Ragged tiles (NA = 252, 1016, 4088) mask their tail.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // floats of the other run staged per pass (16 KB)

__global__ void merge_ranks_kernel(const float* __restrict__ keys_a,
                                   const float* __restrict__ keys_b,
                                   int* __restrict__ count_a, int* __restrict__ count_b,
                                   int na, int nb, int tiles_a) {
  __shared__ float other[kChunk];
  const long long pair = blockIdx.x;
  const bool side_a = static_cast<int>(blockIdx.y) < tiles_a;
  const int tile = static_cast<int>(blockIdx.y) - (side_a ? 0 : tiles_a);
  const int n_self = side_a ? na : nb;
  const int n_other = side_a ? nb : na;
  const float* self = side_a ? keys_a + pair * na : keys_b + pair * nb;
  const float* run = side_a ? keys_b + pair * nb : keys_a + pair * na;
  const int i = tile * kThreads + threadIdx.x;
  const bool live = i < n_self;
  const float x = live ? self[i] : 0.0f;

  int count = 0;
  for (int base = 0; base < n_other; base += kChunk) {
    const int len = min(kChunk, n_other - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < len; j += kThreads) other[j] = run[base + j];
    __syncthreads();
    if (side_a) {
      for (int j = 0; j < len; ++j) count += other[j] < x ? 1 : 0;
    } else {
      for (int j = 0; j < len; ++j) count += other[j] <= x ? 1 : 0;
    }
  }
  if (live) (side_a ? count_a + pair * na : count_b + pair * nb)[i] = count;
}

}  // namespace

// keys_a (batch, na) f32, keys_b (batch, nb) f32 -> count_a (batch, na)
// int32, count_b (batch, nb) int32.  All contiguous, on `device`.
REPRO_EXPORT int repro_merge_ranks(const float* keys_a, const float* keys_b, int* count_a,
                                   int* count_b, long long batch, int na, int nb, int device,
                                   void* stream) {
  const int tiles_a = (na + kThreads - 1) / kThreads;
  const int tiles_b = (nb + kThreads - 1) / kThreads;
  if (batch == 0 || tiles_a + tiles_b == 0) return 0;
  if (tiles_a + tiles_b > 65535 || batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_on(device, [&] {
    const dim3 grid(static_cast<unsigned>(batch), static_cast<unsigned>(tiles_a + tiles_b));
    merge_ranks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys_a, keys_b, count_a, count_b, na, nb, tiles_a);
    return cudaSuccess;
  });
}
