// bma_cost_matrix: the lambda^BMa branch-cost matrix of every search state.
//
// Replaces the Pallas kernel bma_cost_matrix_pallas
// (src/repro/kernels/bma_cost_matrix.py:69, pallas_call at :87), behind
// EngineConfig.use_kernel; one launch per search iteration on the "cuda"
// backend.  For state s, q-slot v and g-slot u:
//
//   lam[s, v, u] = 1[qv[v] != gv[u]]
//                + 1/2 * (max(sum_l iq[v, l], sum_l ig[u, l]) - sum_l min(iq[v, l], ig[u, l]))
//                + sum_j pos_anch[j] * 1[qa_ord[v, j] != ga[u, img_cl[j]]]
//
// The reference wrapper gathers gcross[u, j] = ga[u, img_cl[j]] into a
// (B, N, N) tensor before its kernel; here that gather is folded in, so the
// kernel reads ga and img_cl directly and one (B, N, N) operand never
// exists.  The per-pair operands (qv, gv, qa_ord, ga) are passed once per
// pair, not once per state: the `expand` states s of a pair share row
// pair = s / expand of them, so the engine never copies them out to the
// (B, N, N) state axis.
//
// Bound on the H100: bytes.  It reads qa_ord and ga once per pair (P*N*N
// int32 each, P = B / expand), the two (B, N, Le) histograms and the
// (B, N) vectors, and writes lam (B*N*N f32): ~12.6 MB at the main path's
// shape (P = 256 pairs, expand 8, B = 2048, N = 32, Le = 3), about 3.8 us
// at 3.35 TB/s; the O(N) anchor loop per element is ~67 M compares in
// all, far under the card's integer rate.
//
// Design: a block per (state, tile of 32 u-columns), 32 x 8 threads.  The
// block first stages its slice of the gathered matrix, gc[u][j] =
// ga[u, img_cl[j]], in shared memory (rows padded to N + 1 words, so the
// 32 lanes of a warp, one u each, hit 32 different banks at every j),
// along with img_cl and pos_anch.  Then lane x of warp y computes column
// u = u0 + x for rows v = y, y + 8, ...: the qa_ord row of v is a broadcast
// read shared by the warp, and the lam row store is coalesced.  The
// states of one pair run in neighbouring blocks, so their re-reads of the
// pair's ga and qa_ord mostly hit L2.  Shared memory is (32 * (N + 1) +
// 2 N) words, 4.5 KB at N = 32; the launch opts into more than 48 KB when
// N is large.  All sums are of small integers and halves, exact in any
// order, so the result equals the plain twin bit for bit; Le = 0 simply
// skips the label loop.

#include "common.cuh"

namespace {

constexpr int kTileU = 32;  // u-columns per block: one per lane
constexpr int kRows = 8;    // warps per block, striding v

__global__ void bma_cost_matrix_kernel(const int* __restrict__ qv, const int* __restrict__ gv,
                                       const float* __restrict__ inner_q,
                                       const float* __restrict__ inner_g,
                                       const int* __restrict__ qa_ord,
                                       const int* __restrict__ ga,
                                       const int* __restrict__ img_cl,
                                       const float* __restrict__ pos_anch,
                                       float* __restrict__ out, int expand, int n, int le) {
  extern __shared__ unsigned char smem[];
  int* s_img = reinterpret_cast<int*>(smem);
  float* s_pa = reinterpret_cast<float*>(s_img + n);
  int* s_gc = reinterpret_cast<int*>(s_pa + n);  // (kTileU, n + 1)

  const long long s = blockIdx.x;
  const long long sn = s * n;              // row base of per-state operands
  const long long pn = (s / expand) * n;   // row base of per-pair operands
  const int u0 = blockIdx.y * kTileU;
  const int tid = threadIdx.y * kTileU + threadIdx.x;
  const int nthreads = kTileU * kRows;
  const int stride = n + 1;

  for (int j = tid; j < n; j += nthreads) {
    s_img[j] = img_cl[sn + j];
    s_pa[j] = pos_anch[sn + j];
  }
  __syncthreads();
  for (int k = tid; k < kTileU * n; k += nthreads) {
    const int ul = k / n;
    const int j = k - ul * n;
    const int u = u0 + ul;
    s_gc[ul * stride + j] = (u < n) ? ga[(pn + u) * n + s_img[j]] : 0;
  }
  __syncthreads();

  const int ul = threadIdx.x;
  const int u = u0 + ul;
  if (u >= n) return;
  const int gv_u = gv[pn + u];
  const float* hg = inner_g + (sn + u) * le;
  float sg = 0.0f;
  for (int l = 0; l < le; ++l) sg = __fadd_rn(sg, hg[l]);
  const int* gc = s_gc + ul * stride;

  for (int v = threadIdx.y; v < n; v += kRows) {
    const float vmis = (qv[pn + v] != gv_u) ? 1.0f : 0.0f;
    const float* hq = inner_q + (sn + v) * le;
    float sq = 0.0f, inter = 0.0f;
    for (int l = 0; l < le; ++l) {
      sq = __fadd_rn(sq, hq[l]);
      inter = __fadd_rn(inter, fminf(hq[l], hg[l]));
    }
    const float ups = __fsub_rn(fmaxf(sq, sg), inter);

    const int* qrow = qa_ord + (pn + v) * n;
    float mism = 0.0f;
    for (int j = 0; j < n; ++j) {
      if (qrow[j] != gc[j]) mism = __fadd_rn(mism, s_pa[j]);
    }
    out[(sn + v) * n + u] = __fadd_rn(__fadd_rn(vmis, __fmul_rn(0.5f, ups)), mism);
  }
}

}  // namespace

// qv, gv (batch / expand, n) int32 and qa_ord, ga (batch / expand, n, n)
// int32, one row per pair; inner_q, inner_g (batch, n, le) f32, img_cl
// (batch, n) int32 in [0, n) and pos_anch (batch, n) f32, one row per
// state, the states of pair p being rows p * expand ... p * expand +
// expand - 1 -> out (batch, n, n) f32.  All contiguous.
REPRO_EXPORT int repro_bma_cost_matrix(const int* qv, const int* gv, const float* inner_q,
                                       const float* inner_g, const int* qa_ord, const int* ga,
                                       const int* img_cl, const float* pos_anch, float* out,
                                       long long batch, int expand, int n, int le, int device,
                                       void* stream) {
  if (batch == 0 || n == 0) return 0;
  return repro::launch_on(device, [&] {
    const size_t smem =
        (static_cast<size_t>(kTileU) * (n + 1) + 2 * static_cast<size_t>(n)) * 4;
    const cudaError_t err = repro::allow_smem(bma_cost_matrix_kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(batch),
                    static_cast<unsigned>((n + kTileU - 1) / kTileU));
    const dim3 block(kTileU, kRows);
    bma_cost_matrix_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, expand, n, le);
    return cudaSuccess;
  });
}
