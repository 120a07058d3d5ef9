// lsa_children: the delta^LSa child-bound vector of every search state.
//
// Replaces the Pallas kernel lsa_children_pallas
// (src/repro/kernels/lsa_children.py:102, pallas_call at :132), behind
// EngineConfig.use_kernel; one launch per search iteration on the "cuda"
// backend.  For state s and candidate g-slot u (the child v_i -> u):
//
//   lb[u] = base[u] + de[u] + ups_i[u] + ups_vi[u] + cross[u]   (BIG where u is not free)
//
// with the inner-edge and v_i cross multiset distances computed from the
// pre-reduced (N, Le) histograms, the exact-delta edge mismatches
// de[u] = sum_j pa[j] * 1[qrow[j] != a_ju[j, u]], and the per-anchor cross
// adjustments cross[u] = sum_j pa[j] * (a_ju[j, u] > 0
//     ? adjb_j[j] + 1[cg[j, a-1] <= cq[j, a-1]] : base_j[j]).
//
// Bound on the H100: bytes.  The only (B, N, N) operand is a_ju (int32),
// read once; the rest is (B, N) and (B, N, Le).  At the main path's shape
// (B = 2048, N = 32, Le = 3) that is ~10 MB, about 3 us at 3.35 TB/s, at
// or below the launch latency.
//
// Design: one block per state and one thread per candidate u.  Threads
// loop over the anchor positions j in order, reading a_ju[s, j, u]
// coalesced across u; the per-j scalars (qrow, pos_anch, base_j, adjb_j),
// the cq/cg rows and the three (Le,) histograms sit in shared memory,
// since every thread of the state reads all of them.  cg[j, a-1] is
// indexed directly instead of the reference's Le-step one-hot
// accumulation.  All terms are small integers and halves, so the result is
// exact and equals the plain twin bit for bit; Le = 0 skips the label
// loops (every a_ju is then 0).

#include "common.cuh"

namespace {

__global__ void lsa_children_kernel(
    const float* __restrict__ base, const float* __restrict__ free_g,
    const float* __restrict__ rowhist_g, const int* __restrict__ a_ju,
    const int* __restrict__ qrow, const float* __restrict__ pos_anch,
    const float* __restrict__ cq, const float* __restrict__ cg,
    const float* __restrict__ base_j, const float* __restrict__ adjb_j,
    const float* __restrict__ hq_i, const float* __restrict__ hg_i,
    const float* __restrict__ cq_vi, float* __restrict__ out, int n, int le) {
  extern __shared__ unsigned char smem[];
  int* s_qrow = reinterpret_cast<int*>(smem);
  float* s_pa = reinterpret_cast<float*>(s_qrow + n);
  float* s_base_j = s_pa + n;
  float* s_adjb_j = s_base_j + n;
  float* s_cq = s_adjb_j + n;      // (n, le)
  float* s_cg = s_cq + n * le;     // (n, le)
  float* s_hq = s_cg + n * le;     // (le,)
  float* s_hg = s_hq + le;         // (le,)
  float* s_cqvi = s_hg + le;       // (le,)

  const long long s = blockIdx.x;
  const long long sn = s * n;
  const long long sl = s * le;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s_qrow[j] = qrow[sn + j];
    s_pa[j] = pos_anch[sn + j];
    s_base_j[j] = base_j[sn + j];
    s_adjb_j[j] = adjb_j[sn + j];
  }
  for (int k = threadIdx.x; k < n * le; k += blockDim.x) {
    s_cq[k] = cq[sn * le + k];
    s_cg[k] = cg[sn * le + k];
  }
  for (int l = threadIdx.x; l < le; l += blockDim.x) {
    s_hq[l] = hq_i[sl + l];
    s_hg[l] = hg_i[sl + l];
    s_cqvi[l] = cq_vi[sl + l];
  }
  __syncthreads();

  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    // ---- inner edges + v_i cross: one pass over the edge labels ----
    const float* rg = rowhist_g + (sn + u) * le;
    float inter_i = 0.0f, inter_vi = 0.0f;
    float n_i1 = 0.0f, n_i2 = 0.0f, s1_vi = 0.0f, s2_u = 0.0f;
    for (int l = 0; l < le; ++l) {
      const float r = rg[l];
      const float hg_u = __fsub_rn(s_hg[l], r);
      inter_i = __fadd_rn(inter_i, fminf(s_hq[l], hg_u));
      inter_vi = __fadd_rn(inter_vi, fminf(s_cqvi[l], r));
      n_i1 = __fadd_rn(n_i1, s_hq[l]);
      n_i2 = __fadd_rn(n_i2, hg_u);
      s1_vi = __fadd_rn(s1_vi, s_cqvi[l]);
      s2_u = __fadd_rn(s2_u, r);
    }
    const float ups_i = __fsub_rn(fmaxf(n_i1, n_i2), inter_i);
    const float ups_vi = __fsub_rn(fmaxf(s1_vi, s2_u), inter_vi);

    // ---- anchor cross terms and exact-delta mismatches ----
    float cross = 0.0f, de = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int a = a_ju[(sn + j) * n + u];
      const float pa = s_pa[j];
      float term;
      if (a > 0) {
        // a label outside 1..le has no histogram bin: both sides read 0
        const float d = (a > le) ? 1.0f
                                 : (s_cg[j * le + a - 1] <= s_cq[j * le + a - 1] ? 1.0f : 0.0f);
        term = __fadd_rn(s_adjb_j[j], d);
      } else {
        term = s_base_j[j];
      }
      cross = __fadd_rn(cross, __fmul_rn(term, pa));
      if (s_qrow[j] != a) de = __fadd_rn(de, pa);
    }

    float lb = __fadd_rn(base[sn + u], de);
    lb = __fadd_rn(lb, ups_i);
    lb = __fadd_rn(lb, ups_vi);
    lb = __fadd_rn(lb, cross);
    out[sn + u] = free_g[sn + u] > 0.0f ? lb : repro::kBig;
  }
}

}  // namespace

// base, free_g, pos_anch, base_j, adjb_j (batch, n) f32; rowhist_g, cq, cg
// (batch, n, le) f32; a_ju (batch, n, n) int32; qrow (batch, n) int32;
// hq_i, hg_i, cq_vi (batch, le) f32 -> out (batch, n) f32.  All contiguous.
REPRO_EXPORT int repro_lsa_children(const float* base, const float* free_g,
                                    const float* rowhist_g, const int* a_ju, const int* qrow,
                                    const float* pos_anch, const float* cq, const float* cg,
                                    const float* base_j, const float* adjb_j, const float* hq_i,
                                    const float* hg_i, const float* cq_vi, float* out,
                                    long long batch, int n, int le, int device, void* stream) {
  if (batch == 0 || n == 0) return 0;
  return repro::launch_on(device, [&] {
    const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float) +
                        static_cast<size_t>(2 * n + 3) * le * sizeof(float);
    const cudaError_t err = repro::allow_smem(lsa_children_kernel, smem);
    if (err != cudaSuccess) return err;
    const int threads = n < 256 ? ((n + 31) / 32) * 32 : 256;
    lsa_children_kernel<<<static_cast<unsigned>(batch), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        base, free_g, rowhist_g, a_ju, qrow, pos_anch, cq, cg, base_j, adjb_j, hq_i, hg_i,
        cq_vi, out, n, le);
    return cudaSuccess;
  });
}
