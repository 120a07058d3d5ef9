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
//     ? adjb_j[j] + 1[cg[j, a-1] <= cq[j, a-1]] : base_j[j]),
// where a_ju[j, u] = ga[img_cl[j], u].  The reference gathers a_ju into a
// (B, N, N) operand before its kernel; here that gather is folded in: the
// kernel takes the pair's ga (one row per pair, state s reading pair
// s / expand, as bma_cost_matrix does) and the state's img_cl.
//
// Bound on the H100: bytes.  It reads ga once per pair (P*N*N int32), the
// (B, N) and (B, N, Le) operands once, and writes (B, N) f32: ~5.6 MB at
// the main path's shape (P = 256, expand 8, B = 2048, N = 32, Le = 3),
// about 1.7 us at 3.35 TB/s (12.7 MB and 3.8 us with the a_ju copy).
//
// Design.  One block per state with one thread per u is a single warp at
// N = 32, too few to hide the reads inside the j loop.  Here a block is up
// to kMaxStates states of one pair (one warp each, lanes along u) and one
// 32-column tile of u, so 8 warps at N = 32 and expand 8.  Round A: the
// tile ga[:, u0:u0+32] of the pair, staged once for all the block's
// states, and the states' (N,) and (N, Le) rows, each one contiguous run
// of cp.async copies (16-byte where aligned), all issued at once; while
// they fly each thread computes its own u's inner-edge and v_i upsilons
// from its rowhist_g column (rowhist_g comes label-major, (Le, N) per
// state, the layout the engine builds it in, so lanes read it coalesced
// and it reaches the kernel uncopied).  Round B, warp sl for state sl:
// per position j the cross term of each label class, term_j(a) *
// pos_anch[j] for a <= 0, a = 1..Le and a > Le (the roundings the loop
// would make, hoisted out of it), and, in order, the record {pos_anch, qrow, img_cl row offset, term
// row} of every position that can change a sum.  A position with
// pos_anch = +-0 whose terms are all +-0 adds +-0 to both sums, which
// leaves them as they are (they start at +0 and round to nearest), so it
// is left out: unanchored positions cost nothing.  Phase 2: each (state,
// u) walks its records in order, eight at a time (the record, a =
// s_ga[img_j][lane] and the term of a's class read together), keeping its
// sums in order in one thread, so it equals the plain twin bit for bit on
// any exact input.  Labels outside 1..Le keep
// their meaning: above Le has no histogram bin (d = 1), at or below 0
// takes base_j.  Le = 0 has two classes, a <= 0 and a > 0.  S shrinks
// where the block's shared memory would pass the card's 227 KB; from N ~
// 100 the ga tile alone takes more than the default 48 KB (the opt-in
// launch path).  The loop is compiled for each Le up to 4 (LE), so the
// label loops unroll; other Le take the same code with a runtime count.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;       // u-columns per block: one per lane
constexpr int kMaxStates = 8;   // states (warps) per block
constexpr size_t kSmemMax = 232448;

inline int round4(int x) { return (x + 3) & ~3; }

// words of shared memory: the ga tile, then per (state, j) the staged
// pos_anch, qrow, img_cl, base_j, adjb_j (5), cq and cg rows (2 le), the
// record (4) and the class terms (le + 2), each array 16-byte aligned
inline size_t lsa_smem_bytes(int n, int le, int states) {
  const size_t sn = round4(states * n), snl = round4(states * n * le);
  return (static_cast<size_t>(kTile) * n + 9 * sn + 2 * snl +
          round4(states * n * (le + 2)) + round4(states)) * 4;
}

// LE >= 0: the edge-label count, known at compile time (the label loops
// unroll); LE < 0 reads le.
template <int LE>
__global__ void __launch_bounds__(kTile * kMaxStates)
    lsa_children_kernel(const float* __restrict__ base, const float* __restrict__ free_g,
                        const float* __restrict__ rowhist_g, const int* __restrict__ ga,
                        const int* __restrict__ img_cl, const int* __restrict__ qrow,
                        const float* __restrict__ pos_anch, const float* __restrict__ cq,
                        const float* __restrict__ cg, const float* __restrict__ base_j,
                        const float* __restrict__ adjb_j, const float* __restrict__ hq_i,
                        const float* __restrict__ hg_i, const float* __restrict__ cq_vi,
                        float* __restrict__ out, int expand, int groups, int states, int n,
                        int le_arg, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int le = LE >= 0 ? LE : le_arg;
  const int classes = le + 2;
  const int sn = (states * n + 3) & ~3, snl = (states * n * le + 3) & ~3;
  int* s_ga = reinterpret_cast<int*>(smem);                       // (n, kTile)
  int4* s_rec = reinterpret_cast<int4*>(s_ga + kTile * n);        // (states, n)
  float* s_pa = reinterpret_cast<float*>(s_rec + sn);             // (states, n)
  int* s_qrow = reinterpret_cast<int*>(s_pa + sn);
  int* s_img = s_qrow + sn;
  float* s_base_j = reinterpret_cast<float*>(s_img + sn);
  float* s_adjb_j = s_base_j + sn;
  float* s_cq = s_adjb_j + sn;                                    // (states, n, le)
  float* s_cg = s_cq + snl;
  float* s_term = s_cg + snl;                                     // (states, n, le + 2)
  int* s_count = reinterpret_cast<int*>(s_term + ((states * n * classes + 3) & ~3));  // (states,)

  const int p = blockIdx.x / groups;
  const int first = (blockIdx.x - p * groups) * states;
  const int ns = min(states, expand - first);
  const long long s0 = static_cast<long long>(p) * expand + first;
  const int u0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, lane = tid & 31, sl = tid >> 5;
  const int nthreads = blockDim.x;
  const int* ga_p = ga + static_cast<long long>(p) * n * n;

  // ---- phase 1, round A: every staging copy issued at once (cp.async,
  // 16-byte where aligned): the pair's ga tile and the states' (n,) and
  // (n, le) rows, each one contiguous run ----
  if (vec4) {
    for (int k = tid; k < n * (kTile / 4); k += nthreads) {
      const int r = k >> 3, c = (k & 7) * 4;
      if (u0 + c < n)
        repro::copy_async16(s_ga + r * kTile + c, ga_p + static_cast<long long>(r) * n + u0 + c);
    }
  } else {
    for (int k = tid; k < n * kTile; k += nthreads) {
      const int r = k >> 5, c = k & 31;
      if (u0 + c < n) repro::copy_async4(s_ga + r * kTile + c, ga_p + static_cast<long long>(r) * n + u0 + c);
    }
  }
  const long long g0 = s0 * n;
  repro::copy_words_async(s_pa, pos_anch + g0, ns * n, tid, nthreads);
  repro::copy_words_async(s_qrow, qrow + g0, ns * n, tid, nthreads);
  repro::copy_words_async(s_img, img_cl + g0, ns * n, tid, nthreads);
  repro::copy_words_async(s_base_j, base_j + g0, ns * n, tid, nthreads);
  repro::copy_words_async(s_adjb_j, adjb_j + g0, ns * n, tid, nthreads);
  repro::copy_words_async(s_cq, cq + g0 * le, ns * n * le, tid, nthreads);
  repro::copy_words_async(s_cg, cg + g0 * le, ns * n * le, tid, nthreads);

  // ---- round A, while the copies fly: this thread's u, inner edges and
  // the v_i cross term from its rowhist_g column ----
  const int u = u0 + lane;
  const bool live = sl < ns && u < n;
  float head = 0.0f, ups_i = 0.0f, ups_vi = 0.0f;
  bool is_free = false;
  if (live) {
    const long long su = (s0 + sl) * n + u;
    const long long sle = (s0 + sl) * le;
    head = base[su];
    is_free = free_g[su] > 0.0f;
    const float* rg = rowhist_g + (s0 + sl) * le * n + u;  // rg[l * n]: label l
    float inter_i = 0.0f, inter_vi = 0.0f;
    float n_i1 = 0.0f, n_i2 = 0.0f, s1_vi = 0.0f, s2_u = 0.0f;
#pragma unroll
    for (int l = 0; l < le; ++l) {
      const float r = rg[static_cast<long long>(l) * n];
      const float hq = hq_i[sle + l], cv = cq_vi[sle + l];
      const float hg_u = __fsub_rn(hg_i[sle + l], r);
      inter_i = __fadd_rn(inter_i, fminf(hq, hg_u));
      inter_vi = __fadd_rn(inter_vi, fminf(cv, r));
      n_i1 = __fadd_rn(n_i1, hq);
      n_i2 = __fadd_rn(n_i2, hg_u);
      s1_vi = __fadd_rn(s1_vi, cv);
      s2_u = __fadd_rn(s2_u, r);
    }
    ups_i = __fsub_rn(fmaxf(n_i1, n_i2), inter_i);
    ups_vi = __fsub_rn(fmaxf(s1_vi, s2_u), inter_vi);
  }
  repro::wait_async_copies();
  __syncthreads();

  // ---- phase 1, round B: warp sl takes state sl.  Per position j the
  // cross term of each label class, term(a) * pos_anch[j] for a <= 0,
  // a = 1..le and a > le; then the records {pos_anch, qrow, img_cl row
  // offset, term row} of the positions that can change a sum, in order.
  // A position with pos_anch = +-0 whose terms are all +-0 adds +-0 to
  // both sums, which leaves them as they are (they start at +0), so it is
  // left out. ----
  if (sl < ns) {
    int count = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane, k = sl * n + j;
      bool keep = false;
      int4 rec;
      if (j < n) {
        const float pa = s_pa[k];
        const float adjb = s_adjb_j[k];
        float* t = s_term + k * classes;
        t[0] = __fmul_rn(s_base_j[k], pa);                // a <= 0
        bool zero = t[0] == 0.0f;
#pragma unroll
        for (int l = 0; l < le; ++l) {                    // a = l + 1
          const float d = s_cg[k * le + l] <= s_cq[k * le + l] ? 1.0f : 0.0f;
          t[l + 1] = __fmul_rn(__fadd_rn(adjb, d), pa);
          zero &= t[l + 1] == 0.0f;
        }
        t[le + 1] = __fmul_rn(__fadd_rn(adjb, 1.0f), pa); // a > le: no bin, d = 1
        zero &= t[le + 1] == 0.0f;
        keep = !(pa == 0.0f && zero);
        rec = make_int4(__float_as_int(pa), s_qrow[k], s_img[k] * kTile, k * classes);
      }
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (keep) s_rec[sl * n + count + __popc(kept & ((1u << lane) - 1u))] = rec;
      count += __popc(kept);
    }
    if (lane == 0) s_count[sl] = count;
  }
  __syncthreads();
  if (!live) return;

  // ---- phase 2: anchor cross terms and exact-delta mismatches, j in order ----
  const int4* rec = s_rec + sl * n;
  const int* col = s_ga + lane;
  // eight records at a time: their record, ga and term reads are issued
  // together, and the sums still take them in order
  const int count = s_count[sl];
  float cross = 0.0f, de = 0.0f;
  int e = 0;
  for (; e + 8 <= count; e += 8) {
    int4 r[8];
    int a[8];
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = rec[e + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = col[r[i].z];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = s_term[r[i].w + min(max(a[i], 0), le + 1)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cross = __fadd_rn(cross, t[i]);
      if (r[i].y != a[i]) de = __fadd_rn(de, __int_as_float(r[i].x));
    }
  }
  for (; e < count; ++e) {
    const int4 r = rec[e];
    const int a = col[r.z];
    cross = __fadd_rn(cross, s_term[r.w + min(max(a, 0), le + 1)]);
    if (r.y != a) de = __fadd_rn(de, __int_as_float(r.x));
  }

  float lb = __fadd_rn(head, de);
  lb = __fadd_rn(lb, ups_i);
  lb = __fadd_rn(lb, ups_vi);
  lb = __fadd_rn(lb, cross);
  out[(s0 + sl) * n + u] = is_free ? lb : repro::kBig;
}

}  // namespace

// base, free_g, pos_anch, base_j, adjb_j (batch, n) f32; rowhist_g
// (batch, le, n) f32; cq, cg (batch, n, le) f32; ga (batch / expand, n, n) int32, one row per pair;
// img_cl (batch, n) int32 in [0, n); qrow (batch, n) int32; hq_i, hg_i,
// cq_vi (batch, le) f32 -> out (batch, n) f32.  The states of pair p are
// rows p * expand ... p * expand + expand - 1.  All contiguous.
REPRO_EXPORT int repro_lsa_children(const float* base, const float* free_g,
                                    const float* rowhist_g, const int* ga, const int* img_cl,
                                    const int* qrow, const float* pos_anch, const float* cq,
                                    const float* cg, const float* base_j, const float* adjb_j,
                                    const float* hq_i, const float* hg_i, const float* cq_vi,
                                    float* out, long long batch, int expand, int n, int le,
                                    int device, void* stream) {
  if (batch == 0 || n == 0) return 0;
  return repro::launch_on(device, [&] {
    int states = expand < kMaxStates ? expand : kMaxStates;
    while (states > 1 && lsa_smem_bytes(n, le, states) > kSmemMax) --states;
    const size_t smem = lsa_smem_bytes(n, le, states);
    const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(ga) % 16 == 0);
    const int groups = (expand + states - 1) / states;
    const dim3 grid(static_cast<unsigned>(batch / expand * groups),
                    static_cast<unsigned>((n + kTile - 1) / kTile));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel) {
      const cudaError_t err = repro::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kTile * states, smem, st>>>(base, free_g, rowhist_g, ga, img_cl, qrow,
                                                 pos_anch, cq, cg, base_j, adjb_j, hq_i, hg_i,
                                                 cq_vi, out, expand, groups, states, n, le, vec4);
      return cudaSuccess;
    };
    switch (le) {
      case 0: return launch(lsa_children_kernel<0>);
      case 1: return launch(lsa_children_kernel<1>);
      case 2: return launch(lsa_children_kernel<2>);
      case 3: return launch(lsa_children_kernel<3>);
      case 4: return launch(lsa_children_kernel<4>);
      default: return launch(lsa_children_kernel<-1>);
    }
  });
}
