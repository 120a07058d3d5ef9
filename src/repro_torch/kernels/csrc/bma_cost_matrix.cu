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
// The gather gcross[u, j] = ga[u, img_cl[j]] of the reference wrapper is
// folded in (the kernel reads ga and img_cl), and the per-pair operands
// (qv, gv, qa_ord, ga) are passed once per pair: state s reads pair row
// s / expand.
//
// Bound on the H100: bytes.  It reads qa_ord and ga once per pair, the two
// (N, Le) histograms of each state and the (B, N) vectors, and writes lam
// (B*N*N f32, 8.4 MB of the ~12.6 MB at the main path's shape: P = 256
// pairs, expand 8, B = 2048, N = 32, Le = 3), about 3.8 us at 3.35 TB/s.
//
// Design.  Written as above, the anchor term is an O(N) loop per element,
// ~250 instructions, which puts a kernel at ~11x its byte bound (42.8 us
// against 3.8 on the H100, PERF.md).  Here it is counted with label
// bitmasks over the order positions j, ceil(N / 32) words each:
//
//   A      = {j : pos_anch[j] != 0}                          per state
//   Q_k[v] = {j : bit k of qa_ord[v, j] is set}              per pair
//   G_k[u] = {j : bit k of ga[u, img_cl[j]] is set}          per state
//   mism   = popc(A & OR_k (Q_k[v] ^ G_k[u]))
//
// with k over the label_bits(Le) bit planes of the labels 0..Le.  Two
// labels differ exactly where some bit plane differs, so this is the
// one-hot form popc(A) - sum_l popc(A & Q_l[v] & G_l[u]) with Le + 1
// masks folded into ceil(log2(Le + 1)) planes (2 at Le = 3).  The count
// is an exact integer, so it equals the twin's sum of 0/1 products bit for
// bit.  It is exact only when every pos_anch of the block's states is 0
// or 1 and every label of qa_ord and ga fits the planes; each block
// checks that while it builds the masks and decides with
// __syncthreads_and, and otherwise runs the ordered per-j loop of the
// direct form (the twin's arithmetic, _rn intrinsics) for its states.
// One launch therefore equals the twin on any input, with no host-side
// test.  The bitmask path is compiled for Le <= kMaxLe (at most 3 planes)
// and N <= 32 * kMaxWords; other shapes take the loop.
//
// A block is one pair and up to kStates of its states (fewer when the
// batch has too few pairs to give half the SMs a block), 512 threads.  The
// histograms come label-major, (Le, N) per state, the layout the engine
// builds them in (bounds.py::hist), so they reach the kernel uncopied.
// Phase 1, round A: every operand the block needs (the pair's qv, gv,
// qa_ord, ga; the states' img_cl, pos_anch and (N, Le) histograms) is
// staged with cp.async in its device-memory layout, 16-byte copies where
// aligned, all issued at once.  Round B, shared memory only: the
// histogram row sums, and the bit planes with lanes along the positions j
// of a 32-position word, one ballot per plane: the Q planes of the pair's
// rows, and for each state the A word and the G planes, a warp taking
// every other u with its lanes' img_cl and pos_anch held in registers.
// Phase 2: one thread per item of kRows rows x 4 columns (16-byte lam
// stores where N % 4 == 0 and the output is aligned), the u side's labels
// and histograms held in registers across the rows; per element about 20
// instructions (the histogram terms, one XOR per plane, an AND and a
// popcount per word).  A one-hot mma.sync product with K = (Le + 1) * N
// would also give the counts, but the popcount form already costs fewer
// instructions per element than the fragments would take to load, so it
// is not used.  Le = 0 has no plane: every label must be 0.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kStates = 8;     // states of one pair per block, at most
constexpr size_t kSmemMax = 232448;
constexpr int kMaxLe = 4;      // edge-label counts compiled in; above, the ordered loop
constexpr int kMaxWords = 4;   // 32-position words per mask (n <= 128)
constexpr int kRows = 4;       // rows v per thread item

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// bit planes that hold the labels 0..le
__host__ __device__ constexpr int label_bits(int le) {
  return le <= 0 ? 0 : (le < 2 ? 1 : (le < 4 ? 2 : (le < 8 ? 3 : 4)));
}

// Shared-memory layout, in 4-byte words; every array starts 16-byte
// aligned.  The staged operands keep their device-memory layout, so each
// is one contiguous run of 16-byte copies.
struct Layout {
  int nn, words, bits;  // mask row stride round4(n), words per mask, bit planes
  bool masks;           // the shape allows the bitmask path
  int qv, gv, img, pa, sq, sg, iq, ig, qa, ga, a, q, g, total;
  __host__ __device__ Layout(int n, int le, int states) {
    nn = round4(n);
    words = (n + 31) / 32;
    bits = label_bits(le);
    masks = le <= kMaxLe && words <= kMaxWords;
    const int sn = round4(states * n);
    int at = 0;
    qv = at; at += nn;
    gv = at; at += nn;
    img = at; at += sn;                                  // [s][j]
    pa = at; at += sn;
    sq = at; at += sn;                                   // [s][v]
    sg = at; at += sn;
    iq = at; at += round4(states * n * le);              // [s][l][v]
    ig = at; at += round4(states * n * le);
    qa = at; at += masks ? round4(n * n) : 0;            // [v][j]
    ga = at; at += masks ? round4(n * n) : 0;            // [u][c]
    a = at; at += masks ? round4(states * words) : 0;    // [s][w]
    q = at; at += masks ? bits * words * nn : 0;         // [k][w][v]
    g = at; at += masks ? states * bits * words * nn : 0;   // [s][k][w][u]
    total = at;
  }
};

struct Ctx {
  const int* qa_ord;  // this pair's (n, n), device memory
  const int* ga;      // this pair's (n, n), device memory
  const int *s_qv, *s_gv, *s_img;
  const float *s_pa, *s_sq, *s_sg, *s_iq, *s_ig;
  const unsigned *s_a, *s_q, *s_g;
  int n, le, nn, words, row_groups;
  bool fast;
};

// One item: rows rg, rg + row_groups, ... (kRows of them) of local state
// s, columns u0 .. u0 + V - 1.  LE >= 0 is the edge-label count known at
// compile time (the u-side histogram terms stay in registers); LE < 0
// reads c.le and takes only the ordered loop.
template <int LE, int V>
__device__ __forceinline__ void bma_item(const Ctx& c, float* __restrict__ out, int s, int rg,
                                         int u0) {
  constexpr int kBits = label_bits(LE);
  constexpr int kLe = LE > 0 ? LE : 1;
  const int n = c.n, nn = c.nn;
  const int le = LE >= 0 ? LE : c.le;
  int gvv[V];
  float sgv[V], igv[kLe][V];
  if constexpr (V == 4) {
    const int4 g4 = *reinterpret_cast<const int4*>(c.s_gv + u0);
    gvv[0] = g4.x;
    gvv[1] = g4.y;
    gvv[2] = g4.z;
    gvv[3] = g4.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) gvv[i] = c.s_gv[u0 + i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sgv[i] = c.s_sg[s * n + u0 + i];
    if (LE > 0) {
#pragma unroll
      for (int l = 0; l < kLe; ++l) igv[l][i] = c.s_ig[(s * le + l) * n + u0 + i];
    }
  }

  for (int r = 0; r < kRows; ++r) {
    const int v = rg + r * c.row_groups;
    if (v >= n) break;
    float mism[V];
    if (LE >= 0 && c.fast) {
      int cnt[V];
#pragma unroll
      for (int i = 0; i < V; ++i) cnt[i] = 0;
      for (int w = 0; w < c.words; ++w) {
        unsigned x[V];
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = 0u;
#pragma unroll
        for (int k = 0; k < kBits; ++k) {
          const int plane = k * c.words + w;
          const unsigned qk = c.s_q[plane * nn + v];
          const unsigned* g = c.s_g + (s * kBits * c.words + plane) * nn + u0;
          if constexpr (V == 4) {
            const uint4 g4 = *reinterpret_cast<const uint4*>(g);
            x[0] |= qk ^ g4.x;
            x[1] |= qk ^ g4.y;
            x[2] |= qk ^ g4.z;
            x[3] |= qk ^ g4.w;
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) x[i] |= qk ^ g[i];
          }
        }
        const unsigned anchored = c.s_a[s * c.words + w];
#pragma unroll
        for (int i = 0; i < V; ++i) cnt[i] += __popc(x[i] & anchored);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) mism[i] = __int2float_rn(cnt[i]);
    } else {
      // the ordered loop of the twin's sum (any pos_anch, any label)
      const int* qrow = c.qa_ord + static_cast<long long>(v) * n;
      const int* img = c.s_img + s * n;
      const float* pa = c.s_pa + s * n;
#pragma unroll
      for (int i = 0; i < V; ++i) mism[i] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const int qj = qrow[j];
        const int im = img[j];
        const float p = pa[j];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (qj != c.ga[static_cast<long long>(u0 + i) * n + im]) mism[i] = __fadd_rn(mism[i], p);
        }
      }
    }

    const int qvv = c.s_qv[v];
    const float sqv = c.s_sq[s * n + v];
    const float* iq = c.s_iq + s * le * n + v;  // iq[l * n]: label l
    float res[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float inter = 0.0f;
      if (LE >= 0) {
#pragma unroll
        for (int l = 0; l < LE; ++l) inter = __fadd_rn(inter, fminf(iq[l * n], igv[l][i]));
      } else {
        for (int l = 0; l < le; ++l)
          inter = __fadd_rn(inter, fminf(iq[l * n], c.s_ig[(s * le + l) * n + u0 + i]));
      }
      const float ups = __fsub_rn(fmaxf(sqv, sgv[i]), inter);
      const float vmis = (qvv != gvv[i]) ? 1.0f : 0.0f;
      res[i] = __fadd_rn(__fadd_rn(vmis, __fmul_rn(0.5f, ups)), mism[i]);
    }
    float* o = out + static_cast<long long>(v) * n + u0;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = res[i];
    }
  }
}

template <int LE>
__global__ void __launch_bounds__(kThreads, 2)
    bma_cost_matrix_kernel(const int* __restrict__ qv, const int* __restrict__ gv,
                           const float* __restrict__ inner_q, const float* __restrict__ inner_g,
                           const int* __restrict__ qa_ord, const int* __restrict__ ga,
                           const int* __restrict__ img_cl, const float* __restrict__ pos_anch,
                           float* __restrict__ out, int expand, int groups, int states,
                           int n, int le, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(n, le, states);
  int* sw = reinterpret_cast<int*>(smem);
  float* sf = reinterpret_cast<float*>(smem);
  unsigned* su = reinterpret_cast<unsigned*>(smem);
  constexpr int kBits = label_bits(LE);

  const int p = blockIdx.x / groups;
  const int first = (blockIdx.x - p * groups) * states;  // local state 0's index in the pair
  const int ns = min(states, expand - first);
  const long long s0 = static_cast<long long>(p) * expand + first;
  const long long pn = static_cast<long long>(p) * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int nn = L.nn, W = L.words;
  const int* qa_p = qa_ord + pn * n;
  const int* ga_p = ga + pn * n;
  // the bitmask path needs the labels compiled in and the masks in budget
  const bool masks = LE >= 0 && L.masks;

  // ---- phase 1, round A: every staging copy issued at once (cp.async,
  // 16-byte where aligned) ----
  repro::copy_words_async(sw + L.qv, qv + pn, n, tid, kThreads);
  repro::copy_words_async(sw + L.gv, gv + pn, n, tid, kThreads);
  repro::copy_words_async(sw + L.img, img_cl + s0 * n, ns * n, tid, kThreads);
  repro::copy_words_async(sf + L.pa, pos_anch + s0 * n, ns * n, tid, kThreads);
  repro::copy_words_async(sf + L.iq, inner_q + s0 * n * le, ns * n * le, tid, kThreads);
  repro::copy_words_async(sf + L.ig, inner_g + s0 * n * le, ns * n * le, tid, kThreads);
  if (masks) {
    repro::copy_words_async(sw + L.qa, qa_p, static_cast<long long>(n) * n, tid, kThreads);
    repro::copy_words_async(sw + L.ga, ga_p, static_cast<long long>(n) * n, tid, kThreads);
  }
  repro::wait_async_copies();
  __syncthreads();

  // ---- phase 1, round B (shared memory only): histogram row sums and the
  // label bit planes, one 32-position word per warp task, lanes along the
  // positions j (one ballot per plane) ----
  for (int k = tid; k < ns * n; k += kThreads) {
    const int s = k / n, at = s * le * n + k - s * n;  // state s, row k - s * n, label 0
    float tq = 0.0f, tg = 0.0f;
    for (int l = 0; l < le; ++l) {
      tq = __fadd_rn(tq, sf[L.iq + at + l * n]);
      tg = __fadd_rn(tg, sf[L.ig + at + l * n]);
    }
    sf[L.sq + k] = tq;
    sf[L.sg + k] = tg;
  }
  bool ok = masks;
  if (masks) {
    constexpr unsigned kLabels = 1u << kBits;  // labels 0 .. 2^bits - 1 are exact
    // lanes along the positions j of one 32-position word; one ballot per
    // bit plane, lane k keeps plane k
    for (int w = 0; w < W; ++w) {
      const int j = w * 32 + lane;
      const bool in = j < n;
      // Q planes of the pair's qa_ord rows, rows spread over the warps
      for (int v = warp; v < n; v += kWarps) {
        const unsigned lab = in ? static_cast<unsigned>(sw[L.qa + v * n + j]) : 0u;
        ok &= lab < kLabels;
        unsigned mine = 0u;
#pragma unroll
        for (int k = 0; k < kBits; ++k) {
          const unsigned plane = __ballot_sync(0xffffffffu, (lab >> k) & 1u);
          if (lane == k) mine = plane;
        }
        if (lane < kBits) su[L.q + (lane * W + w) * nn + v] = mine;
      }
      // A and the G planes: warp (s, half) takes state s, every other u
      for (int sh = warp; sh < 2 * ns; sh += kWarps) {
        const int s = sh >> 1, half = sh & 1;
        const int im = in ? sw[L.img + s * n + j] : 0;
        const float x = in ? sf[L.pa + s * n + j] : 0.0f;
        ok &= x == 0.0f || x == 1.0f;
        if (half == 0) {
          const unsigned anch = __ballot_sync(0xffffffffu, x != 0.0f);
          if (lane == 0) su[L.a + s * W + w] = anch;
        }
        for (int u = half; u < n; u += 2) {
          const unsigned lab = in ? static_cast<unsigned>(sw[L.ga + u * n + im]) : 0u;
          ok &= lab < kLabels;
          unsigned mine = 0u;
#pragma unroll
          for (int k = 0; k < kBits; ++k) {
            const unsigned plane = __ballot_sync(0xffffffffu, (lab >> k) & 1u);
            if (lane == k) mine = plane;
          }
          if (lane < kBits) su[L.g + ((s * kBits + lane) * W + w) * nn + u] = mine;
        }
      }
    }
  }
  const bool fast = __syncthreads_and(ok) != 0;

  // ---- phase 2: lam, one item of kRows rows x (4 or 1) columns per thread ----
  Ctx c;
  c.qa_ord = qa_p;
  c.ga = ga_p;
  c.s_qv = sw + L.qv;
  c.s_gv = sw + L.gv;
  c.s_img = sw + L.img;
  c.s_pa = sf + L.pa;
  c.s_sq = sf + L.sq;
  c.s_sg = sf + L.sg;
  c.s_iq = sf + L.iq;
  c.s_ig = sf + L.ig;
  c.s_a = su + L.a;
  c.s_q = su + L.q;
  c.s_g = su + L.g;
  c.n = n;
  c.le = le;
  c.nn = nn;
  c.words = W;
  c.row_groups = (n + kRows - 1) / kRows;
  c.fast = fast;

  const int units = vec4 ? n / 4 : n;  // column groups per row
  const int per_state = units * c.row_groups;
  for (int item = tid; item < ns * per_state; item += kThreads) {
    const int s = item / per_state, rest = item - s * per_state;
    const int rg = rest / units, ug = rest - rg * units;
    float* o = out + (s0 + s) * n * n;
    if (vec4)
      bma_item<LE, 4>(c, o, s, rg, ug * 4);
    else
      bma_item<LE, 1>(c, o, s, rg, ug);
  }
}

template <int LE>
cudaError_t launch_bma(const int* qv, const int* gv, const float* inner_q, const float* inner_g,
                       const int* qa_ord, const int* ga, const int* img_cl, const float* pos_anch,
                       float* out, long long batch, int expand, int n, int le,
                       cudaStream_t stream) {
  // the states of one pair a block takes: up to kStates, so the pair's
  // masks are built once for them; halved while that leaves more than
  // half the SMs without a block (few pairs), and fewer where shared
  // memory runs out
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long pairs = batch / expand;
  int states = expand < kStates ? expand : kStates;
  while (states > 1 && 2 * pairs * ((expand + states - 1) / states) < sms)
    states = (states + 1) / 2;
  while (states > 1 && static_cast<size_t>(Layout(n, le, states).total) * 4 > kSmemMax) --states;
  const size_t smem = static_cast<size_t>(Layout(n, le, states).total) * 4;
  err = repro::allow_smem(bma_cost_matrix_kernel<LE>, smem);
  if (err != cudaSuccess) return err;
  const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int groups = (expand + states - 1) / states;
  const long long blocks = batch / expand * groups;
  bma_cost_matrix_kernel<LE><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, expand, groups, states, n, le,
      vec4);
  return cudaSuccess;
}

}  // namespace

// qv, gv (batch / expand, n) int32 and qa_ord, ga (batch / expand, n, n)
// int32, one row per pair; inner_q, inner_g (batch, le, n) f32, img_cl
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
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (le) {
      case 0: return launch_bma<0>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
      case 1: return launch_bma<1>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
      case 2: return launch_bma<2>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
      case 3: return launch_bma<3>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
      case 4: return launch_bma<4>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
      default: return launch_bma<-1>(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch, out, batch, expand, n, le, st);
    }
  });
}
