"""The port's kernel twins and bound math against the JAX reference.

Inputs are made with numpy from a seed and go through both the reference
(``repro``: Pallas kernels in interpret mode or their ``ref.py`` oracles,
the per-state bound functions) and the port (``repro_torch``).  Tolerances:

* kernel twins vs reference kernels: exact (``np.array_equal``) — every
  term is a small integer or half, or a min/argmin;
* merge ranks vs the Pallas merge kernel: exact — integer counts;
* auction and forced bounds: exact where |value| < 2**20, ``rtol=1e-6``
  above.  Prices inflate to ~BIG = 1e7 (the f32 ulp there is 1.0), so sums
  that carry them may round differently if a backend reorders them.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
(marker ``cuda``) and ``python3 chip_smoke.py`` hold each against its twin
there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import auction as ref_auc  # noqa: E402
from repro.core.engine import bounds as ref_eb  # noqa: E402
from repro.core.engine.tensor_graphs import pack_pairs as ref_pack  # noqa: E402
from repro.data.graphs import perturb, random_graph  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.lsa_children import lsa_children_pallas  # noqa: E402
from repro.kernels.merge_topk import merge_ranks_pallas  # noqa: E402
from repro.kernels.reduced_top2 import reduced_top2_pallas  # noqa: E402

from repro_torch.core.engine import auction as auc  # noqa: E402
from repro_torch.core.engine import bounds as eb  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

T = torch.as_tensor


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_big_close(got, want):
    """Exact below 2**20; rtol 1e-6 above (BIG-sized sums, see module doc)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    small = np.abs(want) < 2.0 ** 20
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got[~small], want[~small], rtol=1e-6)


# ------------------------------------------------------------ kernel twins

def _bma_inputs(rng, b, n, le, vl=5, el=3):
    qv = rng.integers(0, vl, (b, n)).astype(np.int32)
    gv = rng.integers(0, vl, (b, n)).astype(np.int32)
    iq = rng.integers(0, 4, (b, n, le)).astype(np.float32)
    ig = rng.integers(0, 4, (b, n, le)).astype(np.float32)
    qa = rng.integers(0, el, (b, n, n)).astype(np.int32)
    ga = rng.integers(0, el, (b, n, n)).astype(np.int32)
    img = rng.integers(0, n, (b, n)).astype(np.int32)
    pa = rng.integers(0, 2, (b, n)).astype(np.float32)
    return qv, gv, iq, ig, qa, ga, img, pa


PAIR_ARGS = (0, 1, 4, 5)   # qv, gv, qa_ord, ga: one row per pair


@pytest.mark.parametrize("b,n,le,expand", [
    (3, 16, 2, 1), (2, 5, 3, 1), (1, 32, 5, 1), (3, 6, 2, 4), (2, 5, 1, 8)])
def test_bma_cost_matrix_twin_matches_reference(b, n, le, expand):
    """With ``expand`` states per pair, the per-pair operands passed once
    per pair give the reference's result on them copied to every state."""
    rng = np.random.default_rng(b * 100 + n + le + expand)
    per_pair = _bma_inputs(rng, b, n, le)
    per_state = _bma_inputs(rng, b * expand, n, le)
    args = [a if i in PAIR_ARGS else s
            for i, (a, s) in enumerate(zip(per_pair, per_state))]
    full = [np.repeat(a, expand, axis=0) if i in PAIR_ARGS else a
            for i, a in enumerate(args)]
    want = ref_ops.bma_cost_matrix(*(jnp.asarray(a) for a in full))
    got = kops.bma_cost_matrix(*(T(a) for a in args))
    assert np.array_equal(_np(got), np.asarray(want))
    assert np.array_equal(_np(ref.bma_cost_matrix_ref(*(T(a) for a in args))),
                          np.asarray(want))
    if expand > 1:
        args[6] = args[6][:-1]
        with pytest.raises(ValueError, match="divide evenly"):
            kops.bma_cost_matrix(*(T(a) for a in args))


def test_bma_cost_matrix_twin_unbatched_and_edgeless():
    rng = np.random.default_rng(7)
    args = _bma_inputs(rng, 1, 8, 0)
    gcross = np.take_along_axis(args[5], np.broadcast_to(
        args[6][:, None, :], args[5].shape), axis=2)
    want = ref_ref.bma_cost_matrix_ref(
        *(jnp.asarray(a) for a in args[:5]), jnp.asarray(gcross),
        jnp.asarray(args[7]))
    got = kops.bma_cost_matrix(*(T(a[0]) for a in args))
    assert np.array_equal(_np(got), np.asarray(want)[0])


@pytest.mark.parametrize("b,n", [(1, 1), (4, 5), (2, 64)])
def test_reduced_top2_twin_matches_reference(b, n):
    rng = np.random.default_rng(b * 7 + n)
    cost = rng.random((b, n, n)).astype(np.float32)
    prices = (rng.random((b, n)) * 3).astype(np.float32)
    want = ref_ref.reduced_top2_ref(jnp.asarray(cost), jnp.asarray(prices))
    got = kops.reduced_top2(T(cost), T(prices))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    assert got[1].dtype == torch.int32


def test_reduced_top2_twin_ties_and_big_entries():
    """Tied minima give m2 == m1 and the first index; BIG-sized rows
    round like the Pallas kernel."""
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 3, (3, 8, 8)).astype(np.float32)
    cost[0, :, :4] = 1e7
    cost[1, 2, :] = 1e7 + 1.0
    prices = np.zeros((3, 8), np.float32)
    prices[2] = rng.integers(0, 2, 8) * 1e7
    want = reduced_top2_pallas(jnp.asarray(cost), jnp.asarray(prices),
                               interpret=True)
    got = kops.reduced_top2(T(cost), T(prices))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    ties = _np(got[0]) == _np(got[2])
    assert ties.any()


def _assert_top2_matches_pallas(cost, prices):
    want = reduced_top2_pallas(jnp.asarray(cost), jnp.asarray(prices),
                               interpret=True)
    got = kops.reduced_top2(T(cost), T(prices))
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32
                           else torch.float32)
        assert np.array_equal(_np(g), np.asarray(w))
    return got


@pytest.mark.parametrize("n", [8, 16, 128])
def test_reduced_top2_matches_pallas_at_each_width(n):
    """Widths the card kernel lays out differently (several rows of a warp
    per state, two lanes per row, sixteen lanes per row), with ties,
    1e7 entries and +inf rows: exact against the Pallas kernel."""
    rng = np.random.default_rng(n)
    cost = rng.integers(0, 3, (5, n, n)).astype(np.float32)
    cost[1, ::3, ::2] = 1e7
    cost[2, 4] = np.inf
    prices = rng.integers(0, 2, (5, n)).astype(np.float32)
    _assert_top2_matches_pallas(cost, prices)


def test_reduced_top2_all_inf_rows():
    """A row of +inf reports column 0 and m2 = +inf, with finite or
    infinite prices."""
    cost = np.full((3, 32, 32), np.inf, np.float32)
    cost[1, 5:] = 2.0
    prices = np.zeros((3, 32), np.float32)
    prices[2] = np.inf
    m1, a1, m2 = _assert_top2_matches_pallas(cost, prices)
    assert (_np(a1)[0] == 0).all() and np.isinf(_np(m2)[0]).all()


@pytest.mark.parametrize("n,j", [(64, 31), (128, 31), (128, 63)])
def test_reduced_top2_ties_across_lane_boundaries(n, j):
    """The row minimum at columns j and j + 1 (31/32, 63/64: where lane
    groups of the card kernel meet) and at the last column: the first
    index wins and m2 == m1."""
    rng = np.random.default_rng(n + j)
    cost = (rng.integers(2, 6, (4, n, n)) * 0.5).astype(np.float32)
    cost[:, :, j:j + 2] = 0.5
    cost[:, :, n - 1] = 0.5
    cost[1, 3, j] = 0.75
    prices = np.zeros((4, n), np.float32)
    m1, a1, m2 = _assert_top2_matches_pallas(cost, prices)
    assert (_np(a1)[0] == j).all() and (_np(m2) == _np(m1)).all()
    assert _np(a1)[1, 3] == j + 1


def _lsa_inputs(rng, b, n, le, expand=1, labels=None):
    """The port's 14 ``lsa_children`` operands: ``ga`` one row per pair
    (``b // expand`` rows) with edge labels drawn from ``labels`` (default
    0..Le), ``img_cl`` one row per state."""
    f32 = np.float32
    lo, hi = labels or (0, le + 1)
    return (
        (rng.integers(0, 6, (b, n)) * 0.5).astype(f32),        # base
        rng.integers(0, 2, (b, n)).astype(f32),                 # free_g
        rng.integers(0, 3, (b, n, le)).astype(f32),             # rowhist_g
        rng.integers(lo, hi, (b // expand, n, n)).astype(np.int32),  # ga
        rng.integers(0, n, (b, n)).astype(np.int32),            # img_cl
        rng.integers(lo, hi, (b, n)).astype(np.int32),          # qrow
        rng.integers(0, 2, (b, n)).astype(f32),                 # pos_anch
        rng.integers(0, 3, (b, n, le)).astype(f32),             # cq
        rng.integers(0, 3, (b, n, le)).astype(f32),             # cg
        rng.integers(0, 4, (b, n)).astype(f32),                 # base_j
        rng.integers(0, 4, (b, n)).astype(f32),                 # adjb_j
        (rng.integers(0, 7, (b, le)) * 0.5).astype(f32),        # hq_i
        (rng.integers(3, 9, (b, le)) * 0.5).astype(f32),        # hg_i
        rng.integers(0, 3, (b, le)).astype(f32),                # cq_vi
    )


def _lsa_reference_args(args):
    """The reference's 13 operands: ``a_ju[s, j, u] = ga[s // expand,
    img_cl[s, j], u]`` built in numpy in place of ``ga`` and ``img_cl``."""
    ga, img = args[3], args[4]
    ga = np.repeat(ga, img.shape[0] // ga.shape[0], axis=0)
    a_ju = np.take_along_axis(ga, img[:, :, None], axis=1)
    return (*args[:3], a_ju, *args[5:])


@pytest.mark.parametrize("b,n,le", [(3, 16, 3), (2, 6, 4)])
def test_lsa_children_twin_matches_reference(b, n, le):
    rng = np.random.default_rng(b * 31 + n * 3 + le)
    args = _lsa_inputs(rng, b, n, le)
    want = ref_ref.lsa_children_ref(
        *(jnp.asarray(a) for a in _lsa_reference_args(args)))
    got = kops.lsa_children(*(T(a) for a in args))
    assert np.array_equal(_np(got), np.asarray(want))


def test_lsa_children_twin_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    args = _lsa_inputs(rng, 2, 16, 3)
    want = lsa_children_pallas(
        *(jnp.asarray(a) for a in _lsa_reference_args(args)), interpret=True)
    got = kops.lsa_children(*(T(a[0]) for a in args))     # unbatched
    assert np.array_equal(_np(got), np.asarray(want)[0])


LSA_LABELS = {"in_range": None, "outside": (-2, 6)}


@pytest.mark.parametrize("labels", sorted(LSA_LABELS))
@pytest.mark.parametrize("le", [0, 1, 3])
@pytest.mark.parametrize("n,expand", [(5, 1), (16, 4), (32, 8)])
def test_lsa_children_per_pair_ga_matches_reference(n, expand, le, labels):
    """``ga`` passed once per pair (``expand`` states each) and gathered by
    ``img_cl`` gives the reference's result on the gathered ``a_ju``, also
    with labels outside 1..Le (above Le: d = 1; at or below 0: base_j) and
    at Le = 0; against the Pallas kernel in interpret mode where Le > 0."""
    rng = np.random.default_rng(n * 10 + expand + le)
    args = _lsa_inputs(rng, 2 * expand, n, le, expand=expand,
                       labels=LSA_LABELS[labels])
    ref_args = [jnp.asarray(a) for a in _lsa_reference_args(args)]
    want = np.asarray(ref_ref.lsa_children_ref(*ref_args))
    got = kops.lsa_children(*(T(a) for a in args))
    assert np.array_equal(_np(got), want)
    assert np.array_equal(_np(ref.lsa_children_ref(*(T(a) for a in args))),
                          want)
    if le:
        assert np.array_equal(
            np.asarray(lsa_children_pallas(*ref_args, interpret=True)), want)


def test_lsa_children_rejects_states_that_do_not_divide_among_pairs():
    args = [T(a) for a in _lsa_inputs(np.random.default_rng(2), 8, 6, 2,
                                       expand=4)]
    args[3] = args[3][:1].repeat(3, 1, 1)          # 3 pair rows, 8 states
    with pytest.raises(ValueError, match="divide evenly"):
        kops.lsa_children(*args)


@pytest.mark.parametrize("na,nb", [(7, 5), (16, 16), (1, 9)])
def test_merge_ranks_and_hist_intersect_twins(na, nb):
    rng = np.random.default_rng(na * nb)
    a = np.sort(rng.integers(0, 6, (3, na)).astype(np.float32), axis=1)
    b = np.sort(rng.integers(0, 6, (3, nb)).astype(np.float32), axis=1)
    a[0, -1] = np.inf
    for g, w in zip(ref.merge_ranks_ref(T(a), T(b)),
                    ref_ref.merge_ranks_ref(jnp.asarray(a), jnp.asarray(b))):
        assert np.array_equal(_np(g), np.asarray(w)) and g.dtype == torch.int32
    hq = rng.integers(0, 4, (2, na, 3)).astype(np.float32)
    hg = rng.integers(0, 4, (2, nb, 3)).astype(np.float32)
    assert np.array_equal(
        _np(ref.hist_intersect_ref(T(hq), T(hg))),
        np.asarray(ref_ref.hist_intersect_ref(jnp.asarray(hq),
                                              jnp.asarray(hg))))


def _merge_keys(rng, b, na, nb, kind):
    """Merge-rank inputs: sorted runs, unsorted runs, all ties, or runs
    full of +inf, the engine's INF = 3e8 and signed zeros."""
    a = rng.integers(0, 8, (b, na)).astype(np.float32)
    k = rng.integers(0, 8, (b, nb)).astype(np.float32)
    if kind == "sorted":
        a, k = np.sort(a, axis=1), np.sort(k, axis=1)
    elif kind == "ties":
        a[:], k[:] = 3.0, 3.0
    elif kind == "inf_big":
        for x in (a, k):
            x[:, ::3] = np.inf
            x[:, 1::3] = 3.0e8
            x[:, 2::5] = -0.0
        a[:, 4::7] = 0.0
    return a, k


MERGE_SHAPES = [(12, 8), (28, 16), (60, 64), (12, 64), (60, 8)]


@pytest.mark.parametrize("na,nb", MERGE_SHAPES)
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "ties", "inf_big"])
def test_merge_ranks_matches_reference_kernel(na, nb, kind):
    """Rung-like (pool - expand, expand x slots) shapes, NB above and below
    NA: the wrapper equals the Pallas kernel and its oracle exactly."""
    rng = np.random.default_rng(na * 1000 + nb)
    a, k = _merge_keys(rng, 3, na, nb, kind)
    got = kops.merge_ranks(T(a), T(k))
    for want in (merge_ranks_pallas(jnp.asarray(a), jnp.asarray(k),
                                    interpret=True),
                 ref_ref.merge_ranks_ref(jnp.asarray(a), jnp.asarray(k))):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(_np(g), np.asarray(w))
    if kind == "ties":
        assert (_np(got[0]) == 0).all() and (_np(got[1]) == na).all()


def _mixed_merge_runs(rng, b, na, nb):
    """Rows by index mod 6: both runs sorted; both unsorted; sorted with
    signed zeros, +inf and 3e8; only keys_a sorted; only keys_b sorted;
    sorted with a NaN tail (unsorted for the card kernel's test)."""
    pool = np.array([-2.0, -0.0, 0.0, 1.0, 3.0e8, np.inf], np.float32)
    a = rng.integers(0, 16, (b, na)).astype(np.float32)
    k = rng.integers(0, 16, (b, nb)).astype(np.float32)
    a[2::6] = rng.choice(pool, a[2::6].shape)
    k[2::6] = rng.choice(pool, k[2::6].shape)
    kind = (np.arange(b) % 6)[:, None]
    a = np.where((kind != 1) & (kind != 4), np.sort(a, axis=1), a)
    k = np.where((kind != 1) & (kind != 3), np.sort(k, axis=1), k)
    a[5::6, -1] = np.nan
    k[5::6, -1] = np.nan
    return a, k


@pytest.mark.parametrize("na,nb", [(28, 16), (60, 64), (130, 9)])
def test_merge_ranks_mixed_sorted_and_unsorted_rows(na, nb):
    """One batch whose rows the card kernel binary-searches or counts: the
    wrapper equals the Pallas kernel exactly on every row."""
    rng = np.random.default_rng(na + nb)
    a, k = _mixed_merge_runs(rng, 12, na, nb)
    want = merge_ranks_pallas(jnp.asarray(a), jnp.asarray(k), interpret=True)
    for g, w in zip(kops.merge_ranks(T(a), T(k)), want):
        assert g.dtype == torch.int32
        assert np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("na,nb", [(12, 8), (60, 64), (250, 33)])
def test_merge_ranks_sorted_signed_zeros_and_inf_tails(na, nb):
    """Sorted runs (non-decreasing under IEEE <=) holding -0.0 and 0.0 in
    both orders, ties, and +inf / 3e8 tails: exact against the Pallas
    kernel, and equal to the searchsorted ranks a binary search gives."""
    rng = np.random.default_rng(na * 7 + nb)

    def runs(n):
        # per row: a block of -1, a block of zeros whose signs alternate
        # (-0.0 first in even rows, 0.0 first in odd rows), then 2.0, and
        # a 3e8 / +inf tail
        x = np.full((4, n), 2.0, np.float32)
        for r in range(4):
            lo = int(rng.integers(0, n // 4 + 1))
            z = np.arange(max(3, n // 3))
            x[r, :lo] = -1.0
            x[r, lo:lo + len(z)] = np.where(z % 2 == r % 2, -0.0, 0.0)
        x[:, -2:] = np.float32(3.0e8)
        x[1:, -1] = np.inf
        return x

    a, k = runs(na), runs(nb)
    for x in (a, k):
        assert (x[:, :-1] <= x[:, 1:]).all()
        pairs = np.signbit(x[:, :-1]).astype(int) - np.signbit(x[:, 1:])
        zero = (x[:, :-1] == 0) & (x[:, 1:] == 0)
        assert (pairs[zero] == 1).any() and (pairs[zero] == -1).any()
    want = merge_ranks_pallas(jnp.asarray(a), jnp.asarray(k), interpret=True)
    got = kops.merge_ranks(T(a), T(k))
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    for r in range(4):
        assert np.array_equal(_np(got[0])[r],
                              np.searchsorted(k[r], a[r], side="left"))
        assert np.array_equal(_np(got[1])[r],
                              np.searchsorted(a[r], k[r], side="right"))


def test_merge_ranks_unbatched_and_empty_runs():
    rng = np.random.default_rng(4)
    a, k = _merge_keys(rng, 1, 28, 16, "inf_big")
    want = merge_ranks_pallas(jnp.asarray(a), jnp.asarray(k), interpret=True)
    got = kops.merge_ranks(T(a[0]), T(k[0]))
    for g, w in zip(got, want):
        assert g.shape == (w.shape[1],)
        assert np.array_equal(_np(g), np.asarray(w)[0])
    ca, cb = kops.merge_ranks(torch.zeros(2, 0), T(k[:, :5].repeat(2, 0)))
    assert ca.shape == (2, 0) and _np(cb).tolist() == [[0] * 5] * 2
    ca, cb = kops.merge_ranks(torch.zeros(0, 4), torch.zeros(0, 3))
    assert ca.shape == (0, 4) and cb.shape == (0, 3)


def test_cpu_wrappers_use_twins_and_count_no_launches():
    kops.reset_launch_counts()
    rng = np.random.default_rng(0)
    kops.reduced_top2(T(rng.random((2, 4, 4), np.float32)),
                      T(rng.random((2, 4), np.float32)))
    kops.bma_cost_matrix(*(T(a) for a in _bma_inputs(rng, 1, 4, 2)))
    kops.lsa_children(*(T(a) for a in _lsa_inputs(rng, 1, 4, 2)))
    kops.merge_ranks(*(T(a) for a in _merge_keys(rng, 2, 6, 4, "sorted")))
    assert kops.launch_counts() == {"reduced_top2": 0, "bma_cost_matrix": 0,
                                    "lsa_children": 0, "merge_ranks": 0}


def test_kernel_build_is_lazy_and_content_addressed():
    """Importing the wrappers builds nothing; the library name hashes the
    sources, and lands under build/ at the repository root."""
    assert _build._LIB is None or _build.library_path().exists()
    path = _build.library_path()
    assert path.parent.name == "repro_torch_kernels"
    assert path.parent.parent.name == "build"
    assert path == _build.library_path()
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


# ----------------------------------------------------- engine-state bounds

def _engine_state(rng, slots, n_graph, level):
    """A real reference (PairConsts, StateMasks, level, g_cost) engine state
    (built as in ``tests/test_kernels.py::_engine_state``), plus the raw
    inputs."""
    q = random_graph(rng, n_graph, density=0.4, n_vlabels=3, n_elabels=2)
    g = perturb(rng, q, int(rng.integers(0, 4)), n_vlabels=3, n_elabels=2)
    t = ref_pack([(q, g)], slots=slots)
    pc = ref_eb.make_pair_consts(
        jnp.asarray(t.qv[0]), jnp.asarray(t.gv[0]), jnp.asarray(t.qa[0]),
        jnp.asarray(t.ga[0]), jnp.asarray(t.order[0]), jnp.asarray(t.n[0]),
        t.n_vlabels, t.n_elabels)
    n = int(t.n[0])
    level = min(level, n - 1)
    img = np.full(slots, -1, np.int32)
    img[:level] = rng.permutation(n)[:level]
    sm = ref_eb.state_masks(pc, jnp.asarray(img), jnp.int32(level))
    g_cost = float(rng.integers(0, 7)) * 0.5
    return pc, sm, jnp.int32(level), jnp.float32(g_cost), (t, img, level,
                                                           g_cost)


def _port_state(raw):
    t, img, level, g_cost = raw
    pc = eb.make_pair_consts(T(t.qv[0]), T(t.gv[0]), T(t.qa[0]), T(t.ga[0]),
                             T(t.order[0]), T(t.n[0]), t.n_vlabels,
                             t.n_elabels)
    lvl = torch.tensor(level, dtype=torch.int32)
    sm = eb.state_masks(pc, T(img), lvl)
    return pc, sm, lvl, torch.tensor(g_cost, dtype=torch.float32)


STATES = [(8, 5, 0), (8, 8, 3), (8, 7, 5)]


@pytest.mark.parametrize("slots,n_graph,level", STATES)
def test_engine_state_bounds_match_reference(slots, n_graph, level):
    """Pair constants, state masks, exact deltas, both LSa paths, both BMa
    cost-matrix paths and the BMa children of a real engine state equal the
    reference's.  The bounds are held to the reference's *unfused* path
    (its fused path fails on edgeless states, ROADMAP R1)."""
    rng = np.random.default_rng(slots * 100 + n_graph * 10 + level)
    rpc, rsm, rlvl, rgc, raw = _engine_state(rng, slots, n_graph, level)
    pc, sm, lvl, gc = _port_state(raw)
    for name in ("qa_ord", "oh_q", "oh_g", "oh_q_ord"):
        assert np.array_equal(_np(getattr(pc, name)),
                              np.asarray(getattr(rpc, name))), name
    for name in rsm._fields:
        assert np.array_equal(_np(getattr(sm, name)),
                              np.asarray(getattr(rsm, name))), name
    assert np.array_equal(_np(eb.child_exact_delta(pc, sm)),
                          np.asarray(ref_eb.child_exact_delta(rpc, rsm)))
    want_lsa = np.asarray(ref_eb.lsa_children(rpc, rsm, rlvl, rgc,
                                              use_kernel=False))
    want_bma = np.asarray(ref_eb.bma_cost_matrix(rpc, rsm, use_kernel=False))
    for uk in (False, True):
        assert np.array_equal(_np(eb.lsa_children(pc, sm, lvl, gc,
                                                  use_kernel=uk)), want_lsa)
        assert np.array_equal(_np(eb.bma_cost_matrix(pc, sm, use_kernel=uk)),
                              want_bma)
    img = raw[1]
    want = ref_eb.bma_children(rpc, rsm, jnp.asarray(img), rlvl, rgc,
                               sweeps=8, use_kernel=False)
    got = eb.bma_children(pc, sm, T(img), lvl, gc, sweeps=8, use_kernel=True)
    assert_big_close(got.lb, want.lb)
    assert np.array_equal(_np(got.full_img), np.asarray(want.full_img))
    assert_big_close(got.full_cost, want.full_cost)


def test_edgeless_state_r1_reproducer():
    """The ROADMAP R1 state (n_elabels == 0): the reference's fused path
    raises there; the port's fused and unfused paths both answer and equal
    the reference's unfused bounds."""
    rpc, rsm, rlvl, rgc, raw = _engine_state(np.random.default_rng(832),
                                             slots=8, n_graph=3, level=2)
    assert raw[0].n_elabels == 0
    pc, sm, lvl, gc = _port_state(raw)
    want_lsa = np.asarray(ref_eb.lsa_children(rpc, rsm, rlvl, rgc,
                                              use_kernel=False))
    want_bma = np.asarray(ref_eb.bma_cost_matrix(rpc, rsm, use_kernel=False))
    for uk in (False, True):
        assert np.array_equal(_np(eb.lsa_children(pc, sm, lvl, gc,
                                                  use_kernel=uk)), want_lsa)
        assert np.array_equal(_np(eb.bma_cost_matrix(pc, sm, use_kernel=uk)),
                              want_bma)


def test_bma_kernel_operands_keep_pair_constants_per_pair():
    """In the search's layout — pair constants ``(pairs, 1, ...)`` against
    states ``(pairs, expand, ...)`` — the per-pair kernel operands keep one
    row per pair, and both BMa paths agree."""
    from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device
    from repro_torch.data import graphs as port_graphs
    rng = np.random.default_rng(5)
    pairs, expand, slots = 3, 4, 8
    graphs = [port_graphs.random_graph(rng, int(rng.integers(4, 8)),
                                       density=0.4, n_vlabels=3, n_elabels=2)
              for _ in range(pairs)]
    packed = pack_pairs([(g, port_graphs.perturb(rng, g, 2, n_vlabels=3,
                                                 n_elabels=2))
                         for g in graphs], slots=slots)
    pc = eb.make_pair_consts(*to_device(packed, "cpu")).unsqueeze(1)
    level = np.zeros((pairs, expand), np.int32)
    img = np.full((pairs, expand, slots), -1, np.int32)
    for p, n in enumerate(packed.n):
        for e in range(expand):
            level[p, e] = rng.integers(0, n)
            img[p, e, :level[p, e]] = rng.permutation(n)[:level[p, e]]
    sm = eb.state_masks(pc, T(img), T(level))
    flat, lead = eb.bma_kernel_operands(pc, sm)
    assert tuple(lead) == (pairs, expand)
    assert [tuple(x.shape[:1]) for x in flat] == \
        [(pairs,)] * 2 + [(pairs * expand,)] * 2 + [(pairs,)] * 2 \
        + [(pairs * expand,)] * 2
    assert torch.equal(eb.bma_cost_matrix(pc, sm, use_kernel=True),
                       eb.bma_cost_matrix(pc, sm, use_kernel=False))


def _search_layout_states(seed, pairs, expand, slots):
    """Engine states in the search's layout: pair constants ``(pairs, 1,
    ...)`` against ``(pairs, expand, ...)`` states; returns ``(packed, pc,
    sm, img, level, gc)`` with ``img``, ``level``, ``gc`` in numpy."""
    from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device
    from repro_torch.data import graphs as port_graphs
    rng = np.random.default_rng(seed)
    graphs = [port_graphs.random_graph(rng, int(rng.integers(4, 8)),
                                       density=0.4, n_vlabels=3, n_elabels=2)
              for _ in range(pairs)]
    packed = pack_pairs([(g, port_graphs.perturb(rng, g, 2, n_vlabels=3,
                                                 n_elabels=2))
                         for g in graphs], slots=slots)
    pc = eb.make_pair_consts(*to_device(packed, "cpu")).unsqueeze(1)
    level = np.zeros((pairs, expand), np.int32)
    img = np.full((pairs, expand, slots), -1, np.int32)
    for p, n in enumerate(packed.n):
        for e in range(expand):
            level[p, e] = rng.integers(0, n)
            img[p, e, :level[p, e]] = rng.permutation(n)[:level[p, e]]
    gc = (rng.integers(0, 7, (pairs, expand)) * 0.5).astype(np.float32)
    sm = eb.state_masks(pc, T(img), T(level))
    return packed, pc, sm, img, level, gc


def test_lsa_kernel_operands_keep_ga_per_pair():
    """In the search's layout the ``lsa_children`` kernel operands carry
    ``ga`` once per pair and ``img_cl`` per state (no ``a_ju`` copy), and
    the fused bound of every state equals the reference's on that state."""
    pairs, expand, slots = 3, 4, 8
    packed, pc, sm, img, level, gc = _search_layout_states(
        9, pairs, expand, slots)
    flat, lead = eb.lsa_kernel_operands(pc, sm, T(level), T(gc))
    assert tuple(lead) == (pairs, expand) and len(flat) == 14
    assert flat[3].shape == (pairs, slots, slots)              # ga
    assert flat[4].shape == (pairs * expand, slots)            # img_cl
    assert all(x.shape[0] == pairs * expand
               for i, x in enumerate(flat) if i != 3)
    got = eb.lsa_children(pc, sm, T(level), T(gc), use_kernel=True)
    assert torch.equal(got, eb.lsa_children(pc, sm, T(level), T(gc),
                                            use_kernel=False))
    for p in range(pairs):
        rpc = ref_eb.make_pair_consts(
            *(jnp.asarray(getattr(packed, k)[p])
              for k in ("qv", "gv", "qa", "ga", "order", "n")),
            packed.n_vlabels, packed.n_elabels)
        for e in range(expand):
            rsm = ref_eb.state_masks(rpc, jnp.asarray(img[p, e]),
                                     jnp.int32(level[p, e]))
            want = ref_eb.lsa_children(rpc, rsm, jnp.int32(level[p, e]),
                                       jnp.float32(gc[p, e]),
                                       use_kernel=False)
            assert np.array_equal(_np(got[p, e]), np.asarray(want))


@pytest.mark.parametrize("slots", [8, 13])
def test_kernel_operand_histograms_are_label_major(slots):
    """The engine builds the (N, Le) histogram operands label-major (a
    transposed view of a contiguous (Le, N) per state), the layout the
    ``bma_cost_matrix`` and ``lsa_children`` kernels read, so the wrappers
    hand them over uncopied; every other operand is contiguous."""
    _, pc, sm, _, level, gc = _search_layout_states(slots, 3, 4, slots)
    lsa, _ = eb.lsa_kernel_operands(pc, sm, T(level), T(gc))
    bma, _ = eb.bma_kernel_operands(pc, sm)
    label_major = [lsa[2], bma[2], bma[3]]     # rowhist_g, inner_q, inner_g
    for h in label_major:
        assert h.shape == (12, slots, 2) and not h.is_contiguous()
        assert h.transpose(1, 2).is_contiguous()
    rest = [x for i, x in enumerate(lsa) if i != 2] + \
           [x for i, x in enumerate(bma) if i not in (2, 3)]
    assert all(x.is_contiguous() for x in rest)


# ------------------------------------------------------------------ auction

def _lams(seed, count=4):
    """BMa cost matrices of real engine states, stacked (S, N, N)."""
    rng = np.random.default_rng(seed)
    lams, rows = [], []
    for k in range(count):
        rpc, rsm, _, _, _ = _engine_state(rng, 8, 4 + k, k)
        lams.append(np.asarray(ref_eb.bma_cost_matrix(rpc, rsm,
                                                      use_kernel=False)))
        rows.append(int(rsm.vi))
    return np.stack(lams), np.asarray(rows, np.int32)


@pytest.mark.parametrize("seed,sweeps", [(0, 8), (2, 3)])
def test_auction_and_forced_bounds_match_reference(seed, sweeps):
    lam, rows = _lams(seed)
    rst = ref_auc.run_auction(jnp.asarray(lam), sweeps)
    st = auc.run_auction(T(lam), sweeps)
    assert_big_close(st.prices, rst.prices)
    assert np.array_equal(_np(st.row_to_col), np.asarray(rst.row_to_col))
    assert np.array_equal(_np(st.col_to_row), np.asarray(rst.col_to_row))
    prices = np.array(rst.prices)
    assert_big_close(
        auc.forced_dual_bounds(T(lam), T(prices), T(rows)),
        ref_auc.forced_dual_bounds(jnp.asarray(lam), jnp.asarray(prices),
                                   jnp.asarray(rows)))
    assert_big_close(auc.dual_bound(T(lam), T(prices)),
                     ref_auc.dual_bound(jnp.asarray(lam),
                                        jnp.asarray(prices)))
    assert np.array_equal(
        _np(auc.greedy_primal(T(lam), T(prices))),
        np.asarray(ref_auc.greedy_primal(jnp.asarray(lam),
                                         jnp.asarray(prices))))


def test_seq_sum_is_index_ordered():
    x = torch.tensor([[1e7, 0.5, 0.5, 0.5], [0.5, 0.5, 0.5, 1e7]])
    got = auc.seq_sum(x, -1)
    want = [np.float32(np.float32(np.float32(1e7) + np.float32(0.5))
                       + np.float32(0.5)) + np.float32(0.5),
            np.float32(1.5) + np.float32(1e7)]
    assert _np(got).tolist() == [float(w) for w in want]
    assert _np(auc.seq_sum(x.T, -2, keepdim=True)).shape == (1, 2)
