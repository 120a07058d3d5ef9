"""The port's CUDA kernels and engine on the card (marker ``cuda``).

Every test here needs a GPU and the CUDA toolkit, and skips without them.
On a machine with a card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package: the card's
machine has neither.  The kernels are held to their plain PyTorch twins
with ``torch.equal`` (every term they compute is exact in f32), and the
engine's outcomes on the card to the same engine on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine import auction as auc  # noqa: E402
from repro_torch.core.engine import bounds as eb  # noqa: E402
from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device  # noqa: E402
from repro_torch.data.graphs import aids_like_graph, perturb, random_graph  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _pairs(rng, count, n_lo, n_hi, edges=True):
    out = []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi + 1))
        if edges:
            g = aids_like_graph(rng, n, n_vlabels=12, n_elabels=3)
            h = perturb(rng, g, int(rng.integers(1, 5)), n_vlabels=12,
                        n_elabels=3)
        else:   # edgeless on both sides: n_elabels == 0 once packed
            g = random_graph(rng, n, density=0.0, n_vlabels=5, n_elabels=1)
            h = g.copy()
            h.vlabels[:2] = rng.integers(0, 5, size=2)
        out.append((g, h))
    return out


def _states(pairs, slots, expand, rng, device):
    """Random search states on packed pairs, built with the engine's code."""
    packed = pack_pairs(pairs, slots=slots)
    pc = eb.make_pair_consts(*to_device(packed, device)).unsqueeze(1)
    img = np.full((len(pairs), expand, slots), -1, np.int32)
    level = np.zeros((len(pairs), expand), np.int32)
    for p, n in enumerate(packed.n):
        for e in range(expand):
            level[p, e] = rng.integers(0, n)
            img[p, e, :level[p, e]] = rng.permutation(n)[:level[p, e]]
    level_t = torch.as_tensor(level, device=device)
    sm = eb.state_masks(pc, torch.as_tensor(img, device=device), level_t)
    g_cost = torch.as_tensor(rng.integers(0, 9, level.shape) * 0.5,
                             dtype=torch.float32, device=device)
    return pc, sm, level_t, g_cost


@pytest.mark.parametrize("slots,n_lo,n_hi,edges", [
    (8, 3, 8, True), (16, 8, 15, True), (24, 10, 24, True),
    (32, 20, 30, True), (64, 40, 60, True), (16, 4, 16, False)])
def test_kernels_equal_their_twins(card, slots, n_lo, n_hi, edges):
    """Engine-state operands, a slot count that is not a power of two,
    and an edgeless batch (Le = 0)."""
    rng = np.random.default_rng(slots)
    pc, sm, level, g_cost = _states(_pairs(rng, 16, n_lo, n_hi, edges),
                                    slots, 4, rng, card)
    kops.reset_launch_counts()
    flat, _ = eb.lsa_kernel_operands(pc, sm, level, g_cost)
    assert flat[3].shape[0] == 16 and flat[4].shape[0] == 64   # ga per pair
    assert torch.equal(kops.lsa_children(*flat), ref.lsa_children_ref(*flat))
    flat, _ = eb.bma_kernel_operands(pc, sm)
    assert flat[0].shape[0] == 16 and flat[2].shape[0] == 64  # per pair
    lam = kops.bma_cost_matrix(*flat)
    assert torch.equal(lam, ref.bma_cost_matrix_ref(*flat))
    prices = auc.run_auction(lam, 8).prices
    for got, want in zip(kops.reduced_top2(lam, prices),
                         ref.reduced_top2_ref(lam, prices)):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    assert counts["lsa_children"] == 1 and counts["bma_cost_matrix"] == 1
    assert counts["reduced_top2"] == 7       # 6 auction sweeps + this call


@pytest.mark.parametrize("slots,n_lo,n_hi", [(13, 5, 13), (32, 20, 30)])
def test_kernels_read_label_major_and_contiguous_histograms(card, slots,
                                                            n_lo, n_hi):
    """The engine's histograms reach the kernels label-major and uncopied;
    contiguous (N, Le) copies of them give the same results, one launch a
    call either way."""
    rng = np.random.default_rng(slots + 1)
    pc, sm, level, g_cost = _states(_pairs(rng, 8, n_lo, n_hi), slots, 4,
                                    rng, card)
    lsa, _ = eb.lsa_kernel_operands(pc, sm, level, g_cost)
    bma, _ = eb.bma_kernel_operands(pc, sm)
    assert all(h.transpose(1, 2).is_contiguous()
               for h in (lsa[2], bma[2], bma[3]))
    want_lsa = ref.lsa_children_ref(*lsa)
    want_bma = ref.bma_cost_matrix_ref(*bma)
    for layout in (lambda x: x, lambda x: x.contiguous()):
        kops.reset_launch_counts()
        assert torch.equal(kops.lsa_children(*map(layout, lsa)), want_lsa)
        assert torch.equal(kops.bma_cost_matrix(*map(layout, bma)), want_bma)
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        assert counts["lsa_children"] == 1 and counts["bma_cost_matrix"] == 1


def test_kernels_at_a_large_slot_count(card):
    """N = 400: rows longer than a warp, and more than 48 KB of shared
    memory for bma_cost_matrix's staged gather (the opt-in launch path)."""
    g = torch.Generator(device="cpu").manual_seed(3)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g).to(card, torch.int32)

    def halves(hi, *shape):
        return (torch.randint(0, hi, shape, generator=g) * 0.5).to(card)

    b, n, le = 2, 400, 3
    bma_args = [ints(5, b, n), ints(5, b, n), halves(6, b, n, le),
                halves(6, b, n, le), ints(le + 1, b, n, n),
                ints(le + 1, b, n, n), ints(n, b, n), ints(2, b, n).float()]
    assert torch.equal(kops.bma_cost_matrix(*bma_args),
                       ref.bma_cost_matrix_ref(*bma_args))
    lsa_args = [halves(9, b, n), ints(2, b, n).float(), halves(4, b, n, le),
                ints(le + 1, b, n, n), ints(n, b, n), ints(le + 1, b, n),
                ints(2, b, n).float(), halves(4, b, n, le),
                halves(4, b, n, le), halves(6, b, n), halves(6, b, n),
                halves(8, b, le), halves(8, b, le), halves(4, b, le)]
    assert torch.equal(kops.lsa_children(*lsa_args),
                       ref.lsa_children_ref(*lsa_args))
    cost, prices = halves(20, b, n, n), halves(20, b, n)
    for got, want in zip(kops.reduced_top2(cost, prices),
                         ref.reduced_top2_ref(cost, prices)):
        assert torch.equal(got, want)


def test_bma_cost_matrix_per_pair_operands_equal_copies(card):
    """Per-pair operands read once per pair give the result of the same
    operands copied to every state (3 states per pair, a ragged u tile)."""
    g = torch.Generator(device="cpu").manual_seed(5)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g).to(card, torch.int32)

    pairs, expand, n, le = 5, 3, 40, 3
    b = pairs * expand
    args = [ints(5, pairs, n), ints(5, pairs, n),
            ints(4, b, n, le).float(), ints(4, b, n, le).float(),
            ints(le + 1, pairs, n, n), ints(le + 1, pairs, n, n),
            ints(n, b, n), ints(2, b, n).float()]
    copies = [x.repeat_interleave(expand, 0) if i in (0, 1, 4, 5) else x
              for i, x in enumerate(args)]
    assert torch.equal(kops.bma_cost_matrix(*args),
                       kops.bma_cost_matrix(*copies))
    assert torch.equal(kops.bma_cost_matrix(*args),
                       ref.bma_cost_matrix_ref(*copies))


def _bma_operands(g, pairs, expand, n, le, device, labels=None,
                  pos=(0.0, 1.0)):
    """bma_cost_matrix operands, per-pair rows for qv/gv/qa_ord/ga: edge
    labels from ``labels`` (default 0..Le), pos_anch from ``pos``."""
    lo, hi = labels or (0, le + 1)
    b = pairs * expand

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g).to(torch.int32)

    pa = torch.tensor(pos)[torch.randint(0, len(pos), (b, n), generator=g)]
    args = [ints(0, 5, pairs, n), ints(0, 5, pairs, n),
            ints(0, 6, b, n, le) * 0.5, ints(0, 6, b, n, le) * 0.5,
            ints(lo, hi, pairs, n, n), ints(lo, hi, pairs, n, n),
            ints(0, n, b, n), pa]
    return [x.to(device) for x in args]


BMA_GENERAL = {
    # (pairs, expand, n, le, labels, pos_anch values)
    "pos_anch_halves": (6, 8, 32, 3, None, (0.0, 0.5, 1.0)),
    "pos_anch_two": (6, 8, 32, 3, None, (0.0, 1.0, 2.0)),
    "negative_labels": (6, 8, 32, 3, (-2, 4), (0.0, 1.0)),
    "labels_above_le": (6, 8, 64, 3, (0, 7), (0.0, 1.0)),
    "above_mask_budget": (3, 4, 40, 8, None, (0.0, 1.0)),
    "le0_labels_above": (6, 4, 24, 0, (0, 2), (0.0, 1.0)),
}


@pytest.mark.parametrize("kind", sorted(BMA_GENERAL))
def test_bma_cost_matrix_general_path_equals_its_twin(card, kind):
    """Inputs the bitmask path cannot count exactly (pos_anch other than
    0/1, labels outside 0..Le, (Le + 1) * ceil(N / 32) above the mask
    budget): the blocks take the ordered loop inside the same single
    launch and still equal the twin."""
    pairs, expand, n, le, labels, pos = BMA_GENERAL[kind]
    g = torch.Generator(device="cpu").manual_seed(len(kind))
    args = _bma_operands(g, pairs, expand, n, le, card, labels, pos)
    kops.reset_launch_counts()
    got = kops.bma_cost_matrix(*args)
    torch.cuda.synchronize()
    assert kops.launch_counts()["bma_cost_matrix"] == 1
    assert torch.equal(got, ref.bma_cost_matrix_ref(*args))


@pytest.mark.parametrize("n", [8, 32, 64])
def test_bma_cost_matrix_mixes_both_paths_in_one_launch(card, n):
    """One batch where some pairs' states hold a half pos_anch or a label
    above Le (the ordered loop) and the rest count with bitmasks."""
    g = torch.Generator(device="cpu").manual_seed(n)
    pairs, expand, le = 8, 4, 3
    args = _bma_operands(g, pairs, expand, n, le, card)
    args[7][3 * expand + 1, n // 2] = 0.5          # pair 3, one state
    args[5][5, 0, n - 1] = le + 2                  # pair 5's ga
    args[4][6, n - 1, 0] = -1                      # pair 6's qa_ord
    kops.reset_launch_counts()
    got = kops.bma_cost_matrix(*args)
    torch.cuda.synchronize()
    assert kops.launch_counts()["bma_cost_matrix"] == 1
    assert torch.equal(got, ref.bma_cost_matrix_ref(*args))


@pytest.mark.parametrize("n", [1, 31, 33, 400])
@pytest.mark.parametrize("expand", [1, 8])
def test_lsa_children_reads_ga_per_pair(card, n, expand):
    """``ga`` one row per pair gathered by ``img_cl`` inside the kernel:
    one state per pair or eight; N = 1, around a warp, and N = 400 (a
    ga tile above the default 48 KB of shared memory); labels outside
    1..Le in the mix; one launch."""
    g = torch.Generator(device="cpu").manual_seed(n * 10 + expand)
    pairs, le = 3, 3
    b = pairs * expand

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g).to(card, torch.int32)

    def halves(hi, *shape):
        return (torch.randint(0, hi, shape, generator=g) * 0.5).to(card)

    args = [halves(9, b, n), ints(0, 2, b, n).float(), halves(4, b, n, le),
            ints(-1, le + 3, pairs, n, n), ints(0, n, b, n),
            ints(-1, le + 3, b, n), ints(0, 2, b, n).float(),
            halves(4, b, n, le), halves(4, b, n, le), halves(6, b, n),
            halves(6, b, n), halves(8, b, le), halves(8, b, le),
            halves(4, b, le)]
    kops.reset_launch_counts()
    got = kops.lsa_children(*args)
    torch.cuda.synchronize()
    assert kops.launch_counts()["lsa_children"] == 1
    assert torch.equal(got, ref.lsa_children_ref(*args))


def test_reduced_top2_ties_and_one_column_rows(card):
    cost = torch.zeros(3, 5, 5, device=card)
    cost[1] = 1e7
    prices = torch.zeros(3, 5, device=card)
    for got, want in zip(kops.reduced_top2(cost, prices),
                         ref.reduced_top2_ref(cost, prices)):
        assert torch.equal(got, want)
    one = torch.rand(4, 1, 1, device=card)
    for got, want in zip(kops.reduced_top2(one, torch.zeros(4, 1, device=card)),
                         ref.reduced_top2_ref(one, torch.zeros(4, 1,
                                                               device=card))):
        assert torch.equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    cost = torch.zeros(2, 4, 4, device=card)
    with pytest.raises(TypeError, match="float32"):
        kops.reduced_top2(cost.double(), torch.zeros(2, 4, device=card))
    with pytest.raises(ValueError, match="shapes"):
        kops.reduced_top2(cost, torch.zeros(2, 3, device=card))
    with pytest.raises(ValueError, match="several devices"):
        kops.reduced_top2(cost, torch.zeros(2, 4))


@pytest.mark.parametrize("verification", [False, True])
def test_card_outcomes_equal_cpu_outcomes(card, verification):
    rng = np.random.default_rng(7)
    pairs = _pairs(rng, 12, 4, 14)
    cfg = dict(pool=128, expand=4, max_iters=64)

    def run(backend, device):
        eng = ged.GedEngine(backend, device=device, **cfg)
        return eng.verify(pairs, 2.0) if verification else eng.compute(pairs)

    want = run("torch", "cpu")
    for backend in ("cuda", "torch"):
        for a, b in zip(run(backend, card), want):
            assert (a.ged, a.similar, a.certified, a.lower_bound,
                    a.upper_bound, a.stats) == \
                (b.ged, b.similar, b.certified, b.lower_bound,
                 b.upper_bound, b.stats)


def test_cached_repeat_launches_no_kernel(card, monkeypatch):
    """On ``"cuda"`` with the result cache on, the first ``compute``
    launches the kernels and the second is answered from the cache with
    no launch at all, equal to the first (``"cached"`` added)."""
    monkeypatch.delenv("REPRO_GED_SHARED_CACHE_DIR", raising=False)
    pairs = _pairs(np.random.default_rng(9), 12, 4, 14)
    eng = ged.GedEngine("cuda", device=card, cache=True, pool=128,
                        expand=4, max_iters=64)
    kops.reset_launch_counts()
    first = eng.compute(pairs)
    assert kops.launch_counts()["bma_cost_matrix"] > 0
    kops.reset_launch_counts()
    second = eng.compute(pairs)
    assert set(kops.launch_counts().values()) == {0}
    assert eng.stats["result_cache_hits"] == len(pairs)
    for a, b in zip(first, second):
        assert b.stats.pop("cached") is True
        assert (a.ged, a.similar, a.certified, a.lower_bound,
                a.upper_bound, a.stats) == \
            (b.ged, b.similar, b.certified, b.lower_bound, b.upper_bound,
             b.stats)
        assert (a.mapping is None and b.mapping is None) or \
            np.array_equal(a.mapping, b.mapping)


MERGE_SHAPES = [(252, 128), (1016, 256), (4088, 256), (1016, 512),
                (4088, 512), (100, 700), (0, 5), (7, 0)]


@pytest.mark.parametrize("na,nb", MERGE_SHAPES)
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "ties_inf_big"])
def test_merge_ranks_equals_its_twin(card, na, nb, kind):
    """The escalation rungs' (pool - expand, expand x slots) shapes at
    N = 32 and 64, NB above NA, empty runs; unsorted runs, ties, +inf,
    the engine's INF = 3e8 and signed zeros."""
    g = torch.Generator(device="cpu").manual_seed(na * 7 + nb)
    a = torch.randint(0, 50, (37, na), generator=g).float()
    b = torch.randint(0, 50, (37, nb), generator=g).float()
    if kind == "sorted":
        a, b = a.sort(1).values, b.sort(1).values
    elif kind == "ties_inf_big":
        a[:, ::2], b[:, ::2] = 3.0, 3.0
        a[:, 1::5], b[:, 1::5] = float("inf"), float("inf")
        a[:, 3::7], b[:, 3::7] = 3.0e8, 3.0e8
        a[:, 4::9], b[:, 4::9] = -0.0, 0.0
    a, b = a.to(card), b.to(card)
    kops.reset_launch_counts()
    got = kops.merge_ranks(a, b)
    torch.cuda.synchronize()
    for x, y in zip(got, ref.merge_ranks_ref(a, b)):
        assert x.dtype == torch.int32 and torch.equal(x, y)
    assert kops.launch_counts()["merge_ranks"] == (1 if na + nb else 0)
    one = kops.merge_ranks(a[0], b[0])
    assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[1][0])


@pytest.mark.parametrize("verification", [False, True])
def test_auto_card_outcomes_equal_cpu_outcomes(card, verification):
    """The default ``"auto"`` backend with every family fused (the merge
    kernel included) on the card gives the CPU's outcomes."""
    rng = np.random.default_rng(11)
    pairs = _pairs(rng, 12, 4, 14)

    def run(device, **kw):
        eng = ged.GedEngine(device=device, **kw)
        eng._backend.scheduler.rungs = ((16, 2, 8), (64, 4, 32))
        return eng.verify(pairs, 2.0) if verification else eng.compute(pairs)

    want = run("cpu")
    kops.reset_launch_counts()
    got = run(card, dispatch=ged.KernelDispatch(
        lsa_fused=True, bma_fused=True, merge_fused=True))
    assert kops.launch_counts()["merge_ranks"] > 0
    for a, b in zip(got, want):
        assert (a.ged, a.similar, a.certified, a.lower_bound,
                a.upper_bound, a.backend, a.stats["rung"]) == \
            (b.ged, b.similar, b.certified, b.lower_bound, b.upper_bound,
             b.backend, b.stats["rung"])


def _top2_operands(b, n, device, seed, offset=0):
    """Reduced-cost operands with ties everywhere (costs in {0, 1, 2}):
    tied minima straddle every lane boundary (columns 7/8, 15/16, 31/32,
    63/64 share the row minimum) and consecutive rows are copies, so ties
    also straddle row groups; plus all-+inf rows and 1e7 entries.  With
    ``offset`` both start that many floats into a buffer (not 16-byte
    aligned)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cost = torch.randint(0, 3, (b, n, n), generator=g).float()
    for j in (7, 15, 31, 63):
        if j + 1 < n:
            cost[:, 1::3, j:j + 2] = -1.0
    cost[:, 2::3] = cost[:, 1::3][:, : cost[:, 2::3].shape[1]]
    cost[::4, 0] = float("inf")
    cost[1::4, ::5, ::2] = 1.0e7
    prices = torch.randint(0, 2, (b, n), generator=g).float()
    prices[::3] = 0.0
    out = []
    for x in (cost, prices):
        buf = torch.empty(x.numel() + offset, device=device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        out.append(view)
    return out


@pytest.mark.parametrize("n", [1, 2, 16, 31, 33, 64, 128])
@pytest.mark.parametrize("b", [1, 37])
@pytest.mark.parametrize("offset", [0, 1])
def test_reduced_top2_single_pass_equals_its_twin(card, n, b, offset):
    """Every width class of the one-pass kernel (several states per warp,
    one state per warp, states shared among warps), float4 and scalar
    loads, B not a multiple of the rows a block takes; one launch."""
    cost, prices = _top2_operands(b, n, card, seed=n * 10 + b, offset=offset)
    assert cost.is_contiguous() and cost.data_ptr() % 16 == 4 * offset
    kops.reset_launch_counts()
    got = kops.reduced_top2(cost, prices)
    torch.cuda.synchronize()
    assert kops.launch_counts()["reduced_top2"] == 1
    for x, y in zip(got, ref.reduced_top2_ref(cost, prices)):
        assert torch.equal(x, y)


def _mixed_runs(b, na, nb, seed):
    """Rows by index mod 6: both runs sorted; both unsorted; sorted with
    signed zeros in either order and +inf/3e8 tails; only keys_a sorted;
    only keys_b sorted; sorted with a NaN tail."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pool = torch.tensor([-2.0, -0.0, 0.0, 1.0, 4.0, 3.0e8, float("inf")])
    a = torch.randint(0, 64, (b, na), generator=g).float()
    k = torch.randint(0, 64, (b, nb), generator=g).float()
    a[2::6] = pool[torch.randint(0, len(pool), a[2::6].shape, generator=g)]
    k[2::6] = pool[torch.randint(0, len(pool), k[2::6].shape, generator=g)]
    kind = (torch.arange(b) % 6)[:, None]
    a = torch.where((kind != 1) & (kind != 4), a.sort(1).values, a)
    k = torch.where((kind != 1) & (kind != 3), k.sort(1).values, k)
    a[5::6, -1] = float("nan")
    k[5::6, -1] = float("nan")
    return a, k


@pytest.mark.parametrize("na,nb", [(1016, 256), (4088, 512), (100, 700),
                                   (20000, 256), (256, 20000)])
def test_merge_ranks_mixed_rows_equal_its_twin(card, na, nb):
    """One batch mixes rows the kernel binary-searches with rows it counts;
    NA or NB = 20,000 is longer than the kernel stages in shared memory."""
    a, b = (x.to(card) for x in _mixed_runs(24, na, nb, seed=na + nb))
    kops.reset_launch_counts()
    got = kops.merge_ranks(a, b)
    torch.cuda.synchronize()
    assert kops.launch_counts()["merge_ranks"] == 1
    for x, y in zip(got, ref.merge_ranks_ref(a, b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("na,nb", [(1016, 256), (20000, 256), (256, 20000)])
def test_merge_ranks_sorted_signed_zeros_equal_its_twin(card, na, nb):
    """NaN-free sorted runs of few distinct keys: -0.0 and 0.0 in either
    order inside one run, long ties, +inf and 3e8 tails; the binary search
    must give the comparison counts exactly."""
    g = torch.Generator(device="cpu").manual_seed(na * 3 + nb)
    pool = torch.tensor([-1.0, -0.0, 0.0, 2.0, 3.0e8, float("inf")])
    a = pool[torch.randint(0, len(pool), (9, na), generator=g)].sort(1).values
    b = pool[torch.randint(0, len(pool), (9, nb), generator=g)].sort(1).values
    zeros = a == 0
    assert (zeros & a.signbit()).any() and (zeros & ~a.signbit()).any()
    a, b = a.to(card), b.to(card)
    kops.reset_launch_counts()
    got = kops.merge_ranks(a, b)
    torch.cuda.synchronize()
    assert kops.launch_counts()["merge_ranks"] == 1
    for x, y in zip(got, ref.merge_ranks_ref(a, b)):
        assert torch.equal(x, y)


# ------------------------------------------------- deadlines and faults

def _fields(o):
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.stats)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_roomy_deadline_changes_no_outcome_and_no_launch(card, backend):
    """``deadline_s=3600`` on the card: the same outcomes and the same
    launch counts as the same engine without a deadline, and no
    robustness counter in the stats."""
    pairs = _pairs(np.random.default_rng(21), 12, 4, 14)
    cfg = dict(cache=False, pool=128, expand=4, max_iters=64)
    if backend == "auto":
        cfg = dict(cache=False, use_kernel=True)
    runs = []
    for extra in ({}, {"deadline_s": 3600.0}):
        eng = ged.GedEngine(backend, device=card, **cfg, **extra)
        kops.reset_launch_counts()
        outs = eng.compute(pairs) + eng.verify(pairs, 2.0)
        runs.append((outs, kops.launch_counts(), eng.stats))
    (plain, plain_n, _), (roomy, roomy_n, stats) = runs
    assert plain_n == roomy_n and plain_n["reduced_top2"] > 0
    assert [_fields(o) for o in plain] == [_fields(o) for o in roomy]
    assert not any(o.timed_out or o.degraded for o in roomy)
    assert not [k for k in stats if k.removeprefix("executor_").startswith(
        ("retries", "fault_", "degraded_", "timed_out_pairs"))]


def test_kernel_fault_launches_nothing_and_host_solves(card):
    """``kernel@times=inf`` on ``"cuda"``: the kernel site fires before
    any launch, so no kernel runs on the card; every bucket goes to the
    host solver (``degraded_host``), whose answers are certified and
    equal the clean run's."""
    pairs = _pairs(np.random.default_rng(22), 8, 4, 12)
    cfg = dict(cache=False, pool=128, expand=4, max_iters=64)
    clean = ged.GedEngine("cuda", device=card, **cfg).compute(pairs)
    eng = ged.GedEngine("cuda", device=card, fault_inject="kernel@times=inf",
                        **cfg)
    kops.reset_launch_counts()
    outs = eng.compute(pairs)
    assert set(kops.launch_counts().values()) == {0}
    assert eng.stats["degraded_host"] == len(pairs)
    assert "degraded_kernel" not in eng.stats
    for a, b in zip(clean, outs):
        assert b.certified and b.degraded
        if a.certified:
            assert a.ged == b.ged


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_kernel_build_failure_raises_on_the_card(card, backend,
                                                 monkeypatch):
    """A kernel library that does not build is a real failure, not a
    fault to degrade: ``compute`` raises, and no pair goes to the host
    solver."""
    from repro_torch.kernels import _build

    def no_library():
        raise RuntimeError("nvcc failed for ['lsa_children.cu']")

    monkeypatch.setattr(_build, "library", no_library)
    pairs = _pairs(np.random.default_rng(24), 4, 4, 12)
    eng = ged.GedEngine(backend, device=card, cache=False, use_kernel=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.compute(pairs)
    assert "degraded_host" not in eng.stats


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_expired_deadline_launches_nothing(card, backend):
    """``deadline_s=0`` on the card: every pair answers timed out with the
    admissible floor, and no kernel is launched."""
    pairs = _pairs(np.random.default_rng(23), 8, 4, 12)
    eng = ged.GedEngine(backend, device=card, cache=False, deadline_s=0.0)
    kops.reset_launch_counts()
    outs = eng.compute(pairs) + eng.verify(pairs, 2.0)
    assert set(kops.launch_counts().values()) == {0}
    assert all(o.timed_out and not o.certified for o in outs)
    assert eng.stats["timed_out_pairs"] == 2 * len(pairs)


def _store_corpus(seed, count, queries):
    """AIDS-like graphs (62 vertex labels) with n in [8, 15) and seven
    planted near-duplicates of each of the first ``queries`` graphs, so
    ``top_k(4)``'s eight sketch-nearest seeds are all near graphs."""
    rng = np.random.default_rng(seed)
    graphs = [aids_like_graph(rng, int(rng.integers(8, 15)), n_vlabels=62,
                              n_elabels=3) for _ in range(count)]
    for qi in range(queries):
        for _ in range(7):
            graphs.append(perturb(rng, graphs[qi], int(rng.integers(1, 4)),
                                  n_vlabels=62, n_elabels=3))
    return graphs


def test_store_on_the_card_launches_every_kernel_and_equals_cpu(card):
    """A corpus store with every kernel family fused: stage 1 and stage 2
    launch all four kernels on the card, and the hits, the signatures and
    the stage-0 bounds equal the same store's on the CPU."""
    corpus = _store_corpus(40, 120, 4)
    fused = ged.KernelDispatch(lsa_fused=True, bma_fused=True,
                               merge_fused=True)
    opts = dict(use_kernel=True, dispatch=fused, cache=False, pool=256,
                expand=4, max_iters=256, batch_size=8)
    on_card = ged.GraphStore(corpus, device=card, **opts)
    on_cpu = ged.GraphStore(corpus, device="cpu", **opts)
    assert np.array_equal(on_card._cindex.sigs, on_cpu._cindex.sigs)
    queries = corpus[:4]

    def rows(hits):
        return [(h.graph_id, h.stage, h.ged, h.similar, h.certified,
                 h.lower_bound, h.upper_bound) for h in hits]

    kops.reset_launch_counts()
    got = [rows(h) for h in on_card.search_batch(queries, 3.0)]
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    assert all(v > 0 for v in launches.values()), launches
    assert got == [rows(h) for h in on_cpu.search_batch(queries, 3.0)]
    assert all(len(h) >= 4 for h in got)           # query + planted
    assert on_card.stats["stage1_decided"] > 0
    for q in queries[:2]:
        assert rows(on_card.top_k(q, 4)) == rows(on_cpu.top_k(q, 4))
        assert np.array_equal(on_card._index.scan(q), on_cpu._index.scan(q))


# ------------------------------------------------ multi-device placement

def _mesh(card, shards=2):
    """``shards`` entries per visible card: two shards on the one card of
    a one-card machine, a real split where there are more."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())] * shards


@pytest.mark.parametrize("verification", [False, True])
def test_sharded_and_auto_mesh_on_the_card_equal_cpu(card, verification):
    """``"sharded"`` and ``"auto"`` on a card mesh, every family fused:
    batches pad to the mesh, all four kernels launch, and the outcomes
    equal the single-device CPU run's.  ``"sharded"`` on one card takes
    the fast path."""
    rng = np.random.default_rng(13)
    pairs = _pairs(rng, 11, 4, 14)
    fused = ged.KernelDispatch(lsa_fused=True, bma_fused=True,
                               merge_fused=True)
    mesh = _mesh(card)

    def run(backend, **kw):
        eng = ged.GedEngine(backend, cache=False, dispatch=fused, **kw)
        if backend == "auto":
            eng._backend.scheduler.rungs = ((16, 2, 8), (64, 4, 32))
        outs = eng.verify(pairs, 2.0) if verification \
            else eng.compute(pairs)
        return outs, eng

    for backend, single in (("auto", "auto"), ("sharded", "torch")):
        want, _ = run(single, device="cpu")
        kops.reset_launch_counts()
        got, eng = run(backend, mesh=mesh)
        torch.cuda.synchronize()
        assert eng.batch_multiple == len(mesh)
        assert all(v > 0 for v in kops.launch_counts().values())
        assert eng.stats["executor_single_device_fastpath"] == 0
        for a, b in zip(got, want):
            assert (a.ged, a.similar, a.certified, a.lower_bound,
                    a.upper_bound, a.stats) == \
                (b.ged, b.similar, b.certified, b.lower_bound,
                 b.upper_bound, b.stats)
    one = ged.GedEngine("sharded", device="cuda:0", cache=False)
    one.compute(pairs[:2])
    assert one.batch_multiple == 1
    assert one.stats["executor_single_device_fastpath"] == \
        one.stats["executor_calls"] > 0


def test_a_launch_under_a_device_context_reaches_that_device(card):
    """Each card's shard launches on that card, on its current stream."""
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        with torch.cuda.device(d):
            cost = torch.rand(64, 32, 32, device=d)
            prices = torch.rand(64, 32, device=d)
            kops.reset_launch_counts()
            got = kops.reduced_top2(cost, prices)
            torch.cuda.current_stream(d).synchronize()
        assert kops.launch_counts()["reduced_top2"] == 1
        assert all(t.device == d for t in got)
        want = ref.reduced_top2_ref(cost.cpu(), prices.cpu())
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_store_on_a_card_mesh_equals_cpu(card):
    """``GraphStore(mesh=...)`` on the card: feature buckets split per
    shard, signatures byte-equal, hits equal to the CPU store's."""
    corpus = _store_corpus(41, 90, 3)
    opts = dict(cache=False, pool=256, expand=4, max_iters=256,
                batch_size=8)
    mesh = _mesh(card)
    on_mesh = ged.GraphStore(corpus, mesh=mesh, **opts)
    on_cpu = ged.GraphStore(corpus, device="cpu", **opts)
    assert all({sh[0].shape[0] for sh in b.shards}
               == {-(-len(b.ids) // len(mesh))}
               for b in on_mesh._index.buckets)
    assert on_mesh._cindex.sigs.tobytes() == on_cpu._cindex.sigs.tobytes()

    def rows(hits):
        return [(h.graph_id, h.stage, h.ged, h.similar, h.certified,
                 h.lower_bound, h.upper_bound) for h in hits]

    queries = corpus[:3]
    assert [rows(h) for h in on_mesh.search_batch(queries, 3.0)] == \
        [rows(h) for h in on_cpu.search_batch(queries, 3.0)]


def test_verification_service_on_the_card_equals_cpu(card):
    """The serving layer on the card with the kernels: answers equal the
    CPU service's, and repeats are cache hits that launch nothing."""
    from repro_torch.serving import GedRequest, GedVerificationService
    rng = np.random.default_rng(17)
    reqs = [GedRequest(q, g, tau=3.0) for q, g in _pairs(rng, 12, 4, 14)]
    want = GedVerificationService(device="cpu", batch_size=8,
                                  slots=16).verify(reqs)
    svc = GedVerificationService(batch_size=8, slots=16, use_kernel=True)
    kops.reset_launch_counts()
    got = svc.verify(reqs)
    torch.cuda.synchronize()
    assert kops.launch_counts()["bma_cost_matrix"] > 0
    for a, b in zip(got, want):
        assert (a.similar, a.certified, a.lower_bound, a.upper_bound) == \
            (b.similar, b.certified, b.lower_bound, b.upper_bound)
    kops.reset_launch_counts()
    again = svc.verify(reqs)
    assert all(o.stats.get("cached") for o in again)
    assert sum(kops.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "nemotron-4-15b", "qwen2-72b",
                                  "qwen2-vl-2b", "qwen3-8b"])
def test_lm_generate_on_the_card_equals_cpu(card, arch):
    """The LM serving path on the card (reduced config, f32 compute, the
    same weights as the CPU run): prefill logits within rtol 1e-4, every
    cache within one bf16 step (2**-7 of the value), and ``generate``'s
    tokens equal."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.params import init_params, params_from_numpy
    from repro_torch.serving import generate
    base = get_arch(arch)
    cfg = dataclasses.replace(
        reduced(base, layers=3 if base.window_pattern else 2),
        remat="none", compute_dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = params_from_numpy(cpu)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    patches = None
    if cfg.vlm is not None:
        patches = (rng.normal(size=(2, cfg.vlm.num_patches, cfg.d_model))
                   * 0.02).astype(np.float32)
    with torch.no_grad():
        lc, cc = T.prefill_step(cpu, prompt, cfg, patches=patches,
                                impl="naive")
        lg, cg = T.prefill_step(gpu, prompt, cfg, patches=patches,
                                impl="naive")
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
    for key in cc:
        torch.testing.assert_close(cg[key].cpu().float(), cc[key].float(),
                                   rtol=2.0 ** -7, atol=1e-5)
    want = generate(cpu, prompt, cfg, max_new=4, patches=patches,
                    impl="naive", device="cpu")
    got = generate(gpu, prompt, cfg, max_new=4, patches=patches,
                   impl="naive")
    assert np.array_equal(got, want)
