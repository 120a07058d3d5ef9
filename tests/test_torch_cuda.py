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
    (8, 3, 8, True), (24, 10, 24, True), (32, 20, 30, True),
    (16, 4, 16, False)])
def test_kernels_equal_their_twins(card, slots, n_lo, n_hi, edges):
    """Engine-state operands, a slot count that is not a power of two,
    and an edgeless batch (Le = 0)."""
    rng = np.random.default_rng(slots)
    pc, sm, level, g_cost = _states(_pairs(rng, 16, n_lo, n_hi, edges),
                                    slots, 4, rng, card)
    kops.reset_launch_counts()
    flat, _ = eb.lsa_kernel_operands(pc, sm, level, g_cost)
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
                ints(le + 1, b, n, n), ints(le + 1, b, n),
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
