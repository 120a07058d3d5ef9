"""The port's packing, frontier primitives and search engine against the
JAX reference.

Inputs come from numpy with a seed.  Packed arrays must be byte-equal to
the reference's; the merge primitives bit-identical; and the engine's
output dict (``ged``/``similar``, ``exact``, ``lower_bound``,
``upper_bound``, ``iterations``, ``expanded``, ``best_img``, ``floor``)
equal to ``repro.core.engine.api.dispatch_packed``'s on the identical
packed input (``tensor_graphs.from_reference``), for A*/DFS, computation
and verification, every bound family, kernels on and off, the merge kernel
included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine.api import dispatch_packed as ref_dispatch  # noqa: E402
from repro.core.engine.search import EngineConfig as RefConfig  # noqa: E402
from repro.kernels.autotune import KernelDispatch as RefDispatch  # noqa: E402
from repro.core.engine.tensor_graphs import label_vocab as ref_vocab  # noqa: E402
from repro.core.engine.tensor_graphs import pack_pairs as ref_pack  # noqa: E402
from repro.data.graphs import aids_like_graph, perturb, random_graph  # noqa: E402
from repro.parallel.ops import merge_sorted_topk as ref_merge  # noqa: E402
from repro.parallel.ops import sort_by_key as ref_sort  # noqa: E402

from repro_torch.core.engine.api import dispatch_packed  # noqa: E402
from repro_torch.core.engine.search import EngineConfig, run_batch  # noqa: E402
from repro_torch.core.engine.tensor_graphs import (from_reference,  # noqa: E402
                                                   label_vocab, pack_pairs,
                                                   to_device)
from repro_torch.core.exact.graph import Graph  # noqa: E402
from repro_torch.kernels.autotune import KernelDispatch  # noqa: E402
from repro_torch.parallel.ops import merge_sorted_topk, sort_by_key  # noqa: E402

FIELDS = ("qv", "gv", "qa", "ga", "order", "n")


def _pairs(seed, count, n_lo, n_hi):
    """Mixed AIDS-like and dense random pairs (reference generators)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(n_lo, n_hi + 1))
        if i % 2:
            g = random_graph(rng, n, density=0.4, n_vlabels=3, n_elabels=2)
            h = perturb(rng, g, int(rng.integers(0, 5)), n_vlabels=3,
                        n_elabels=2)
        else:
            g = aids_like_graph(rng, n, n_vlabels=8, n_elabels=3)
            h = perturb(rng, g, int(rng.integers(1, 5)), n_vlabels=8,
                        n_elabels=3)
        if i == 3:   # a pair of different sizes: BOTTOM padding in q
            h = aids_like_graph(rng, max(1, n - 2), n_vlabels=8, n_elabels=3)
        out.append((g, h))
    return out


def _port_graphs(pairs):
    return [(Graph(q.vlabels, q.adj), Graph(g.vlabels, g.adj))
            for q, g in pairs]


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("seed,slots,use_vocab", [(0, None, False),
                                                  (1, 16, False),
                                                  (2, 8, True)])
def test_pack_pairs_byte_equal_to_reference(seed, slots, use_vocab):
    pairs = _pairs(seed, 6, 2, 8)
    vocab = None
    if use_vocab:
        vv, ee = ref_vocab(pairs)
        vocab = (vv + (99,), ee + (7,))     # a superset vocab is allowed
    want = ref_pack(pairs, slots=slots, vocab=vocab)
    got = pack_pairs(_port_graphs(pairs), slots=slots, vocab=vocab)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (got.n_vlabels, got.n_elabels) == (want.n_vlabels, want.n_elabels)
    assert label_vocab(_port_graphs(pairs)) == ref_vocab(pairs)


def test_pack_pairs_rejects_uncovered_vocab_and_small_slots():
    pairs = _port_graphs(_pairs(3, 2, 5, 6))
    with pytest.raises(ValueError, match="vocab does not cover"):
        pack_pairs(pairs, vocab=((0,), ()))
    with pytest.raises(ValueError, match="does not fit"):
        pack_pairs(pairs, slots=4)


def test_from_reference_and_to_device_carry_the_batch():
    want = ref_pack(_pairs(4, 3, 3, 7))
    got = from_reference(want)
    for f in FIELDS:
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
    dev = to_device(got, "cpu")
    assert all(getattr(dev, f).dtype == torch.int32 for f in FIELDS)
    assert np.array_equal(dev.qa.numpy(), want.qa)
    assert (dev.n_vlabels, dev.n_elabels) == (want.n_vlabels, want.n_elabels)


# ------------------------------------------------------ frontier primitives

def _ref_merge_rows(a, b, pa, pb, keep, da, db, perm, use_kernel=False):
    outs = [ref_merge(jnp.asarray(a[i]), jnp.asarray(b[i]),
                      jnp.asarray(pa[i]), jnp.asarray(pb[i]), keep,
                      drop_a=jnp.asarray(da[i]), drop_b=jnp.asarray(db[i]),
                      perm_b=None if perm is None else jnp.asarray(perm[i]),
                      use_kernel=use_kernel)
            for i in range(a.shape[0])]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(3)]


MERGE_CASES = ["overflow", "all_ties", "inf_runs", "perm_b", "short_a"]


def _merge_case(case):
    """Runs, payloads and drop values of one merge case (numpy)."""
    rng = np.random.default_rng(MERGE_CASES.index(case))
    rows, na, nb, keep, w = 3, 12, 10, 9, 4
    if case == "short_a":
        na, keep = 0, 6
    a = np.sort(rng.integers(0, 6, (rows, na)), axis=1).astype(np.float32)
    b_raw = rng.integers(0, 6, (rows, nb)).astype(np.float32)
    if case == "all_ties":
        a[:] = 2.0
        b_raw[:] = 2.0
    if case == "inf_runs":
        a[:, na // 2:] = np.inf
        b_raw[:, ::2] = np.inf
    pa = rng.integers(0, 99, (rows, na, w)).astype(np.int32)
    pb = rng.integers(100, 199, (rows, nb, w)).astype(np.int32)
    da = (a + 0.5).astype(np.float32)
    db = (b_raw + 0.25).astype(np.float32)
    if case == "perm_b":
        b = np.stack([np.sort(r, kind="stable") for r in b_raw])
        perm = np.stack([np.argsort(r, kind="stable") for r in b_raw])
        return a, b, pa, pb, keep, da, db, perm
    order = np.argsort(b_raw, axis=1, kind="stable")
    return (a, np.take_along_axis(b_raw, order, 1), pa,
            np.take_along_axis(pb, order[..., None], 1), keep, da,
            np.take_along_axis(db, order, 1), None)


def _port_merge(a, b, pa, pb, keep, da, db, perm, use_kernel=False):
    T = torch.as_tensor
    return merge_sorted_topk(T(a), T(b), T(pa), T(pb), keep, drop_a=T(da),
                             drop_b=T(db),
                             perm_b=None if perm is None else T(perm),
                             use_kernel=use_kernel)


def _assert_bit_equal(got, want):
    for g, wnt in zip(got, want):
        g = g.numpy()
        assert g.dtype == wnt.dtype and g.tobytes() == wnt.tobytes()


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_sorted_topk_bit_identical_to_reference(case):
    args = _merge_case(case)
    want = _ref_merge_rows(*args)
    _assert_bit_equal(_port_merge(*args), want)
    if case == "overflow":
        assert np.isfinite(want[2]).all()       # something was dropped


def test_sort_by_key_is_stable_like_reference():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 4, (2, 17)).astype(np.float32)
    keys[1, 3:9] = np.inf
    payload = {"i": np.arange(34).reshape(2, 17),
               "img": rng.integers(0, 9, (2, 17, 3))}
    got_k, got_p = sort_by_key(torch.as_tensor(keys),
                               {k: torch.as_tensor(v)
                                for k, v in payload.items()})
    for r in range(2):
        want_k, want_p = ref_sort(jnp.asarray(keys[r]),
                                  {k: jnp.asarray(v[r])
                                   for k, v in payload.items()})
        assert np.array_equal(got_k[r].numpy(), np.asarray(want_k))
        for k in payload:
            assert np.array_equal(got_p[k][r].numpy(), np.asarray(want_p[k]))


@pytest.mark.parametrize("case", ["overflow", "all_ties", "inf_runs"])
def test_merge_kernel_path_bit_identical_to_unfused_and_reference(case):
    """``use_kernel=True`` (rank counts from the merge-ranks kernel's
    wrapper) equals the unfused merge and the reference's kernel merge."""
    args = _merge_case(case)
    got = _port_merge(*args, use_kernel=True)
    _assert_bit_equal(got, [x.numpy() for x in _port_merge(*args)])
    _assert_bit_equal(got, _ref_merge_rows(*args, use_kernel=True))
    # leading axes beyond one pair axis flatten through the kernel
    a, b, pa, pb, keep, da, db, _ = args
    T = torch.as_tensor
    lead2 = merge_sorted_topk(T(a)[None], T(b)[None], T(pa)[None],
                              T(pb)[None], keep, drop_a=T(da)[None],
                              drop_b=T(db)[None], use_kernel=True)
    for x, y in zip(lead2, got):
        assert torch.equal(x[0], y)


# ------------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def batches():
    """Two packed batches: slots 8 (PAD-heavy, an unequal-size pair) and
    slots 16, with per-pair thresholds."""
    out = {}
    for slots, (seed, lo, hi) in {8: (10, 2, 8), 16: (11, 5, 13)}.items():
        packed = ref_pack(_pairs(seed, 8, lo, hi), slots=slots)
        taus = np.random.default_rng(seed).integers(0, 6, 8).astype(
            np.float32)
        out[slots] = (packed, taus)
    return out


# (strategy, verification, bound, use_kernel, slots, pool): hybrid for every
# combination of the other three, lsa and bma once each
ENGINE_CASES = [
    (s, v, "hybrid", uk, 8, 32)
    for s in ("astar", "dfs") for v in (False, True) for uk in (False, True)
] + [("astar", False, "lsa", False, 16, 64),
     ("dfs", True, "bma", True, 16, 64)]


@pytest.mark.parametrize("strategy,verification,bound,use_kernel,slots,pool",
                         ENGINE_CASES)
def test_engine_output_equals_reference(batches, strategy, verification,
                                        bound, use_kernel, slots, pool):
    packed, taus = batches[slots]
    kw = dict(pool=pool, expand=4, max_iters=40, bound=bound,
              strategy=strategy, use_kernel=use_kernel)
    want = {k: np.asarray(v) for k, v in ref_dispatch(
        packed, taus, RefConfig(**kw), verification).items()}
    got = {k: v.numpy() for k, v in dispatch_packed(
        from_reference(packed), taus, EngineConfig(**kw), verification,
        device="cpu").items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])


def test_engine_result_does_not_depend_on_batch_mates(batches):
    """A finished pair is frozen while the rest of its batch runs on: each
    pair alone gives the row it gets in the whole batch."""
    packed, taus = batches[16]
    dev = to_device(from_reference(packed), "cpu")
    cfg = EngineConfig(pool=32, expand=4, max_iters=40, use_kernel=True)
    whole = run_batch(dev, torch.as_tensor(taus), cfg, False)
    assert len(set(whole["iterations"].tolist())) > 2
    for i in range(len(taus)):
        one = run_batch(dev._replace(**{f: getattr(dev, f)[i:i + 1]
                                        for f in FIELDS}),
                        torch.as_tensor(taus[i:i + 1]), cfg, False)
        for k in whole:
            assert torch.equal(one[k][0], whole[k][i]), (i, k)


def test_engine_config_validation_and_merge_dispatch():
    """``use_kernel`` takes True, False and "auto" (anything else raises),
    and a pinned ``merge_fused`` dispatch runs with the unfused outcome."""
    for bad in ("fast", 1.5, None):
        with pytest.raises(ValueError, match="use_kernel"):
            EngineConfig(use_kernel=bad)
    assert EngineConfig(use_kernel="auto").use_kernel == "auto"
    packed = pack_pairs([(Graph([0, 1], [[0, 1], [1, 0]]),
                          Graph([0, 2], [[0, 1], [1, 0]]))])
    base = dict(pool=8, expand=2, max_iters=4)
    fused = dispatch_packed(packed, [0.0], EngineConfig(
        dispatch=KernelDispatch(merge_fused=True), **base), False,
        device="cpu")
    plain = dispatch_packed(packed, [0.0], EngineConfig(use_kernel=False,
                                                        **base),
                            False, device="cpu")
    assert fused["ged"].tolist() == [1.0]
    for k in plain:
        assert torch.equal(fused[k], plain[k]), k


@pytest.mark.parametrize("strategy", ["astar", "dfs"])
@pytest.mark.parametrize("verification", [False, True])
def test_engine_with_fused_merge_equals_reference(batches, strategy,
                                                  verification):
    """Every family fused, the merge included: the output dict equals the
    reference's ``_run_batch`` under the same dispatch, bit for bit."""
    packed, taus = batches[8]
    kw = dict(pool=32, expand=4, max_iters=40, strategy=strategy,
              use_kernel="auto")
    fields = dict(lsa_fused=True, bma_fused=True, merge_fused=True)
    want = {k: np.asarray(v) for k, v in ref_dispatch(
        packed, taus, RefConfig(dispatch=RefDispatch(**fields), **kw),
        verification).items()}
    got = {k: v.numpy() for k, v in dispatch_packed(
        from_reference(packed), taus,
        EngineConfig(dispatch=KernelDispatch(**fields), **kw), verification,
        device="cpu").items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])
