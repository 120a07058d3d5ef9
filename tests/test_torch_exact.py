"""The port's host solver (``repro_torch.core.exact``) against the
reference's (``repro.core.exact``) on the same seeded pairs.

The port's modules are copies, so everything is compared exactly: for
every bound and strategy that ``tests/test_exact_core.py`` covers, the
distance, the verification verdict, the upper bound, the cost of the best
mapping and the count of expanded states are equal; tiny pairs also
equal the brute-force oracle.  Pairs are built by the reference's
generators and handed to the port as the same numpy arrays.
"""

import numpy as np
import pytest

from repro.core import exact as ref_exact
from repro.core.exact.brute import brute_force_ged as ref_brute
from repro.data.graphs import perturb, random_graph

from repro_torch.core import exact
from repro_torch.core.exact.brute import brute_force_ged
from repro_torch.core.exact.graph import Graph, editorial_cost, pad_pair


def _pairs(seed, count, n_lo=3, n_hi=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        q = random_graph(rng, int(rng.integers(n_lo, n_hi)), density=0.4,
                         n_vlabels=3, n_elabels=2)
        if i % 2:
            g = perturb(rng, q, int(rng.integers(1, 4)), n_vlabels=3,
                        n_elabels=2)
        else:
            g = random_graph(rng, int(rng.integers(n_lo, n_hi)), density=0.4,
                             n_vlabels=3, n_elabels=2)
        out.append((q, g))
    return out


def _port(g):
    return Graph(g.vlabels.copy(), g.adj.copy())


def _mapping_cost(q, g, mapping):
    qp, gp, _ = pad_pair(q, g)
    return editorial_cost(qp, gp, mapping)


def _same(got, want, q, g):
    assert (got.ged, got.similar, got.upper_bound, got.lower_bound,
            got.timed_out) == (want.ged, want.similar, want.upper_bound,
                               want.lower_bound, want.timed_out)
    assert got.stats.expanded == want.stats.expanded
    assert got.stats.generated == want.stats.generated
    if want.best_mapping is None:
        assert got.best_mapping is None
    else:
        assert np.array_equal(got.best_mapping, want.best_mapping)
        assert _mapping_cost(_port(q), _port(g), got.best_mapping) == \
            _mapping_cost(q, g, want.best_mapping)


def test_exports_match_the_reference():
    assert exact.BOUNDS == ref_exact.BOUNDS
    assert set(exact.__all__) == set(ref_exact.__all__)


@pytest.mark.parametrize("bound", ["LS", "LSa", "BM", "BMa"])
@pytest.mark.parametrize("strategy", ["astar", "dfs"])
def test_ged_and_verify_equal_reference(bound, strategy):
    for q, g in _pairs(17, 6):
        want = ref_exact.ged(q, g, bound=bound, strategy=strategy)
        got = exact.ged(_port(q), _port(g), bound=bound, strategy=strategy)
        _same(got, want, q, g)
        tau = float(want.ged) - 1.0 if want.ged else 1.0
        for t in (tau, tau + 1.0):
            _same(exact.ged_verify(_port(q), _port(g), t, bound=bound,
                                   strategy=strategy),
                  ref_exact.ged_verify(q, g, t, bound=bound,
                                       strategy=strategy), q, g)


@pytest.mark.parametrize("bound", ["BMaN", "SM", "SMa"])
def test_slow_bounds_equal_reference(bound):
    for q, g in _pairs(19, 3, 3, 6):
        _same(exact.ged(_port(q), _port(g), bound=bound),
              ref_exact.ged(q, g, bound=bound), q, g)


def test_no_expand_all_and_matching_order_equal_reference():
    for q, g in _pairs(23, 4):
        for bound in ("LSa", "BMa"):
            _same(exact.ged(_port(q), _port(g), bound=bound,
                            expand_all=False),
                  ref_exact.ged(q, g, bound=bound, expand_all=False), q, g)
        qp, gp, _ = pad_pair(_port(q), _port(g))
        rq, rg, _ = ref_exact.pad_pair(q, g)
        assert np.array_equal(exact.matching_order(qp, gp),
                              ref_exact.matching_order(rq, rg))


def test_tiny_pairs_equal_brute_force():
    for q, g in _pairs(29, 8, 2, 5):
        want = ref_brute(q, g)
        assert brute_force_ged(_port(q), _port(g)) == want
        assert exact.ged(_port(q), _port(g)).ged == want


def test_deadline_is_duck_typed_and_honoured():
    class Expired:
        def expired(self):
            return True

    q, g = _pairs(31, 2, 6, 8)[0]
    got = exact.ged(_port(q), _port(g), deadline=Expired())
    want = ref_exact.ged(q, g, deadline=Expired())
    assert got.timed_out and want.timed_out
    _same(got, want, q, g)
    got = exact.ged_verify(_port(q), _port(g), 2.0, deadline=Expired())
    _same(got, ref_exact.ged_verify(q, g, 2.0, deadline=Expired()), q, g)


def test_assignment_and_multiset_equal_reference():
    from repro.core.exact.assignment import hungarian as ref_hungarian
    from repro.core.exact.multiset import multiset_edit_distance as ref_med
    rng = np.random.default_rng(37)
    for n in (1, 3, 6):
        c = rng.integers(0, 9, (n, n)).astype(np.float64)
        got, want = exact.hungarian(c), ref_hungarian(c)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    a, b = rng.integers(0, 4, 7).tolist(), rng.integers(0, 4, 5).tolist()
    assert exact.multiset_edit_distance(a, b) == ref_med(a, b)
