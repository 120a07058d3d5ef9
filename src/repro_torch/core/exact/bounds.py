"""Lower bounds for partial mappings (paper §4 and App. A.3).

Every bound is exposed through a *children scorer*: given a partial mapping
``f`` at level ``i`` (images ``img`` of ``order[:i]``), score **all**
extensions ``f u {v_i -> u}`` at once — the paper's "expand all" /
Alg. 3 / Alg. 4 formulation:

=========  =============================================================
``LS``     label-set bound, Alg. 4 (surplus counters, O(size(q)+size(g)))
``LSa``    anchor-aware label-set bound (inner/cross partition)
``BM``     branch-match bound [31] via one forced-all assignment solve
``BMa``    anchor-aware branch-match bound, Alg. 3 (one O(n^3) solve)
``BMaN``   naive anchor-aware branch match (one solve per child; O(n^4))
``SM``     star-match bound [28] extended to edge labels (App. A.3)
``SMa``    anchor-aware star-match bound (App. A.3)
=========  =============================================================

Scorers return ``ChildScores`` with, per candidate ``u`` of ``V(g)``:
``lb[u]`` (``inf`` if ``u`` is already used), ``g_cost[u]`` (the exact
``delta_f'(q[f'], g[f'])`` of the child), and optionally a heuristic full
mapping (the assignment ``M`` of Alg. 3) for upper-bound updates.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.exact.assignment import hungarian, solve_forced_all
from repro_torch.core.exact.graph import Graph
from repro_torch.core.exact.multiset import multiset_edit_distance

_INF = float("inf")


@dataclasses.dataclass
class ChildScores:
    lb: np.ndarray                     # (n,) float; inf where u is used
    g_cost: np.ndarray                 # (n,) float; exact child editorial cost so far
    full_mapping: Optional[np.ndarray]  # (n,) int or None — heuristic extension


class PairContext:
    """Static per-(q, g) data shared by every bound evaluation."""

    def __init__(self, q: Graph, g: Graph, order: np.ndarray):
        if q.n != g.n:
            raise ValueError("PairContext requires padded equal-size graphs")
        self.q = q
        self.g = g
        self.n = q.n
        self.order = np.asarray(order, dtype=np.int64)
        self.qv = q.vlabels
        self.gv = g.vlabels
        self.qa = q.adj
        self.ga = g.adj


def _labels_of(adj_row: np.ndarray, mask: np.ndarray) -> List[int]:
    vals = adj_row[mask]
    return vals[vals > 0].tolist()


class _Frame:
    """Per-expansion scratch (anchors/free sets, exact child deltas)."""

    def __init__(self, ctx: PairContext, img: Tuple[int, ...]):
        self.ctx = ctx
        n = ctx.n
        i = len(img)
        self.i = i
        self.vi = int(ctx.order[i]) if i < n else -1
        self.anchors_q = ctx.order[:i]
        self.anchors_g = np.asarray(img, dtype=np.int64)
        fq = np.ones(n, dtype=bool)
        fq[self.anchors_q] = False
        fg = np.ones(n, dtype=bool)
        fg[self.anchors_g] = False
        self.free_q_mask = fq                   # includes v_i
        self.free_g_mask = fg
        self.free_q = np.nonzero(fq)[0]
        self.free_g = np.nonzero(fg)[0]
        # q-side free set once v_i is anchored:
        fq2 = fq.copy()
        if self.vi >= 0:
            fq2[self.vi] = False
        self.free_q2_mask = fq2
        self.free_q2 = np.nonzero(fq2)[0]

        if self.vi < 0:  # full mapping: no next vertex, no children
            self.delta_exact = np.zeros(n)
            return
        # Exact editorial-cost increment of child (v_i -> u), for every u.
        dv = (ctx.qv[self.vi] != ctx.gv).astype(np.float64)
        if i > 0:
            aq = ctx.qa[self.vi, self.anchors_q]          # (i,)
            ag = ctx.ga[:, self.anchors_g]                # (n, i)
            de = np.count_nonzero(aq[None, :] != ag, axis=1).astype(np.float64)
        else:
            de = np.zeros(n)
        self.delta_exact = dv + de


def _upsilon_counters(cq: Counter, cg: Counter) -> Tuple[int, int, int]:
    """(|S1|, |S2|, |S1 /\\ S2|) for Counters."""
    s1 = sum(cq.values())
    s2 = sum(cg.values())
    inter = sum(min(cq[k], cg[k]) for k in cq.keys() & cg.keys())
    return s1, s2, inter


class BoundEvaluator:
    """Children scorers for all seven bounds."""

    def __init__(self, ctx: PairContext):
        self.ctx = ctx

    # ------------------------------------------------------------------ LS
    def children_ls(self, img: Tuple[int, ...], g_cost: float,
                    cand_mask: Optional[np.ndarray] = None) -> ChildScores:
        """Alg. 4: label-set bound for all children with surplus counters."""
        ctx, fr = self.ctx, _Frame(self.ctx, img)
        n = ctx.n

        # --- q side (fixed across children) --------------------------------
        # Vertex labels of q \ f' (free vertices minus v_i).
        cqv = Counter(ctx.qv[fr.free_q2].tolist())
        # Edge labels of q \ f' = edges with >= 1 endpoint in free_q2.
        # Equivalently: all edges of q\f minus edges (v_i -> anchors_q).
        he_q = Counter()
        sub = ctx.qa[np.ix_(fr.free_q, np.arange(n))]
        # edges with >=1 endpoint free, before anchoring v_i:
        for a_idx, v in enumerate(fr.free_q):
            row = ctx.qa[v]
            for w in np.nonzero(row)[0]:
                if w > v or not fr.free_q_mask[w]:
                    # count each inner edge once (v < w), each cross edge once
                    # (free endpoint side).
                    if fr.free_q_mask[w] and w < v:
                        continue
                    he_q[int(row[w])] += 1
        del sub
        # remove edges (v_i -> anchors_q): they leave q\f' entirely
        for w in fr.anchors_q:
            a = int(ctx.qa[fr.vi, w])
            if a:
                he_q[a] -= 1
                if he_q[a] == 0:
                    del he_q[a]
        n1 = sum(he_q.values())

        # --- g side base ----------------------------------------------------
        cgv = Counter(ctx.gv[fr.free_g].tolist())
        he_g = Counter()
        for u in fr.free_g:
            row = ctx.ga[u]
            for w in np.nonzero(row)[0]:
                if fr.free_g_mask[w] and w < u:
                    continue
                he_g[int(row[w])] += 1
        n2_base = sum(he_g.values())

        # Surplus counters (Alg. 4 lines 3-6): n_E(a) = count_g - count_q.
        nE: Dict[int, int] = {}
        for a in set(he_q) | set(he_g):
            nE[a] = he_g.get(a, 0) - he_q.get(a, 0)
        cE_base = sum(min(he_q[a], he_g[a]) for a in he_q.keys() & he_g.keys())
        nV: Dict[int, int] = {}
        for a in set(cqv) | set(cgv):
            nV[a] = cgv.get(a, 0) - cqv.get(a, 0)
        cV_base = sum(min(cqv[a], cgv[a]) for a in cqv.keys() & cgv.keys())
        max_v = max(n - fr.i - 1, n - fr.i - 1)

        lbs = np.full(n, _INF)
        for u in fr.free_g:
            if cand_mask is not None and not cand_mask[u]:
                continue
            # remove edges (u -> anchors_g) from the g-side edge multiset
            n2, cE = n2_base, cE_base
            touched: List[int] = []
            for w in fr.anchors_g:
                a = int(ctx.ga[u, w])
                if a:
                    n2 -= 1
                    if nE.get(a, 0) <= 0:
                        cE -= 1
                    nE[a] = nE.get(a, 0) - 1
                    touched.append(a)
            ups_e = max(n1, n2) - cE
            dv = 1 if nV.get(int(ctx.gv[u]), 0) <= 0 else 0
            ups_v = max_v - (cV_base - dv)
            lbs[u] = g_cost + fr.delta_exact[u] + ups_v + ups_e
            for a in touched:  # restore surplus (Alg. 4 lines 21-23)
                nE[a] += 1
        return ChildScores(lbs, g_cost + fr.delta_exact, None)

    # ----------------------------------------------------------------- LSa
    def children_lsa(self, img: Tuple[int, ...], g_cost: float,
                     cand_mask: Optional[np.ndarray] = None) -> ChildScores:
        """Anchor-aware label-set bound for all children.

        Components per child ``f' = f u {v_i -> u}``:
          Y(vertex labels) + Y(inner edges) + sum_anchors Y(cross edges).
        """
        ctx, fr = self.ctx, _Frame(self.ctx, img)
        n = ctx.n

        # Vertex component: identical bookkeeping to LS.
        cqv = Counter(ctx.qv[fr.free_q2].tolist())
        cgv = Counter(ctx.gv[fr.free_g].tolist())
        nV = {a: cgv.get(a, 0) - cqv.get(a, 0) for a in set(cqv) | set(cgv)}
        cV_base = sum(min(cqv[a], cgv[a]) for a in cqv.keys() & cgv.keys())
        max_v = n - fr.i - 1

        # Inner edges: q side fixed = edges with both endpoints in free_q2.
        heI_q = Counter()
        for a_i, v in enumerate(fr.free_q2):
            row = ctx.qa[v]
            for w in np.nonzero(row)[0]:
                if fr.free_q2_mask[w] and w > v:
                    heI_q[int(row[w])] += 1
        nI1 = sum(heI_q.values())
        # g side base = edges with both endpoints free_g.
        heI_g = Counter()
        for u in fr.free_g:
            row = ctx.ga[u]
            for w in np.nonzero(row)[0]:
                if fr.free_g_mask[w] and w > u:
                    heI_g[int(row[w])] += 1
        nI2_base = sum(heI_g.values())
        nIE = {a: heI_g.get(a, 0) - heI_q.get(a, 0) for a in set(heI_q) | set(heI_g)}
        cIE_base = sum(min(heI_q[a], heI_g[a]) for a in heI_q.keys() & heI_g.keys())

        # Old-anchor cross components. q side (fixed): edges anchor -> free_q2.
        # g side base: edges f(anchor) -> free_g; per child remove (f(anchor), u).
        anchor_data = []  # (s1, s2, inter, cq, cg) per anchor j
        base_cross_sum = 0.0
        for j in range(fr.i):
            vq, ug = int(fr.anchors_q[j]), int(fr.anchors_g[j])
            cq = Counter(_labels_of(ctx.qa[vq], fr.free_q2_mask))
            cg = Counter(_labels_of(ctx.ga[ug], fr.free_g_mask))
            s1, s2, inter = _upsilon_counters(cq, cg)
            anchor_data.append((s1, s2, inter, cq, cg))
            base_cross_sum += max(s1, s2) - inter

        # v_i's own cross component (q side fixed).
        cq_vi = Counter(_labels_of(ctx.qa[fr.vi], fr.free_q2_mask))

        # anchors adjacent to u (g side) for fast per-child adjustment
        lbs = np.full(n, _INF)
        for u in fr.free_g:
            if cand_mask is not None and not cand_mask[u]:
                continue
            # inner edges: remove u's free-neighbor edges from g inner multiset
            nI2, cIE = nI2_base, cIE_base
            touched: List[int] = []
            for w in np.nonzero(ctx.ga[u])[0]:
                if fr.free_g_mask[w]:
                    a = int(ctx.ga[u, w])
                    nI2 -= 1
                    if nIE.get(a, 0) <= 0:
                        cIE -= 1
                    nIE[a] = nIE.get(a, 0) - 1
                    touched.append(a)
            ups_inner = max(nI1, nI2) - cIE
            for a in touched:
                nIE[a] += 1

            # old anchors: only those adjacent to u change from base
            cross_sum = base_cross_sum
            for j in range(fr.i):
                a = int(ctx.ga[int(fr.anchors_g[j]), u])
                if a:
                    s1, s2, inter, cq, cg = anchor_data[j]
                    d = 1 if cg[a] <= cq[a] else 0
                    cross_sum += (max(s1, s2 - 1) - (inter - d)) - (max(s1, s2) - inter)

            # v_i component vs u's free neighbours (minus u itself)
            cg_u = Counter(
                int(ctx.ga[u, w]) for w in np.nonzero(ctx.ga[u])[0]
                if fr.free_g_mask[w] and w != u
            )
            ups_vi = multiset_edit_distance(cq_vi.elements(), cg_u.elements())

            dv = 1 if nV.get(int(ctx.gv[u]), 0) <= 0 else 0
            ups_v = max_v - (cV_base - dv)
            lbs[u] = g_cost + fr.delta_exact[u] + ups_v + ups_inner + cross_sum + ups_vi
        return ChildScores(lbs, g_cost + fr.delta_exact, None)

    # ---------------------------------------------------------- BM family
    def _branch_hists(self, fr: _Frame, inner_only: bool) -> Tuple[np.ndarray, ...]:
        """Per-free-vertex edge-label Counters for q and g sides."""
        ctx = self.ctx
        if inner_only:
            qmask, gmask = fr.free_q_mask, fr.free_g_mask
        else:
            qmask = np.ones(ctx.n, dtype=bool)
            gmask = np.ones(ctx.n, dtype=bool)
        cq = [Counter(_labels_of(ctx.qa[v], qmask)) for v in fr.free_q]
        cg = [Counter(_labels_of(ctx.ga[u], gmask)) for u in fr.free_g]
        return cq, cg

    def _pairwise_upsilon(self, cq: List[Counter], cg: List[Counter]) -> np.ndarray:
        k = len(cq)
        out = np.zeros((k, k))
        for a in range(k):
            for b in range(k):
                s1, s2, inter = _upsilon_counters(cq[a], cg[b])
                out[a, b] = max(s1, s2) - inter
        return out

    def _cross_mismatch(self, fr: _Frame) -> np.ndarray:
        """sum_j 1[l(v, order_j) != l(u, img_j)] over free (v, u) pairs."""
        ctx = self.ctx
        if fr.i == 0:
            return np.zeros((len(fr.free_q), len(fr.free_g)))
        mq = ctx.qa[np.ix_(fr.free_q, fr.anchors_q)]   # (k, i)
        mg = ctx.ga[np.ix_(fr.free_g, fr.anchors_g)]   # (k, i)
        return np.count_nonzero(mq[:, None, :] != mg[None, :, :], axis=2).astype(float)

    def _lambda_matrix(self, fr: _Frame, kind: str) -> np.ndarray:
        """lambda^{BM|BMa|SM|SMa} over free_q x free_g (v_i treated as free)."""
        ctx = self.ctx
        vmis = (ctx.qv[fr.free_q][:, None] != ctx.gv[fr.free_g][None, :]).astype(float)
        if kind in ("BM", "SM"):
            cq, cg = self._branch_hists(fr, inner_only=False)
            lam = vmis + 0.5 * self._pairwise_upsilon(cq, cg)
        else:  # BMa / SMa
            cq, cg = self._branch_hists(fr, inner_only=True)
            lam = vmis + 0.5 * self._pairwise_upsilon(cq, cg) + self._cross_mismatch(fr)
        if kind in ("SM", "SMa"):
            nq = [Counter(ctx.qv[np.nonzero(ctx.qa[v] * fr.free_q_mask)[0]].tolist())
                  for v in fr.free_q]
            ng = [Counter(ctx.gv[np.nonzero(ctx.ga[u] * fr.free_g_mask)[0]].tolist())
                  for u in fr.free_g]
            lam = lam + self._pairwise_upsilon(nq, ng)
        return lam

    def _star_denominator(self, fr: _Frame) -> float:
        ctx = self.ctx
        # degree within q\f of free vertices (inner + cross edges)
        dq = max((int(np.count_nonzero(ctx.qa[v])) for v in fr.free_q), default=0)
        dg = max((int(np.count_nonzero(ctx.ga[u])) for u in fr.free_g), default=0)
        return float(max(4, dq + 1, dg + 1))

    def _children_assignment(self, img: Tuple[int, ...], g_cost: float, kind: str,
                             cand_mask: Optional[np.ndarray] = None) -> ChildScores:
        ctx, fr = self.ctx, _Frame(self.ctx, img)
        n = ctx.n
        k = len(fr.free_q)
        lam = self._lambda_matrix(fr, kind)
        if cand_mask is not None:
            vi_row = int(np.nonzero(fr.free_q == fr.vi)[0][0])
            banned = ~cand_mask[fr.free_g]
            lam = lam.copy()
            lam[vi_row, banned] = 1e7  # Alg. 3 line 3 (large finite BIG)
        vi_row = int(np.nonzero(fr.free_q == fr.vi)[0][0])
        forced, mcol, _total = solve_forced_all(lam, vi_row)
        denom = self._star_denominator(fr) if kind in ("SM", "SMa") else 1.0

        lbs = np.full(n, _INF)
        lbs[fr.free_g] = g_cost + forced / denom
        if cand_mask is not None:
            lbs[~cand_mask] = _INF

        # Heuristic full mapping from the matching M (paper §4.2 remark).
        full = np.full(n, -1, dtype=np.int64)
        full[fr.anchors_q] = fr.anchors_g
        full[fr.free_q] = fr.free_g[mcol]
        return ChildScores(lbs, g_cost + fr.delta_exact, full)

    def children_bm(self, img, g_cost, cand_mask=None) -> ChildScores:
        return self._children_assignment(img, g_cost, "BM", cand_mask)

    def children_bma(self, img, g_cost, cand_mask=None) -> ChildScores:
        return self._children_assignment(img, g_cost, "BMa", cand_mask)

    def children_sm(self, img, g_cost, cand_mask=None) -> ChildScores:
        return self._children_assignment(img, g_cost, "SM", cand_mask)

    def children_sma(self, img, g_cost, cand_mask=None) -> ChildScores:
        return self._children_assignment(img, g_cost, "SMa", cand_mask)

    # ---------------------------------------------------------------- BMaN
    def children_bman(self, img: Tuple[int, ...], g_cost: float,
                      cand_mask: Optional[np.ndarray] = None) -> ChildScores:
        """Naive anchor-aware branch match: one assignment solve per child.

        ``delta^BMaN(f') = delta_f'(q[f'], g[f']) + delta^BMa(q\\f', g\\f')``
        with ``v_i`` *anchored* — tighter than BMa, |V(g)| x costlier.
        """
        ctx, fr = self.ctx, _Frame(self.ctx, img)
        n = ctx.n
        lbs = np.full(n, _INF)
        gc = g_cost + fr.delta_exact
        best_full, best_lb = None, _INF
        for u in fr.free_g:
            if cand_mask is not None and not cand_mask[u]:
                continue
            img2 = img + (int(u),)
            fr2 = _Frame(ctx, img2)
            if len(fr2.free_q) == 0:
                lbs[u] = gc[u]
                continue
            lam = self._lambda_matrix(fr2, "BMa")
            mcol, total = hungarian(lam)
            lbs[u] = gc[u] + total
            if lbs[u] < best_lb:
                # heuristic full mapping from this child's matching M
                # (paper §4.2 remark, same as Alg. 3's extension)
                best_lb = lbs[u]
                full = np.full(n, -1, dtype=np.int64)
                full[fr2.anchors_q] = fr2.anchors_g
                full[fr2.free_q] = fr2.free_g[mcol]
                best_full = full
        return ChildScores(lbs, gc, best_full)


# Naive whole-state bounds, used as oracles in property tests ----------------

def remaining_lower_bound(ctx: PairContext, img: Tuple[int, ...], kind: str) -> float:
    """``delta_lower(q\\f, g\\f)`` computed from scratch for a *given* state."""
    if len(img) >= ctx.n:
        return 0.0
    fr = _Frame(ctx, img)
    # For a state (not children): free sets exclude nothing extra; rebuild a
    # frame "as if" v_i were not special by using the raw anchor sets.
    n = ctx.n
    free_q = np.nonzero(fr.free_q_mask)[0]
    free_g = np.nonzero(fr.free_g_mask)[0]
    ev = BoundEvaluator(ctx)
    if kind == "LS":
        lq = Counter(ctx.qv[free_q].tolist())
        lg = Counter(ctx.gv[free_g].tolist())
        he_q = Counter()
        for v in free_q:
            for w in np.nonzero(ctx.qa[v])[0]:
                if fr.free_q_mask[w] and w < v:
                    continue
                he_q[int(ctx.qa[v, w])] += 1
        he_g = Counter()
        for u in free_g:
            for w in np.nonzero(ctx.ga[u])[0]:
                if fr.free_g_mask[w] and w < u:
                    continue
                he_g[int(ctx.ga[u, w])] += 1
        return (multiset_edit_distance(lq.elements(), lg.elements())
                + multiset_edit_distance(he_q.elements(), he_g.elements()))
    if kind == "LSa":
        lq = Counter(ctx.qv[free_q].tolist())
        lg = Counter(ctx.gv[free_g].tolist())
        tot = multiset_edit_distance(lq.elements(), lg.elements())
        heI_q, heI_g = Counter(), Counter()
        for v in free_q:
            for w in np.nonzero(ctx.qa[v])[0]:
                if fr.free_q_mask[w] and w > v:
                    heI_q[int(ctx.qa[v, w])] += 1
        for u in free_g:
            for w in np.nonzero(ctx.ga[u])[0]:
                if fr.free_g_mask[w] and w > u:
                    heI_g[int(ctx.ga[u, w])] += 1
        tot += multiset_edit_distance(heI_q.elements(), heI_g.elements())
        for j in range(fr.i):
            vq, ug = int(fr.anchors_q[j]), int(fr.anchors_g[j])
            cq = _labels_of(ctx.qa[vq], fr.free_q_mask)
            cg = _labels_of(ctx.ga[ug], fr.free_g_mask)
            tot += multiset_edit_distance(cq, cg)
        return float(tot)
    if kind in ("BM", "BMa", "SM", "SMa"):
        if len(free_q) == 0:
            return 0.0
        lam = ev._lambda_matrix(fr, kind)
        _, total = hungarian(lam)
        if kind in ("SM", "SMa"):
            total /= ev._star_denominator(fr)
        return float(total)
    raise ValueError(kind)


SCORERS = {
    "LS": BoundEvaluator.children_ls,
    "LSa": BoundEvaluator.children_lsa,
    "BM": BoundEvaluator.children_bm,
    "BMa": BoundEvaluator.children_bma,
    "BMaN": BoundEvaluator.children_bman,
    "SM": BoundEvaluator.children_sm,
    "SMa": BoundEvaluator.children_sma,
}
