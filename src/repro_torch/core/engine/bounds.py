"""Batched anchor-aware bound components (histogram algebra).

The PyTorch counterpart of ``repro/core/engine/bounds.py``.  Everything
here scores **all children of a search state at once** — the tensor
formulation of the paper's Alg. 3 / Alg. 4 — with multiset edit distances
as dense histogram operations:

    Y(S1, S2) = max(|S1|, |S2|) - sum_l min(h1[l], h2[l])

Where the reference takes one pair and one state and is ``vmap``-ed twice,
these functions take explicit leading axes: the pair constants carry
``(..., N)``-shaped fields and the state tensors ``(..., N)``-shaped ones,
and the two broadcast (the search loop passes pair constants as
``(pairs, 1, ...)`` against ``(pairs, expand, ...)`` states).  Every term
is a small integer or half, so each bound is exact in f32 whatever the
summation order, and the fused (kernel) and unfused paths agree bit for
bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.engine import auction as auc
from repro_torch.kernels import ops as kops

BIG = 1e7


def take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``take_along_dim`` with broadcasting leading axes and any int index."""
    return torch.take_along_dim(x, idx.long(), dim)


def hist(oh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...luw,...w->...ul", oh, w)``: per-row label histograms of
    the columns weighted by ``w`` (exact: 0/1 sums in f32).  The result is
    a transposed view, label-major in memory: the layout the kernels read,
    so it reaches them uncopied."""
    return torch.matmul(oh, w[..., None, :, None])[..., 0].transpose(-1, -2)


class PairConsts(NamedTuple):
    """Per-pair tensors, computed once outside the search loop."""

    qv: torch.Tensor        # (..., N) int32
    gv: torch.Tensor        # (..., N) int32
    qa: torch.Tensor        # (..., N, N) int32
    ga: torch.Tensor        # (..., N, N) int32
    order: torch.Tensor     # (..., N) int32
    n: torch.Tensor         # (...,) int32
    oh_q: torch.Tensor      # (..., Le, N, N) f32 one-hot edge labels
    oh_g: torch.Tensor      # (..., Le, N, N) f32
    qa_ord: torch.Tensor    # (..., N, N) int32 = qa[:, order] (cols by order position)
    oh_q_ord: torch.Tensor  # (..., N, Le, N) f32 = oh_q[:, order[j], :] by position j
    n_vlabels: int
    n_elabels: int

    def unsqueeze(self, dim: int) -> "PairConsts":
        """Insert a broadcast axis at leading position ``dim``."""
        return PairConsts(*(t.unsqueeze(dim) for t in self[:10]),
                          self.n_vlabels, self.n_elabels)


def make_pair_consts(qv, gv, qa, ga, order, n, n_vlabels: int,
                     n_elabels: int) -> PairConsts:
    labels = torch.arange(1, n_elabels + 1, dtype=qa.dtype, device=qa.device)
    oh_q = (qa[..., None, :, :] == labels[:, None, None]).float()
    oh_g = (ga[..., None, :, :] == labels[:, None, None]).float()
    qa_ord = take(qa, order[..., None, :], -1)
    oh_q_ord = take(oh_q.transpose(-3, -2), order[..., :, None, None], -3)
    return PairConsts(qv, gv, qa, ga, order, n, oh_q, oh_g, qa_ord, oh_q_ord,
                      n_vlabels, n_elabels)


class StateMasks(NamedTuple):
    vi: torch.Tensor          # (...,) int32 next q vertex
    anchored_q: torch.Tensor  # (..., N) bool
    used_g: torch.Tensor      # (..., N) bool
    free_q: torch.Tensor      # (..., N) f32 (includes v_i)
    free_q2: torch.Tensor     # (..., N) f32 (excludes v_i)
    free_g: torch.Tensor      # (..., N) f32
    img_cl: torch.Tensor      # (..., N) int32 img clamped to [0, N)
    pos_anch: torch.Tensor    # (..., N) f32 1.0 where position j < level


def state_masks(pc: PairConsts, img: torch.Tensor, level: torch.Tensor
                ) -> StateMasks:
    N = pc.qv.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=img.device)
    vmask = ids < pc.n[..., None]
    pos_anch = ids < level[..., None]
    # JAX wraps a negative index (n == 0 gives level - 1 = -1) instead of
    # failing; so does this, and an n == 0 pair is done before it matters
    at = torch.minimum(level, pc.n - 1)
    at = torch.where(at < 0, at + N, at)
    vi = take(pc.order, at[..., None], -1)[..., 0]
    shape = torch.broadcast_shapes(pc.order.shape, pos_anch.shape)
    # order is a permutation, so this scatter writes every slot once
    anchored_q = torch.zeros(shape, dtype=torch.bool, device=img.device).scatter(
        -1, pc.order.long().expand(shape), pos_anch.expand(shape))
    img_cl = img.clamp(0, N - 1)
    used_g = ((img[..., None, :] == ids[:, None])
              & pos_anch[..., None, :]).any(-1)
    free_q = (~anchored_q) & vmask
    free_q2 = free_q & (ids != vi[..., None])
    free_g = (~used_g) & vmask
    return StateMasks(vi, anchored_q, used_g, free_q.float(), free_q2.float(),
                      free_g.float(), img_cl, pos_anch.float())


def child_exact_delta(pc: PairConsts, sm: StateMasks) -> torch.Tensor:
    """Exact editorial-cost increment of (v_i -> u) for every u: (..., N)."""
    dv = (take(pc.qv, sm.vi[..., None], -1) != pc.gv).float()
    qrow = take(pc.qa_ord, sm.vi[..., None, None], -2)[..., 0, :]  # by position
    grow = take(pc.ga, sm.img_cl[..., None, :], -1)                # (N u, N pos)
    de = ((qrow[..., None, :] != grow).float()
          * sm.pos_anch[..., None, :]).sum(-1)
    return dv + de


def _flatten(args, trails):
    """Broadcast kernel operands over their common leading axes and flatten
    those to one state axis; returns ``(flat_operands, lead_shape)``."""
    lead = torch.broadcast_shapes(*(x.shape[:x.ndim - len(t)]
                                    for x, t in zip(args, trails)))
    # an explicit size: -1 is ambiguous for the empty (.., 0) histograms
    # of an edgeless batch
    size = math.prod(lead)
    return [x.expand(*lead, *t).reshape(size, *t)
            for x, t in zip(args, trails)], lead


def _flatten_pairs(args, trails, lead):
    """Flatten per-pair kernel operands to one pair axis under the states'
    leading shape ``lead``.  The trailing axes of ``lead`` along which all
    of them broadcast (size 1: the search's ``expand`` axis) are left out,
    so a kernel reads each pair row once for all its states instead of
    from a copy per state; state ``s`` of the flattened state axis belongs
    to pair row ``s // (states per pair)``."""
    m = len(lead)
    shapes = [(1,) * (m - x.ndim + len(t)) + tuple(x.shape[:x.ndim - len(t)])
              for x, t in zip(args, trails)]
    k = max((i + 1 for s in shapes for i, d in enumerate(s) if d != 1),
            default=0)
    size = math.prod(lead[:k])
    return [x.reshape(*s, *t).expand(*lead[:k], *s[k:], *t).reshape(size, *t)
            for x, s, t in zip(args, shapes, trails)]


def _vertex_ups(pc: PairConsts, sm: StateMasks, level: torch.Tensor
                ) -> torch.Tensor:
    """Vertex-label multiset distance of every child (..., N)."""
    bins = torch.arange(pc.n_vlabels + 2, dtype=pc.qv.dtype,
                        device=pc.qv.device)
    voh_q = (pc.qv[..., None] == bins).float()
    voh_g = (pc.gv[..., None] == bins).float()
    hq_v = (voh_q * sm.free_q2[..., None]).sum(-2)
    hg_v = (voh_g * sm.free_g[..., None]).sum(-2)
    inter_v = torch.minimum(hq_v, hg_v).sum(-1)
    max_v = (pc.n - level - 1).float()
    # removing label gv[u] from the g side
    surplus_u = take(hg_v - hq_v, pc.gv, -1)                 # (..., N)
    return max_v[..., None] - (inter_v[..., None] - (surplus_u <= 0).float())


def lsa_kernel_operands(pc: PairConsts, sm: StateMasks, level: torch.Tensor,
                        g_cost: torch.Tensor):
    """The 14 operands of the ``lsa_children`` kernel and the leading
    shape to restore: the per-state ones flattened to one state axis, the
    pair's ``ga`` to one pair axis.

    Pre-reduced histograms: (N, Le) contractions + row gathers; the
    (N, N)-shaped accumulation loops, and the gather of ``ga`` rows by
    ``img_cl`` that feeds them, stay inside the kernel.
    """
    rowhist_g = hist(pc.oh_g, sm.free_g)                     # (..., N, Le)
    rowhist_q2 = hist(pc.oh_q, sm.free_q2)
    hq_i = 0.5 * (rowhist_q2 * sm.free_q2[..., None]).sum(-2)
    hg_i = 0.5 * (rowhist_g * sm.free_g[..., None]).sum(-2)
    cq = take(rowhist_q2, pc.order[..., None], -2)          # (..., N pos, Le)
    cg = take(rowhist_g, sm.img_cl[..., None], -2)
    s1 = cq.sum(-1)
    s2 = cg.sum(-1)
    inter_j = torch.minimum(cq, cg).sum(-1)
    base_j = torch.maximum(s1, s2) - inter_j
    adjb_j = torch.maximum(s1, s2 - 1.0) - inter_j
    qrow = take(pc.qa_ord, sm.vi[..., None, None], -2)[..., 0, :]
    cq_vi = take(rowhist_q2, sm.vi[..., None, None], -2)[..., 0, :]
    dv = (take(pc.qv, sm.vi[..., None], -1) != pc.gv).float()
    base = g_cost[..., None] + dv + _vertex_ups(pc, sm, level)
    n, le = pc.qv.shape[-1], pc.n_elabels
    flat, lead = _flatten(
        [base, sm.free_g, rowhist_g, sm.img_cl, qrow, sm.pos_anch, cq, cg,
         base_j, adjb_j, hq_i, hg_i, cq_vi],
        [(n,), (n,), (n, le), (n,), (n,), (n,), (n, le), (n, le),
         (n,), (n,), (le,), (le,), (le,)])
    (ga,) = _flatten_pairs([pc.ga], [(n, n)], lead)
    return flat[:3] + [ga] + flat[3:], lead


def lsa_children(pc: PairConsts, sm: StateMasks, level: torch.Tensor,
                 g_cost: torch.Tensor, use_kernel: bool = False
                 ) -> torch.Tensor:
    """delta^LSa(f u {v_i -> u}) for every u; +BIG where u is not free.

    ``use_kernel=True`` routes the (N, N)-shaped work — inner-edge
    upsilons, per-(anchor, u) cross adjustments, exact-delta edge
    mismatches — through the ``lsa_children`` kernel; only (N, Le)-sized
    histogram contractions and row gathers run outside it.  Both paths
    compute the identical bound, also at ``n_elabels == 0``.
    """
    if use_kernel:
        flat, lead = lsa_kernel_operands(pc, sm, level, g_cost)
        return kops.lsa_children(*flat).reshape(*lead, -1)

    ups_v = _vertex_ups(pc, sm, level)

    # ---- inner edges --------------------------------------------------------
    rowhist_q2 = hist(pc.oh_q, sm.free_q2)
    hq_i = 0.5 * (rowhist_q2 * sm.free_q2[..., None]).sum(-2)
    rowhist_g = hist(pc.oh_g, sm.free_g)                     # (..., N, Le)
    hg_i = 0.5 * (rowhist_g * sm.free_g[..., None]).sum(-2)
    hg_i_u = hg_i[..., None, :] - rowhist_g                  # (..., N u, Le)
    n_i1 = hq_i.sum(-1)
    n_i2 = hg_i_u.sum(-1)
    inter_i = torch.minimum(hq_i[..., None, :], hg_i_u).sum(-1)
    ups_i = torch.maximum(n_i1[..., None], n_i2) - inter_i

    # ---- old-anchor cross components ---------------------------------------
    cq = torch.matmul(pc.oh_q_ord, sm.free_q2[..., None, :, None])[..., 0]
    oh_g_img = take(pc.oh_g.transpose(-3, -2), sm.img_cl[..., None, None], -3)
    cg = torch.matmul(oh_g_img, sm.free_g[..., None, :, None])[..., 0]
    s1 = cq.sum(-1)
    s2 = cg.sum(-1)
    inter_j = torch.minimum(cq, cg).sum(-1)
    base_j = torch.maximum(s1, s2) - inter_j                 # (..., N pos)
    a_ju = take(pc.ga, sm.img_cl[..., None], -2)             # (..., N pos, N u)
    labels = torch.arange(1, pc.n_elabels + 1, dtype=a_ju.dtype,
                          device=a_ju.device)
    aoh = (a_ju[..., None] == labels).float()                # (pos, u, Le)
    cg_at = (aoh * cg[..., :, None, :]).sum(-1)
    cq_at = (aoh * cq[..., :, None, :]).sum(-1)
    d_ju = (cg_at <= cq_at).float()
    adj_j = (torch.maximum(s1[..., None], s2[..., None] - 1.0)
             - (inter_j[..., None] - d_ju))
    ups_ju = torch.where(a_ju > 0, adj_j, base_j[..., None])  # (pos, u)
    cross_sum = (ups_ju * sm.pos_anch[..., None]).sum(-2)

    # ---- v_i's own cross component ------------------------------------------
    oh_q_vi = take(pc.oh_q, sm.vi[..., None, None, None], -2)[..., 0, :]
    cq_vi = (oh_q_vi * sm.free_q2[..., None, :]).sum(-1)      # (..., Le)
    s1_vi = cq_vi.sum(-1)
    s2_u = rowhist_g.sum(-1)
    inter_vi = torch.minimum(cq_vi[..., None, :], rowhist_g).sum(-1)
    ups_vi = torch.maximum(s1_vi[..., None], s2_u) - inter_vi

    delta = child_exact_delta(pc, sm)
    lb = g_cost[..., None] + delta + ups_v + ups_i + cross_sum + ups_vi
    return torch.where(sm.free_g > 0, lb, BIG)


def bma_kernel_operands(pc: PairConsts, sm: StateMasks):
    """The 8 operands of the ``bma_cost_matrix`` kernel and the leading
    shape to restore: the per-state ones flattened to one state axis, the
    per-pair ones (``qv``, ``gv``, ``qa_ord``, ``ga``) to one pair axis."""
    # the histograms broadcast the pair and state leading axes, so their
    # leading shape is every operand's
    inner_q = hist(pc.oh_q, sm.free_q)                        # (..., N, Le)
    inner_g = hist(pc.oh_g, sm.free_g)
    n, le = pc.qv.shape[-1], pc.n_elabels
    (inner_q, inner_g, img_cl, pos_anch), lead = _flatten(
        [inner_q, inner_g, sm.img_cl, sm.pos_anch],
        [(n, le), (n, le), (n,), (n,)])
    qv, gv, qa_ord, ga = _flatten_pairs(
        [pc.qv, pc.gv, pc.qa_ord, pc.ga], [(n,), (n,), (n, n), (n, n)], lead)
    return [qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch], lead


def bma_cost_matrix(pc: PairConsts, sm: StateMasks, use_kernel: bool = True
                    ) -> torch.Tensor:
    """lambda^BMa over all (v, u) with dummy structure for non-free slots.

    Dummy rows (anchored / PAD q-slots) pair with dummy columns at cost 0 and
    with free columns at BIG, so the NxN optimum equals the free-free optimum.
    """
    if use_kernel:
        flat, lead = bma_kernel_operands(pc, sm)
        n = pc.qv.shape[-1]
        lam_free = kops.bma_cost_matrix(*flat).reshape(*lead, n, n)
    else:
        inner_q = hist(pc.oh_q, sm.free_q)                    # (..., N, Le)
        inner_g = hist(pc.oh_g, sm.free_g)
        sq = inner_q.sum(-1)
        sg = inner_g.sum(-1)
        inter = torch.minimum(inner_q[..., :, None, :],
                              inner_g[..., None, :, :]).sum(-1)
        ups = torch.maximum(sq[..., :, None], sg[..., None, :]) - inter
        qcross = pc.qa_ord                                    # (..., N v, N pos)
        gcross = take(pc.ga, sm.img_cl[..., None, :], -1)     # (..., N u, N pos)
        mism = ((qcross[..., :, None, :] != gcross[..., None, :, :]).float()
                * sm.pos_anch[..., None, None, :]).sum(-1)
        vmis = (pc.qv[..., :, None] != pc.gv[..., None, :]).float()
        lam_free = vmis + 0.5 * ups + mism

    fq = sm.free_q[..., :, None] > 0
    fg = sm.free_g[..., None, :] > 0
    dummy = torch.where(fq == fg, 0.0, BIG)
    return torch.where(fq & fg, lam_free, dummy)


class BmaChildren(NamedTuple):
    lb: torch.Tensor            # (..., N) forced dual bounds (+BIG where not free)
    full_img: torch.Tensor      # (..., N) heuristic full mapping by order position
    full_cost: torch.Tensor     # (...,) editorial cost of the heuristic mapping


def editorial_cost_tensor(pc: PairConsts, fmap: torch.Tensor) -> torch.Tensor:
    """Exact editorial cost of a full mapping given *by vertex* (..., N)."""
    N = pc.qv.shape[-1]
    ids = torch.arange(N, dtype=torch.int32, device=fmap.device)
    vmask = (ids < pc.n[..., None]).float()
    vterm = ((pc.qv != take(pc.gv, fmap, -1)).float() * vmask).sum(-1)
    gmap = take(take(pc.ga, fmap[..., :, None], -2), fmap[..., None, :], -1)
    pairm = vmask[..., :, None] * vmask[..., None, :]
    upper = (ids[:, None] < ids[None, :]).float()
    eterm = ((pc.qa != gmap).float() * pairm * upper).sum((-2, -1))
    return vterm + eterm


def bma_children(pc: PairConsts, sm: StateMasks, img: torch.Tensor,
                 level: torch.Tensor, g_cost: torch.Tensor, sweeps: int,
                 use_kernel: bool = True) -> BmaChildren:
    """Alg. 3 batched: one auction, dual forced bounds for every child."""
    N = pc.qv.shape[-1]
    lam = bma_cost_matrix(pc, sm, use_kernel=use_kernel)
    st = auc.run_auction(lam, sweeps)
    forced = auc.forced_dual_bounds(lam, st.prices, sm.vi)
    lb = g_cost[..., None] + forced.clamp_min(0.0)
    lb = torch.where(sm.free_g > 0, lb, BIG)

    # Heuristic full mapping (paper §4.2 remark): greedy primal completion.
    assign = auc.greedy_primal(lam, st.prices)           # (..., N) col per row v
    pos = torch.arange(N, dtype=torch.int32, device=img.device)
    img_full = torch.where(pos < level[..., None], img,
                           take(assign, pc.order, -1))
    fmap = torch.zeros_like(img_full).scatter(
        -1, pc.order.long().expand_as(img_full), img_full)
    full_cost = editorial_cost_tensor(pc, fmap)
    # Defence in depth: a mapping sending a real vertex to a PAD slot is not
    # a valid editorial script — poison its cost so it can never become the
    # incumbent upper bound.
    invalid = ((fmap >= pc.n[..., None]) & (pos < pc.n[..., None])).any(-1)
    full_cost = full_cost + invalid.float() * BIG
    return BmaChildren(lb, img_full, full_cost)
