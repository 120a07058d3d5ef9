"""Plain PyTorch twins of the kernel oracles (``repro/kernels/ref.py``).

They are the semantics of record for the hand-written CUDA kernels in
``csrc/``: ``kernels/ops.py`` calls them for CPU tensors, and the card's
check (``chip_smoke.py``) holds every kernel to them with ``torch.equal``.
All operands carry a leading batch axis ``B``.
"""

from __future__ import annotations

import torch

BIG = 1e7


def states_per_pair(pairs: int, states: int) -> int:
    """How many state rows share one pair row (``states // pairs``)."""
    if pairs == states:
        return 1
    if pairs == 0 or states % pairs:
        raise ValueError(f"{states} state rows do not divide evenly among "
                         f"{pairs} pair rows")
    return states // pairs


def bma_cost_matrix_ref(
    qv: torch.Tensor,        # (P, N) int32
    gv: torch.Tensor,        # (P, N) int32
    inner_q: torch.Tensor,   # (B, N, Le) f32 — free-inner edge-label histograms
    inner_g: torch.Tensor,   # (B, N, Le) f32
    qa_ord: torch.Tensor,    # (P, N, N) int32 — q adjacency, cols by order position
    ga: torch.Tensor,        # (P, N, N) int32 — g adjacency
    img_cl: torch.Tensor,    # (B, N) int — image of each order position, in [0, N)
    pos_anch: torch.Tensor,  # (B, N) f32 — 1.0 where position j is anchored
) -> torch.Tensor:
    """lambda^BMa(v, u) for all free-slot pairs (B, N, N).

    = 1[l(v) != l(u)]
      + 1/2 * ( max(|E_I(v)|, |E_I(u)|) - sum_l min(h_v[l], h_u[l]) )
      + sum_{anchored j} 1[ qa[v, order_j] != ga[u, img_j] ]

    Takes ``ga`` and ``img_cl`` like the reference wrapper
    (``repro/kernels/ops.py::bma_cost_matrix``); the gather
    ``gcross[b, u, j] = ga[b, u, img_cl[b, j]]`` happens here, as it does
    inside the CUDA kernel.  The per-pair operands carry ``P`` rows, ``B``
    a multiple of ``P`` (``P == B`` is the reference's layout): state ``s``
    reads pair row ``s // (B // P)``.
    """
    rep = states_per_pair(qv.shape[0], img_cl.shape[0])
    if rep != 1:
        qv, gv, qa_ord, ga = (x.repeat_interleave(rep, 0)
                              for x in (qv, gv, qa_ord, ga))
    gcross = torch.take_along_dim(ga, img_cl.long()[:, None, :], dim=2)
    vmis = (qv[:, :, None] != gv[:, None, :]).float()
    sq = inner_q.sum(2)
    sg = inner_g.sum(2)
    inter = hist_intersect_ref(inner_q, inner_g)
    ups = torch.maximum(sq[:, :, None], sg[:, None, :]) - inter
    mism = torch.einsum(
        "bvuj,bj->bvu",
        (qa_ord[:, :, None, :] != gcross[:, None, :, :]).float(), pos_anch)
    return vmis + 0.5 * ups + mism


def reduced_top2_ref(cost: torch.Tensor, prices: torch.Tensor):
    """Per-row (min, argmin, second-min) of ``cost + prices`` (B, N, N)->(B, N)x3.

    The second min masks only the argmin column with ``+BIG``, so a tied
    minimum gives ``m2 == m1``.  ``argmin`` resolves ties to the first
    index, as in JAX.
    """
    red = cost + prices[:, None, :]
    m1 = red.amin(-1)
    a1 = red.argmin(-1)
    onehot = (torch.arange(red.shape[-1], device=red.device) == a1[..., None])
    m2 = (red + onehot.to(red.dtype) * BIG).amin(-1)
    return m1, a1.to(torch.int32), m2


def hist_intersect_ref(hq: torch.Tensor, hg: torch.Tensor) -> torch.Tensor:
    """Pairwise histogram-intersection sizes: (B, Nq, L) x (B, Nu, L) -> (B, Nq, Nu)."""
    return torch.minimum(hq[:, :, None, :], hg[:, None, :, :]).sum(3)


def merge_ranks_ref(keys_a: torch.Tensor, keys_b: torch.Tensor):
    """Rank counts for a two-run merge (int32):

    count_a[b, i] = #{j : keys_b[b, j] <  keys_a[b, i]}   (B, NA)
    count_b[b, j] = #{i : keys_a[b, i] <= keys_b[b, j]}   (B, NB)

    On sorted runs these equal ``searchsorted(keys_b, keys_a, "left")`` /
    ``searchsorted(keys_a, keys_b, "right")``.
    """
    count_a = (keys_b[:, None, :] < keys_a[:, :, None]).sum(2)
    count_b = (keys_a[:, None, :] <= keys_b[:, :, None]).sum(2)
    return count_a.to(torch.int32), count_b.to(torch.int32)


def lsa_children_ref(
    base: torch.Tensor,       # (B, N) f32 — g_cost + vertex-label terms per u
    free_g: torch.Tensor,     # (B, N) f32 — 1.0 where u is a free g vertex
    rowhist_g: torch.Tensor,  # (B, N, Le) f32 — free-neighbour edge hists of g
    ga: torch.Tensor,         # (P, N, N) int32 — g adjacency, one row per pair
    img_cl: torch.Tensor,     # (B, N) int — image of each order position, in [0, N)
    qrow: torch.Tensor,       # (B, N) int32 — qa_ord[v_i] (q edges of v_i by pos)
    pos_anch: torch.Tensor,   # (B, N) f32 — 1.0 where position j is anchored
    cq: torch.Tensor,         # (B, N, Le) f32 — anchored-q cross hists by pos
    cg: torch.Tensor,         # (B, N, Le) f32 — anchored-g cross hists by pos
    base_j: torch.Tensor,     # (B, N) f32 — max(s1, s2) - inter per pos
    adjb_j: torch.Tensor,     # (B, N) f32 — max(s1, s2 - 1) - inter per pos
    hq_i: torch.Tensor,       # (B, Le) f32 — free-inner edge hist of q
    hg_i: torch.Tensor,       # (B, Le) f32 — free-inner edge hist of g
    cq_vi: torch.Tensor,      # (B, Le) f32 — v_i's free-neighbour edge hist
) -> torch.Tensor:
    """delta^LSa child-bound vector (B, N): +BIG where u is not free.

    Takes the pair's ``ga`` and the state's ``img_cl`` in place of the
    reference's ``a_ju``; the gather ``a_ju[b, j, u] = ga[b, img_cl[b, j],
    u]`` happens here, as it does inside the CUDA kernel.  ``ga`` carries
    ``P`` rows, ``B`` a multiple of ``P``, as in :func:`bma_cost_matrix_ref`.
    """
    rep = states_per_pair(ga.shape[0], img_cl.shape[0])
    if rep != 1:
        ga = ga.repeat_interleave(rep, 0)
    a_ju = torch.take_along_dim(ga, img_cl.long()[:, :, None], dim=1)
    # ---- inner edges: remove u's incident free edges from the g side ----
    hg_i_u = hg_i[:, None, :] - rowhist_g                    # (B, N u, Le)
    n_i1 = hq_i.sum(1)                                       # (B,)
    n_i2 = hg_i_u.sum(2)                                     # (B, N)
    inter_i = torch.minimum(hq_i[:, None, :], hg_i_u).sum(2)
    ups_i = torch.maximum(n_i1[:, None], n_i2) - inter_i

    # ---- v_i's own cross component --------------------------------------
    s1_vi = cq_vi.sum(1)                                     # (B,)
    s2_u = rowhist_g.sum(2)                                  # (B, N)
    inter_vi = torch.minimum(cq_vi[:, None, :], rowhist_g).sum(2)
    ups_vi = torch.maximum(s1_vi[:, None], s2_u) - inter_vi

    # ---- old-anchor cross terms -----------------------------------------
    le = hq_i.shape[1]
    labels = torch.arange(1, le + 1, dtype=a_ju.dtype, device=a_ju.device)
    aoh = (a_ju[:, :, :, None] == labels).float()            # (B, pos, u, Le)
    cg_at = torch.einsum("bjul,bjl->bju", aoh, cg)
    cq_at = torch.einsum("bjul,bjl->bju", aoh, cq)
    d_ju = (cg_at <= cq_at).float()
    ups_ju = torch.where(a_ju > 0, adjb_j[:, :, None] + d_ju,
                         base_j[:, :, None])                 # (B, pos, u)
    cross = torch.einsum("bju,bj->bu", ups_ju, pos_anch)

    # ---- exact-delta edge mismatches of (v_i -> u) ----------------------
    de = torch.einsum(
        "bju,bj->bu", (qrow[:, :, None] != a_ju).float(), pos_anch)

    lb = base + de + ups_i + ups_vi + cross
    return torch.where(free_g > 0, lb, torch.full_like(lb, BIG))
