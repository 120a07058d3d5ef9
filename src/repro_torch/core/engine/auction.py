"""Batched auction assignment with LP-dual admissible lower bounds.

The PyTorch counterpart of ``repro/core/engine/auction.py``.  It rests on
the same two facts:

1. **Weak LP duality.**  For *any* price vector ``p``,

       dual(p) = sum_i min_j (c_ij + p_j) - sum_j p_j  <=  OPT(c),

   so a fixed number of auction sweeps yields a valid lower bound whose
   tightness is a dial (sweep count), never a correctness requirement.

2. **Forced-edge minors.**  ``OPT(c | row r -> col u) = c[r, u] + OPT(minor)``
   and the same ``p`` restricted to the minor is dual-feasible there:

       forced_lb[u] = c[r, u] + sum_{i != r} min_{j != u} (c_ij + p_j)
                      - (sum_j p_j - p_u).

Every function takes any number of leading batch axes (``cost`` is
``(..., N, N)``); the per-row top-2 goes through the ``reduced_top2``
kernel wrapper, which flattens them.

Reduction order: prices inflate to ~BIG (1e7) when a row's second-best
column is forbidden, and the f32 ulp at 1e7 is 1.0, so the sums in
:func:`dual_bound` and :func:`forced_dual_bounds` depend on their order.
They are taken strictly in index order (:func:`seq_sum`), the order of
the reference's sequential reduction loop, on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops as kops

BIG = 1e7


class AuctionState(NamedTuple):
    prices: torch.Tensor      # (..., N) float32 column prices
    row_to_col: torch.Tensor  # (..., N) int32, -1 if unassigned
    col_to_row: torch.Tensor  # (..., N) int32, -1 if unowned


def seq_sum(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Sum along ``dim`` in strict index order: ``((x0 + x1) + x2) + ...``.

    Where the summands carry BIG-sized prices the result depends on the
    order; this one is the same on the CPU and on the card.
    """
    parts = x.unbind(dim)
    out = parts[0].clone() if parts else x.sum(dim)
    for p in parts[1:]:
        out = out + p
    return out.unsqueeze(dim) if keepdim else out


def init_auction(cost: torch.Tensor) -> AuctionState:
    shape = cost.shape[:-1]
    return AuctionState(
        prices=torch.zeros(shape, dtype=torch.float32, device=cost.device),
        row_to_col=torch.full(shape, -1, dtype=torch.int32, device=cost.device),
        col_to_row=torch.full(shape, -1, dtype=torch.int32, device=cost.device),
    )


def reduced_top2(cost: torch.Tensor, prices: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(min, argmin, second-min) per row of ``cost + prices`` over any
    leading axes, through the kernel wrapper."""
    lead, n = cost.shape[:-2], cost.shape[-1]
    m1, a1, m2 = kops.reduced_top2(cost.reshape(-1, n, n),
                                   prices.expand(*lead, n).reshape(-1, n))
    return m1.reshape(*lead, n), a1.reshape(*lead, n), m2.reshape(*lead, n)


def auction_sweep(cost: torch.Tensor, st: AuctionState, eps: float
                  ) -> AuctionState:
    """One Jacobi sweep: every unassigned row bids; highest bid wins the col."""
    n = cost.shape[-1]
    ids = torch.arange(n, dtype=torch.int32, device=cost.device)
    unassigned = st.row_to_col < 0                     # (..., N)
    m1, a1, m2 = reduced_top2(cost, st.prices)         # fused kernel
    incr = (m2 - m1) + eps                             # bid increment per row
    incr = torch.where(unassigned, incr, -BIG)         # only unassigned bid

    # Resolve conflicts: per column, the bidding row with the largest
    # increment wins (one-hot scatter + first-index argmax over rows).
    bid_onehot = (a1[..., None] == ids).to(cost.dtype)            # (..., N, N)
    bids = torch.where(unassigned[..., None],
                       bid_onehot * incr[..., None]
                       + (1.0 - bid_onehot) * (-BIG), -BIG)
    win_incr = bids.amax(-2)                           # (..., N) per col
    win_row = bids.argmax(-2).to(torch.int32)
    has_bid = win_incr > -BIG / 2

    new_prices = torch.where(has_bid, st.prices + win_incr, st.prices)

    # Ownership transfer: winning rows take their columns; displaced owners
    # become unassigned.
    new_col_to_row = torch.where(has_bid, win_row, st.col_to_row)
    onehot_owner = new_col_to_row[..., None, :] == ids[:, None]   # (..., row, col)
    any_col = onehot_owner.any(-1)
    new_row_to_col = torch.where(
        any_col, onehot_owner.to(torch.uint8).argmax(-1).to(torch.int32), -1)
    return AuctionState(new_prices, new_row_to_col, new_col_to_row)


def run_auction(cost: torch.Tensor, n_sweeps: int,
                phases: Tuple[float, ...] = (1.0, 0.25, 0.125)) -> AuctionState:
    """Fixed-budget auction with epsilon-scaling.

    Each phase *unassigns all rows* and warm-starts from the previous
    phase's prices (without the reset the assignment freezes under
    coarse-phase price overshoot).
    """
    st = init_auction(cost)
    per_phase = max(n_sweeps // max(len(phases), 1), 1)
    for eps in phases:
        # phase reset: keep prices, drop the assignment
        st = AuctionState(st.prices, torch.full_like(st.row_to_col, -1),
                          torch.full_like(st.col_to_row, -1))
        for _ in range(per_phase):
            st = auction_sweep(cost, st, eps)
    return st


def dual_bound(cost: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """Weak-duality lower bound on OPT(cost) for any price vector."""
    reduced = cost + prices[..., None, :]
    return seq_sum(reduced.amin(-1), -1) - seq_sum(prices, -1)


def forced_dual_bounds(cost: torch.Tensor, prices: torch.Tensor,
                       row: torch.Tensor) -> torch.Tensor:
    """Lower bound on OPT(cost | row -> u) for **every** column u at once.

    ``row`` holds one row index per problem (shape ``cost.shape[:-2]``).
    Returns (..., N).
    """
    n = cost.shape[-1]
    m1, a1, m2 = reduced_top2(cost, prices)             # (..., N) per row
    # Row minima over columns != u: m2 where the argmin was u, else m1.
    u_ids = torch.arange(n, dtype=torch.int32, device=cost.device)
    excl = torch.where(a1[..., :, None] == u_ids, m2[..., :, None],
                       m1[..., :, None])                # (..., N rows, N u)
    total_excl = seq_sum(excl, -2)                      # (..., N u)
    row_idx = row.long()[..., None, None]
    row_excl = torch.take_along_dim(excl, row_idx, -2)[..., 0, :]
    minors = total_excl - row_excl                      # sum_{i != row}
    p_tot = seq_sum(prices, -1, keepdim=True)
    c_row = torch.take_along_dim(cost, row_idx, -2)[..., 0, :]
    return c_row + minors - (p_tot - prices)


def greedy_primal(cost: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """A full (not necessarily optimal) assignment for upper-bound updates.

    Sequential greedy over rows on the reduced costs, one step per row.
    Returns the column per row, int32 ``(..., N)``.

    Prices are clipped before use: auction bids against forbidden (BIG)
    second-best columns legitimately inflate a price to ~BIG, which would
    invert the dummy/free class separation of the GED cost matrices and let
    a real vertex grab a PAD column.
    """
    n = cost.shape[-1]
    ids = torch.arange(n, device=cost.device)
    reduced = cost + prices.clamp(0.0, 1e3)[..., None, :]
    used = torch.zeros(cost.shape[:-1], dtype=torch.bool, device=cost.device)
    cols = []
    for i in range(n):
        rowc = reduced[..., i, :] + torch.where(used, BIG, 0.0)
        j = rowc.argmin(-1)
        used = used | (ids == j[..., None])
        cols.append(j)
    return torch.stack(cols, -1).to(torch.int32)
