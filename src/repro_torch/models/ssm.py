"""Attention-free sequence mixers: Mamba2 (SSD) and RWKV6 (Finch).

The port of the reference's ``repro/models/ssm.py``.  Both mixers come
twice:

* **chunked parallel form** for prefill: the sequence is zero-padded to a
  multiple of ``cfg.ssm.chunk`` and split into chunks; within a chunk the
  interactions are dense ``(c x c)`` products, and the state crosses
  chunks in a Python loop (the reference's ``lax.scan``).  Zero padding
  leaves the final state unchanged (``dt = 0`` for SSD, ``w_log = 0`` and
  ``k = 0`` for WKV6), so prefill hands it to decode as the cache;
* **recurrent form** for decode: O(1) state per layer.

Every scan input is cast to f32, as in the reference.  The masked upper
triangle of a chunk's decay matrix holds ``exp`` of positive numbers,
which may overflow: it is masked by selection, never by multiplying with
a 0/1 mask (``inf * 0`` is NaN).

Conventions: inputs are (B, S, d); params are one layer's dict.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import cdt as compute_dtype
from repro_torch.parallel.sharding import is_distributed, reduce_partial


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``t`` by ``pad`` rows at the end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


# ============================================================= Mamba2 (SSD)

def mamba2_dims(cfg: ArchConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return dict(d_inner=d_inner, n_heads=n_heads, d_state=s.d_state,
                head_dim=s.head_dim, n_groups=s.n_groups, d_conv=s.d_conv)


def _ssd_chunk_scan(xh, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD.  xh: (B,S,H,P), dt: (B,S,H), a_log: (H,) <= 0 decay,
    b, c: (B,S,G,N) with G groups broadcast over heads.

    Returns (y (B,S,H,P) f32, final state (B,H,P,N) f32).  Within a
    chunk y = (C B^T o L) x + decay^t C state_in; state_out = decay^c
    state_in + sum_t decay^(c-t) dt_t B_t x_t.
    """
    bsz, s, h, p = xh.shape
    g, n = b.shape[2], b.shape[3]
    s_orig = s
    pad = (-s) % chunk                      # zero-pad: dt=0 => no state change
    if pad:
        xh, dt, b, c = (_pad_seq(t, pad) for t in (xh, dt, b, c))
        s += pad
    nc = s // chunk
    rep = h // g

    xc = xh.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bc = b.float().reshape(bsz, nc, chunk, g, n)
    cc = c.float().reshape(bsz, nc, chunk, g, n)
    da = dtc * a_log.float()[None, None, None, :]          # (B,nc,c,H)
    da_cum = torch.cumsum(da, 2)                           # inclusive
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=xh.device))

    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for i in range(nc):
        xk, dtk, dacum = xc[:, i], dtc[:, i], da_cum[:, i]
        # intra-chunk: L[t,u] = exp(dacum_t - dacum_u) for u <= t
        rel = dacum[:, :, None, :] - dacum[:, None, :, :]  # (B,c,c,H)
        l_mat = torch.where(tri[None, :, :, None], torch.exp(rel),
                            torch.zeros((), device=rel.device))
        bk_h = bc[:, i].repeat_interleave(rep, dim=2)      # (B,c,H,N)
        ck_h = cc[:, i].repeat_interleave(rep, dim=2)
        scores = torch.einsum("bthn,buhn->btuh", ck_h, bk_h) * l_mat
        y_intra = torch.einsum("btuh,buhp->bthp", scores * dtk[:, None],
                               xk)
        y_state = torch.einsum("bthn,bhpn->bthp", ck_h, state) \
            * torch.exp(dacum)[..., None]
        da_tot = dacum[:, -1]                              # (B,H)
        w = torch.exp(da_tot[:, None, :] - dacum)          # (B,c,H)
        upd = torch.einsum("buhn,buhp->bhpn", bk_h * (w * dtk)[..., None],
                           xk)
        state = torch.exp(da_tot)[:, :, None, None] * state + upd
        ys.append(y_intra + y_state)
    y = torch.stack(ys, 1).reshape(bsz, s, h, p)
    y = y + d_skip.float()[None, None, :, None] * xh.float()
    return y[:, :s_orig], state


def _gated_out(y, z, p, x, cdt):
    """Mamba2's gated RMS norm before the output projection."""
    yn = y * torch.rsqrt(reduce_partial(y.square().mean(-1, keepdim=True))
                         + 1e-6)
    y = yn * p["norm_scale"] * F.silu(z)
    return (y.to(cdt) @ p["out_proj"].to(cdt)).to(x.dtype)


def _mamba_in(xc_, p, cdt):
    """The four input projections (z, x, B|C, dt), each back to f32."""
    return [reduce_partial(xc_ @ p[name].to(cdt)).float()
            for name in ("in_z", "in_x", "in_bc", "in_dt")]


def mamba2_train(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                 return_state: bool = False):
    """Full-sequence Mamba2 block (prefill). x: (B, S, d)."""
    dims = mamba2_dims(cfg)
    bsz, s, _ = x.shape
    di, h, n, hp = (dims["d_inner"], dims["n_heads"], dims["d_state"],
                    dims["head_dim"])
    g = dims["n_groups"]
    cdt = compute_dtype(cfg)

    z, xin, bc, dt = _mamba_in(x.to(cdt), p, cdt)
    b, c = bc.chunk(2, -1)
    # causal depthwise conv over xin, kernel (K, di)
    k = cfg.ssm.d_conv
    xpad = F.pad(xin, (0, 0, k - 1, 0))
    xconv = sum(xpad[:, i:i + s] * p["conv_w"][i][None, None, :]
                for i in range(k)) + p["conv_b"][None, None, :]
    xconv = F.silu(xconv)
    dt = F.softplus(dt + p["dt_bias"][None, None, :])       # (B,S,H)
    a_log = -torch.exp(p["a_log"])                          # (H,) < 0

    def core(xconv, dt, b, c, a_log, d_skip):
        nh, bsz = dt.shape[-1], dt.shape[0]
        y, final = _ssd_chunk_scan(xconv.reshape(bsz, s, nh, hp), dt, a_log,
                                   b.reshape(bsz, s, g, n),
                                   c.reshape(bsz, s, g, n), d_skip,
                                   cfg.ssm.chunk)
        return y.reshape(bsz, s, nh * hp), final

    y, final = _by_heads(core, h, "sswwvv", (2, 1), xconv, dt, b, c, a_log,
                         p["d_skip"])
    out = _gated_out(y, z, p, x, cdt)
    if return_state:
        return out, {"ssd": final, "conv": xin[:, s - (k - 1):]}
    return out


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None
                      ) -> Dict[str, torch.Tensor]:
    dims = mamba2_dims(cfg)
    return {
        "ssd": torch.zeros((batch, dims["n_heads"], dims["head_dim"],
                            dims["d_state"]), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, dims["d_inner"]),
                            dtype=torch.float32, device=device),
    }


def mamba2_decode(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step. x: (B, 1, d); returns a new state."""
    dims = mamba2_dims(cfg)
    bsz = x.shape[0]
    di, h, n, hp = (dims["d_inner"], dims["n_heads"], dims["d_state"],
                    dims["head_dim"])
    g = dims["n_groups"]
    cdt = compute_dtype(cfg)

    z, xin, bc, dt = _mamba_in(x[:, 0].to(cdt), p, cdt)
    b, c = bc.chunk(2, -1)
    conv_hist = torch.cat([state["conv"], xin[:, None, :]], 1)
    k = cfg.ssm.d_conv
    xconv = sum(conv_hist[:, i] * p["conv_w"][i][None, :]
                for i in range(k)) + p["conv_b"][None, :]
    xconv = F.silu(xconv)
    dt = F.softplus(dt + p["dt_bias"][None, :])             # (B,H)
    a_log = -torch.exp(p["a_log"])

    def core(xconv, dt, b, c, a_log, d_skip, ssd):
        nh, bsz = dt.shape[-1], dt.shape[0]
        da = torch.exp(dt * a_log[None, :])                 # (B,H)
        xh = xconv.reshape(bsz, nh, hp)
        bh = b.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)[:, :nh]
        ch = c.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)[:, :nh]
        new_ssd = da[:, :, None, None] * ssd \
            + (dt[:, :, None] * xh)[..., None] * bh[:, :, None, :]
        y = torch.einsum("bhn,bhpn->bhp", ch, new_ssd) \
            + d_skip[None, :, None] * xh
        return y.reshape(bsz, nh * hp), new_ssd

    y, new_ssd = _by_heads(core, h, "sswwvvt", (1, 1), xconv, dt, b, c,
                           a_log, p["d_skip"], state["ssd"])
    out = _gated_out(y, z, p, x, cdt)
    return out[:, None, :], {"ssd": new_ssd, "conv": conv_hist[:, 1:]}


# ===================================================== per-device heads

def _by_heads(core, h: int, kinds: str, out_dims: Tuple[int, ...], *args):
    """``core(*args)`` for mixers whose channels split into ``h`` heads;
    on DTensors, per device over its own batch rows and heads
    (``local_map``): DTensor has no cheap rule for the chunked scans'
    high-rank einsums, nor for splitting a sharded channel dim into heads.

    ``kinds`` has one letter per arg: ``s`` a batch-major stream whose
    last dim runs over heads, ``v`` a per-channel / per-head vector,
    ``t`` a batch-major state with heads on dim 1, ``w`` a batch-major
    tensor every head reads whole (SSD's B / C).  ``out_dims`` gives each
    output's heads dim (batch first).  Heads are split over ``model``
    when ``h`` divides over it, else replicated; the batch over the
    rules' batch axes when it divides.  None args pass through.
    """
    lead = next(a for a in args if a is not None)
    if not is_distributed(lead):
        return core(*args)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import (get_rules, logical_spec,
                                               spec_to_placements)

    mesh, rules = lead.device_mesh, get_rules()
    batch = spec_to_placements(
        logical_spec((lead.shape[0],), ("batch",), rules), mesh)
    heads = spec_to_placements(logical_spec((h,), ("heads",), rules), mesh)

    def layout(hdim):
        return [Shard(0) if bp.is_shard() and hdim != 0 else
                Shard(hdim) if hp.is_shard() and hdim is not None
                else Replicate() for bp, hp in zip(batch, heads)]

    from torch.distributed.tensor import Partial

    in_p, grad_p, placed = [], [], []
    for kind, a in zip(kinds, args):
        if a is None:
            in_p.append(None)
            grad_p.append(None)
            placed.append(None)
            continue
        if not is_distributed(a):
            a = distribute_tensor(a, mesh, [Replicate()] * mesh.ndim)
        hdim = {"s": a.ndim - 1, "v": 0, "t": 1, "w": None}[kind]
        in_p.append(layout(hdim))
        # a tensor every head reads whole gets each head group's gradient
        grad_p.append([Partial() if kind == "w" and hp.is_shard() else pl
                       for pl, hp in zip(in_p[-1], heads)])
        placed.append(a)
    out_p = tuple(layout(d) for d in out_dims)
    return local_map(core, out_placements=out_p, in_placements=tuple(in_p),
                     in_grad_placements=tuple(grad_p), device_mesh=mesh,
                     redistribute_inputs=True)(*placed)


# ============================================================ RWKV6 (Finch)

def rwkv6_dims(cfg: ArchConfig) -> Dict[str, int]:
    hd = cfg.ssm.head_dim
    return dict(n_heads=cfg.d_model // hd, head_dim=hd)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x_{t-1} stream; ``prev`` (B, d) seeds position -1 (decode carries it)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], 1)


def _rwkv_proj(x, xprev, mix, w, lora_a=None, lora_b=None):
    """RWKV6 data-dependent interpolation + projection (``w`` None: the
    low-rank term alone, where the reference multiplies by a zero
    matrix first)."""
    xm = x + (xprev - x) * mix[None, None, :]
    out = reduce_partial(xm @ w) if w is not None else 0.0
    if lora_a is not None:
        out = out + reduce_partial(
            torch.tanh(reduce_partial(xm @ lora_a)) @ lora_b)
    return out


def _wkv6_chunk_scan(r, k, v, w_log, u, chunk: int):
    """Chunked WKV6.  r, k, v: (B,S,H,hd); w_log: (B,S,H,hd) <= 0
    log-decay (data-dependent, per channel); u: (H, hd) bonus.

    Returns (y (B,S,H,hd) f32, final state (B,H,hd,hd) f32).  State
    S_t = diag(exp(w_log_t)) S_{t-1} + k_t v_t^T, and
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T).  The (B, c, c, H, hd) decay
    tensor is built and freed once per chunk: in place without autograd,
    out of place when grad is enabled, so the scan can be differentiated.
    """
    bsz, s, h, hd = r.shape
    s_orig = s
    pad = (-s) % chunk          # zero-pad: w_log=0, k=0 => state preserved
    if pad:
        r, k, v, w_log = (_pad_seq(t, pad) for t in (r, k, v, w_log))
        s += pad
    nc = s // chunk

    def resh(t):
        return t.float().reshape(bsz, nc, chunk, h, hd)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w_log)
    u = u.float()
    ar = torch.arange(chunk, device=r.device)
    strict = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    state = torch.zeros((bsz, h, hd, hd), dtype=torch.float32,
                        device=r.device)
    ys = []
    for i in range(nc):
        rk, kk, vk, wk = rc[:, i], kc[:, i], vc[:, i], wc[:, i]
        wcum = torch.cumsum(wk, 1)                 # inclusive
        # o_t = r_t diag(exp(wcum_{t-1})) state  (decay before t's update)
        wcum_excl = wcum - wk
        y_state = torch.einsum("bthd,bhde->bthe", rk * torch.exp(wcum_excl),
                               state)
        # u < t: decay prod_{j=u+1..t-1} = exp(wcum_excl_t - wcum_u)
        decay = wcum_excl[:, :, None] - wcum[:, None, :]   # (B,t,u,H,hd)
        # masked before the exp: exp(-inf) = 0 where the reference's
        # where() gives 0, and no inf can reach a gradient as 0 * inf
        if torch.is_grad_enabled():
            decay = torch.exp(decay.masked_fill(~strict, -math.inf)) \
                * rk[:, :, None] * kk[:, None]
        else:       # in place: serving holds one chunk tensor, not four
            decay.masked_fill_(~strict, -math.inf).exp_()
            decay.mul_(rk[:, :, None]).mul_(kk[:, None])
        att = decay.sum(-1)                                # (B,t,u,H)
        del decay
        diag = (rk * u[None, None] * kk).sum(-1)           # current token
        y_intra = torch.einsum("btuh,buhe->bthe", att, vk) \
            + diag[..., None] * vk
        w_tot = wcum[:, -1]                        # (B,H,hd)
        kw = kk * torch.exp(w_tot[:, None] - wcum)  # decay from u+1..c
        state = torch.exp(w_tot)[..., None] * state \
            + torch.einsum("buhd,buhe->bhde", kw, vk)
        ys.append(y_state + y_intra)
    y = torch.stack(ys, 1).reshape(bsz, s, h, hd)
    return y[:, :s_orig], state


def rwkv6_time_mix(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                   prev_x: Optional[torch.Tensor] = None,
                   state: Optional[torch.Tensor] = None):
    """RWKV6 attention (time-mix), in f32.  Prefill when ``state`` is None
    (chunked), else one recurrent step.  Returns (out, new state, the last
    position's f32 input for the next token shift)."""
    dims = rwkv6_dims(cfg)
    h, hd = dims["n_heads"], dims["head_dim"]
    bsz, s, d = x.shape
    xf = x.float()
    xprev = _token_shift(xf, prev_x)

    r = _rwkv_proj(xf, xprev, p["mix_r"], p["wr"])
    k = _rwkv_proj(xf, xprev, p["mix_k"], p["wk"])
    v = _rwkv_proj(xf, xprev, p["mix_v"], p["wv"])
    g = _rwkv_proj(xf, xprev, p["mix_g"], p["wg"])
    # data-dependent decay (low-rank): w = exp(-exp(base + lora))
    wl = _rwkv_proj(xf, xprev, p["mix_w"], None, p["w_lora_a"],
                    p["w_lora_b"]) + p["w_base"][None, None, :]
    w_log = -torch.exp(wl)                                  # (B,S,d) <= 0

    def core(r, k, v, w_log, u, ln_scale, ln_bias, state):
        """The WKV recurrence and the per-head group norm over ``n`` =
        ``d' / hd`` heads: (B, S, d') streams -> (B, S, d') f32."""
        n = r.shape[-1] // hd
        bsz, s = r.shape[:2]                # this device's rows

        def heads(t):
            return t.reshape(bsz, s, n, hd)

        u = u.reshape(n, hd)
        if state is None:
            y, new_state = _wkv6_chunk_scan(heads(r), heads(k), heads(v),
                                            heads(w_log), u, cfg.ssm.chunk)
        else:
            rh, kh, vh = heads(r)[:, 0], heads(k)[:, 0], heads(v)[:, 0]
            wh = torch.exp(heads(w_log)[:, 0])              # (B,H,hd)
            kv = kh[..., :, None] * vh[..., None, :]        # (B,H,hd,hd)
            y = torch.einsum("bhd,bhde->bhe", rh,
                             state + u[None, :, :, None] * kv)
            new_state = wh[..., None] * state + kv
            y = y[:, None]                                  # (B,1,H,hd)

        # group norm over each head
        yf = y.reshape(bsz, -1, n, hd)
        mu = yf.mean(-1, keepdim=True)
        var = yf.var(-1, keepdim=True, correction=0)
        yn = (yf - mu) * torch.rsqrt(var + 64e-5)
        yn = yn * ln_scale.reshape(1, 1, n, hd) \
            + ln_bias.reshape(1, 1, n, hd)
        return yn.reshape(bsz, -1, n * hd), new_state

    yn, new_state = _by_heads(core, h, "ssssvvvt", (2, 1), r, k, v, w_log,
                              p["u"], p["ln_x_scale"], p["ln_x_bias"], state)
    out = (yn * F.silu(g)) @ p["wo"]
    return out.to(x.dtype), new_state, xf[:, -1]


def rwkv6_channel_mix(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                      prev_x: Optional[torch.Tensor] = None):
    """RWKV6 FFN (channel-mix) with token shift and squared ReLU, in f32."""
    xf = x.float()
    xprev = _token_shift(xf, prev_x)
    xk = xf + (xprev - xf) * p["mix_fk"][None, None, :]
    xr = xf + (xprev - xf) * p["mix_fr"][None, None, :]
    kk = torch.square(F.relu(reduce_partial(xk @ p["fk"])))
    out = torch.sigmoid(reduce_partial(xr @ p["fr"])) \
        * reduce_partial(kk @ p["fv"])
    return out.to(x.dtype), xf[:, -1]
