"""Mamba2 blocks via SSD (state-space duality), chunked matmul form.

The port of ``repro.models.ssm``: the minimal-SSD algorithm (Dao & Gu,
arXiv:2405.21060).  The sequence splits into chunks of ``chunk``
positions; the work inside a chunk is a masked matmul, the work across
chunks a short recurrence over per-chunk states (a loop over chunks).
Decode is the exact one-token recurrence.

Every reduction of a prefill runs over a fixed axis — a chunk's
positions, ``d_state``, the model width or the conv's taps — never over
the padded length L, the depthwise conv is a fixed-order sum over its
taps (not ``F.conv1d``, whose algorithm may change with L), and the
narrow dt projection runs at a fixed row count (``_dt_proj``).  With
dt zeroed past a row's ``seq_len`` every pad position is an identity
transition, so the serving engine may put recurrent rows in power-of-two
length buckets.  That holds on the CPU; on the card the prefill passes
``rows`` (``FwdOptions.rows_invariant``), which sends the projections,
the SSD's products and the gated norm through the rows-invariant kernels
(cuBLAS picks its GEMM by shape, so a padded row would round otherwise).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rows_gemm.ops import rows_einsum, rows_gemm
from repro_torch.kernels.rows_gemm.ref import rows_gemm_ref
from .layers import gated_rms_norm, silu


class MambaDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_width: int

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state


def mamba_dims(d_model: int, d_state: int, head_dim: int, expand: int,
               conv_width: int, tp: int = 1) -> MambaDims:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    if n_heads % tp:
        n_heads = ((n_heads + tp - 1) // tp) * tp   # pad heads to TP degree
        d_inner = n_heads * head_dim
    return MambaDims(d_model, d_inner, n_heads, head_dim, d_state, conv_width)


def mamba_shapes(dims: MambaDims) -> dict:
    """The shapes of one block's weights as ``repro.models.ssm.init_mamba``
    lays them out (z / x / B / C / dt projections as separate weights)."""
    d, di, n, H = dims.d_model, dims.d_inner, dims.d_state, dims.n_heads
    return {"in_z": (d, di), "in_x": (d, di), "in_B": (d, n),
            "in_C": (d, n), "in_dt": (d, H),
            "conv_w": (dims.conv_width, dims.conv_channels),
            "conv_b": (dims.conv_channels,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm": (di,), "out_proj": (di, d)}


# leaves that stay float32 under any model dtype, as init_mamba makes them
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


DT_ROWS = 64        # rows a block of the prefill's dt projection


def _dt_proj(x: torch.Tensor, w: torch.Tensor,
             rows: bool = False) -> torch.Tensor:
    """``x @ w`` for the narrow dt projection (one column a head), one
    block of ``DT_ROWS`` rows at a time (``rows_gemm_ref``'s ``block``),
    or with ``rows`` through the rows-invariant kernel, whose plain
    version takes the same blocks."""
    if rows:
        return rows_gemm(x, w, block=DT_ROWS)
    return rows_gemm_ref(x, w, block=DT_ROWS)


def _causal_depthwise_conv(xbc: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor,
                           init: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """xbc (B, L, C), w (W, C) depthwise causal, in xbc's dtype.

    ``init`` (B, W-1, C): the trailing conv inputs of an already processed
    prefix (prefix-KV chunked prefill); without it the sequence start sees
    the conv's zero left-pad.  The taps accumulate in float32, in tap
    order, one position at a time, whatever L is."""
    W = w.shape[0]
    L = xbc.shape[1]
    if init is not None:
        lhs = torch.cat([init.to(xbc.dtype), xbc], dim=1)
    else:
        lhs = F.pad(xbc, (0, 0, W - 1, 0))
    lhs = lhs.float()
    w32 = w.float()
    out = lhs[:, 0:L] * w32[0]
    for t in range(1, W):
        out = out + lhs[:, t:t + L] * w32[t]
    return out.to(xbc.dtype) + b


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T) lower-triangular cumulative segment sums,
    -inf above the diagonal (masked before any exp, so exp gives 0
    there)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, ss, float("-inf"))


def ssd_chunked(xd: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                rows: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, in float32.

    xd (b, l, h, p) dt-prescaled inputs; dtA (b, l, h) dt * A (negative);
    B_ / C_ (b, l, n) the input and output projections (one group).
    Returns (y (b, l, h, p), final_state (b, h, p, n)).  Each product
    reduces over a chunk's positions or over n; with ``rows`` each goes
    through the rows-invariant kernel (``rows_einsum``), whose sums do
    not depend on b or the chunk count."""
    einsum = rows_einsum if rows else torch.einsum
    b, l, h, p = xd.shape
    n = B_.shape[-1]
    if l % chunk:
        raise ValueError(f"seq len {l} must divide chunk {chunk}")
    c = l // chunk
    xc = xd.reshape(b, c, chunk, h, p).float()
    ac = dtA.reshape(b, c, chunk, h).float()
    Bc = B_.reshape(b, c, chunk, n).float()
    Cc = C_.reshape(b, c, chunk, n).float()

    a_cum = torch.cumsum(ac, dim=2)                        # (b,c,k,h)
    # --- intra-chunk (matmul form) ---
    Lm = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))        # (b,c,h,k,l)
    scores = einsum("bckn,bcln->bckl", Cc, Bc)
    y_diag = einsum("bchkl,bclhp->bckhp", scores[:, :, None] * Lm, xc)
    # --- per-chunk states ---
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b,c,l,h)
    states = einsum("bclhp,bcln->bchpn", xc * decay_states[..., None], Bc)
    # --- inter-chunk recurrence: the state BEFORE each chunk ---
    chunk_decay = torch.exp(a_cum[:, :, -1, :])            # (b,c,h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xd.device)
         if initial_state is None else initial_state.float())
    prev = []
    for ci in range(c):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)
    # --- off-diagonal contribution ---
    y_off = (einsum("bckn,bchpn->bckhp", Cc, prev_states)
             * torch.exp(a_cum)[..., None])
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, s


def _tp_weights(p: dict, dims: MambaDims, tp):
    """A mamba block's weights as a token-split rank computes with them
    (``tp``, a ``dist.megatron.ServingTP``; ``p`` its blocks): ``(p, h0,
    nh)``, the rank's heads ``[h0, h0 + nh)``.  Where the heads split over
    the model axis, ``in_z``/``in_x``/``in_dt`` are already the rank's
    columns and the per-head and per-feature vectors are cut to them;
    otherwise every head is the rank's (the projections' column blocks
    gathered).  ``conv_w`` comes whole (a few rows: its channel blocks
    gathered), ``in_B``/``in_C``/``conv_b`` are whole."""
    H, P, di = dims.n_heads, dims.head_dim, dims.d_inner
    q = dict(p)
    if p["conv_w"].shape[-1] != dims.conv_channels:
        q["conv_w"] = tp.cat(p["conv_w"])
    if p["in_dt"].shape[-1] != H and H % tp.tp == 0 \
            and p["in_x"].shape[-1] != di:
        nh = H // tp.tp
        h0 = tp.m * nh
        for k in ("A_log", "D", "dt_bias"):
            q[k] = p[k].narrow(-1, h0, nh)
        q["norm"] = p["norm"].narrow(-1, h0 * P, nh * P)
        return q, h0, nh
    for k, n in (("in_z", di), ("in_x", di), ("in_dt", H)):
        if p[k].shape[-1] != n:
            q[k] = tp.cat(p[k])
    return q, 0, H


def _conv_block(t: torch.Tensor, dims: MambaDims, tp) -> torch.Tensor:
    """This rank's block of conv channels of ``t`` (..., conv_channels)
    where the decode state splits them over the model axis."""
    C = dims.conv_channels
    if tp is None or C % tp.tp:
        return t
    n = C // tp.tp
    return t.narrow(-1, tp.m * n, n)


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_channels) trailing conv inputs
    state: torch.Tensor  # (B, H, P, N) SSM state, float32


def init_mamba_cache(batch: int, dims: MambaDims, dtype=torch.float32,
                     device="cuda") -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, dims.conv_width - 1, dims.conv_channels),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, dims.n_heads, dims.head_dim,
                           dims.d_state), dtype=torch.float32,
                          device=device))


def mamba_forward(p: dict, x: torch.Tensor, dims: MambaDims, *,
                  chunk: int = 64,
                  initial_state: Optional[torch.Tensor] = None,
                  initial_conv: Optional[torch.Tensor] = None,
                  seq_len: Optional[torch.Tensor] = None,
                  return_state: bool = False, tp=None, rows: bool = False):
    """Full mamba2 block on (B, L, D).  Returns (out, MambaCache | None).

    ``initial_state`` (B, H, P, N) and ``initial_conv`` (B, W-1,
    conv_channels) continue an already processed prefix (prefix-KV chunked
    prefill): the scan starts from the saved state and the conv's first
    windows read the prefix's trailing raw xBC inputs.  ``seq_len`` (B,)
    marks each row's real length: dt is zeroed past it (an identity
    transition of the recurrence), and the returned conv tail is gathered
    at the row's real end.

    With ``tp`` (a ``dist.megatron.ServingTP``, ``p`` the rank's blocks)
    the block runs on the rank's heads (``_tp_weights``): its columns of
    z, x and dt, the conv on its x channels and the whole B and C, the
    scan, and the gated norm over its features (one sum of squares over
    the model group); ``out_proj`` is row-parallel.  The state it returns
    is its heads', the conv tail its block of channels (the tail's x
    channels gathered: ``W - 1`` rows).

    ``rows`` (``FwdOptions.rows_invariant``, not with ``tp``): the
    projections, the SSD's products and the gated norm through the
    rows-invariant kernels."""
    B, L, _ = x.shape
    di, n = dims.d_inner, dims.d_state
    W1 = dims.conv_width - 1
    h0, nh = 0, dims.n_heads
    if tp is not None:
        if initial_state is not None or initial_conv is not None:
            raise ValueError("a tensor-parallel mamba block starts from a "
                             "zero state (the recompute prefill)")
        p, h0, nh = _tp_weights(p, dims, tp)
    di_l, x0 = nh * dims.head_dim, h0 * dims.head_dim
    mm = rows_gemm if rows else torch.matmul
    z = mm(x, p["in_z"].to(x.dtype))
    x_raw = mm(x, p["in_x"].to(x.dtype))
    B_raw = mm(x, p["in_B"].to(x.dtype))
    C_raw = mm(x, p["in_C"].to(x.dtype))
    dt_raw = _dt_proj(x, p["in_dt"].to(x.dtype), rows)
    xbc_raw = torch.cat([x_raw, B_raw, C_raw], dim=-1)
    if initial_conv is not None:
        ic = initial_conv.to(x.dtype)
        icx, icB, icC = ic[..., :di_l], ic[..., di_l:di_l + n], \
            ic[..., di_l + n:]
    else:
        ic = torch.zeros_like(xbc_raw[:, :W1])   # the conv's zero left-pad
        icx = icB = icC = None
    full = torch.cat([ic, xbc_raw], dim=1)
    if seq_len is None:
        conv_tail = full[:, -W1:]
    else:
        # raw position q sits at index q + W1 of [ic | xbc_raw]: the tail
        # window [len - W1, len) is indices [len, len + W1)
        idx = (seq_len[:, None].long()
               + torch.arange(W1, device=x.device)[None, :])
        conv_tail = full.gather(
            1, idx[..., None].expand(-1, -1, full.shape[-1]))
    if tp is not None:
        if di_l != di:
            conv_tail = torch.cat([tp.cat(conv_tail[..., :di_l]),
                                   conv_tail[..., di_l:]], dim=-1)
        conv_tail = _conv_block(conv_tail, dims, tp)
    # the depthwise conv works per channel, so x / B / C convolve apart
    cw = p["conv_w"].to(x.dtype)
    cb = p["conv_b"].to(x.dtype)
    xs = silu(_causal_depthwise_conv(x_raw, cw[:, x0:x0 + di_l],
                                     cb[x0:x0 + di_l], icx))
    B_ = silu(_causal_depthwise_conv(B_raw, cw[:, di:di + n],
                                       cb[di:di + n], icB))
    C_ = silu(_causal_depthwise_conv(C_raw, cw[:, di + n:], cb[di + n:],
                                       icC))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B,L,H)
    if seq_len is not None:
        tok_ok = (torch.arange(L, device=x.device)[None, :]
                  < seq_len[:, None])
        dt = torch.where(tok_ok[:, :, None], dt, 0.0)
    A = -torch.exp(p["A_log"].float())                             # (H,)
    xh = xs.reshape(B, L, nh, dims.head_dim)
    pad = (-L) % chunk
    if pad and return_state and seq_len is None:
        raise ValueError(f"seq len {L} must divide chunk {chunk} when the "
                         "final state is needed (prefill) and no seq_len "
                         "mask marks the pad tail")
    if pad:
        # zero dt on the pad: identity transitions; the causal scan keeps
        # y[:, :L] exact whatever the tail holds
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        B_p = F.pad(B_, (0, 0, 0, pad))
        C_p = F.pad(C_, (0, 0, 0, pad))
    else:
        xh_p, dt_p, B_p, C_p = xh, dt, B_, C_
    y, final_state = ssd_chunked(xh_p.float() * dt_p[..., None], dt_p * A,
                                 B_p, C_p, chunk=chunk,
                                 initial_state=initial_state, rows=rows)
    if pad:
        y = y[:, :L]
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, L, di_l).to(x.dtype)
    out = gated_rms_norm(y, z, p["norm"].float(),
                         tp=tp if nh != dims.n_heads else None, rows=rows)
    out = _out_proj(p, out, dims, tp, rows)
    if return_state:
        return out, MambaCache(conv=conv_tail, state=final_state)
    return out, None


def _out_proj(p: dict, y: torch.Tensor, dims: MambaDims, tp,
              rows: bool = False) -> torch.Tensor:
    if tp is None:
        w = p["out_proj"].to(y.dtype)
        return rows_gemm(y, w) if rows else y @ w
    return tp.row({"w": p["out_proj"]}, y, dims.d_inner)


def mamba_decode_step(p: dict, x: torch.Tensor, cache: MambaCache,
                      dims: MambaDims,
                      tp=None) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrence.  x (B, D) -> (out (B, D), new cache).  The
    conv runs in float32 (its taps in order), the state update in
    float32.

    With ``tp`` (a ``dist.megatron.ServingTP``, ``p`` the rank's blocks)
    ``cache`` holds the rank's heads of the state and its block of conv
    channels (``decode_state_shardings``): the rank's x columns are
    gathered (a few rows), the conv runs on its channel block and its
    output is gathered, then the state update runs on its heads, the
    gated norm takes one sum of squares over the model group and
    ``out_proj`` is row-parallel."""
    B = x.shape[0]
    di, n = dims.d_inner, dims.d_state
    h0, nh = 0, dims.n_heads
    if tp is not None:
        p, h0, nh = _tp_weights(p, dims, tp)
    di_l, x0 = nh * dims.head_dim, h0 * dims.head_dim
    z = x @ p["in_z"].to(x.dtype)
    x_new = x @ p["in_x"].to(x.dtype)
    if di_l != di:
        x_new = tp.cat(x_new)
    xbc_new = torch.cat([x_new, x @ p["in_B"].to(x.dtype),
                         x @ p["in_C"].to(x.dtype)], dim=-1)
    dt_raw = x @ p["in_dt"].to(x.dtype)
    Cc = cache.conv.shape[-1]                  # the state's conv channels
    c0 = 0 if Cc == dims.conv_channels else tp.m * Cc
    window = torch.cat([cache.conv, xbc_new[:, None, c0:c0 + Cc].to(
        cache.conv.dtype)], dim=1)
    w32 = p["conv_w"].float()[:, c0:c0 + Cc]
    win32 = window.float()
    conv_out = win32[:, 0] * w32[0]
    for t in range(1, w32.shape[0]):
        conv_out = conv_out + win32[:, t] * w32[t]
    conv_out = conv_out + p["conv_b"].float()[c0:c0 + Cc]
    xbc = silu(conv_out).to(x.dtype)
    if Cc != dims.conv_channels:
        xbc = tp.cat(xbc)
    xs, B_, C_ = xbc[:, x0:x0 + di_l], xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, nh, dims.head_dim).float()
    decay = torch.exp(dt * A)                                      # (B,H)
    state = (cache.state * decay[..., None, None]
             + (xh * dt[..., None])[..., None]
             * B_.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, C_.float())
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, di_l).to(x.dtype)
    out = gated_rms_norm(y, z, p["norm"].float(),
                         tp=tp if nh != dims.n_heads else None)
    return _out_proj(p, out, dims, tp), MambaCache(conv=window[:, 1:],
                                                   state=state)
