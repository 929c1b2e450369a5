"""Mamba2 (SSD) layer, port of ``repro/models/ssm.py``: the chunked scan
over a whole sequence and the recurrent decode step, for the Zamba2 hybrid
backbone (``models/zamba.py``).

The recurrence, per head, with state (n, P):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t

A whole sequence (``mamba_apply``) runs the chunked algorithm
(``_ssd_chunked``, chunks of ``CHUNK``): an intra-chunk quadratic term and
an inter-chunk state recurrence, as plain torch ops on every device (no
Pallas kernel covers it; it is ``forward``'s route, not the engine's).  One
decode step (``mamba_decode``) is, on the card, kernel 1 for ``in_proj``,
``ops.mamba_cell_gated`` (the conv, the state update in place, the readout
and the gated norm, one launch, ``kernels/mamba_cell.py``) and kernel 1 for
``out_proj``; ``mamba_apply`` gates its rows with ``ops.rmsnorm_gated``.
State math is f32; projections run in the model dtype and are quantizable
(W4A16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, linear

CHUNK = 128


def mamba_init(gen: torch.Generator, cfg) -> Params:
    """Random weights from ``gen`` on ``gen.device``: A = -exp(0) = -1,
    D = 1, dt_bias = 0, conv taps N(0, 0.1), as the reference's init."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen, device=dev,
                         dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, cfg.dtype),
        "conv_w": (conv_w * 0.1).to(cfg.dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=cfg.dtype, device=dev),
        "out_proj": dense_init(gen, di, d, cfg.dtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, xbc (B, L, C), w (K, C): the taps summed in
    the model dtype one at a time, as the reference's Python ``sum``."""
    k, seq = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:seq] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + seq] * w[i]
    return F.silu(out + b)


def _split_proj(cfg, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def mamba_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD, x (B, L, d_model) -> (B, L, d_model)."""
    bsz, seq, _ = x.shape
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    proj = linear(x, p["in_proj"])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(bsz, seq, h, ph)
    bm = xbc[..., di:di + n]
    cm = xbc[..., di + n:]
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y = _ssd_chunked(xs.to(f32), dt, a, bm.to(f32), cm.to(f32))
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(bsz, seq, di).to(x.dtype)
    y = ops.rmsnorm_gated(y, p["norm"], z)
    return linear(y, p["out_proj"])


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-triangular pairwise sums:
    out[i, j] = sum(a[j + 1 .. i]), -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xs, dt, a, bm, cm, chunk: int = CHUNK):
    """Chunked SSD: xs (b, L, H, P) f32, dt (b, L, H), a (H,), bm and cm
    (b, L, N).  L must be a multiple of the chunk (or at most one), as the
    reference asserts."""
    b, seq, h, ph = xs.shape
    n = bm.shape[-1]
    q = min(chunk, seq)
    nc = seq // q
    if seq % q:
        raise ValueError(f"_ssd_chunked: length {seq} is not a multiple of "
                         f"the {q}-token chunk")
    xs_c = xs.reshape(b, nc, q, h, ph)
    dt_c = dt.reshape(b, nc, q, h)
    b_c = bm.reshape(b, nc, q, n)
    c_c = cm.reshape(b, nc, q, n)

    a_c = dt_c * a[None, None, None, :]                   # (b, nc, q, h)
    lmat = torch.exp(_segsum(a_c.movedim(-1, 2)))         # (b, nc, h, q, q)
    # intra-chunk: Y[i] = sum_{j <= i} (C_i . B_j) L[i, j] dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    w = cb[:, :, None] * lmat * dt_c.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xs_c)
    # chunk-final states: S_c = sum_j exp(acum_last - acum_j) dt_j B_j x_j^T
    acum = torch.cumsum(a_c, dim=2)
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)
    s = torch.einsum("bcqh,bcqn,bcqhp->bchnp", decay_to_end * dt_c, b_c, xs_c)
    # inter-chunk recurrence: the state BEFORE each chunk
    chunk_decay = torch.exp(acum[:, :, -1, :])            # (b, nc, h)
    hprev = torch.zeros((b, h, n, ph), dtype=torch.float32, device=xs.device)
    before = []
    for c in range(nc):
        before.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s[:, c]
    hstates = torch.stack(before, dim=1)                  # (b, nc, h, n, p)
    # inter-chunk output: Y[i] += C_i . (exp(acum_i) * H_c)
    in_decay = torch.exp(acum)
    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", c_c, hstates, in_decay)
    return (y_intra + y_inter).reshape(b, seq, h, ph)


# -- decode --------------------------------------------------------------------

def mamba_cache_init(cfg, batch: int, device) -> Params:
    """The conv window (B, K - 1, d_inner + 2 n) in the model dtype and the
    SSM state (B, heads, n, P) f32, zeros."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=cfg.dtype, device=device),
        "state": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                 active: torch.Tensor | None = None):
    """One token, x (B, 1, d_model): returns (out (B, 1, d_model), cache),
    the window and state advanced in place for the rows in ``active`` (all
    when None)."""
    proj = linear(x, p["in_proj"])[:, 0]
    y = ops.mamba_cell_gated(proj, cache["conv"], p["conv_w"], p["conv_b"],
                             p["A_log"], p["D"], p["dt_bias"],
                             cache["state"], p["norm"],
                             n_state=cfg.ssm_state,
                             head_dim=cfg.ssm_head_dim, active=active)
    return linear(y[:, None], p["out_proj"]), cache
