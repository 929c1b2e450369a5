"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), port of
``repro/models/xlstm.py``.  [arXiv:2405.04517]

* mLSTM over a whole sequence runs the stabilized quadratic parallel form
  (``_mlstm_parallel``), or its chunkwise form past ``MLSTM_CHUNK`` tokens
  (``_mlstm_chunked``): plain tensor algebra, which the reference leaves to
  XLA.  One decode step is ``ops.mlstm_cell``: the gate projections and the
  (dh x dh) memory update with its readout, a fixed-order kernel on the
  card (``kernels/mlstm_cell.py``).
* sLSTM is strictly recurrent: both the whole sequence and one decode step
  run ``ops.slstm_scan`` (TPU kernel 8 on the card), the step at L = 1 from
  the cache's state.

Recurrent and state math is f32; projections run in the model dtype and
are quantizable (W4A16).  The gate projections ``w_i``/``w_f`` stay 16-bit
and their outputs are rounded to the model dtype before the f32 math, as
in the reference.  Decode updates the cache IN PLACE (the transformer's KV
cache does the same): ``C`` and the sLSTM state are written by the kernels,
``n`` and ``m`` copied from the cell's outputs; rows outside ``active`` keep
their state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, linear


# -- mLSTM --------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    di = 2 * d                       # projection factor 2
    h = cfg.n_heads
    dev = gen.device
    return {
        "norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "up_x": dense_init(gen, d, di, cfg.dtype),
        "up_z": dense_init(gen, d, di, cfg.dtype),
        "wq": dense_init(gen, di, di, cfg.dtype),
        "wk": dense_init(gen, di, di, cfg.dtype),
        "wv": dense_init(gen, di, di, cfg.dtype),
        "w_i": dense_init(gen, di, h, cfg.dtype, scale=0.01),
        "w_f": dense_init(gen, di, h, cfg.dtype, scale=0.01),
        "b_i": torch.zeros((h,), dtype=torch.float32, device=dev),
        # open forget gates at init
        "b_f": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=cfg.dtype, device=dev),
        "down": dense_init(gen, di, d, cfg.dtype),
    }


def _mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilized parallel mLSTM.  q/k/v (b, h, L, dh) f32; gates (b, h, L)
    f32."""
    L, dh = q.shape[-2:]
    fcum = torch.cumsum(F.logsigmoid(f_gate), dim=-1)        # sum_{1..t}
    # D[i, j] = sum_{k=j+1..i} logf_k + i_j  (j <= i)
    D = fcum[..., :, None] - fcum[..., None, :] + i_gate[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask, D, -torch.inf)
    m = torch.clamp(D.amax(dim=-1, keepdim=True), min=-1e30)
    S = q @ k.transpose(-1, -2) / math.sqrt(dh)
    W = S * torch.exp(D - m)
    norm = torch.maximum(W.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    return (W / norm) @ v


MLSTM_CHUNK = 256


def _mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilized mLSTM: the same function as the
    recurrence and the quadratic form in O(L * chunk) memory.  Per chunk,
    with the incoming state (C, n, m0) and local cumulative log-forget b_t,
    ``m_t = max(b_t + m0, max_{j<=t}(b_t - b_j + i_j))``; the carried state
    enters each output scaled by ``exp(b_t + m0 - m_t)``; the outgoing
    state takes t = chunk (the reference's docstring has the algebra)."""
    b, h, L, dh = q.shape
    c = min(chunk, L)
    pad = (-L) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        dead = torch.arange(L + pad, device=q.device) >= L
        i_gate = F.pad(i_gate, (0, pad)) - 1e30 * dead      # dead inputs
        f_gate = F.pad(f_gate, (0, pad))
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    C0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m0 = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    outs = []
    for s in range(0, L + pad, c):
        qc, kc, vc = (t[:, :, s:s + c] for t in (q, k, v))
        ic, fc = i_gate[..., s:s + c], f_gate[..., s:s + c]
        bcum = torch.cumsum(F.logsigmoid(fc), dim=-1)
        D = bcum[..., :, None] - bcum[..., None, :] + ic[..., None, :]
        D = torch.where(tri, D, -torch.inf)
        m_t = torch.maximum(bcum + m0[..., None], D.amax(dim=-1))
        m_t = torch.clamp(m_t, min=-1e30)

        S = qc @ kc.transpose(-1, -2) / math.sqrt(dh)
        W = S * torch.exp(D - m_t[..., None])
        carry_scale = torch.exp(bcum + m0[..., None] - m_t)  # (b, h, c)
        num = carry_scale[..., None] * (qc @ C0) + W @ vc
        den = (carry_scale * torch.einsum("bhid,bhd->bhi", qc, n0)
               + W.sum(dim=-1))
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])

        # outgoing state at t = c
        b_end = bcum[..., -1:]
        m_new = m_t[..., -1]
        decay = torch.exp(b_end + m0[..., None] - m_new[..., None])  # (b,h,1)
        w_j = torch.exp(b_end - bcum + ic - m_new[..., None])       # (b,h,c)
        k_s = kc / math.sqrt(dh)
        C0 = C0 * decay[..., None] + torch.einsum("bhj,bhjd,bhje->bhde",
                                                  w_j, k_s, vc)
        n0 = n0 * decay + torch.einsum("bhj,bhjd->bhd", w_j, k_s)
        m0 = m_new
    return torch.cat(outs, dim=2)[:, :, :L]


def _gate_preacts(xp, p: Params):
    """``linear(xp, w) -> model dtype -> f32 + b`` for the input and forget
    gates, (..., h) each."""
    return tuple(linear(xp, p[w]).to(torch.float32) + p[bias]
                 for w, bias in (("w_i", "b_i"), ("w_f", "b_f")))


def mlstm_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One mLSTM block over a whole sequence: x (b, L, d)."""
    b, L, _ = x.shape
    h = cfg.n_heads
    xi = layers.rmsnorm(x, p["norm"])
    xp = linear(xi, p["up_x"])
    z = linear(xi, p["up_z"])
    di = xp.shape[-1]
    dh = di // h

    def heads(t):
        return t.reshape(b, L, h, dh).transpose(1, 2).to(torch.float32)

    q, k, v = (heads(linear(xp, p[w])) for w in ("wq", "wk", "wv"))
    ig, fg = (g.transpose(1, 2) for g in _gate_preacts(xp, p))
    if L > MLSTM_CHUNK:
        y = _mlstm_chunked(q, k, v, ig, fg)                  # O(L·C) memory
    else:
        y = _mlstm_parallel(q, k, v, ig, fg)                 # (b, h, L, dh)
    y = y.transpose(1, 2).reshape(b, L, di).to(x.dtype)
    y = layers.rmsnorm(y, p["out_norm"]) * F.silu(z)
    return x + linear(y, p["down"])


def mlstm_cache_init(cfg, batch: int, device) -> Params:
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), -1e30, **f32)}


def mlstm_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                 active: torch.Tensor | None = None):
    """One token, x (b, 1, d); ``cache`` (C, n, m) is updated in place for
    the rows in ``active`` (all when None)."""
    b = x.shape[0]
    h = cfg.n_heads
    xi = layers.rmsnorm(x, p["norm"])
    xp = linear(xi, p["up_x"])
    z = linear(xi, p["up_z"])
    di = xp.shape[-1]
    q, k, v = (linear(xp, p[w]).reshape(b, h, di // h)
               for w in ("wq", "wk", "wv"))
    y, n_new, m_new = ops.mlstm_cell(
        xp[:, 0], q, k, v, p["w_i"], p["w_f"], p["b_i"], p["b_f"],
        cache["C"], cache["n"], cache["m"], active=active)
    cache["n"].copy_(n_new)
    cache["m"].copy_(m_new)
    y = y.reshape(b, 1, di).to(x.dtype)
    y = layers.rmsnorm(y, p["out_norm"]) * F.silu(z)
    return x + linear(y, p["down"]), cache


# -- sLSTM --------------------------------------------------------------------

def _slstm_heads(cfg) -> tuple[int, int]:
    h = max(cfg.n_heads, 1)
    return h, cfg.d_model // h


def slstm_init(gen: torch.Generator, cfg) -> Params:
    """The recurrence is block-diagonal over heads, as in the xLSTM paper:
    R is (h, dh, 4dh)."""
    d = cfg.d_model
    h, dh = _slstm_heads(cfg)
    dev = gen.device
    r = torch.randn((h, dh, 4 * dh), generator=gen, device=dev,
                    dtype=torch.float32)
    return {
        "norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "w_gates": dense_init(gen, d, 4 * d, cfg.dtype),     # z, i, f, o
        "r_gates": (r * 0.01).to(cfg.dtype),
        "b_gates": torch.zeros((h, 4 * dh), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "down": dense_init(gen, d, d, cfg.dtype),
    }


def _slstm_block(cfg, p: Params, x: torch.Tensor, state, active):
    b, L, d = x.shape
    h, dh = _slstm_heads(cfg)
    xi = layers.rmsnorm(x, p["norm"])
    gates_x = linear(xi, p["w_gates"]).to(torch.float32).reshape(
        b, L, h, 4 * dh)
    hs = ops.slstm_scan(gates_x, p["r_gates"], p["b_gates"], state,
                        active=active)
    y = layers.rmsnorm(hs.reshape(b, L, d).to(x.dtype), p["out_norm"])
    return x + linear(y, p["down"])


def slstm_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One sLSTM block over a whole sequence from a fresh state."""
    return _slstm_block(cfg, p, x, None, None)


def slstm_cache_init(cfg, batch: int, device) -> Params:
    h, dh = _slstm_heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "h": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h, dh), -1e30, **f32)}


def slstm_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                 active: torch.Tensor | None = None):
    """One token: the scan at L = 1 from the cache's (c, n, h, m), which it
    updates in place for the rows in ``active``."""
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    return _slstm_block(cfg, p, x, state, active), cache
