"""Dense oracles (the port of ``repro/kernels/ref.py``, main-path subset).

Each is the semantic ground truth in its most obvious dense form, in f32:
readability over speed.  ``ops`` reaches them with ``impl="ref"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import QuantizedTensor, unpack_int4
from repro_torch.core.sparsity import (
    SparseQuantizedTensor, sparse_to_quantized)

__all__ = ["w4a16_matmul_ref", "sparse_w4a16_matmul_ref", "dense_matmul_ref",
           "ffn_ref",
           "attention_ref", "decode_attention_ref", "mixed_attention_ref",
           "slstm_scan_ref"]


def w4a16_matmul_ref(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Group-exact oracle: per-128-group integer-exact f32 dot, scale
    applied to the group's partial sum, groups summed, cast to x's dtype."""
    in_f, out_f = qt.shape
    g = qt.group_size
    q = unpack_int4(qt.packed, g).to(torch.float32)
    xg = x.reshape(*x.shape[:-1], in_f // g, g).to(torch.float32)
    qg = q.reshape(in_f // g, g, out_f)
    partial = torch.einsum("...kg,kgo->...ko", xg, qg)
    out = (partial * qt.scales.to(torch.float32)).sum(dim=-2)
    return out.to(x.dtype)


def sparse_w4a16_matmul_ref(x: torch.Tensor,
                            st: SparseQuantizedTensor) -> torch.Tensor:
    """Dense oracle of the block-sparse matmul: the kept blocks scattered
    back into the dense W4A16 layout (zero scales for dropped blocks), then
    the group-exact dot of :func:`w4a16_matmul_ref`."""
    return w4a16_matmul_ref(x, sparse_to_quantized(st))


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """16-bit-weight oracle: the weight in x's dtype, the dot in f32, the
    bias in f32, cast to x's dtype."""
    y = torch.einsum("...k,ko->...o", x.to(torch.float32),
                     w.to(x.dtype).to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def _mm(x, w, b=None):
    if isinstance(w, QuantizedTensor):
        y = w4a16_matmul_ref(x, w)
    elif isinstance(w, SparseQuantizedTensor):
        y = sparse_w4a16_matmul_ref(x, w)
    else:
        y = (x @ w.to(x.dtype)).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def ffn_ref(x, gate, up, down, *, activation="swiglu", up_bias=None,
            down_bias=None) -> torch.Tensor:
    """Unfused FFN oracle: three independent matmuls, activation in the
    compute dtype (the reference's ``mlp_apply`` composition)."""
    if activation == "swiglu":
        return _mm(torch.nn.functional.silu(_mm(x, gate)) * _mm(x, up), down)
    if activation == "geglu":
        return _mm(_gelu(_mm(x, gate)) * _mm(x, up), down)
    if activation == "gelu":
        return _mm(_gelu(_mm(x, up, up_bias)), down, down_bias)
    raise ValueError(f"unknown activation {activation!r}")


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  scale=None) -> torch.Tensor:
    """Dense full-sequence oracle.  q (b, hq, sq, d), k/v (b, hkv, skv, d),
    GQA by repeating K/V; q occupies the LAST sq positions of the skv
    context; ``window`` = sliding-window size; f32 softmax (a row with no
    visible key gives NaN, as the reference's)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    rep = hq // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    dev = q.device
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    q_pos = torch.arange(sq, device=dev) + (skv - sq)
    k_pos = torch.arange(skv, device=dev)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    logits = torch.where(mask, logits, torch.tensor(-torch.inf, device=dev))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def mixed_attention_ref(q, k_cache, v_cache, lengths, q_lens, *,
                        window=None, scale=None) -> torch.Tensor:
    """Chunked q against the whole cache, dense.  q (b, hq, C, d); caches
    (b, hkv, MAX, d); ``lengths`` (b,) includes the chunk; query j of row b
    sits at ``lengths - q_lens + j``; dead queries return exact zeros."""
    b, hq, c, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    dev = q.device
    lengths = torch.as_tensor(lengths, device=dev).reshape(-1).expand(b).long()
    q_lens = torch.as_tensor(q_lens, device=dev).reshape(-1).expand(b).long()
    qg = q.reshape(b, hkv, rep, c, d).to(torch.float32)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg,
                          k_cache.to(torch.float32)) * scale
    pos = torch.arange(max_len, device=dev)
    j = torch.arange(c, device=dev)
    q_pos = (lengths - q_lens)[:, None] + j[None, :]
    valid = pos[None, None, :] < torch.clamp(lengths, max=max_len)[:, None,
                                                                   None]
    valid = valid & (pos[None, None, :] <= q_pos[:, :, None])
    valid = valid & (j[None, :] < q_lens[:, None])[..., None]
    if window is not None:
        valid = valid & (pos[None, None, :] > q_pos[:, :, None] - window)
    vm = valid[:, None, None]
    logits = torch.where(vm, logits, torch.tensor(-torch.inf, device=dev))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.clamp(m, min=-1e30))
    p = torch.where(vm, p, torch.zeros((), device=dev))
    denom = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(denom == 0, torch.ones((), device=dev), denom)
    out = torch.einsum("bgrqk,bgkd->bgrqd",
                       probs.to(q.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, hq, c, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, length, *, window=None,
                         scale=None) -> torch.Tensor:
    """Single-token decode oracle: the ``q_lens = 1`` case."""
    b = q.shape[0]
    ones = torch.ones(b, dtype=torch.int32, device=q.device)
    return mixed_attention_ref(q, k_cache, v_cache, length, ones,
                               window=window, scale=scale)


def slstm_scan_ref(gates_x, r, b, state=None) -> torch.Tensor:
    """The straight ``_slstm_step`` loop of ``repro/models/xlstm.py:249``:
    gates_x (B, L, h, 4dh), r (h, dh, 4dh), b (h, 4dh) -> hs (B, L, h, dh),
    from ``state = (c, n, h, m)`` or zeros with ``m = -1e30``; the state is
    not written back."""
    bsz, seq, heads, g4 = gates_x.shape
    dh = g4 // 4
    if state is None:
        z = torch.zeros((bsz, heads, dh), dtype=torch.float32,
                        device=gates_x.device)
        state = (z, z, z, torch.full_like(z, -1e30))
    c, n, hid, m = state
    rf = r.to(torch.float32)
    hs = []
    for t in range(seq):
        gates = gates_x[:, t] + torch.einsum("bhd,hde->bhe", hid, rf) + b[None]
        z_t = torch.tanh(gates[..., :dh])
        i_t = gates[..., dh:2 * dh]
        f_t = gates[..., 2 * dh:3 * dh]
        o_t = torch.sigmoid(gates[..., 3 * dh:])
        logf = torch.nn.functional.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        i_act = torch.exp(i_t - m_new)
        f_act = torch.exp(logf + m - m_new)
        c = f_act * c + i_act * z_t
        n = torch.maximum(f_act * n + i_act, torch.exp(-m_new))
        hid = o_t * c / n
        m = m_new
        hs.append(hid)
    return torch.stack(hs, dim=1)
