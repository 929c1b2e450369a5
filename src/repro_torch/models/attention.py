"""Attention for serving: GQA, RoPE, slot KV cache (port of the slot subset
of ``repro/models/attention.py``).

The cache is updated IN PLACE, which JAX could not do: ``_chunk_write`` and
the decode write assign into the cache tensors the caller passes, and
``attn_mixed`` / ``attn_decode`` return that same dict.  A cache row is
written only at the positions its request really occupies, so a
``q_lens == 0`` row (or a decode row outside ``write_mask``) is untouched,
the property the reference gets from its read-modify-write and select.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, linear


def check_supported(cfg) -> None:
    """Raise for the configurations a later slice of the port brings."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    if cfg.kv_layout != "slot":
        raise NotImplementedError(
            "kv_layout='paged' needs the paged variant of the attention "
            "kernel, which a later slice ports")
    if cfg.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={cfg.kv_quant!r} needs the int8-KV variant of the "
            "attention kernel, which a later slice ports")
    if cfg.rope_type not in ("standard", "none"):
        raise NotImplementedError(f"rope_type {cfg.rope_type!r}")


def attn_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p: Params = {
        "wq": dense_init(gen, d, hq * hd, cfg.dtype),
        "wk": dense_init(gen, d, hkv * hd, cfg.dtype),
        "wv": dense_init(gen, d, hkv * hd, cfg.dtype),
        "wo": dense_init(gen, hq * hd, d, cfg.dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=cfg.dtype, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=cfg.dtype, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.dtype, device=dev)
    return p


def _project_qkv(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, hq, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, hkv, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, hkv, hd)
    q = q.transpose(1, 2)           # (b, h, s, d)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"])
        k = layers.rmsnorm(k, p["k_norm"])
    if cfg.rope_type == "standard":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k, v


def init_kv_cache(cfg, batch: int, max_len: int, device) -> Params:
    check_supported(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def kv_cache_slot_axes(cfg, axis: int = 1) -> Params:
    """Request-slot axis of each cache leaf (1 for a (layers, B, ...) stack)."""
    return {"k": axis, "v": axis}


def _chunk_write(cache_leaf: torch.Tensor, new: torch.Tensor,
                 starts: torch.Tensor, q_lens: torch.Tensor) -> None:
    """In place: row ``b`` writes ``new[b, :, :q_lens[b]]`` at positions
    ``starts[b] ..``; every other position keeps its value.  Callers
    guarantee ``starts + q_lens <= L``."""
    c = new.shape[2]
    j = torch.arange(c, device=new.device)
    rows, cols = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
    cache_leaf[rows, :, starts.long()[rows] + cols] = \
        new[rows, :, cols].to(cache_leaf.dtype)


def attn_mixed(cfg, p: Params, x: torch.Tensor, positions, cache: Params,
               lengths: torch.Tensor, q_lens: torch.Tensor):
    """Mixed prefill/decode step.  x (b, C, d); ``lengths`` (b,) = valid
    cache tokens BEFORE this step; ``q_lens`` (b,) = live new tokens per
    row.  Writes each row's live K/V at its true positions, then attends
    with intra-chunk causal masking.  Returns (out, cache)."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    _chunk_write(cache["k"], k, lengths, q_lens)
    _chunk_write(cache["v"], v, lengths, q_lens)
    o = ops.mixed_attention(q, cache["k"], cache["v"], lengths + q_lens,
                            q_lens, window=cfg.window)
    o = o.transpose(1, 2).reshape(b, c, cfg.n_heads * cfg.head_dim)
    return linear(o, p["wo"]), cache


def attn_decode(cfg, p: Params, x: torch.Tensor, positions, cache: Params,
                lengths: torch.Tensor, *,
                write_mask: torch.Tensor | None = None):
    """One-token decode.  x (b, 1, d); ``lengths`` (b,) = context length
    INCLUDING the new token.  ``write_mask`` (b,) bool keeps masked rows'
    caches untouched (the reference writes them and selects the old rows
    back; in place the write is simply skipped).  Returns (out, cache)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, positions)
    cache_len = cache["k"].shape[2]
    rolling = cfg.window is not None and cache_len <= cfg.window
    if rolling:
        # rolling SWA buffer: slot = pos mod window; RoPE is applied before
        # caching and softmax is permutation-invariant
        write_idx = (lengths - 1) % cache_len
        attn_len = torch.clamp(lengths, max=cache_len)
        attn_window = None
    else:
        write_idx = lengths - 1
        attn_len = lengths
        attn_window = cfg.window
    rows = torch.arange(b, device=x.device)
    if write_mask is not None:
        rows = rows[write_mask]
    write_idx = write_idx.long()
    cache["k"][rows, :, write_idx[rows]] = k[rows, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, write_idx[rows]] = v[rows, :, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q, cache["k"], cache["v"], attn_len,
                             window=attn_window)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return linear(o, p["wo"]), cache
