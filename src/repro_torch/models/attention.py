"""Attention: GQA, RoPE, slot or paged KV cache, fp or int8 K/V (port of
the dense path of ``repro/models/attention.py``).  The full-sequence path
(``attn_apply``, ``attn_prefill``) runs ``ops.attention``; the serving
steps (``attn_mixed``, ``attn_decode``) run ``ops.mixed_attention``
against the cache.

The cache is updated IN PLACE, which JAX could not do: ``ops.kv_write``
writes one layer's K/V leaves into the cache tensors the caller passes (one
kernel launch a layer on the card, reading ``q_lens`` / the write mask on
the device, so no step reads a device value on the host), and
``attn_mixed`` / ``attn_decode`` return that same dict.  A cache row is
written only at the positions its request really occupies, so a ``q_lens
== 0`` row (or a decode row outside ``write_mask``) is untouched, the
property the reference gets from its read-modify-write and select.
Paged: the reference routes dead positions and masked rows to the null
block; here they are skipped, so no write ever lands in a block the row
has not leased and the null block is never written (nor read: the
kernels address only a row's live pages).

Paged layout.  Per layer the pool leaf is ``(n_blocks + 1, hkv, bs, hd)``;
the LAST block is the null block, and page-table entries of pages a slot
has not leased point there, so a stale table never aliases a live block.
The page table ``(B, pages_per_slot)`` of physical block ids is host-owned
(the engine leases and frees blocks) and rides into each dispatch as a
tensor: logical position ``p`` of slot ``b`` lives at
``pool[page_table[b, p // bs], :, p % bs]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_flash import PAGE_SIZES
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, linear


def check_supported(cfg, device=None) -> None:
    """Raise for the configurations a later slice of the port brings, and
    for a page size the paged kernel does not take when ``device`` is a
    CUDA device (the CPU's plain version takes any).  The ssm family has no
    KV cache and ignores the KV options, as in the reference."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and ssm only)")
    if cfg.family == "ssm":
        return
    if cfg.kv_quant not in ("none", "int8"):
        raise NotImplementedError(f"kv_quant {cfg.kv_quant!r} is not ported")
    if cfg.rope_type not in ("standard", "none"):
        raise NotImplementedError(f"rope_type {cfg.rope_type!r} is not ported")
    if (cfg.kv_layout == "paged" and device is not None
            and torch.device(device).type == "cuda"
            and cfg.kv_block_size not in PAGE_SIZES):
        raise NotImplementedError(
            f"kv_block_size={cfg.kv_block_size}: the paged attention kernel "
            f"takes pages of {PAGE_SIZES.start} to {PAGE_SIZES.stop - 1} "
            "tokens (the reference's kernel wants >= 8; the CUDA tile holds "
            "at most 128 keys)")


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


def _merge_heads(cfg, o: torch.Tensor) -> torch.Tensor:
    """(b, h, s, hd) attention output -> (b, s, h * hd) for ``wo``."""
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)


PAGED_PREFILL_ERROR = (
    "paged KV caches have no full-sequence prefill path — serve through "
    "mixed_step/decode_step (chunked admission); the standalone api.prefill "
    "is a slot-layout/training surface")


def attn_apply(cfg, p: Params, x: torch.Tensor, positions, *,
               causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (forward): every query against the whole
    sequence through ``ops.attention`` (the flash kernel on the card)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = ops.attention(q, k, v, causal=causal, window=cfg.window)
    return linear(_merge_heads(cfg, o), p["wo"])


def attn_prefill(cfg, p: Params, x: torch.Tensor, positions, cache: Params):
    """Whole-prompt prefill: full attention over the prompt AND the slot
    cache written in place from position 0 (fp, or int8 through
    ``quantize_kv``).  With a cache shorter than the prompt (a rolling
    window) only the last ``cache_len`` tokens' K/V are kept, the set a
    windowed decode will ever read.  Returns (out, cache)."""
    if cfg.kv_layout == "paged":
        raise ValueError(PAGED_PREFILL_ERROR)
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = ops.attention(q, k, v, causal=True, window=cfg.window)
    out = linear(_merge_heads(cfg, o), p["wo"])
    cache_len = cache["k"].shape[2]
    if cache_len < k.shape[2]:
        k, v = k[:, :, -cache_len:], v[:, :, -cache_len:]
    for name, new in _new_kv(cfg, k, v).items():
        cache[name][:, :, :new.shape[2]] = new.to(cache[name].dtype)
    return out, cache


# -- paged KV layout ---------------------------------------------------------

def paged_blocks_for(length: int, block_size: int) -> int:
    """Blocks needed to cover ``length`` logical tokens (ceil division)."""
    return -(-length // block_size)


def paged_geometry(cfg, max_len: int) -> tuple[int, int]:
    """(block_size, pages_per_slot) for a paged cache addressing ``max_len``
    logical positions per slot (the last page may be partially
    addressable)."""
    bs = cfg.kv_block_size
    return bs, paged_blocks_for(max_len, bs)


def paged_pool_blocks(cfg, batch: int, max_len: int) -> int:
    """Usable (non-null) pool blocks: ``cfg.kv_pool_blocks`` or the slot
    layout's exact capacity ``batch * pages_per_slot``."""
    _, n_pages = paged_geometry(cfg, max_len)
    return cfg.kv_pool_blocks or batch * n_pages


def default_page_table(batch: int, pool_blocks: int,
                       device=None) -> torch.Tensor:
    """Linear identity table for a default-sized pool (slot ``b`` owns
    blocks ``b*pages .. (b+1)*pages-1``), the layout bit-equivalent to the
    slot cache.  ``pool_blocks`` is the pool leaf's leading dim INCLUDING
    the null block."""
    n_pages = (pool_blocks - 1) // batch
    return torch.arange(batch * n_pages, dtype=torch.int32,
                        device=device).reshape(batch, n_pages)


def _kv_leaves(cfg, shape: tuple, device) -> Params:
    """K/V leaves of one layer with token axes ``shape`` (..., hd): the
    activation dtype, or int8 with per-(token, head) f32 scales."""
    if cfg.kv_quant == "int8":
        scale_shape = (*shape[:-1], 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scale_shape, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_kv_cache_paged(cfg, batch: int, max_len: int, device) -> Params:
    """Shared-pool paged KV leaves (one layer): ``(P+1, hkv, bs, hd)``."""
    bs, _ = paged_geometry(cfg, max_len)
    p = paged_pool_blocks(cfg, batch, max_len) + 1   # + null block (last)
    return _kv_leaves(cfg, (p, cfg.n_kv_heads, bs, cfg.head_dim), device)


def init_kv_cache(cfg, batch: int, max_len: int, device) -> Params:
    check_supported(cfg, device)
    if cfg.kv_layout == "paged":
        return init_kv_cache_paged(cfg, batch, max_len, device)
    return _kv_leaves(cfg, (batch, cfg.n_kv_heads, max_len, cfg.head_dim),
                      device)


def kv_cache_slot_axes(cfg, axis: int = 1) -> Params:
    """Request-slot axis of each cache leaf (1 for a (layers, B, ...)
    stack).  Paged leaves are SHARED pools with no slot axis, marked with
    the ``-1`` sentinel."""
    if cfg.kv_layout == "paged":
        axis = -1
    axes: Params = {"k": axis, "v": axis}
    if cfg.kv_quant == "int8":
        axes["k_scale"] = axis
        axes["v_scale"] = axis
    return axes


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) -> int8 values + per-vector absmax scale (round half to
    even, as ``jnp.round``)."""
    tf = t.to(torch.float32)
    a = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(a / 127.0, min=1e-10)
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _new_kv(cfg, k: torch.Tensor, v: torch.Tensor) -> Params:
    """This step's K/V (b, hkv, s, hd) as the cache stores them."""
    if cfg.kv_quant != "int8":
        return {"k": k, "v": v}
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _scales(cache: Params) -> dict:
    return {"k_scale": cache.get("k_scale"), "v_scale": cache.get("v_scale")}


def attn_mixed(cfg, p: Params, x: torch.Tensor, positions, cache: Params,
               lengths: torch.Tensor, q_lens: torch.Tensor, *,
               page_table: torch.Tensor | None = None):
    """Mixed prefill/decode step.  x (b, C, d); ``lengths`` (b,) = valid
    cache tokens BEFORE this step; ``q_lens`` (b,) = live new tokens per
    row.  Writes each row's live K/V at its true positions (through
    ``page_table`` for a paged pool: None = the linear default table of a
    default-sized pool), then attends with intra-chunk causal masking.
    Requires ``lengths + q_lens <= cache span``, so a rolling window never
    wraps here and ``cfg.window`` masks directly.  Returns (out, cache)."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cfg.kv_layout == "paged" and page_table is None:
        page_table = default_page_table(b, cache["k"].shape[0], x.device)
    ops.kv_write(cache, _new_kv(cfg, k, v), lengths, q_lens,
                 page_table=page_table)
    o = ops.mixed_attention(q, cache["k"], cache["v"], lengths + q_lens,
                            q_lens, window=cfg.window, page_table=page_table,
                            **_scales(cache))
    return linear(_merge_heads(cfg, o), p["wo"]), cache


def attn_decode(cfg, p: Params, x: torch.Tensor, positions, cache: Params,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None):
    """One-token decode.  x (b, 1, d); ``lengths`` (b,) = context length
    INCLUDING the new token.  ``write_mask`` (b,) bool keeps masked rows'
    caches untouched (the reference writes them and selects the old rows
    back, or routes a paged write to the null block; in place the write is
    simply skipped).  A window no longer than the cache span makes it a
    rolling buffer (slot = position mod span), on a paged pool as on the
    slot cache.  Returns (out, cache)."""
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, positions)
    paged = cfg.kv_layout == "paged"
    if paged:
        if page_table is None:
            page_table = default_page_table(b, cache["k"].shape[0], x.device)
        span = page_table.shape[1] * cache["k"].shape[2]
    else:
        span = cache["k"].shape[2]
    rolling = cfg.window is not None and span <= cfg.window
    if rolling:
        # rolling SWA buffer: slot = pos mod span; RoPE is applied before
        # caching and softmax is permutation-invariant
        write_idx = (lengths - 1) % span
        attn_len = torch.clamp(lengths, max=span)
        attn_window = None
    else:
        write_idx = torch.clamp(lengths - 1, 0, span - 1)
        attn_len = lengths
        attn_window = cfg.window
    live = (torch.ones(b, dtype=torch.int32, device=x.device)
            if write_mask is None else write_mask.to(torch.int32))
    ops.kv_write(cache, _new_kv(cfg, k, v), write_idx, live,
                 page_table=page_table)
    o = ops.decode_attention(q, cache["k"], cache["v"], attn_len,
                             window=attn_window, page_table=page_table,
                             **_scales(cache))
    return linear(_merge_heads(cfg, o), p["wo"]), cache
