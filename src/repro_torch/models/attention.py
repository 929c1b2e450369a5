"""Attention: GQA, RoPE or M-RoPE, slot or paged KV cache, fp or int8 K/V
(port of the dense path of ``repro/models/attention.py``).  The
full-sequence path (``attn_apply``, ``attn_prefill``) runs
``ops.attention``; the serving steps (``attn_mixed``, ``attn_decode``) run
``ops.mixed_attention`` against the cache.  Whisper's decoder
cross-attention (``cross_kv``, ``cross_attn_apply``) runs
``ops.attention`` without a mask over the request's encoder K/V.

The cache is updated IN PLACE, which JAX could not do: in the serving steps
``ops.qkv_rope_write`` takes a layer's raw q/k/v projections, adds their
biases, applies a ``qk_norm`` config's per-head q/k RMSNorm and RoPE,
quantizes K/V for an int8 cache and writes them into
the cache tensors the caller passes (one kernel launch a layer on the card,
reading ``q_lens`` / the write mask on the device, so no step reads a
device value on the host), and ``attn_mixed`` / ``attn_decode`` return
that same dict.  The step's index tensors (``StepIndex``: write positions,
attention lengths, the write mask) are computed once a step, not once a
layer.  A cache row is written only at the positions its request really
occupies, so a ``q_lens == 0`` row (or a decode row outside
``write_mask``) is untouched, the property the reference gets from its
read-modify-write and select.
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

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_flash import PAGE_SIZES
from repro_torch.kernels.kv_write import (  # noqa: F401 (this module's too)
    dequantize_kv, quantize_kv)
from repro_torch.models import layers
from repro_torch.models.layers import Params, dense_init, linear


def check_supported(cfg, device=None) -> None:
    """Raise for the configurations a later slice of the port brings, and
    for a page size the paged kernel does not take when ``device`` is a
    CUDA device (the CPU's plain version takes any).  The ssm family has no
    KV cache and ignores the KV options, as in the reference; a ``moe``
    config with no experts is a dense model, as in the reference."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (dense, moe, vlm, ssm, "
            "hybrid and audio only)")
    if cfg.family == "ssm":
        return
    if cfg.family == "audio" and cfg.rope_type != "none":
        raise NotImplementedError(
            f"an audio config with rope_type {cfg.rope_type!r} is not ported "
            "(Whisper's positions are sinusoids added to its inputs)")
    if cfg.kv_quant not in ("none", "int8"):
        raise NotImplementedError(f"kv_quant {cfg.kv_quant!r} is not ported")
    if cfg.rope_type not in ("standard", "mrope", "none"):
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
    """q (contiguous), k, v (b, h, s, hd) of x (b, s, d), biased, normed
    (``qk_norm``) and rotated at ``positions``: (b, s), or (3, b, s) ids
    for M-RoPE."""
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
    elif cfg.rope_type == "mrope":
        q = layers.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = layers.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
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
    b, n = k.shape[0], k.shape[2]
    zeros = torch.zeros(b, dtype=torch.int32, device=k.device)
    ops.kv_write(cache, _new_kv(cfg, k, v), zeros, zeros + n)
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


def _new_kv(cfg, k: torch.Tensor, v: torch.Tensor) -> Params:
    """This step's K/V (b, hkv, s, hd) as the cache stores them."""
    if cfg.kv_quant != "int8":
        return {"k": k, "v": v}
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _scales(cache: Params) -> dict:
    return {"k_scale": cache.get("k_scale"), "v_scale": cache.get("v_scale")}


@dataclasses.dataclass
class StepIndex:
    """A serving step's index tensors, shared by every layer: RoPE at
    positions ``rope_base[b] + j``, K/V written at ``starts[b] + j`` for
    ``j < q_lens[b]``, attention over ``attn_len`` with ``attn_q_lens``
    live queries, ``window`` (None after a rolling window's wrap) and
    ``page_table`` (None: the slot layout).  ``rolling``: a rolling
    window's decode, whose RoPE positions run past the cache span and so
    past the fused epilogue's table (``kv_write.rope_rows``)."""
    rope_base: torch.Tensor
    starts: torch.Tensor
    q_lens: torch.Tensor
    attn_len: torch.Tensor
    attn_q_lens: torch.Tensor
    window: int | None
    page_table: torch.Tensor | None
    rolling: bool = False


def _span(cfg, cache: Params, b: int, page_table, device):
    """(page_table, logical span a row addresses) of one layer's cache; a
    paged pool without a table takes the default table."""
    if cfg.kv_layout != "paged":
        return None, cache["k"].shape[2]
    if page_table is None:
        page_table = default_page_table(b, cache["k"].shape[0], device)
    return page_table, page_table.shape[1] * cache["k"].shape[2]


def mixed_index(cfg, cache: Params, b: int, lengths: torch.Tensor,
                q_lens: torch.Tensor, page_table=None) -> StepIndex:
    """The index tensors of a mixed step (``cache``: any one layer's
    leaves)."""
    page_table, _ = _span(cfg, cache, b, page_table, lengths.device)
    return StepIndex(rope_base=lengths, starts=lengths, q_lens=q_lens,
                     attn_len=lengths + q_lens, attn_q_lens=q_lens,
                     window=cfg.window, page_table=page_table)


def decode_index(cfg, cache: Params, b: int, lengths: torch.Tensor,
                 page_table=None, write_mask=None) -> StepIndex:
    """The index tensors of a decode step (``lengths`` include the new
    token).  A window no longer than the cache span makes the cache a
    rolling buffer (slot = position mod span), on a paged pool as on the
    slot cache."""
    page_table, span = _span(cfg, cache, b, page_table, lengths.device)
    rolling = cfg.window is not None and span <= cfg.window
    if rolling:
        # rolling SWA buffer: slot = pos mod span; RoPE is applied before
        # caching and softmax is permutation-invariant
        write_idx = (lengths - 1) % span
        attn_len = torch.clamp(lengths, max=span)
        window = None
    else:
        write_idx = torch.clamp(lengths - 1, 0, span - 1)
        attn_len = lengths
        window = cfg.window
    ones = torch.ones(b, dtype=torch.int32, device=lengths.device)
    live = ones if write_mask is None else write_mask.to(torch.int32)
    return StepIndex(rope_base=lengths - 1, starts=write_idx, q_lens=live,
                     attn_len=attn_len, attn_q_lens=ones, window=window,
                     page_table=page_table, rolling=rolling)


def _qkv_into_cache(cfg, p: Params, x: torch.Tensor, cache: Params,
                    index: StepIndex) -> torch.Tensor:
    """Project q/k/v, write this step's K/V into ``cache`` and return q
    (b, h, s, d): the fused epilogue (``ops.qkv_rope_write``) after the
    bias-free projections, a ``qk_norm`` config's per-head q/k norm (between
    the bias and RoPE) inside it.  A rolling window's decode keeps the
    unfused chain: its positions run past the epilogue's RoPE table (the
    cache span).  A serving step's position ids come from the row lengths,
    so an M-RoPE config's three streams are equal there, and M-RoPE is
    the standard rotation (``apply_mrope``): the epilogue reads the
    standard table."""
    if index.rolling:
        c = x.shape[1]
        positions = index.rope_base[:, None] + torch.arange(
            c, dtype=index.rope_base.dtype, device=x.device)[None, :]
        q, k, v = _project_qkv(cfg, p, x, layers.rope_ids(cfg, positions))
        ops.kv_write(cache, _new_kv(cfg, k, v), index.starts, index.q_lens,
                     page_table=index.page_table)
        return q
    theta = None if cfg.rope_type == "none" else cfg.rope_theta
    return ops.qkv_rope_write(
        cache, linear(x, p["wq"]), linear(x, p["wk"]), linear(x, p["wv"]),
        (p.get("bq"), p.get("bk"), p.get("bv")), n_heads=cfg.n_heads,
        theta=theta, rope_base=index.rope_base,
        starts=index.starts, q_lens=index.q_lens,
        page_table=index.page_table, q_norm=p.get("q_norm"),
        k_norm=p.get("k_norm"))


def attn_mixed(cfg, p: Params, x: torch.Tensor, cache: Params,
               lengths: torch.Tensor, q_lens: torch.Tensor, *,
               page_table: torch.Tensor | None = None,
               index: StepIndex | None = None):
    """Mixed prefill/decode step.  x (b, C, d); ``lengths`` (b,) = valid
    cache tokens BEFORE this step; ``q_lens`` (b,) = live new tokens per
    row.  Writes each row's live K/V at its true positions (through
    ``page_table`` for a paged pool: None = the linear default table of a
    default-sized pool), then attends with intra-chunk causal masking.
    Requires ``lengths + q_lens <= cache span``, so a rolling window never
    wraps here and ``cfg.window`` masks directly.  ``index``: the step's
    ``mixed_index``, computed here when not given.  Returns (out, cache)."""
    if index is None:
        index = mixed_index(cfg, cache, x.shape[0], lengths, q_lens,
                            page_table)
    q = _qkv_into_cache(cfg, p, x, cache, index)
    o = ops.mixed_attention(q, cache["k"], cache["v"], index.attn_len,
                            index.attn_q_lens, window=index.window,
                            page_table=index.page_table, **_scales(cache))
    return linear(_merge_heads(cfg, o), p["wo"]), cache


def attn_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None,
                index: StepIndex | None = None):
    """One-token decode.  x (b, 1, d); ``lengths`` (b,) = context length
    INCLUDING the new token.  ``write_mask`` (b,) bool keeps masked rows'
    caches untouched (the reference writes them and selects the old rows
    back, or routes a paged write to the null block; in place the write is
    simply skipped).  A window no longer than the cache span makes it a
    rolling buffer (``decode_index``).  ``index``: the step's
    ``decode_index``, computed here when not given.  Returns (out, cache)."""
    if index is None:
        index = decode_index(cfg, cache, x.shape[0], lengths, page_table,
                             write_mask)
    q = _qkv_into_cache(cfg, p, x, cache, index)
    o = ops.decode_attention(q, cache["k"], cache["v"], index.attn_len,
                             window=index.window, page_table=index.page_table,
                             ones=index.attn_q_lens, **_scales(cache))
    return linear(_merge_heads(cfg, o), p["wo"]), cache


# -- cross attention (Whisper decoder) ----------------------------------------

def cross_attn_init(gen: torch.Generator, cfg) -> Params:
    return attn_init(gen, cfg)


def cross_kv(cfg, p: Params, enc_out: torch.Tensor):
    """Cross-attention K/V (b, hkv, s_enc, hd) of the encoder's output
    (b, s_enc, d), computed once a request; views of the projections."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    k = linear(enc_out, p["wk"], p.get("bk"))
    v = linear(enc_out, p["wv"], p.get("bv"))
    return (k.reshape(b, s, hkv, hd).transpose(1, 2),
            v.reshape(b, s, hkv, hd).transpose(1, 2))


def cross_attn_apply(cfg, p: Params, x: torch.Tensor,
                     enc_kv: tuple) -> torch.Tensor:
    """x (b, s, d) attends, without a mask, to the encoder K/V (b, hkv,
    s_enc, hd) through ``ops.attention`` (the flash kernel on the card).
    A layer's K/V sliced from the cache's (layers, b, hkv, s_enc, hd)
    stack is contiguous, so the kernel reads it in place."""
    b, s, _ = x.shape
    hd, hq = cfg.head_dim, cfg.n_heads
    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, hq, hd).transpose(1, 2)
    k, v = enc_kv
    o = ops.attention(q.contiguous(), k, v, causal=False)
    return linear(_merge_heads(cfg, o), p["wo"])
