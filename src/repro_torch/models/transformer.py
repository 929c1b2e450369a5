"""Decoder-only transformer (port of the dense path of
``repro/models/transformer.py``): ``forward`` and whole-prompt ``prefill``
over the full sequence, ``mixed_step`` and ``decode_step`` for serving.

Block parameters are stacked along a leading layer axis, as in the
reference; the layers run as a Python loop over views of the stacked
tensors (``layer_params``), and the KV cache stacks one layer's leaves
along a leading layer axis: (layers, B, hkv, L, hd) slots, or one
(layers, P+1, hkv, bs, hd) pool per layer for the paged layout, updated in
place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.models.layers import Params


def block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "ln_attn": layers.norm_init(cfg, gen.device),
        "attn": attention.attn_init(gen, cfg),
        "ln_mlp": layers.norm_init(cfg, gen.device),
        "mlp": layers.mlp_init(gen, cfg),
    }


def _stack_into(dst, layer, i):
    for k, v in layer.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, i)
        else:
            dst[k][i] = v


def _empty_stack(layer, n):
    return {k: (_empty_stack(v, n) if isinstance(v, dict) else
                torch.empty((n, *v.shape), dtype=v.dtype, device=v.device))
            for k, v in layer.items()}


def stack_blocks(gen: torch.Generator, cfg, n: int,
                 init_fn=block_init) -> Params:
    """``n`` blocks of ``init_fn(gen, cfg)`` initialised one after another
    into stacked tensors."""
    first = init_fn(gen, cfg)
    out = _empty_stack(first, n)
    _stack_into(out, first, 0)
    for i in range(1, n):
        _stack_into(out, init_fn(gen, cfg), i)
    return out


def init_params(cfg, gen: torch.Generator) -> Params:
    p: Params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype),
        "blocks": stack_blocks(gen, cfg, cfg.n_layers),
        "ln_f": layers.norm_init(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         cfg.dtype)
    return p


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters as views of the stacked tensors."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def embed_tokens(cfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = layers.linear(x, params["embed"].T)
    else:
        logits = layers.linear(x, params["lm_head"])
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    one = attention.init_kv_cache(cfg, batch, max_len, device)
    return {k: v.unsqueeze(0).repeat(cfg.n_layers, *([1] * v.dim()))
            for k, v in one.items()}


def cache_slot_axes(cfg) -> Params:
    return attention.kv_cache_slot_axes(cfg, axis=1)


def _layer_cache(cache: Params, i: int) -> Params:
    return {k: v[i] for k, v in cache.items()}


def _mlp_residual(cfg, bp: Params, x: torch.Tensor) -> torch.Tensor:
    return x + layers.mlp_apply(cfg, bp["mlp"],
                                layers.apply_norm(cfg, bp["ln_mlp"], x))


# -- full sequence ------------------------------------------------------------

def block_apply(cfg, p: Params, x: torch.Tensor, positions) -> tuple:
    """One block over the whole sequence; returns (x, aux = 0): the dense
    family has no auxiliary loss."""
    h = attention.attn_apply(cfg, p["attn"],
                             layers.apply_norm(cfg, p["ln_attn"], x),
                             positions)
    return _mlp_residual(cfg, p, x + h), torch.zeros((), device=x.device)


def _scan_blocks(cfg, blocks: Params, x: torch.Tensor, positions):
    """The layer loop of ``forward`` (a Python loop over the stacked
    blocks: remat and scan have no meaning for inference here)."""
    aux_total = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, aux = block_apply(cfg, layer_params(blocks, i), x, positions)
        aux_total = aux_total + aux
    return x, aux_total


def forward(cfg, params: Params, tokens: torch.Tensor, positions=None):
    """tokens (B, S) -> (logits (B, S, V), aux loss)."""
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    if positions is None:
        positions = layers.positions_for(cfg, b, s, device=tokens.device)
    x, aux = _scan_blocks(cfg, params["blocks"], x, positions)
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params, x), aux


PREFILL_CHUNK = 4096


def _last_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(cfg, params["ln_f"], x[:, -1:])
    return unembed(cfg, params, x)[:, 0]


def prefill(cfg, params: Params, tokens: torch.Tensor, max_len: int):
    """Whole-prompt prefill into a fresh slot cache of ``max_len``: returns
    (last-token logits (B, V), cache).  Prompts longer than
    ``PREFILL_CHUNK`` run chunked (``_prefill_chunked``), each chunk
    attending to the cache written so far."""
    b, s = tokens.shape
    if s > PREFILL_CHUNK:
        return _prefill_chunked(cfg, params, tokens, max_len)
    x = embed_tokens(cfg, params, tokens)
    positions = layers.positions_for(cfg, b, s, device=tokens.device)
    cache = init_cache(cfg, b, max_len, tokens.device)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, _ = attention.attn_prefill(
            cfg, bp["attn"], layers.apply_norm(cfg, bp["ln_attn"], x),
            positions, _layer_cache(cache, i))
        x = _mlp_residual(cfg, bp, x + h)
    return _last_logits(cfg, params, x), cache


def _prefill_chunked(cfg, params: Params, tokens: torch.Tensor,
                     max_len: int):
    """``PREFILL_CHUNK``-token chunks in order; each layer writes the
    chunk's K/V into the cache and attends over everything written so far
    (the chunk ends that context, so the causal skip applies).  A window
    no longer than a chunk instead attends over the previous chunk's K/V
    carried per layer, concatenated with this chunk's.  The cache write
    clamps its start as ``jax.lax.dynamic_update_slice`` does."""
    if cfg.kv_layout == "paged":
        raise ValueError(attention.PAGED_PREFILL_ERROR)
    if cfg.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={cfg.kv_quant!r}: chunked prefill writes float K/V "
            "only (the reference's casts K/V to int8 and drops the scales)")
    b, s = tokens.shape
    cq = PREFILL_CHUNK
    assert s % cq == 0, (s, cq)
    swa = cfg.window is not None and cfg.window <= cq
    cache = init_cache(cfg, b, max_len, tokens.device)
    cache_len = cache["k"].shape[3]
    if cq > cache_len:
        raise ValueError(f"a {cq}-token chunk does not fit a cache of "
                         f"{cache_len} (max_len)")
    prev_kv = [None] * cfg.n_layers       # SWA: the previous chunk's K/V
    logits = None
    for o in range(0, s, cq):
        x = embed_tokens(cfg, params, tokens[:, o:o + cq])
        positions = layers.positions_for(cfg, b, cq, offset=o,
                                         device=tokens.device)
        w_off = min(o % cache_len, cache_len - cq)    # the update's clamp
        hi = min(o + cq, cache_len)
        for i in range(cfg.n_layers):
            bp = layer_params(params["blocks"], i)
            lc = _layer_cache(cache, i)
            xin = layers.apply_norm(cfg, bp["ln_attn"], x)
            q, k, v = attention._project_qkv(cfg, bp["attn"], xin, positions)
            lc["k"][:, :, w_off:w_off + cq] = k.to(lc["k"].dtype)
            lc["v"][:, :, w_off:w_off + cq] = v.to(lc["v"].dtype)
            if swa:
                # context = previous chunk ++ this chunk, window-masked;
                # chunk 0 has no previous chunk
                k_ctx, v_ctx = k, v
                if o:
                    k_ctx = torch.cat([prev_kv[i][0], k], dim=2)
                    v_ctx = torch.cat([prev_kv[i][1], v], dim=2)
                prev_kv[i] = (k, v)
            else:
                k_ctx, v_ctx = lc["k"][:, :, :hi], lc["v"][:, :, :hi]
            h = ops.attention(q, k_ctx, v_ctx, causal=True, window=cfg.window)
            h = layers.linear(attention._merge_heads(cfg, h),
                              bp["attn"]["wo"])
            x = _mlp_residual(cfg, bp, x + h)
        if o + cq >= s:
            logits = _last_logits(cfg, params, x)
    return logits, cache


def mixed_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
               lengths: torch.Tensor, q_lens: torch.Tensor, *,
               page_table: torch.Tensor | None = None):
    """Mixed prefill/decode step: tokens (B, C); ``lengths`` (B,) = valid
    cache tokens BEFORE this step; ``q_lens`` (B,) = live tokens per row;
    ``page_table`` (B, pages) routes paged K/V placement.  Returns (logits
    (B, V) of each row's LAST live token, cache)."""
    b, c = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    pos = lengths[:, None] + torch.arange(c, dtype=lengths.dtype,
                                          device=tokens.device)[None, :]
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        lc = _layer_cache(cache, i)
        h, _ = attention.attn_mixed(
            cfg, bp["attn"], layers.apply_norm(cfg, bp["ln_attn"], x), pos,
            lc, lengths, q_lens, page_table=page_table)
        x = _mlp_residual(cfg, bp, x + h)
    # only each row's last live position reaches the LM head
    idx = torch.clamp(q_lens - 1, 0, c - 1).long()
    x_last = x[torch.arange(b, device=x.device), idx][:, None]
    return _last_logits(cfg, params, x_last), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None):
    """One decode step: tokens (B, 1); ``lengths`` (B,) = context length
    including this token; ``page_table`` routes paged K/V placement and
    ``write_mask`` (B,) bool leaves masked rows' caches untouched.  Returns
    (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos = (lengths - 1)[:, None]
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        lc = _layer_cache(cache, i)
        h, _ = attention.attn_decode(
            cfg, bp["attn"], layers.apply_norm(cfg, bp["ln_attn"], x), pos,
            lc, lengths, page_table=page_table, write_mask=write_mask)
        x = _mlp_residual(cfg, bp, x + h)
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params, x)[:, 0], cache
