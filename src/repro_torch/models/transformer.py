"""Decoder-only transformer (port of the dense, MoE and vlm paths of
``repro/models/transformer.py``): ``forward`` and whole-prompt ``prefill``
over the full sequence, ``mixed_step`` and ``decode_step`` for serving.
An MoE config (``cfg.is_moe``) has ``moe`` in place of ``mlp`` in every
block (``models/moe.py``), and ``forward`` returns its summed
load-balance loss.  A vlm config is the dense model with M-RoPE:
``forward`` takes the stubbed frontend's patch embeddings and (3, B, S)
position ids; the serving routes take text only, their three id streams
equal.

``forward`` under autograd (a parameter that requires grad, grad enabled:
the training route) runs the reference's unfused ``block_apply`` a layer
(``x + attn(norm(x))``, then ``x + mlp(norm(x))``, the norms and kernel 7
with their backward kernels), each layer under
``torch.utils.checkpoint`` when ``cfg.remat == "block"`` (the reference's
``jax.checkpoint``), then ``ln_f`` and the head; the dense and vlm families
only.  Without grad every route runs as it always did.

Block parameters are stacked along a leading layer axis, as in the
reference; the layers run as a Python loop over views of the stacked
tensors (``layer_params``), and the KV cache stacks one layer's leaves
along a leading layer axis: (layers, B, hkv, L, hd) slots, or one
(layers, P+1, hkv, bs, hd) pool per layer for the paged layout, updated in
place.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models import attention, layers, moe
from repro_torch.models.layers import Params
from repro_torch.train.checkpoint import tree_paths


def block_init(gen: torch.Generator, cfg) -> Params:
    p = {
        "ln_attn": layers.norm_init(cfg, gen.device),
        "attn": attention.attn_init(gen, cfg),
        "ln_mlp": layers.norm_init(cfg, gen.device),
    }
    if cfg.is_moe:
        p["moe"] = moe.moe_init(gen, cfg)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg)
    return p


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


def _unbind_layers(blocks: Params, n: int) -> list[Params]:
    """Every layer's parameters as views of the stacked tensors, taken with
    one ``unbind`` a leaf, whose backward stacks the layers' gradients once
    (``layer_params``'s ``v[i]`` would add a zero-filled stack a layer)."""
    out: list[Params] = [{} for _ in range(n)]
    for k, v in blocks.items():
        parts = (_unbind_layers(v, n) if isinstance(v, dict)
                 else v.unbind(0))
        for i in range(n):
            out[i][k] = parts[i]
    return out


def block_apply(cfg, p: Params, x: torch.Tensor, positions) -> torch.Tensor:
    """One block as the reference's ``block_apply`` (unfused residual adds;
    dense and vlm configs): the training route's layer."""
    h = attention.attn_apply(cfg, p["attn"],
                             layers.apply_norm(cfg, p["ln_attn"], x),
                             positions)
    x = x + h
    return x + layers.mlp_apply(cfg, p["mlp"],
                                layers.apply_norm(cfg, p["ln_mlp"], x))


def _forward_grad(cfg, params: Params, x: torch.Tensor, positions):
    """The training route's layers, ``ln_f`` and head (see the module
    note)."""
    if cfg.is_moe:
        raise NotImplementedError(
            "training an MoE config (the router's gradient and the "
            "load-balance loss) is not ported (ROADMAP queue 1, item 6a)")
    for bp in _unbind_layers(params["blocks"], cfg.n_layers):
        if cfg.remat == "block":
            x = torch.utils.checkpoint.checkpoint(
                block_apply, cfg, bp, x, positions, use_reentrant=False)
        else:
            x = block_apply(cfg, bp, x, positions)
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return unembed(cfg, params, x), torch.zeros((), device=x.device)


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


def _walk_layers(cfg, params: Params, x: torch.Tensor, attend, *,
                 q_lens=None, aux=None):
    """The layer walk of every route: ``attend(i, bp, n)`` is layer ``i``'s
    attention sublayer on the normed ``n``, returning its output.  Each
    residual add goes into the norm after it (``layers.add_norm``: on the
    card one launch for ``x + h`` -> ``ln_mlp`` and one for ``x + m`` -> the
    next layer's ``ln_attn``); layer 0's ``ln_attn`` is a norm alone.  The
    FFN sublayer is the MLP or, for an MoE config, ``moe.moe_experts``
    (``q_lens``: a mixed chunk's live positions; each layer's load-balance
    loss is appended to the list ``aux`` when one is given), whose
    ``Experts`` the next norm combines as it adds them (one launch).
    Returns the last layer's (x, m): its residual and MLP output (or
    ``Experts``; indexing either selects positions), not yet added, for
    the caller's final add + ``ln_f`` (``_final_norm``)."""
    blocks = [layer_params(params["blocks"], i) for i in range(cfg.n_layers)]
    n = layers.apply_norm(cfg, blocks[0]["ln_attn"], x)
    m = None
    for i, bp in enumerate(blocks):
        if i:
            x, n = layers.add_norm(cfg, bp["ln_attn"], x, m)
        h = attend(i, bp, n)
        x, n = layers.add_norm(cfg, bp["ln_mlp"], x, h)
        if cfg.is_moe:
            m, a = moe.moe_experts(cfg, bp["moe"], n, q_lens=q_lens,
                                   with_aux=aux is not None)
            if aux is not None:
                aux.append(a)
        else:
            m = layers.mlp_apply(cfg, bp["mlp"], n)
    return x, m


def _final_norm(cfg, params: Params, x: torch.Tensor, m) -> torch.Tensor:
    """``ln_f(x + m)``, the sum not kept (``m`` a tensor or an MoE layer's
    ``Experts``)."""
    return layers.add_norm(cfg, params["ln_f"], x, m, keep_sum=False)[1]


# -- full sequence ------------------------------------------------------------

def forward(cfg, params: Params, tokens: torch.Tensor, positions=None,
            vision_embeds: torch.Tensor | None = None):
    """tokens (B, S) -> (logits (B, N + S, V), aux loss: the MoE layers'
    load-balance losses summed, 0 for the dense family).
    ``vision_embeds`` (B, N, d), the patch embeddings of the stubbed vision
    frontend, are cast to the embeddings' dtype and put before the tokens'.
    ``positions``: (B, N + S) ids, or (3, B, N + S) for M-RoPE, whose
    streams may differ (an image's temporal / height / width ids); None
    gives ``layers.positions_for``'s."""
    x = embed_tokens(cfg, params, tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = layers.positions_for(cfg, b, s, device=tokens.device)
    if ops.needs_grad(x, *(t for _, t in tree_paths(params))):
        return _forward_grad(cfg, params, x, positions)
    aux = [] if cfg.is_moe else None
    x, m = _walk_layers(cfg, params, x, lambda i, bp, n:
                        attention.attn_apply(cfg, bp["attn"], n, positions),
                        aux=aux)
    total = torch.zeros((), device=x.device)
    for a in aux or ():
        total = total + a
    return unembed(cfg, params, _final_norm(cfg, params, x, m)), total


PREFILL_CHUNK = 4096


def _last_logits(cfg, params: Params, x: torch.Tensor, m) -> torch.Tensor:
    """The last position's logits from the last layer's (x, m)."""
    n = _final_norm(cfg, params, x[:, -1:], m[:, -1:])
    return unembed(cfg, params, n)[:, 0]


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
    x, m = _walk_layers(cfg, params, x, lambda i, bp, n:
                        attention.attn_prefill(cfg, bp["attn"], n, positions,
                                               _layer_cache(cache, i))[0])
    return _last_logits(cfg, params, x, m), cache


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

        def attend(i, bp, xin):
            lc = _layer_cache(cache, i)
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
            return layers.linear(attention._merge_heads(cfg, h),
                                 bp["attn"]["wo"])
        x, m = _walk_layers(cfg, params, x, attend)
        if o + cq >= s:
            logits = _last_logits(cfg, params, x, m)
    return logits, cache


def mixed_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
               lengths: torch.Tensor, q_lens: torch.Tensor, *,
               page_table: torch.Tensor | None = None,
               all_logits: bool = False):
    """Mixed prefill/decode step: tokens (B, C); ``lengths`` (B,) = valid
    cache tokens BEFORE this step; ``q_lens`` (B,) = live tokens per row;
    ``page_table`` (B, pages) routes paged K/V placement.  Returns (logits
    (B, V) of each row's LAST live token, cache), or with ``all_logits``
    the logits (B, C, V) of EVERY chunk position (the draft-verify
    surface: position j scores the token after ``tokens[b, j]``; positions
    past ``q_lens[b] - 1`` are padding)."""
    b, c = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    index = attention.mixed_index(cfg, _layer_cache(cache, 0), b, lengths,
                                  q_lens, page_table)
    x, m = _walk_layers(cfg, params, x, lambda i, bp, n: attention.attn_mixed(
        cfg, bp["attn"], n, _layer_cache(cache, i), lengths, q_lens,
        index=index)[0], q_lens=q_lens)
    if not all_logits:
        # only each row's last live position reaches the LM head
        rows = torch.arange(b, device=x.device)
        idx = torch.clamp(q_lens - 1, 0, c - 1).long()
        x, m = x[rows, idx][:, None], m[rows, idx][:, None]
    logits = unembed(cfg, params, _final_norm(cfg, params, x, m))
    # the verify surface: every chunk position reaches the LM head
    return (logits if all_logits else logits[:, 0]), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None):
    """One decode step: tokens (B, 1); ``lengths`` (B,) = context length
    including this token; ``page_table`` routes paged K/V placement and
    ``write_mask`` (B,) bool leaves masked rows' caches untouched.  Returns
    (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    index = attention.decode_index(cfg, _layer_cache(cache, 0),
                                   tokens.shape[0], lengths, page_table,
                                   write_mask)
    x, m = _walk_layers(cfg, params, x, lambda i, bp, n: attention.attn_decode(
        cfg, bp["attn"], n, _layer_cache(cache, i), lengths, index=index)[0])
    return unembed(cfg, params, _final_norm(cfg, params, x, m))[:, 0], cache
