"""Whisper-style encoder-decoder (the audio family), port of
``repro/models/whisper.py``.

The conv frontend is a stub, as in the reference: a request brings its
frame embeddings (B, frames, d).  Both stacks are pre-LN with sinusoidal
positions added to their inputs (no RoPE); the decoder's LM head is the
token embedding, read in place through ``embed.T``.

* ``encode`` runs the encoder's self-attention without a mask through
  ``ops.attention`` (the flash kernel on the card).
* The decoder's layers are self-attention, cross-attention over the
  request's encoder K/V, and the gelu MLP.  Each add goes into the norm
  after it (``layers.add_norm``: one ``add_layernorm`` launch on the card),
  the inputs' sinusoids into the first layer's first norm too, so a step
  runs no separate add.
* The cache is ``{"self": ..., "cross": ...}``: the decoder's
  self-attention K/V, slot or paged, as the transformer's, and each layer's
  cross K/V ``(layers, B, hkv, frames, hd)``, written once a request from
  its encoder output (``request_cache``, ``admit_into``) and only read by
  the steps.  A layer's slice of that stack is kernel 7's K/V layout, read
  in place.
* The sinusoid table (``sinusoid_table``) is built once per (rows, d,
  device) before any capture; every route gathers its rows from it, so a
  replayed step runs no ``sin`` / ``cos``.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers
from repro_torch.models.layers import Params
from repro_torch.models.transformer import (
    _layer_cache, init_cache as _self_cache, layer_params, stack_blocks)

_tables: dict[tuple, torch.Tensor] = {}


def sinusoid_table(rows: int, d: int, device) -> torch.Tensor:
    """(rows, d) f32: row ``p`` holds ``sin`` then ``cos`` of ``p *
    freq_i``, ``freq_i = exp(-log(1e4) * i / (d / 2))``, the reference's
    ``_sinusoid`` formula in f32.  Built once per (rows, d, device) from
    host integers and kept; each entry depends on its position alone.
    Building it inside a CUDA graph capture would record it into the
    graph, so that raises: the first call comes before (an engine's
    warm-up)."""
    device = torch.device(device)
    key = (rows, d, device)
    table = _tables.get(key)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the sinusoid table {key} is built inside a CUDA graph "
                "capture: run the step once before capturing it")
        half = d // 2
        f32 = torch.float32
        freqs = torch.exp(-torch.log(torch.tensor(10000.0, device=device))
                          * torch.arange(half, dtype=f32, device=device)
                          / half)
        ang = torch.arange(rows, dtype=torch.int32,
                           device=device)[:, None].to(f32) * freqs
        table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        _tables[key] = table
    return table


# -- parameters ---------------------------------------------------------------

def enc_block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "ln_attn": layers.norm_init(cfg, gen.device),
        "attn": attention.attn_init(gen, cfg),
        "ln_mlp": layers.norm_init(cfg, gen.device),
        "mlp": layers.mlp_init(gen, cfg),
    }


def dec_block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "ln_self": layers.norm_init(cfg, gen.device),
        "self_attn": attention.attn_init(gen, cfg),
        "ln_cross": layers.norm_init(cfg, gen.device),
        "cross_attn": attention.cross_attn_init(gen, cfg),
        "ln_mlp": layers.norm_init(cfg, gen.device),
        "mlp": layers.mlp_init(gen, cfg),
    }


def init_params(cfg, gen: torch.Generator) -> Params:
    return {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype),
        "enc_blocks": stack_blocks(gen, cfg, cfg.n_encoder_layers,
                                   enc_block_init),
        "enc_ln_f": layers.norm_init(cfg, gen.device),
        "dec_blocks": stack_blocks(gen, cfg, cfg.n_layers, dec_block_init),
        "ln_f": layers.norm_init(cfg, gen.device),
    }


# -- the layer walk -----------------------------------------------------------

def _walk(cfg, stack: Params, n_layers: int, x: torch.Tensor,
          h: torch.Tensor, sublayers):
    """Every layer's ``sublayers``, ``(norm key, fn(i, bp, normed) ->
    output)`` in order; every norm takes the add before it
    (``layers.add_norm``: one launch on the card), the first the inputs'
    ``x + h`` (embeddings and their positions' sinusoids), each later one
    the residual add of the sublayer before.  Returns the last (x, h): the
    residual and the last sublayer's output, not yet added."""
    for i in range(n_layers):
        bp = layer_params(stack, i)
        for norm, fn in sublayers:
            x, n = layers.add_norm(cfg, bp[norm], x, h)
            h = fn(i, bp, n)
    return x, h


def _final(cfg, p: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``norm(x + h)``, the sum not kept."""
    return layers.add_norm(cfg, p, x, h, keep_sum=False)[1]


def _mlp(cfg):
    return lambda i, bp, n: layers.mlp_apply(cfg, bp["mlp"], n)


def _unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    # Whisper ties its output head to the token embedding
    return layers.linear(x, params["embed"].T)


# -- encoder ------------------------------------------------------------------

def encode(cfg, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    b, f, d = frames.shape
    pos = sinusoid_table(f, d, frames.device).to(cfg.dtype)
    x, m = _walk(cfg, params["enc_blocks"], cfg.n_encoder_layers,
                 frames.to(cfg.dtype), pos.expand(b, f, d), (
        ("ln_attn", lambda i, bp, n: attention.attn_apply(
            cfg, bp["attn"], n, None, causal=False)),
        ("ln_mlp", _mlp(cfg))))
    return _final(cfg, params["enc_ln_f"], x, m)


def _dec_embed(cfg, params: Params, tokens: torch.Tensor,
               positions: torch.Tensor, rows: int):
    """(token embeddings, the sinusoids of ``positions`` (B, S), rows of a
    table of ``rows``), to be added by the first norm."""
    table = sinusoid_table(rows, cfg.d_model, tokens.device)
    return params["embed"][tokens], table[positions].to(cfg.dtype)


def _cross(cfg, kv_of):
    """The cross-attention sublayer over layer ``i``'s encoder K/V,
    ``kv_of(i, bp)``."""
    return lambda i, bp, n: attention.cross_attn_apply(
        cfg, bp["cross_attn"], n, kv_of(i, bp))


def _cached_kv(cache: Params):
    """Layer ``i``'s cross K/V in ``cache``: views the kernel reads in
    place."""
    return lambda i, bp: (cache["cross"]["k"][i], cache["cross"]["v"][i])


# -- full sequence ------------------------------------------------------------

def forward(cfg, params: Params, frames: torch.Tensor, tokens: torch.Tensor):
    """Teacher-forced pass: (logits (B, S, V), aux = 0)."""
    enc = encode(cfg, params, frames)
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x, m = _walk(cfg, params["dec_blocks"], cfg.n_layers,
                 *_dec_embed(cfg, params, tokens, pos, s), (
        ("ln_self", lambda i, bp, n: attention.attn_apply(
            cfg, bp["self_attn"], n, None, causal=True)),
        ("ln_cross", _cross(cfg, lambda i, bp: attention.cross_kv(
            cfg, bp["cross_attn"], enc))),
        ("ln_mlp", _mlp(cfg))))
    logits = _unembed(params, _final(cfg, params["ln_f"], x, m))
    return logits, torch.zeros((), device=logits.device)


# -- serving ------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_frames,
             cfg.head_dim)
    return {"self": _self_cache(cfg, batch, max_len, device),
            "cross": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                      "v": torch.zeros(shape, dtype=cfg.dtype,
                                       device=device)}}


def cache_slot_axes(cfg) -> Params:
    """The self-attention K/V and the per-request cross K/V both sit at
    axis 1 of their (layers, B, ...) stacks (a paged pool has none), so
    inserting an admission row replaces a slot's audio: a reused slot never
    attends the previous request's."""
    return {"self": attention.kv_cache_slot_axes(cfg, axis=1),
            "cross": {"k": 1, "v": 1}}


def admit_into(cfg, params: Params, row: Params,
               frames: torch.Tensor) -> Params:
    """Encode ``frames`` (B, F, d) and write every decoder layer's cross
    K/V into ``row["cross"]``, in place (the engine's ``("admit", F)``
    graph); nothing else of ``row`` is touched."""
    enc = encode(cfg, params, frames)
    for i in range(cfg.n_layers):
        p = layer_params(params["dec_blocks"], i)["cross_attn"]
        for dst, src in zip((row["cross"]["k"][i], row["cross"]["v"][i]),
                            attention.cross_kv(cfg, p, enc)):
            dst.copy_(src)
    return row


def request_cache(cfg, params: Params, frames: torch.Tensor, max_len: int,
                  device) -> Params:
    """Admission cache for chunked serving: pristine self K/V plus the
    request's cross K/V, computed once from its encoder output; the
    decoder prompt then streams through ``decode_step`` / ``mixed_step``."""
    cache = init_cache(cfg, frames.shape[0], max_len, device)
    return admit_into(cfg, params, cache, frames.to(device))


def prefill(cfg, params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            max_len: int):
    """Encode the audio, run the decoder prompt and build every cache (the
    slot layout: a paged pool has no full-sequence prefill).  Returns
    (last-token logits (B, V), cache)."""
    if cfg.kv_layout == "paged":
        raise ValueError(attention.PAGED_PREFILL_ERROR)
    b, s = tokens.shape
    cache = request_cache(cfg, params, frames, max_len, tokens.device)
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x, m = _walk(cfg, params["dec_blocks"], cfg.n_layers,
                 *_dec_embed(cfg, params, tokens, pos, max(max_len, s)), (
        ("ln_self", lambda i, bp, n: attention.attn_prefill(
            cfg, bp["self_attn"], n, None,
            _layer_cache(cache["self"], i))[0]),
        ("ln_cross", _cross(cfg, _cached_kv(cache))),
        ("ln_mlp", _mlp(cfg))))
    n = _final(cfg, params["ln_f"], x[:, -1:], m[:, -1:])
    return _unembed(params, n)[:, 0], cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None):
    """One decode step: tokens (B, 1); ``lengths`` (B,) = context length
    including this token; ``page_table`` routes paged self K/V placement
    and ``write_mask`` (B,) bool leaves masked rows' caches untouched (the
    cross K/V is only read).  Returns (logits (B, V), cache)."""
    b = tokens.shape[0]
    layer0 = _layer_cache(cache["self"], 0)
    index = attention.decode_index(cfg, layer0, b, lengths, page_table,
                                   write_mask)
    _, span = attention._span(cfg, layer0, b, index.page_table,
                              tokens.device)
    # a dead row (length 0) gathers row 0; its output is never read
    pos = torch.clamp(lengths - 1, 0, span - 1)[:, None]
    x, m = _walk(cfg, params["dec_blocks"], cfg.n_layers,
                 *_dec_embed(cfg, params, tokens, pos, span), (
        ("ln_self", lambda i, bp, n: attention.attn_decode(
            cfg, bp["self_attn"], n, _layer_cache(cache["self"], i),
            lengths, index=index)[0]),
        ("ln_cross", _cross(cfg, _cached_kv(cache))),
        ("ln_mlp", _mlp(cfg))))
    return _unembed(params, _final(cfg, params["ln_f"], x, m))[:, 0], cache
