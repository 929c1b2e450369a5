"""Model API of the port: the dense-family serving subset of
``repro/models/api.py``.

    init_params(cfg, gen)                     -> params tree
    init_cache(cfg, batch, max_len, device)   -> KV cache (updated in place)
    has_paged_kv(cfg)                         -> shared-pool layout?
    cache_slot_axes(cfg)                      -> request-slot axis per leaf
    mixed_step(cfg, params, cache, tokens, lengths, q_lens, page_table=)
    decode_step(cfg, params, cache, tokens, lengths, page_table=,
                write_mask=)

``init_cache`` allocates ONE resident cache: slots indexed by request row,
or, with ``kv_layout="paged"``, one shared block pool per layer that the
caller addresses through a ``(B, pages)`` page table (None = the linear
default table of a default-sized pool).  ``kv_quant="int8"`` stores K/V as
int8 with per-token scales.  ``mixed_step`` advances row ``b`` by
``q_lens[b]`` tokens (1 = decoding row, up to C = mid-prefill row, 0 =
idle) in one call.  Speculation and prefix sharing are later slices: their
gates answer False here.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention, transformer

Params = dict[str, Any]


def init_params(cfg, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``."""
    attention.check_supported(cfg)
    return transformer.init_params(cfg, gen)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Params:
    return transformer.init_cache(cfg, batch, max_len, device)


def has_paged_kv(cfg) -> bool:
    """Whether this config's cache carries paged (shared-pool) KV leaves."""
    return cfg.kv_layout == "paged"


def cache_slot_axes(cfg) -> Params:
    """The request-slot axis of each cache leaf; ``-1`` marks a paged
    shared-pool leaf, which has none."""
    return transformer.cache_slot_axes(cfg)


def _rows(v, b: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(b).contiguous()


def _table(page_table, device) -> torch.Tensor | None:
    if page_table is None:
        return None
    return torch.as_tensor(page_table, dtype=torch.int32,
                           device=device).contiguous()


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                lengths, *, page_table=None,
                write_mask: torch.Tensor | None = None):
    """tokens (B, 1); ``lengths`` scalar or (B,) = context length including
    this token.  ``page_table`` (B, pages) routes paged K/V placement;
    ``write_mask`` (B,) bool leaves masked rows' caches untouched.  Returns
    (logits (B, V), cache)."""
    b = tokens.shape[0]
    return transformer.decode_step(cfg, params, cache, tokens,
                                   _rows(lengths, b, tokens.device),
                                   page_table=_table(page_table,
                                                     tokens.device),
                                   write_mask=write_mask)


def mixed_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
               lengths, q_lens, *, page_table=None):
    """Advance every row by its own token count in one call.

    tokens (B, C); ``lengths`` (B,) = valid cache tokens BEFORE this step;
    ``q_lens`` (B,) = live tokens per row; ``page_table`` (B, pages) routes
    paged K/V placement.  Returns (logits (B, V) of each row's last live
    token, cache).  ``C == 1`` delegates to ``decode_step``
    (bit-identical to the classic decode tick), with ``q_lens == 0`` rows
    left exactly untouched and given zero logits."""
    b, c = tokens.shape
    lengths = _rows(lengths, b, tokens.device)
    q_lens = _rows(q_lens, b, tokens.device)
    page_table = _table(page_table, tokens.device)
    if c == 1:
        active = q_lens > 0
        logits, cache = transformer.decode_step(
            cfg, params, cache, tokens, lengths + torch.clamp(q_lens, min=1),
            page_table=page_table, write_mask=active)
        return torch.where(active[:, None], logits,
                           torch.zeros_like(logits)), cache
    return transformer.mixed_step(cfg, params, cache, tokens, lengths, q_lens,
                                  page_table=page_table)


def supports_speculation(cfg) -> bool:
    return False        # draft-then-verify is a later slice of the port


def supports_prefix_cache(cfg) -> bool:
    return False        # the radix cache and copy-on-write: a later slice
