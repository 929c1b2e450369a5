"""Model API of the port: the dense and ssm (xLSTM) families of
``repro/models/api.py``.

    init_params(cfg, gen)                     -> params tree
    forward(cfg, params, batch)               -> (logits (B, S, V), aux)
    prefill(cfg, params, batch, max_len)      -> (last logits (B, V), cache)
    init_cache(cfg, batch, max_len, device)   -> cache (updated in place)
    has_paged_kv(cfg)                         -> shared-pool layout?
    cache_slot_axes(cfg)                      -> request-slot axis per leaf
    insert_request(cfg, cache, row, slot)     -> cache with row at slot
    evict_slot(cfg, cache, slot, max_len)     -> cache with slot reset
    request_cache(cfg, params, batch, max_len, device) -> admission row
    needs_admission_insert(cfg)               -> reset a slot at admission?
    mixed_step(cfg, params, cache, tokens, lengths, q_lens, page_table=)
    decode_step(cfg, params, cache, tokens, lengths, page_table=,
                write_mask=)

``batch`` is a dict ``{"tokens": (B, S)}``.  Dense family: ``forward`` and
the slot layout's ``prefill`` run the whole sequence through the
full-sequence flash attention (``ops.attention``); a prompt longer than
``transformer.PREFILL_CHUNK`` prefills chunk by chunk.  A paged cache has no
full-sequence prefill: ``prefill`` runs the whole prompt as one
``mixed_step`` chunk under the default page table (``_bulk_prefill``).
``init_cache`` allocates ONE resident cache: slots indexed by request row,
or, with ``kv_layout="paged"``, one shared block pool per layer that the
caller addresses through a ``(B, pages)`` page table (None = the linear
default table of a default-sized pool).  ``kv_quant="int8"`` stores K/V as
int8 with per-token scales.

The ssm family (``xlstm_stack``) has no KV cache: its cache is the
recurrent state, and the KV options are ignored, as in the reference.
``forward`` runs the mLSTM's parallel form and the sLSTM scan (kernel 8);
``prefill`` is ``_bulk_prefill``, which gives the true post-prompt state;
``mixed_step`` steps the chunk through ``decode_step`` one position at a
time (``_mixed_step_scan``), each row advancing only while the position is
below its ``q_lens``, so the state is bitwise that of sequential decode.

``mixed_step`` advances row ``b`` by ``q_lens[b]`` tokens (1 = decoding
row, up to C = mid-prefill row, 0 = idle) in one call.  Speculation and
prefix sharing are later slices: their gates answer False here.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention, transformer, xlstm_stack

Params = dict[str, Any]


def _ssm(cfg) -> bool:
    return cfg.family == "ssm"


def init_params(cfg, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``."""
    attention.check_supported(cfg)
    if _ssm(cfg):
        return xlstm_stack.init_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def forward(cfg, params: Params, batch: dict):
    """tokens (B, S) -> (logits (B, S, V), aux loss = 0)."""
    attention.check_supported(cfg)
    if batch.get("vision_embeds") is not None:
        raise NotImplementedError("vision embeddings come with the vlm family")
    if _ssm(cfg):
        return xlstm_stack.forward(cfg, params, batch["tokens"])
    return transformer.forward(cfg, params, batch["tokens"])


def _bulk_prefill(cfg, params: Params, tokens: torch.Tensor, max_len: int):
    """Whole-prompt prefill through the mixed-step chunk writer: one call
    whose chunk IS the prompt (``q_lens[b] = S``), writing K/V at true
    positions, so a paged pool prefills through its normal write path
    under the default page table, and a recurrent family ends with its
    true post-prompt state."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    zeros = torch.zeros(b, dtype=torch.int32, device=tokens.device)
    return mixed_step(cfg, params, cache, tokens, zeros, zeros + s)


def prefill(cfg, params: Params, batch: dict, max_len: int):
    """Prefill a fresh cache of ``max_len`` with ``batch["tokens"]`` (B, S):
    returns (logits (B, V) of the last prompt token, cache)."""
    tokens = batch["tokens"]
    if has_paged_kv(cfg) or _ssm(cfg):
        return _bulk_prefill(cfg, params, tokens, max_len)
    return transformer.prefill(cfg, params, tokens, max_len)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Params:
    if _ssm(cfg):
        return xlstm_stack.init_cache(cfg, batch, max_len, device)
    return transformer.init_cache(cfg, batch, max_len, device)


def has_paged_kv(cfg) -> bool:
    """Whether this config's cache carries paged (shared-pool) KV leaves.
    The ssm family is pure recurrent state, so paging is a no-op there."""
    return cfg.kv_layout == "paged" and not _ssm(cfg)


def cache_slot_axes(cfg) -> Params:
    """The request-slot axis of each cache leaf; ``-1`` marks a paged
    shared-pool leaf, which has none."""
    if _ssm(cfg):
        return xlstm_stack.cache_slot_axes(cfg)
    return transformer.cache_slot_axes(cfg)


def _leaves(cache: Params, axes: Params):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaves(v, axes[k])
        else:
            yield v, axes[k]


def insert_request(cfg, cache: Params, row_cache: Params,
                   slot: int) -> Params:
    """Copy a batch-1 cache into request slot ``slot`` of every leaf, in
    place (paged pool leaves, which have no slot axis, are skipped)."""
    axes = cache_slot_axes(cfg)
    for (dst, ax), (row, _) in zip(_leaves(cache, axes),
                                   _leaves(row_cache, axes)):
        if ax >= 0:
            dst.select(ax, slot).copy_(row.select(ax, 0))
    return cache


def evict_slot(cfg, cache: Params, slot: int, max_len: int) -> Params:
    """Reset one slot to its freshly initialized state.  KV rows hide
    behind the lengths anyway; recurrent state must return to its init
    value (the mLSTM stabilizer ``m = -1e30``) before the next request."""
    device = next(_leaves(cache, cache_slot_axes(cfg)))[0].device
    return insert_request(cfg, cache, init_cache(cfg, 1, max_len, device),
                          slot)


def request_cache(cfg, params: Params, batch: dict, max_len: int,
                  device="cuda") -> Params:
    """Batch-1 cache a request's chunked admission starts from: a pristine
    ``init_cache`` row (audio's cross-attention K/V come with that
    family)."""
    return init_cache(cfg, 1, max_len, device)


def needs_admission_insert(cfg) -> bool:
    """Whether chunked admission must copy ``request_cache`` into the slot
    before the prompt streams in.  Recurrent families carry state the
    previous occupant mutated (the mLSTM stabilizer ``m``); pure-KV
    families need nothing, their stale rows hide behind the lengths."""
    return cfg.family in ("ssm", "hybrid", "audio")


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
    if _ssm(cfg):
        return xlstm_stack.decode_step(cfg, params, cache, tokens,
                                       write_mask=write_mask)
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
        logits, cache = decode_step(
            cfg, params, cache, tokens, lengths + torch.clamp(q_lens, min=1),
            page_table=page_table, write_mask=active)
        return torch.where(active[:, None], logits,
                           torch.zeros_like(logits)), cache
    if _ssm(cfg):
        return _mixed_step_scan(cfg, params, cache, tokens, lengths, q_lens)
    return transformer.mixed_step(cfg, params, cache, tokens, lengths, q_lens,
                                  page_table=page_table)


def _mixed_step_scan(cfg, params: Params, cache: Params,
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     q_lens: torch.Tensor):
    """Mixed step of a recurrent family: the chunk's positions one
    ``decode_step`` at a time, every position of the chunk (C steps, as
    the reference's scan), row ``b`` advancing only while ``j <
    q_lens[b]`` (the kernels leave masked rows' state untouched, the
    reference's per-row select).  Recurrences are order-exact, so the
    state is bitwise that of feeding the tokens one ``decode_step`` at a
    time; the logits are each row's at position ``q_lens - 1`` (zeros for
    an idle row)."""
    b, c = tokens.shape
    logits = torch.zeros((b, cfg.vocab_size), dtype=cfg.dtype,
                         device=tokens.device)
    for j in range(c):
        active = j < q_lens
        lg, cache = decode_step(
            cfg, params, cache, tokens[:, j:j + 1],
            lengths + torch.clamp(q_lens, min=1).clamp(max=j + 1),
            write_mask=active)
        logits = torch.where((q_lens - 1 == j)[:, None], lg.to(cfg.dtype),
                             logits)
    return logits, cache


def supports_speculation(cfg) -> bool:
    return False        # draft-then-verify is a later slice of the port


def supports_prefix_cache(cfg) -> bool:
    return False        # the radix cache and copy-on-write: a later slice
