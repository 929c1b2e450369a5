"""Model API of the port: the dense, moe, vlm (Qwen2-VL), ssm (xLSTM), hybrid
(Zamba2) and audio (Whisper) families of ``repro/models/api.py``.

    init_params(cfg, gen)                     -> params tree
    forward(cfg, params, batch)               -> (logits (B, S, V), aux)
    loss_fn(cfg, params, batch, aux_weight)   -> (loss + aux term, metrics)
    prefill(cfg, params, batch, max_len)      -> (last logits (B, V), cache)
    init_cache(cfg, batch, max_len, device)   -> cache (updated in place)
    has_paged_kv(cfg)                         -> shared-pool layout?
    cache_slot_axes(cfg)                      -> request-slot axis per leaf
    insert_request(cfg, cache, row, slot)     -> cache with row at slot
    evict_slot(cfg, cache, slot, max_len)     -> cache with slot reset
    request_cache(cfg, params, batch, max_len, device) -> admission row
    admit_into(cfg, params, row, batch)       -> row with its audio's K/V
    needs_admission_insert(cfg)               -> reset a slot at admission?
    mixed_step(cfg, params, cache, tokens, lengths, q_lens, page_table=,
               all_logits=)
    decode_step(cfg, params, cache, tokens, lengths, page_table=,
                write_mask=)
    supports_speculation(cfg) / supports_prefix_cache(cfg) -> serving gates
    copy_pool_block(cfg, cache, src, dst)    -> cache with block src at dst
    export_cache(cfg, cache)                  -> host copy of every leaf
    load_cache_(cfg, cache, arrays)           -> cache, leaves loaded in place

``batch`` is a dict ``{"tokens": (B, S)}``, plus ``{"frames": (B, F, d)}``
for the audio family; ``forward`` of a transformer family also takes
``{"vision_embeds": (B, N, d)}``, the patch embeddings of the vlm family's
stubbed frontend, put before the tokens'.  The transformer families (the
moe family swaps each block's MLP for ``models/moe.py``; the vlm family is
the dense model with M-RoPE, whose serving routes take text only, as the
reference's): ``forward`` and
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

The hybrid family (``zamba``) carries both: every Mamba2 block's conv
window and SSM state, and each shared-block site's K/V (slot or paged).
``forward`` runs the chunked SSD scan and the full-sequence flash
attention; ``prefill`` and ``mixed_step`` take the recurrent family's
routes (``_bulk_prefill``, ``_mixed_step_scan``), as in the reference.

The audio family (``whisper``) keeps a decoder self-attention cache (slot
or paged) and each request's cross-attention K/V (``"cross"``, a slot axis
on every layout), which ``request_cache`` encodes once from the request's
frames and admission copies into the slot.  Its ``mixed_step`` is the scan
as well, as in the reference; ``prefill`` is the slot layout's whole-prompt
pass (a paged pool has none, as in the reference).

``mixed_step`` advances row ``b`` by ``q_lens[b]`` tokens (1 = decoding
row, up to C = mid-prefill row, 0 = idle) in one call; ``all_logits``
returns every chunk position's logits, the surface a speculating engine
verifies its drafts on.  The serving gates answer as the reference's:
speculation for the transformer families, prefix sharing for paged
transformer families.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import (
    attention, transformer, whisper, xlstm_stack, zamba)
from repro_torch.train.checkpoint import VIEW_DTYPES, dtype_name, tree_paths

Params = dict[str, Any]


# the reference's transformer families
_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def _ssm(cfg) -> bool:
    return cfg.family == "ssm"


def _audio(cfg) -> bool:
    return cfg.family == "audio"


def _hybrid(cfg) -> bool:
    return cfg.family == "hybrid"


def init_params(cfg, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``."""
    attention.check_supported(cfg)
    if _ssm(cfg):
        return xlstm_stack.init_params(cfg, gen)
    if _audio(cfg):
        return whisper.init_params(cfg, gen)
    if _hybrid(cfg):
        return zamba.init_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def forward(cfg, params: Params, batch: dict):
    """tokens (B, S) (and the audio family's frames (B, F, d), a
    transformer family's ``vision_embeds`` (B, N, d)) -> (logits (B, N + S,
    V), aux loss: the MoE load-balance loss summed over layers, 0 for the
    other families)."""
    attention.check_supported(cfg)
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer.forward(cfg, params, batch["tokens"],
                                   vision_embeds=batch.get("vision_embeds"))
    if _ssm(cfg):
        return xlstm_stack.forward(cfg, params, batch["tokens"])
    if _audio(cfg):
        return whisper.forward(cfg, params, batch["frames"], batch["tokens"])
    return zamba.forward(cfg, params, batch["tokens"])


# the families whose training route is ported (ROADMAP queue 1, item 6a
# adds the rest)
TRAINED_FAMILIES = ("dense",)


def loss_fn(cfg, params: Params, batch: dict, aux_weight: float = 0.01):
    """Next-token cross-entropy + MoE aux loss (``repro/models/api.py:88``):
    f32 log-softmax of the logits of the first ``labels.shape[1]``
    positions, the labels' log-probabilities, their mean (or, with
    ``batch["mask"]``, their masked sum over ``max(mask.sum(), 1)``).
    Returns ``(loss + aux_weight * aux, {"loss": loss, "aux": aux})``.
    Differentiable for the dense family (``forward``'s training route);
    the others raise ``NotImplementedError``."""
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family} family is not ported (ROADMAP "
            "queue 1, item 6a); the dense family trains")
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    logits = logits[:, : labels.shape[1]]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    else:
        loss = nll.mean()
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


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
    returns (logits (B, V) of the last prompt token, cache).  The audio
    family takes ``batch["frames"]`` too (slot layout only)."""
    tokens = batch["tokens"]
    if _audio(cfg):
        return whisper.prefill(cfg, params, batch["frames"], tokens, max_len)
    if has_paged_kv(cfg) or _ssm(cfg) or _hybrid(cfg):
        return _bulk_prefill(cfg, params, tokens, max_len)
    return transformer.prefill(cfg, params, tokens, max_len)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Params:
    if _ssm(cfg):
        return xlstm_stack.init_cache(cfg, batch, max_len, device)
    if _audio(cfg):
        return whisper.init_cache(cfg, batch, max_len, device)
    if _hybrid(cfg):
        return zamba.init_cache(cfg, batch, max_len, device)
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
    if _audio(cfg):
        return whisper.cache_slot_axes(cfg)
    if _hybrid(cfg):
        return zamba.cache_slot_axes(cfg)
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
    ``init_cache`` row, plus, for the audio family, the cross-attention K/V
    encoded once from ``batch["frames"]`` (1, F, d)."""
    if _audio(cfg):
        return whisper.request_cache(cfg, params, batch["frames"], max_len,
                                     device)
    return init_cache(cfg, 1, max_len, device)


def admit_into(cfg, params: Params, row: Params, batch: dict) -> Params:
    """The audio family's admission work, in place: encode
    ``batch["frames"]`` (B, F, d) and write every decoder layer's cross K/V
    into ``row`` (a cache of B rows, ``init_cache``'s); nothing else of
    ``row`` changes."""
    if not _audio(cfg):
        raise ValueError(f"family {cfg.family!r} has no frames to admit")
    return whisper.admit_into(cfg, params, row, batch["frames"])


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
    step = (whisper.decode_step if _audio(cfg) else
            zamba.decode_step if _hybrid(cfg) else transformer.decode_step)
    return step(cfg, params, cache, tokens, _rows(lengths, b, tokens.device),
                page_table=_table(page_table, tokens.device),
                write_mask=write_mask)


def mixed_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
               lengths, q_lens, *, page_table=None, all_logits: bool = False):
    """Advance every row by its own token count in one call.

    tokens (B, C); ``lengths`` (B,) = valid cache tokens BEFORE this step;
    ``q_lens`` (B,) = live tokens per row; ``page_table`` (B, pages) routes
    paged K/V placement.  Returns (logits (B, V) of each row's last live
    token, cache), or with ``all_logits`` the logits (B, C, V) of every
    chunk position.  ``C == 1`` delegates to ``decode_step``
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
        out = torch.where(active[:, None], logits, torch.zeros_like(logits))
        return (out[:, None] if all_logits else out), cache
    if _ssm(cfg) or _hybrid(cfg) or _audio(cfg):
        return _mixed_step_scan(cfg, params, cache, tokens, lengths, q_lens,
                                page_table=page_table, all_logits=all_logits)
    return transformer.mixed_step(cfg, params, cache, tokens, lengths, q_lens,
                                  page_table=page_table,
                                  all_logits=all_logits)


def _mixed_step_scan(cfg, params: Params, cache: Params,
                     tokens: torch.Tensor, lengths: torch.Tensor,
                     q_lens: torch.Tensor, page_table=None,
                     all_logits: bool = False):
    """Mixed step of the recurrent families and of the audio family: the
    chunk's positions one ``decode_step`` at a time, every position of the
    chunk (C steps, as the reference's scan), row ``b`` advancing only
    while ``j < q_lens[b]`` (the step's ``write_mask``: the kernels leave
    masked rows' state and K/V untouched, the reference's per-row select;
    ``page_table`` routes paged K/V as in every step).  The state is
    bitwise that of feeding the tokens one ``decode_step`` at a time; the
    logits are each row's at position ``q_lens - 1`` (zeros for an idle
    row), or with ``all_logits`` every position's (B, C, V), zeros past a
    row's ``q_lens``."""
    b, c = tokens.shape
    shape = (b, c, cfg.vocab_size) if all_logits else (b, cfg.vocab_size)
    logits = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    for j in range(c):
        active = j < q_lens
        lg, cache = decode_step(
            cfg, params, cache, tokens[:, j:j + 1],
            lengths + torch.clamp(q_lens, min=1).clamp(max=j + 1),
            page_table=page_table, write_mask=active)
        lg = lg.to(cfg.dtype)
        if all_logits:
            logits[:, j] = torch.where(active[:, None], lg,
                                       torch.zeros_like(lg))
        else:
            logits = torch.where((q_lens - 1 == j)[:, None], lg, logits)
    return logits, cache


def supports_speculation(cfg) -> bool:
    """Whether draft-then-verify serving can run on this config: it needs a
    rewindable sequence dimension.  K/V past a row's length hides behind
    true-length masking, so a transformer (or audio) row rewinds by
    shrinking its length on the host; a recurrent state folds every token
    in irreversibly, so ssm and hybrid fall back to plain decode."""
    return cfg.family in _TRANSFORMER_FAMILIES + ("audio",)


def supports_prefix_cache(cfg) -> bool:
    """Whether cross-request prefix sharing can run on this config: the
    paged layout (one block maps into many page tables) and K/V that is a
    pure function of the token prefix, which holds for the transformer
    families (audio's K/V folds in the request's encoder output; recurrent
    families carry per-slot state)."""
    return cfg.kv_layout == "paged" and cfg.family in _TRANSFORMER_FAMILIES


def copy_pool_block(cfg, cache: Params, src, dst) -> Params:
    """Copy physical KV block ``src`` to ``dst`` on every paged pool leaf of
    all layers (int8 scales included), in place: the device half of
    copy-on-write.  ``src`` / ``dst`` are int64 device tensors of shape
    (1,) (or ints), so the copy reads nothing back to the host and one
    captured graph serves every pair of blocks.  Pool leaves are
    ``(n_layers, P+1, hkv, bs, hd)``: the block axis is 1."""
    if not supports_prefix_cache(cfg):
        raise ValueError(
            f"copy_pool_block needs a prefix-shareable config, got "
            f"family={cfg.family!r} kv_layout={cfg.kv_layout!r}")
    pools = [leaf for leaf, axis in _leaves(cache, cache_slot_axes(cfg))
             if axis == -1]     # per-slot leaves have nothing pooled to copy
    s, d = (torch.as_tensor(i, dtype=torch.int64,
                            device=pools[0].device).reshape(1)
            for i in (src, dst))
    for leaf in pools:
        leaf.index_copy_(1, d, leaf.index_select(1, s))
    return cache


def export_cache(cfg, cache: Params) -> Params:
    """Device->host capture of every cache leaf, bitwise: a tree of CPU
    tensors shaped like ``cache`` (a copy even on the CPU).  Serving
    snapshots persist it through the checkpoint leaf codec, which keeps
    bfloat16 as its bit pattern.  Call it after the stream's work is done
    (the engine calls it after a tick's fetch) and never inside a
    capture."""
    return {k: export_cache(cfg, v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True) for k, v in cache.items()}


def load_cache_(cfg, cache: Params, arrays: dict) -> Params:
    """Inverse of :func:`export_cache`: copy each saved leaf IN PLACE into
    the existing tensor (``leaf.copy_``).  ``arrays`` maps each leaf's
    path (dict keys joined by ``/``) to a numpy array in the codec's
    stored dtype (a bfloat16 leaf as its ``uint16`` bit pattern).  Shapes
    and dtypes are checked for every leaf before any is written; nothing
    is cast.  ``cache`` is never rebound or rebuilt, so a graph captured
    on it before the load replays on the loaded state."""
    leaves = list(tree_paths(cache))
    if {p for p, _ in leaves} != set(arrays):
        raise KeyError(f"saved leaves {sorted(arrays)} are not the cache's "
                       f"{sorted(p for p, _ in leaves)}")
    srcs = []
    for path, leaf in leaves:
        arr = np.ascontiguousarray(arrays[path])
        name = dtype_name(leaf.dtype)
        bits, stored = VIEW_DTYPES.get(name, (None, None))
        want = np.dtype(stored).name if stored is not None else name
        if arr.dtype.name != want or tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {path!r}: saved {arr.dtype.name}{tuple(arr.shape)}, "
                f"the cache holds {want}{tuple(leaf.shape)}")
        src = (torch.from_numpy(arr) if bits is None else
               torch.from_numpy(arr.view(dtype_name(bits))).view(leaf.dtype))
        srcs.append((leaf, src))
    for leaf, src in srcs:
        leaf.copy_(src)
    return cache
