"""Zamba2-style hybrid backbone (family ``hybrid``), port of
``repro/models/zamba.py``: Mamba2 layers and weight-shared attention
blocks.  [arXiv:2411.15242]

81 Mamba2 layers (``models/ssm.py``); after every ``shared_attn_every``
(6) of them one of ``n_shared_blocks`` (2) weight-shared transformer
blocks (attention + SwiGLU MLP) runs, alternating (site ``s`` takes block
``s % 2``).  Parameters keep the reference's layout: ``mamba_main`` stacks
``n_seg`` segments x ``seg`` blocks on two leading axes, ``mamba_tail`` the
blocks past the last segment, ``shared`` the shared blocks once; each site
owns only its K/V (the cache's ``kv`` stacks ``n_seg`` sites on its
leading axis, slot or paged, as the transformer stacks layers).

Every route walks the same sublayers in order (``_sublayers``): a Mamba
block's ``ln`` and mixer, a site's ``ln_attn`` and attention, its
``ln_mlp`` and MLP.  The first norm is a norm alone; every later one takes
the residual add before it (``layers.add_norm``: one launch on the card),
and the last add goes into ``ln_f``.  A decode step updates the cache in
place: the Mamba windows and states through ``ops.mamba_cell_gated``, each
site's K/V through the fused q/k/v epilogue.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, ssm
from repro_torch.models.layers import Params
from repro_torch.models.transformer import layer_params, stack_blocks


def shared_block_init(gen: torch.Generator, cfg) -> Params:
    return {"ln_attn": layers.norm_init(cfg, gen.device),
            "attn": attention.attn_init(gen, cfg),
            "ln_mlp": layers.norm_init(cfg, gen.device),
            "mlp": layers.mlp_init(gen, cfg)}


def mamba_block_init(gen: torch.Generator, cfg) -> Params:
    return {"ln": layers.norm_init(cfg, gen.device),
            "mamba": ssm.mamba_init(gen, cfg)}


def _segmentation(cfg) -> tuple[int, int, int]:
    seg = cfg.shared_attn_every
    n_seg = cfg.n_layers // seg
    return seg, n_seg, cfg.n_layers - n_seg * seg


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_params(cfg, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``."""
    seg, n_seg, tail = _segmentation(cfg)
    main = stack_blocks(gen, cfg, n_seg * seg, mamba_block_init)
    p: Params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype),
        "mamba_main": _tree_map(
            lambda a: a.reshape(n_seg, seg, *a.shape[1:]), main),
        "shared": stack_blocks(gen, cfg, cfg.n_shared_blocks,
                               shared_block_init),
        "ln_f": layers.norm_init(cfg, gen.device),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     cfg.dtype),
    }
    if tail:
        p["mamba_tail"] = stack_blocks(gen, cfg, tail, mamba_block_init)
    return p


def _sublayers(cfg, params: Params):
    """(norm params, kind, sublayer params, where) of every sublayer in
    order: kind "mamba" (where: the Mamba block's cache key and indices),
    "attn" and "mlp" (where: the site)."""
    seg, n_seg, tail = _segmentation(cfg)
    for s in range(n_seg):
        mseg = layer_params(params["mamba_main"], s)
        for j in range(seg):
            bp = layer_params(mseg, j)
            yield bp["ln"], "mamba", bp["mamba"], ("mamba_main", s, j)
        sp = layer_params(params["shared"], s % cfg.n_shared_blocks)
        yield sp["ln_attn"], "attn", sp["attn"], s
        yield sp["ln_mlp"], "mlp", sp["mlp"], s
    for t in range(tail):
        bp = layer_params(params["mamba_tail"], t)
        yield bp["ln"], "mamba", bp["mamba"], ("mamba_tail", t)


def _walk(cfg, params: Params, x: torch.Tensor, apply) -> torch.Tensor:
    """``ln_f`` of the residual stream after every sublayer: ``apply(kind,
    p, where, n)`` is a sublayer's output on its normed input ``n``."""
    h = None
    for norm, kind, p, where in _sublayers(cfg, params):
        if h is None:
            n = layers.apply_norm(cfg, norm, x)
        else:
            x, n = layers.add_norm(cfg, norm, x, h)
        h = apply(kind, p, where, n)
    return layers.add_norm(cfg, params["ln_f"], x, h, keep_sum=False)[1]


def forward(cfg, params: Params, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux loss = 0)."""
    b, s = tokens.shape
    positions = layers.positions_for(cfg, b, s, device=tokens.device)

    def apply(kind, p, where, n):
        if kind == "mamba":
            return ssm.mamba_apply(cfg, p, n)
        if kind == "attn":
            return attention.attn_apply(cfg, p, n, positions)
        return layers.mlp_apply(cfg, p, n)
    x = _walk(cfg, params, params["embed"][tokens], apply)
    return (layers.linear(x, params["lm_head"]),
            torch.zeros((), device=tokens.device))


# -- serving -----------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    """Every Mamba block's window and state (``mamba_main`` (n_seg, seg,
    B, ...), ``mamba_tail`` (tail, B, ...)) and every site's K/V (``kv``
    (n_seg, ...) of the slot or paged layout)."""
    seg, n_seg, tail = _segmentation(cfg)
    mc = ssm.mamba_cache_init(cfg, batch, device)
    kv = attention.init_kv_cache(cfg, batch, max_len, device)
    cache: Params = {
        "mamba_main": {k: a[None, None].repeat(n_seg, seg, *[1] * a.dim())
                       for k, a in mc.items()},
        "kv": {k: a[None].repeat(n_seg, *[1] * a.dim())
               for k, a in kv.items()}}
    if tail:
        cache["mamba_tail"] = {k: a[None].repeat(tail, *[1] * a.dim())
                               for k, a in mc.items()}
    return cache


def cache_slot_axes(cfg) -> Params:
    """Request-slot axis of every cache leaf: inserting a fresh row
    through these axes resets the Mamba windows and states; a site's K/V
    rows hide behind the lengths (paged pool leaves: -1)."""
    _, _, tail = _segmentation(cfg)
    axes: Params = {"mamba_main": {"conv": 2, "state": 2},
                    "kv": attention.kv_cache_slot_axes(cfg, axis=1)}
    if tail:
        axes["mamba_tail"] = {"conv": 1, "state": 1}
    return axes


def _mamba_cache(cache: Params, where) -> Params:
    key, *idx = where
    return {k: v[tuple(idx)] for k, v in cache[key].items()}


def _site_kv(cache: Params, s: int) -> Params:
    return {k: v[s] for k, v in cache["kv"].items()}


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                lengths: torch.Tensor, *,
                page_table: torch.Tensor | None = None,
                write_mask: torch.Tensor | None = None):
    """One token a row, tokens (B, 1); ``lengths`` (B,) = context length
    including this token; ``page_table`` routes paged K/V placement and
    ``write_mask`` (B,) bool leaves masked rows' caches (windows, states and
    K/V) untouched.  Returns (logits (B, V), cache)."""
    index = attention.decode_index(cfg, _site_kv(cache, 0), tokens.shape[0],
                                   lengths, page_table, write_mask)

    def apply(kind, p, where, n):
        if kind == "mamba":
            return ssm.mamba_decode(cfg, p, n, _mamba_cache(cache, where),
                                    active=write_mask)[0]
        if kind == "attn":
            return attention.attn_decode(cfg, p, n, _site_kv(cache, where),
                                         lengths, index=index)[0]
        return layers.mlp_apply(cfg, p, n)
    x = _walk(cfg, params, params["embed"][tokens], apply)
    return layers.linear(x, params["lm_head"])[:, 0], cache
