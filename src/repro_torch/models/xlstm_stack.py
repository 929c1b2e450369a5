"""xLSTM model assembly (family ``ssm``), port of
``repro/models/xlstm_stack.py``: the mLSTM/sLSTM residual stack and the LM
head.

xlstm-1.3b has 48 blocks; one in every ``slstm_every`` is sLSTM, the rest
mLSTM.  Parameters keep the reference's layout: ``mlstm_main`` stacks
segments x (slstm_every - 1) mLSTM blocks on two leading axes, ``slstm`` one
block per segment, ``mlstm_tail`` the blocks past the last segment.  The
layers run as a Python loop over views of the stacked tensors.  No
attention and no KV cache: the serving cache is the recurrent state, O(1)
in the context length, updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, xlstm
from repro_torch.models.layers import Params
from repro_torch.models.transformer import layer_params, stack_blocks


def _segmentation(cfg) -> tuple[int, int, int]:
    if cfg.slstm_every <= 0:
        return 0, 0, cfg.n_layers
    n_seg = cfg.n_layers // cfg.slstm_every
    m_per_seg = cfg.slstm_every - 1
    tail = cfg.n_layers - n_seg * cfg.slstm_every
    return n_seg, m_per_seg, tail


def init_params(cfg, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``."""
    n_seg, m_per_seg, tail = _segmentation(cfg)
    p: Params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype),
        "ln_f": layers.norm_init(cfg, gen.device),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     cfg.dtype),
    }
    if n_seg:
        main = stack_blocks(gen, cfg, n_seg * m_per_seg, xlstm.mlstm_init)
        p["mlstm_main"] = {k: a.reshape(n_seg, m_per_seg, *a.shape[1:])
                           for k, a in main.items()}
        p["slstm"] = stack_blocks(gen, cfg, n_seg, xlstm.slstm_init)
    if tail:
        p["mlstm_tail"] = stack_blocks(gen, cfg, tail, xlstm.mlstm_init)
    return p


def _blocks(cfg, tree: Params):
    """(kind, params, cache-or-state) of every block in order, as views of
    the stacked tensors (``tree`` is the params or the cache)."""
    n_seg, m_per_seg, tail = _segmentation(cfg)
    for s in range(n_seg):
        seg = layer_params(tree["mlstm_main"], s)
        for j in range(m_per_seg):
            yield "mlstm", layer_params(seg, j)
        yield "slstm", layer_params(tree["slstm"], s)
    for t in range(tail):
        yield "mlstm", layer_params(tree["mlstm_tail"], t)


def _head(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(cfg, params["ln_f"], x)
    return layers.linear(x, params["lm_head"])


def forward(cfg, params: Params, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux loss = 0)."""
    x = params["embed"][tokens]
    for kind, bp in _blocks(cfg, params):
        apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
        x = apply(cfg, bp, x)
    return _head(cfg, params, x), torch.zeros((), device=tokens.device)


# -- serving: recurrent state instead of a KV cache ---------------------------

def init_cache(cfg, batch: int, max_len: int, device) -> Params:
    """The recurrent state of ``batch`` rows (``max_len`` has no effect:
    the state does not grow with the context)."""
    n_seg, m_per_seg, tail = _segmentation(cfg)
    mc = xlstm.mlstm_cache_init(cfg, batch, device)
    cache: Params = {}
    if n_seg:
        cache["mlstm_main"] = {
            k: a[None, None].repeat(n_seg, m_per_seg, *([1] * a.dim()))
            for k, a in mc.items()}
        cache["slstm"] = {
            k: a[None].repeat(n_seg, *([1] * a.dim()))
            for k, a in xlstm.slstm_cache_init(cfg, batch, device).items()}
    if tail:
        cache["mlstm_tail"] = {k: a[None].repeat(tail, *([1] * a.dim()))
                               for k, a in mc.items()}
    return cache


def cache_slot_axes(cfg) -> Params:
    """Request-slot axis of every state leaf.  Inserting a fresh row
    through these axes is the per-row reset (``m`` returns to -1e30, not
    0, or the next request's stabilizer would be corrupted)."""
    n_seg, _, tail = _segmentation(cfg)
    axes: Params = {}
    if n_seg:
        axes["mlstm_main"] = {"C": 2, "n": 2, "m": 2}    # (seg, blk, B, ...)
        axes["slstm"] = {"c": 1, "n": 1, "h": 1, "m": 1}  # (seg, B, ...)
    if tail:
        axes["mlstm_tail"] = {"C": 1, "n": 1, "m": 1}    # (tail, B, ...)
    return axes


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                write_mask: torch.Tensor | None = None):
    """One token per row, tokens (B, 1): returns (logits (B, V), cache),
    the state advanced in place for the rows in ``write_mask`` (all when
    None)."""
    x = params["embed"][tokens]
    for (kind, bp), (_, bc) in zip(_blocks(cfg, params), _blocks(cfg, cache)):
        step = xlstm.mlstm_decode if kind == "mlstm" else xlstm.slstm_decode
        x, _ = step(cfg, bp, x, bc, active=write_mask)
    return _head(cfg, params, x)[:, 0], cache
