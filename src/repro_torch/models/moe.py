"""Mixture-of-Experts FFN (port of the local path of
``repro/models/moe.py``: mixtral 8 experts top-2, granite 40 top-8).

``moe_apply`` routes each group (a row of ``x (B, S, d)``: a sequence, a
mixed chunk or one decode token) by capacity, as the reference's
``_route`` / ``_dispatch_compute`` / ``_moe_apply_local`` do:

* the router ``(d, E)`` is float32 and never quantized; its product runs
  in x's dtype (on the router cast once to x's dtype, ``_router``), the
  softmax statistics in f32;
* ``ops.moe_router_route``: the product and the routing in one launch:
  top-k with ties to the lower expert index, renormalised; an assignment
  keeps its place when fewer than ``capacity(cfg, S)`` earlier assignments
  of its group chose its expert, and is dropped otherwise;
* ``ops.moe_ffn_w4a16``: every expert's FFN on its kept rows;
* the combine: each token's weighted sum of its kept outputs, rounded as
  the reference rounds its gather and scatter-add.

``moe_experts`` stops before the combine and returns the experts' rows
with each token's route (``Experts``); the layer walk hands them to the
next norm (``layers.add_norm``: ``ops.combine_add_rmsnorm``), so the
combined output is never written.  ``moe_apply`` combines them
(``ops.moe_combine``) for callers that want the layer's output.

``capacity`` depends on the group's length, so a chunk can drop
assignments that one-token decode keeps (decode's capacity is ``top_k``):
mixed and sequential steps agree only where nothing drops, in the
reference too.  A capacity factor of ``n_experts / top_k`` makes the
capacity the group's length, and nothing drops.

The reference's shard_map paths (a mesh) are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init

_ROUTER_CASTS: dict = {}


def moe_init(gen: torch.Generator, cfg) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)
    return {
        "router": dense_init(gen, d, e, torch.float32),
        "gate": (randn(e, d, f) / math.sqrt(d)).to(cfg.dtype),
        "up": (randn(e, d, f) / math.sqrt(d)).to(cfg.dtype),
        "down": (randn(e, f, d) / math.sqrt(f)).to(cfg.dtype),
    }


def capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.n_experts
            * cfg.moe_capacity_factor)
    return max(cfg.top_k, min(c, tokens_per_group))


def _router(router: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f32 router cast to ``dtype`` once (exact, and the reference
    casts it the same way), not once a tick: cached per router tensor.  A
    cast first made inside a CUDA graph capture would be a copy in every
    replay, so that raises."""
    if router.dtype == dtype:
        return router
    key = (router.data_ptr(), router.device, tuple(router.shape), dtype,
           router._version)
    hit = _ROUTER_CASTS.get(key)
    if hit is None:
        if router.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the router's cast was first asked for "
                               "inside a CUDA graph capture; run the step "
                               "eagerly first")
        hit = _ROUTER_CASTS[key] = (router, router.to(dtype))
    return hit[1]


def aux_loss(cfg, logits: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """GShard load-balance loss ``E * sum(me * ce)``: ``me`` the mean
    router probability, ``ce`` the fraction of the top-k assignments of
    each expert (all of them, kept or dropped), as the reference's."""
    e = cfg.n_experts
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=logits.device)
    ce.index_add_(0, topi.reshape(-1).long(),
                  torch.ones(topi.numel(), dtype=torch.float32,
                             device=logits.device))
    return e * torch.sum(me * (ce / topi.numel()))


@dataclasses.dataclass(frozen=True)
class Experts:
    """An MoE layer's output before the combine: ``y`` (rows, d) the
    experts' kept rows, ``slot`` (int32) and ``topw`` (f32) ``(B, S, k)``
    each token's assignments.  Indexing selects tokens as it would select
    them from the combined ``(B, S, d)`` output: it applies to ``slot``
    and ``topw`` and leaves ``y`` whole."""

    y: torch.Tensor
    slot: torch.Tensor
    topw: torch.Tensor

    def __getitem__(self, key) -> "Experts":
        return Experts(self.y, self.slot[key], self.topw[key])

    def combined(self) -> torch.Tensor:
        """The combined output ``(..., d)`` (``ops.moe_combine``)."""
        k = self.slot.shape[-1]
        out = ops.moe_combine(self.y, self.slot.reshape(-1, k),
                              self.topw.reshape(-1, k))
        return out.reshape(*self.slot.shape[:-1], self.y.shape[1])


def moe_experts(cfg, p: Params, x: torch.Tensor, *, q_lens=None,
                with_aux: bool = False):
    """x (B, S, d) -> (``Experts``, aux loss or None): the router's product
    and the route (one op), then every expert's FFN; the combine is left to
    the caller.  ``q_lens`` (B,) int32: a mixed chunk's live positions a row
    (the rest take no expert row and combine to zeros); ``with_aux``
    computes the load-balance loss."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    logits, route = ops.moe_router_route(
        x2, _router(p["router"], x.dtype), group=s, top_k=cfg.top_k,
        capacity=capacity(cfg, s), q_lens=q_lens)
    y = ops.moe_ffn_w4a16(x2, route, p["gate"], p["up"], p["down"],
                          activation=cfg.activation)
    aux = aux_loss(cfg, logits, route.topi) if with_aux else None
    k = cfg.top_k
    return Experts(y, route.slot.reshape(b, s, k),
                   route.topw.reshape(b, s, k)), aux


def moe_apply(cfg, p: Params, x: torch.Tensor, *, q_lens=None,
              with_aux: bool = False):
    """x (B, S, d) -> (out (B, S, d), aux loss or None): ``moe_experts``
    combined."""
    experts, aux = moe_experts(cfg, p, x, q_lens=q_lens, with_aux=with_aux)
    return experts.combined(), aux
