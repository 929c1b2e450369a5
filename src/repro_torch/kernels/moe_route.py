"""MoE routing and combine: CUDA kernel wrappers and their plain versions.

The reference does both in XLA (``repro/models/moe.py:64-118``: ``_route``
and the gather/scatter of ``_dispatch_compute``); it has no Pallas kernel
for them.  Here they are two hand kernels of ``csrc/moe_route.cu``, so a
serving tick routes on the device with no host read and stays one graph
replay:

* ``moe_route`` takes the router's logits ``(T, E)`` of ``T = B * S``
  tokens in ``B`` routing groups of ``S`` (a row's chunk, as the
  reference's ``vmap`` over the batch): f32 softmax, top-k with ties to the
  lower expert index (``jax.lax.top_k``'s rule), the weights renormalised
  by ``max(sum, 1e-9)``, then each assignment's position among its
  expert's in the group's flat ``(S, k)`` order and ``keep = pos <
  capacity``.  It lays the kept assignments out compactly, expert after
  expert and, within an expert, group by group in flat order: ``slot``
  ``(T, k)`` is an assignment's row there (-1: dropped, or a dead token),
  ``counts`` and ``offsets`` ``(E,)`` each expert's rows, ``rows``
  ``(T * k,)`` the token each row reads.
* ``moe_combine`` gives each token ``sum_j y[slot[t, j]] * w[t, j]`` as the
  reference rounds it (``moe.py:110-117``): the weight and each product in
  y's dtype, the sum in that dtype from zero in j order, a dropped
  assignment adding nothing.

A dead token (position ``s >= q_lens[b]`` of a mixed chunk) takes no row:
dead positions come after a group's live ones, so they never take a live
assignment's place, and nothing reads their output.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

ROUTE_NAME = "moe_route"
COMBINE_NAME = "moe_combine"
MAX_EXPERTS = 64             # two a lane of csrc/moe_route.cu's warps
MAX_TOP_K = 32               # one a lane
_ROUTE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Route:
    """One layer's routing: ``topw`` (T, k) f32 and ``topi`` (T, k) int32
    the renormalised top-k; ``slot`` (T, k) int32 each assignment's row in
    the expert-major compact layout (-1: none); ``counts``/``offsets``
    (E,) int32 each expert's rows; ``rows`` (T * k,) int32 the token of
    each row (past the kept total: unspecified, never read).  ``max_rows``
    is a host bound on any expert's count: a group gives an expert at most
    ``min(capacity, S)`` rows."""

    topw: torch.Tensor
    topi: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    max_rows: int


def max_rows(tokens: int, group: int, capacity: int) -> int:
    return (tokens // group) * min(capacity, group)


def _live(tokens: int, group: int, q_lens, device) -> torch.Tensor | None:
    if q_lens is None:
        return None
    q = torch.as_tensor(q_lens, device=device).reshape(-1, 1)
    pos = torch.arange(group, device=device)[None]
    return (pos < q).reshape(tokens)


def topk_torch(logits: torch.Tensor, top_k: int):
    """The plain routing weights: f32 softmax, the top ``top_k`` with ties
    to the lower index (a stable sort), renormalised by ``max(sum, 1e-9)``
    with the sum taken in j order, as the kernel takes it."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :top_k], idx[:, :top_k].to(torch.int32)
    s = topw[:, 0]
    for j in range(1, top_k):
        s = s + topw[:, j]
    return topw / torch.clamp_min(s, 1e-9)[:, None], topi


def moe_route_torch(logits: torch.Tensor, group: int, top_k: int,
                    capacity: int, q_lens=None) -> Route:
    """Plain version of the route kernel (CPU path and card reference)."""
    t, e = logits.shape
    b, dev = t // group, logits.device
    topw, topi = topk_torch(logits, top_k)
    flat = topi.reshape(b, group * top_k).long()
    onehot = torch.nn.functional.one_hot(flat, e).to(torch.int32)
    live = _live(t, group, q_lens, dev)
    if live is not None:
        onehot = onehot * live.repeat_interleave(top_k).reshape(
            b, group * top_k, 1).to(torch.int32)
    pos = (torch.cumsum(onehot, 1) - onehot).gather(2, flat[..., None])[..., 0]
    keep = pos < capacity
    if live is not None:
        keep = keep & live.repeat_interleave(top_k).reshape(b, -1)
    per_group = (onehot * keep[..., None]).sum(1, dtype=torch.int32)
    counts = per_group.sum(0, dtype=torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    base = offsets[None] + torch.cumsum(per_group, 0,
                                        dtype=torch.int32) - per_group
    slot = torch.where(keep, base.gather(1, flat) + pos,
                       torch.full_like(pos, -1)).to(torch.int32)
    n = t * top_k
    rows = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    token = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(
        top_k)
    rows.scatter_(0, torch.where(keep.reshape(-1), slot.reshape(-1).long(),
                                 torch.full((n,), n, device=dev)), token)
    return Route(topw, topi, slot.reshape(t, top_k), counts, offsets,
                 rows[:n], max_rows(t, group, capacity))


def moe_route_cuda(logits: torch.Tensor, group: int, top_k: int,
                   capacity: int, q_lens=None) -> Route:
    """Launch ``csrc/moe_route.cu``'s route kernel: one block a routing
    group, the last block to finish lays out the rows."""
    check_activation(logits, ROUTE_NAME)
    t, e = logits.shape
    if (logits.dim() != 2 or t % group or e > MAX_EXPERTS
            or not 1 <= top_k <= min(e, MAX_TOP_K)):
        raise ValueError(f"{ROUTE_NAME}: logits {tuple(logits.shape)} in "
                         f"groups of {group}, top {top_k} (at most "
                         f"{MAX_TOP_K}) of at most {MAX_EXPERTS} experts")
    b, dev = t // group, logits.device
    logits = logits.contiguous()
    ql = None
    if q_lens is not None:
        ql = torch.as_tensor(q_lens, device=dev)
        if ql.shape != (b,) or ql.dtype != torch.int32:
            raise ValueError(f"{ROUTE_NAME}: q_lens must be int32 ({b},)")
        ql = ql.contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    topw = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    topi = torch.empty((t, top_k), **i32)
    slot = torch.empty((t, top_k), **i32)
    counts = torch.empty((e,), **i32)
    offsets = torch.empty((e,), **i32)
    rows = torch.empty((t * top_k,), **i32)
    per_group = torch.empty((b, e), **i32)
    if t:
        fn = _build.function("moe_route", "moe_route_launch", _ROUTE_ARGTYPES)
        rc = fn(logits.data_ptr(), None if ql is None else ql.data_ptr(),
                topw.data_ptr(), topi.data_ptr(), slot.data_ptr(),
                counts.data_ptr(), offsets.data_ptr(), rows.data_ptr(),
                per_group.data_ptr(), b, group, e, top_k, capacity,
                DTYPE_CODES[logits.dtype], _build.stream_ptr(dev))
        _build.check("moe_route", rc)
        _build.launches[ROUTE_NAME] += 1
    return Route(topw, topi, slot, counts, offsets, rows,
                 max_rows(t, group, capacity))


def moe_combine_torch(y: torch.Tensor, slot: torch.Tensor,
                      topw: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine kernel: ``(T, d)`` in y's dtype."""
    t, k = slot.shape
    w = topw.to(y.dtype)
    acc = torch.zeros((t, y.shape[1]), dtype=y.dtype, device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    for j in range(k):
        s = slot[:, j].long()
        prod = y[s.clamp(min=0)] * w[:, j:j + 1]
        acc = acc + torch.where((s >= 0)[:, None], prod, zero)
    return acc


def moe_combine_cuda(y: torch.Tensor, slot: torch.Tensor,
                     topw: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moe_route.cu``'s combine kernel: one block a token,
    no atomics."""
    check_activation(y, COMBINE_NAME)
    t, k = slot.shape
    d = y.shape[1]
    if (slot.dtype != torch.int32 or topw.shape != (t, k)
            or topw.dtype != torch.float32 or y.dim() != 2
            or k > MAX_TOP_K):
        raise ValueError(f"{COMBINE_NAME}: y (rows, d), slot int32 (T, k), "
                         f"topw f32 (T, k), k <= {MAX_TOP_K}")
    y, slot, topw = y.contiguous(), slot.contiguous(), topw.contiguous()
    out = torch.empty((t, d), dtype=y.dtype, device=y.device)
    if t:
        fn = _build.function("moe_route", "moe_combine_launch",
                             _COMBINE_ARGTYPES)
        rc = fn(y.data_ptr(), slot.data_ptr(), topw.data_ptr(),
                out.data_ptr(), t, k, d, DTYPE_CODES[y.dtype],
                _build.stream_ptr(y.device))
        _build.check("moe_route", rc)
        _build.launches[COMBINE_NAME] += 1
    return out
