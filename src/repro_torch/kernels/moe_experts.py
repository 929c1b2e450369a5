"""The experts of an MoE layer, grouped: CUDA kernel wrappers and their plain
versions.

The reference runs each expert's FFN as ``ops.ffn_w4a16`` under a
``jax.vmap`` over (batch row, expert) on a zero-padded capacity buffer
(``repro/models/moe.py:125-147``); on its TPU a quant group other than 128
rows leaves kernel 2 for the blocked XLA twin
(``repro/kernels/ffn_fused.py:697-708``).  Here the experts of a layer are
two hand kernels of ``csrc/moe_experts.cu``, kernel 2's and kernel 1's
bf16 tensor-core tile (``csrc/w4a16_mma_tile.cuh``) run by a persistent
ring (``csrc/moe_mma_ring.cuh``): each block builds the work items --
(expert with rows, row tile, column strip), ``moe_items_torch`` -- from
the route's counts on the device and strides over them, while a producer
warp streams the weights through TMA into a ring of stages that does not
drain between items:

* ``moe_gate_up_w4a16``: ``act(x @ gate_e) * (x @ up_e)`` for the rows
  each expert keeps, gathered by index from the token rows (``Route.rows``)
  and written to the expert's compact rows of the ``(T * k, d_ff)``
  hidden, so each expert's weights stream once a tick, not once per batch
  row; an expert with no rows does no work.
* ``moe_down_w4a16``: the hidden's rows against ``down_e``, one output row
  per kept assignment.

Both take 32-, 64- and 128-row quant groups (the group is a template
parameter); each row's sum order is fixed by ``(in_f, group)``, the
order of kernels 1 and 2, so a row is bitwise the same whatever the other
rows of its expert, the batch, the chunk width, the tile configuration or
the grid's size.  The plain version of the whole FFN, per expert, is the
reference's (``ffn_w4a16_torch``: any weight mix, the unfused oracle for
16-bit experts).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import _build
from repro_torch.kernels.ffn_fused import (
    GATED_ACTIVATIONS, ffn_gate_up_torch, ffn_w4a16_torch)
from repro_torch.kernels.moe_route import Route
from repro_torch.kernels.w4a16_matmul import (
    MMA_GROUP_SIZES, aligned, check_activation, w4a16_matmul_f32)

GATE_UP_NAME = "moe_gate_up_w4a16"
DOWN_NAME = "moe_down_w4a16"
_ACT_CODES = {"swiglu": 1, "geglu": 2}
_GATE_UP_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
_DOWN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]
# the C launchers' tile configurations by the ``tile`` codes they take
# (rows, columns a work item); 0, the served path's, picks by the route's
# mean rows an expert: up to 32 decode (1), above mid (2)
GATE_UP_TILES = {1: (16, 32), 2: (64, 64)}
DOWN_TILES = {1: (16, 32), 2: (32, 128)}


def _expert_rows(route: Route):
    """(expert, offset, count) of every expert with rows: a host read, for
    the plain versions only."""
    counts, offsets = route.counts.tolist(), route.offsets.tolist()
    return [(e, o, n) for e, (n, o) in enumerate(zip(counts, offsets)) if n]


def moe_items_torch(counts: torch.Tensor, bm: int,
                    strips: int) -> torch.Tensor:
    """Plain version of the work list the grouped kernels' blocks build
    from ``counts`` (``csrc/moe_mma_ring.cuh``, ``moe_items_prefix`` and
    ``moe_item``): ``(n_items, 3)`` int32 rows (expert, first row, strip),
    expert after expert; an expert's ``ceil(count / bm)`` row tiles times
    ``strips`` column strips, the tile fastest.  Item ``i`` of a launch is
    taken by block ``i % grid``."""
    counts = counts.to(torch.int64)
    tiles = (counts + bm - 1) // bm
    per = tiles * strips
    n = int(per.sum())
    first = torch.cumsum(per, 0) - per
    expert = torch.repeat_interleave(torch.arange(counts.numel()), per)
    local = torch.arange(n) - first[expert]
    tile, strip = local % tiles[expert], local // tiles[expert]
    return torch.stack([expert, tile * bm, strip], 1).to(torch.int32)


def moe_ffn_torch(x: torch.Tensor, route: Route, gate, up, down, *,
                  activation: str = "swiglu") -> torch.Tensor:
    """Plain version: each expert's kept rows through ``ffn_w4a16_torch``
    (the reference's numerics for any weight mix), into ``(T * k, d)``."""
    y = torch.zeros((route.rows.numel(), down.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for e, o, n in _expert_rows(route):
        h = x[route.rows[o:o + n].long()]
        y[o:o + n] = ffn_w4a16_torch(
            h, gate[e] if gate is not None else None, up[e], down[e],
            activation=activation)
    return y


def moe_gate_up_torch(x: torch.Tensor, route: Route, gate: QuantizedTensor,
                      up: QuantizedTensor, activation: str) -> torch.Tensor:
    """Plain version of the grouped gate/up kernel: ``(T * k, d_ff)`` in
    x's dtype, the rows past the kept total zero."""
    hidden = torch.zeros((route.rows.numel(), up.shape[1]), dtype=x.dtype,
                         device=x.device)
    for e, o, n in _expert_rows(route):
        hidden[o:o + n] = ffn_gate_up_torch(
            x[route.rows[o:o + n].long()], gate[e], up[e], activation)
    return hidden


def moe_down_torch(hidden: torch.Tensor, route: Route,
                   down: QuantizedTensor) -> torch.Tensor:
    """Plain version of the grouped down kernel: ``(T * k, d)``."""
    y = torch.zeros((hidden.shape[0], down.shape[1]), dtype=hidden.dtype,
                    device=hidden.device)
    for e, o, n in _expert_rows(route):
        y[o:o + n] = w4a16_matmul_f32(hidden[o:o + n], down[e]).to(
            hidden.dtype)
    return y


def check_experts(qt, n_experts: int, device, what: str) -> None:
    """Raise unless ``qt`` is a stack of ``n_experts`` W4A16 matrices the
    grouped tile takes: 32-, 64- or 128-row groups, in % 128 == 0, out % 16
    == 0, bf16 scales, contiguous and 16-byte aligned on ``device``."""
    if not isinstance(qt, QuantizedTensor):
        raise NotImplementedError(
            f"{what}: the grouped expert kernels take W4A16 experts "
            f"(QuantizedTensor), got {type(qt).__name__}; 16-bit and mixed "
            "experts go through ops.moe_ffn_w4a16's plain path on the CPU "
            "only")
    in_f, out_f = qt.shape
    g = qt.group_size
    if g not in MMA_GROUP_SIZES:
        raise ValueError(f"{what}: group {g}, the tile takes "
                         f"{MMA_GROUP_SIZES}")
    if in_f % 128 or out_f % 16:
        raise ValueError(f"{what}: shape {qt.shape} needs in % 128 == 0 and "
                         "out % 16 == 0")
    if (qt.packed.shape != (n_experts, in_f // 2, out_f)
            or qt.packed.dtype != torch.uint8
            or qt.scales.shape != (n_experts, in_f // g, out_f)
            or qt.scales.dtype != torch.bfloat16):
        raise ValueError(
            f"{what}: packed uint8 {(n_experts, in_f // 2, out_f)} and bf16 "
            f"scales {(n_experts, in_f // g, out_f)}")
    for t in (qt.packed, qt.scales):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: weights must be contiguous on {device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: weights must be 16-byte aligned (the "
                             "kernels' TMA loads)")


def moe_gate_up_cuda(x: torch.Tensor, route: Route, gate: QuantizedTensor,
                     up: QuantizedTensor, activation: str, *, tile: int = 0,
                     blocks: int = 0) -> torch.Tensor:
    """Launch ``csrc/moe_experts.cu``'s grouped gate/up kernel.  ``tile``
    (a ``GATE_UP_TILES`` code) and ``blocks`` (the grid's size) are for
    tests and timing; 0, the served path's, lets the launcher choose."""
    check_activation(x, GATE_UP_NAME)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"{GATE_UP_NAME}: the grouped tile takes "
                                  "bfloat16 activations")
    if activation not in _ACT_CODES:
        raise NotImplementedError(f"{GATE_UP_NAME}: gated activations only "
                                  f"({sorted(_ACT_CODES)})")
    e = route.counts.shape[0]
    check_experts(gate, e, x.device, f"{GATE_UP_NAME} gate")
    check_experts(up, e, x.device, f"{GATE_UP_NAME} up")
    d, f = up.shape
    if (gate.shape != up.shape or gate.group_size != up.group_size
            or x.dim() != 2 or x.shape[1] != d):
        raise ValueError(f"{GATE_UP_NAME}: x {tuple(x.shape)}, gate "
                         f"{gate.shape}, up {up.shape}")
    x = aligned(x.contiguous(), 16)
    n = route.rows.numel()
    hidden = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n:
        fn = _build.function("moe_experts", "moe_gate_up_launch",
                             _GATE_UP_ARGTYPES)
        rc = fn(x.data_ptr(), route.rows.data_ptr(), route.counts.data_ptr(),
                route.offsets.data_ptr(), gate.packed.data_ptr(),
                gate.scales.data_ptr(), up.packed.data_ptr(),
                up.scales.data_ptr(), hidden.data_ptr(), e, route.max_rows,
                n, d, f, up.group_size, _ACT_CODES[activation], tile,
                blocks, _build.stream_ptr(x.device))
        _build.check("moe_experts", rc)
        _build.launches[GATE_UP_NAME] += 1
    return hidden


def moe_down_cuda(hidden: torch.Tensor, route: Route, down: QuantizedTensor,
                  *, tile: int = 0, blocks: int = 0) -> torch.Tensor:
    """Launch ``csrc/moe_experts.cu``'s grouped down kernel (``tile``: a
    ``DOWN_TILES`` code; ``blocks``: as ``moe_gate_up_cuda``'s)."""
    check_activation(hidden, DOWN_NAME)
    if hidden.dtype != torch.bfloat16:
        raise NotImplementedError(f"{DOWN_NAME}: the grouped tile takes "
                                  "bfloat16 activations")
    e = route.counts.shape[0]
    check_experts(down, e, hidden.device, DOWN_NAME)
    f, d = down.shape
    if hidden.dim() != 2 or hidden.shape[1] != f:
        raise ValueError(f"{DOWN_NAME}: hidden {tuple(hidden.shape)}, down "
                         f"{down.shape}")
    hidden = aligned(hidden.contiguous(), 16)
    n = hidden.shape[0]
    y = torch.empty((n, d), dtype=hidden.dtype, device=hidden.device)
    if n:
        fn = _build.function("moe_experts", "moe_down_launch", _DOWN_ARGTYPES)
        rc = fn(hidden.data_ptr(), route.counts.data_ptr(),
                route.offsets.data_ptr(), down.packed.data_ptr(),
                down.scales.data_ptr(), y.data_ptr(), e, route.max_rows, n,
                f, d, down.group_size, tile, blocks,
                _build.stream_ptr(hidden.device))
        _build.check("moe_experts", rc)
        _build.launches[DOWN_NAME] += 1
    return y


def moe_ffn_cuda(x: torch.Tensor, route: Route, gate, up, down, *,
                 activation: str = "swiglu") -> torch.Tensor:
    """The two grouped kernels: gate/up into the compact hidden, then
    down, ``(T * k, d)``.  Experts that are not all W4A16 raise."""
    if activation not in GATED_ACTIVATIONS:
        raise NotImplementedError(f"the MoE experts are gated, got "
                                  f"{activation!r}")
    return moe_down_cuda(moe_gate_up_cuda(x, route, gate, up, activation),
                         route, down)
