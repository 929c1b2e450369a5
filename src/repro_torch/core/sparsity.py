"""Log-scale block sparsity on top of W4A16 (EdgeLLM §III-C), in PyTorch.

Bit-exact with the block-granular half of ``repro/core/sparsity.py``: the
contraction axis is cut into 128-row blocks, every group of ``m`` adjacent
blocks keeps the ``k = round(density * m)`` with the largest L1 mass, and
the kept set is shared across a 128-wide output tile.  Layout of one matrix
(``S`` kept blocks per output tile):

    packed     uint8 (out_tiles, S, 64, 128)  kept blocks, sublane-pair nibbles
    scales     bf16  (out_tiles, S, 128)       one per kept block and column
    block_idx  int32 (out_tiles, S)            kept block numbers, ascending

``tile_uniform`` marks a tensor whose kept set is the same for every output
tile (ranked on the importance summed over all tiles): the fused FFN walks
only those hidden tiles of the down projection.  A leading stack axis
(layers) is allowed on the arrays; indexing selects one matrix.

The Fig. 5 packing-cost model and the element-wise N:M masks of the
reference are not on the serving path and are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import (
    GROUP_SIZE, QuantizedTensor, dequantize, quantize)

BLOCKS_PER_GROUP = 8      # paper: "every group of eight adjacent data blocks"

__all__ = ["BLOCKS_PER_GROUP", "SparseQuantizedTensor", "block_importance",
           "block_sparsify_quantize", "sparse_to_quantized",
           "sparse_dequantize"]


@dataclasses.dataclass(frozen=True)
class SparseQuantizedTensor:
    """Block-sparse packed int4 weight; ``shape`` = ``(in, out)`` of one
    matrix.  Indexing a stacked tensor selects one matrix."""

    packed: torch.Tensor
    scales: torch.Tensor
    block_idx: torch.Tensor
    shape: tuple[int, int]
    density: float
    group_size: int = GROUP_SIZE
    tile_uniform: bool = False

    @property
    def kept_blocks(self) -> int:
        return self.packed.shape[-3]

    @property
    def nbytes_model(self) -> int:
        """Device bytes one full read streams: packed, scales and indices."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scales, self.block_idx))

    def __getitem__(self, i) -> "SparseQuantizedTensor":
        return dataclasses.replace(self, packed=self.packed[i],
                                   scales=self.scales[i],
                                   block_idx=self.block_idx[i])


def block_importance(w: torch.Tensor, block: int = GROUP_SIZE,
                     out_tile: int = GROUP_SIZE) -> torch.Tensor:
    """L1 mass of each (128-row block, 128-column tile): (in_blocks,
    out_tiles), in f32."""
    in_f, out_f = w.shape
    g = w.to(torch.float32).abs().reshape(in_f // block, block,
                                          out_f // out_tile, out_tile)
    return g.sum(dim=(1, 3))


def block_sparsify_quantize(w: torch.Tensor, density: float,
                            blocks_per_group: int = BLOCKS_PER_GROUP,
                            scale_dtype=torch.bfloat16,
                            tile_uniform: bool = False
                            ) -> SparseQuantizedTensor:
    """Keep the top ``round(density * blocks_per_group)`` blocks of every
    group of one ``(in, out)`` matrix (by L1 mass, per output tile or, with
    ``tile_uniform``, summed over all tiles), then quantize the kept blocks
    with per-block scales."""
    in_f, out_f = w.shape
    block = GROUP_SIZE
    k = int(round(density * blocks_per_group))
    if not 1 <= k <= blocks_per_group:
        raise ValueError(f"density {density} -> k={k} invalid")
    if in_f % block or out_f % block:
        raise ValueError("in/out features must be multiples of 128")
    n_blocks = in_f // block
    if n_blocks % blocks_per_group:
        raise ValueError(
            f"{n_blocks} blocks not a multiple of group {blocks_per_group}")
    n_groups = n_blocks // blocks_per_group
    out_tiles = out_f // block

    imp = block_importance(w)                         # (n_blocks, out_tiles)
    if tile_uniform:
        imp = imp.sum(dim=1, keepdim=True).expand(imp.shape)
    imp_g = imp.reshape(n_groups, blocks_per_group, out_tiles)
    # top-k per group (a stable sort, as jnp.argsort), ascending index
    order = torch.argsort(-imp_g, dim=1, stable=True)[:, :k, :]
    local = torch.sort(order, dim=1).values
    base = (torch.arange(n_groups, device=w.device)
            * blocks_per_group)[:, None, None]
    block_idx = (local + base).reshape(n_groups * k, out_tiles).T.to(
        torch.int32).contiguous()                     # (out_tiles, S)

    # quantize the whole matrix once, then gather the kept blocks per tile
    qt = quantize(w, group_size=block, scale_dtype=scale_dtype)
    packed_t = qt.packed.reshape(n_blocks, block // 2, out_tiles,
                                 block).permute(2, 0, 1, 3)
    scales_t = qt.scales.reshape(n_blocks, out_tiles, block).permute(1, 0, 2)
    tiles = torch.arange(out_tiles, device=w.device)[:, None]
    idx = block_idx.long()
    return SparseQuantizedTensor(
        packed=packed_t[tiles, idx].contiguous(),
        scales=scales_t[tiles, idx].contiguous(),
        block_idx=block_idx, shape=(in_f, out_f), density=float(density),
        tile_uniform=tile_uniform)


def sparse_to_quantized(st: SparseQuantizedTensor) -> QuantizedTensor:
    """Scatter the kept blocks back into the dense W4A16 layout: dropped
    blocks get zero nibbles and zero scales (the inverse of the gather in
    :func:`block_sparsify_quantize`)."""
    in_f, out_f = st.shape
    block = GROUP_SIZE
    *lead, out_tiles, _, half, _ = st.packed.shape
    n_blocks = in_f // block
    idx = st.block_idx.long()
    packed = st.packed.new_zeros((*lead, out_tiles, n_blocks, half, block))
    packed.scatter_(-3, idx[..., None, None].expand(st.packed.shape),
                    st.packed)
    scales = st.scales.new_zeros((*lead, out_tiles, n_blocks, block))
    scales.scatter_(-2, idx[..., None].expand(st.scales.shape), st.scales)
    # (..., out_tiles, n_blocks, rows, 128 out) -> (..., n_blocks * rows, out)
    return QuantizedTensor(
        packed=packed.movedim(-4, -2).reshape(*lead, n_blocks * half, out_f),
        scales=scales.movedim(-3, -2).reshape(*lead, n_blocks, out_f),
        shape=(in_f, out_f), group_size=st.group_size)


def sparse_dequantize(st: SparseQuantizedTensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """The dense ``(..., in, out)`` matrix (dropped blocks are zeros)."""
    return dequantize(sparse_to_quantized(st), dtype)
