"""Block-level INT4 weight quantization (EdgeLLM §III-B), in PyTorch.

Bit-exact with ``repro/core/quant.py``: symmetric int4 along the
contraction axis, one scale per 128 input channels and output column, and
the *sublane-pair* nibble layout — within each 128-row group, byte ``r``
holds row ``r`` in its low nibble and row ``r + 64`` in its high nibble.
The CUDA kernels read that layout as it is (no repack at load time).

Weights are ``(in_features, out_features)``; a leading stack axis (layers)
is allowed on every function here and on :class:`QuantizedTensor`.
"""

from __future__ import annotations

import dataclasses

import torch

GROUP_SIZE = 128

__all__ = ["GROUP_SIZE", "QuantizedTensor", "quantize", "dequantize",
           "pack_int4", "unpack_int4"]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Packed int4 weight: ``packed`` uint8 ``(..., in/2, out)``, ``scales``
    ``(..., in/group, out)`` (bf16 by default), ``shape`` = ``(in, out)``
    of one matrix.  Indexing a stacked tensor selects one matrix."""

    packed: torch.Tensor
    scales: torch.Tensor
    shape: tuple[int, int]
    group_size: int = GROUP_SIZE

    @property
    def nbytes_model(self) -> int:
        """Device bytes one full read streams (packed nibbles + scales)."""
        return (self.packed.numel() * self.packed.element_size()
                + self.scales.numel() * self.scales.element_size())

    def __getitem__(self, i) -> "QuantizedTensor":
        return QuantizedTensor(self.packed[i], self.scales[i], self.shape,
                               self.group_size)


def pack_int4(q: torch.Tensor, group_size: int = GROUP_SIZE) -> torch.Tensor:
    """int4 values (int8 storage in [-8, 7]) ``(..., in, out)`` -> uint8
    ``(..., in/2, out)`` in the sublane-pair layout."""
    *lead, in_f, out_f = q.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not a multiple of {group_size}")
    half = group_size // 2
    g = q.reshape(*lead, in_f // group_size, group_size, out_f)
    lo = g[..., :half, :].to(torch.uint8) & 0xF
    hi = g[..., half:, :].to(torch.uint8) & 0xF
    return (lo | (hi << 4)).reshape(*lead, in_f // 2, out_f)


def unpack_int4(packed: torch.Tensor,
                group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; int8 values in [-8, 7]."""
    *lead, in_half, out_f = packed.shape
    half = group_size // 2
    g = packed.reshape(*lead, in_half // half, half, out_f)
    lo = (g & 0xF).to(torch.int8)
    hi = (g >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, in_half * 2, out_f)


def quantize(w: torch.Tensor, group_size: int = GROUP_SIZE,
             scale_dtype=torch.bfloat16) -> QuantizedTensor:
    """Symmetric block-level int4 quantization along the contraction axis."""
    *lead, in_f, out_f = w.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not a multiple of {group_size}")
    g = w.to(torch.float32).reshape(*lead, in_f // group_size, group_size,
                                    out_f)
    absmax = g.abs().amax(dim=-2)
    scale = torch.maximum(absmax / 7.0,
                          torch.tensor(1e-10, dtype=torch.float32,
                                       device=w.device))
    q = torch.clamp(torch.round(g / scale.unsqueeze(-2)), -8, 7)
    packed = pack_int4(q.to(torch.int8).reshape(*lead, in_f, out_f),
                       group_size)
    return QuantizedTensor(packed=packed, scales=scale.to(scale_dtype),
                           shape=(in_f, out_f), group_size=group_size)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(qt.packed, qt.group_size).to(torch.float32)
    *lead, in_f, out_f = q.shape
    g = q.reshape(*lead, in_f // qt.group_size, qt.group_size, out_f)
    w = g * qt.scales.to(torch.float32).unsqueeze(-2)
    return w.reshape(*lead, in_f, out_f).to(dtype)
