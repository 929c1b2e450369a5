"""Offline model compiler (EdgeLLM §IV), the port's subset.

``quantize_model`` walks the parameter tree and replaces every static weight
matrix with its W4A16 :class:`QuantizedTensor`, exactly as
``repro/core/compiler.py`` does for the ``"dense"`` strategy (paper Table II:
every kind at density 1.0).  Stacked leading axes (layers) are quantized in
one call.  The log-scale sparse strategies need the sparse kernels, which a
later slice ports.

``TokenBuckets`` keeps the engine's chunk widths on a bounded power-of-two
set, so a later slice can capture one CUDA graph per width.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.quant import GROUP_SIZE, QuantizedTensor, quantize

STRATEGIES = ("none", "dense")
_SPARSE_STRATEGIES = ("strategy1", "strategy2", "strategy3")

# leaf name -> quantized (the dense strategy quantizes every kind)
_QUANTIZED_NAMES = {"wq", "wk", "wv", "wo", "gate", "up", "down", "lm_head"}


def quantize_model(params: dict, strategy: str = "dense") -> dict:
    """Tree transform: static weight matrices -> packed int4 (dense).

    Norms, biases and the embedding (a lookup) stay 16-bit, the paper's
    rule.  ``"none"`` returns the tree unchanged."""
    if strategy in _SPARSE_STRATEGIES:
        raise NotImplementedError(
            f"strategy {strategy!r} needs the block-sparse W4A16 kernels "
            "(sparse_w4a16_matmul_pallas, ffn_fused_sparse_pallas), which "
            "a later slice of the port brings; use 'dense' or 'none'")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "none":
        return params

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if (name in _QUANTIZED_NAMES and isinstance(tree, torch.Tensor)
                and tree.is_floating_point() and tree.ndim >= 2
                and tree.shape[-2] % GROUP_SIZE == 0):
            return quantize(tree)
        return tree

    return walk(params)


def quantized_bytes(params: Any) -> int:
    """Total device bytes of the packed model (the paper's Table II sums)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return params.nbytes_model
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


@dataclasses.dataclass(frozen=True)
class TokenBuckets:
    """Power-of-two token-length buckets with a MAX token bound."""

    max_tokens: int
    min_bucket: int = 16

    def bucket(self, n: int) -> int:
        if n > self.max_tokens:
            raise ValueError(f"{n} tokens exceeds MAX {self.max_tokens}")
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_tokens)

    def all_buckets(self) -> list[int]:
        out, b = [], self.min_bucket
        while b < self.max_tokens:
            out.append(b)
            b *= 2
        out.append(self.max_tokens)
        return out
