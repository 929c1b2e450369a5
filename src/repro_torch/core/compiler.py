"""Offline model compiler (EdgeLLM §IV), the port's subset.

``quantize_model`` walks the parameter tree and replaces every static weight
matrix of the dense family with its packed form per a *sparse strategy*
(paper Table II: a density per layer kind), exactly as
``repro/core/compiler.py`` does: a :class:`QuantizedTensor` at density 1.0,
a log-scale block-sparse :class:`SparseQuantizedTensor` below it.  Stacked
layers, one leading axis or two (the xLSTM's ``(segments, blocks, in,
out)``), are quantized per matrix, as the reference's nested ``vmap`` does:
dense quantization works per 128-row group, so a stack goes whole; a pruned
stack goes matrix by matrix.

``TokenBuckets`` keeps the engine's chunk widths on a bounded power-of-two
set, and ``CompileCache`` memoizes the engine's executables per key, so the
card captures one CUDA graph per chunk width.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.quant import GROUP_SIZE, QuantizedTensor, quantize
from repro_torch.core.sparsity import (
    BLOCKS_PER_GROUP, SparseQuantizedTensor, block_sparsify_quantize)

# layer kind -> density (1.0 = dense-quantized)
SPARSE_STRATEGIES: dict[str, dict[str, float]] = {
    # paper Table II, GLM-6B
    "dense": {"qkv": 1.0, "o": 1.0, "h_to_4h": 1.0, "4h_to_h": 1.0,
              "head": 1.0, "other": 1.0},
    "strategy1": {"qkv": 1.0, "o": 0.5, "h_to_4h": 0.5, "4h_to_h": 0.5,
                  "head": 1.0, "other": 1.0},
    "strategy2": {"qkv": 1.0, "o": 0.5, "h_to_4h": 0.25, "4h_to_h": 0.5,
                  "head": 1.0, "other": 1.0},
    "strategy3": {"qkv": 1.0, "o": 0.5, "h_to_4h": 0.25, "4h_to_h": 0.25,
                  "head": 1.0, "other": 1.0},
}
STRATEGIES = ("none", *SPARSE_STRATEGIES)

# weight names -> layer kind (dense and xLSTM families).  The xLSTM's gate
# projections w_i / w_f (one column per head), the sLSTM's block-diagonal
# recurrent r_gates and every norm and bias stay 16-bit, as in the reference
_KIND_BY_NAME = {"wq": "qkv", "wk": "qkv", "wv": "qkv", "wo": "o",
                 "gate": "h_to_4h", "up": "h_to_4h", "down": "4h_to_h",
                 "lm_head": "head",
                 "up_x": "h_to_4h", "up_z": "h_to_4h", "w_gates": "other"}


def _quantize_2d(w: torch.Tensor, density: float, tile_uniform: bool):
    """One (in, out) matrix, the reference's rules: 16-bit when it does not
    tile; dense-quantized at density 1.0 or when no group size ``m`` in
    (8, 4, 2) divides the block count with ``round(density * m) >= 1``.
    Dense quantization takes a stack of matrices whole."""
    in_f, out_f = w.shape[-2:]
    if in_f % GROUP_SIZE or (density < 1.0 and out_f % GROUP_SIZE):
        return w
    if density >= 1.0:
        return quantize(w)
    n_blocks = in_f // GROUP_SIZE
    for m in (BLOCKS_PER_GROUP, 4, 2):
        if n_blocks % m == 0 and round(density * m) >= 1:
            return block_sparsify_quantize(w, density, blocks_per_group=m,
                                           tile_uniform=tile_uniform)
    return quantize(w)


def _stack(parts: list):
    """Stack per-layer results (tensors, or packed tensors field by field)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


def _quantize_leaf(w: torch.Tensor, density: float, tile_uniform: bool):
    """A pruned stack is quantized layer by layer (the reference's vmap):
    each matrix keeps its own blocks."""
    if w.ndim == 2 or density >= 1.0:
        return _quantize_2d(w, density, tile_uniform)
    return _stack([_quantize_leaf(layer, density, tile_uniform)
                   for layer in w])


def quantize_model(params: dict, strategy: str = "dense") -> dict:
    """Tree transform: static weight matrices -> packed int4 (+ sparse).

    Norms, biases and the embedding (a lookup) stay 16-bit, the paper's
    rule.  ``"none"`` returns the tree unchanged."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "none":
        return params
    dmap = SPARSE_STRATEGIES[strategy]

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        kind = _KIND_BY_NAME.get(name)
        if (kind is None or not isinstance(tree, torch.Tensor)
                or not tree.is_floating_point() or tree.ndim < 2):
            return tree
        # the down projection contracts over d_ff, the axis the fused FFN
        # walks: one kept set for all its output tiles lets it skip the
        # hidden tiles down drops (and their gate/up blocks)
        return _quantize_leaf(tree, dmap[kind],
                              tile_uniform=(kind == "4h_to_h"))

    return walk(params)


def quantized_bytes(params: Any) -> int:
    """Total device bytes of the packed model (the paper's Table II sums)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (QuantizedTensor, SparseQuantizedTensor)):
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


class CompileCache:
    """Memoized serving executables per (name, key): on the card each entry
    is one captured CUDA graph, on the CPU the same function run eagerly.

    Serving uses three key families (the paper's pre-compiled executable
    set from Fig. 9, restated for captured graphs, which fix every shape):

    * ``("mixed", W)`` — the mixed prefill/decode tick at chunk-width
      bucket W (``TokenBuckets`` over the engine's chunk size): prompts
      admit through the SAME dispatch that advances decode rows, so there
      is no per-prompt-length prefill family at all;
    * ``("decode", B)`` — the pure-decode tick: one graph per resident
      slot-batch size, shared by every request at every step;
    * ``("insert", B)`` — the slot copy behind ``insert_request`` (the
      slot index is an operand, so one entry covers all B slots).

    Total serving executables are therefore bounded by
    ``n_chunk_buckets + 2`` per engine regardless of traffic — the paper's
    "17 operators x B buckets" instruction-stream budget, restated as
    graphs: a tick replays one graph, and no traffic captures another
    beyond the budget.
    """

    def __init__(self):
        self._cache: dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self.misses_by_name: dict[str, int] = {}

    def get(self, name: str, bucket: int, build: Callable[[], Any]):
        key = (name, bucket)
        if key not in self._cache:
            self._cache[key] = build()
            self.misses += 1
            self.misses_by_name[name] = self.misses_by_name.get(name, 0) + 1
        else:
            self.hits += 1
        return self._cache[key]

    def keys(self) -> list[tuple]:
        return list(self._cache)

    def __len__(self):
        return len(self._cache)
