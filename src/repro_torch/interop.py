"""Parameter interchange with the JAX reference, through numpy only.

The caller (a test) turns the JAX params tree into numpy first; this module
never imports the reference.  Packed leaves are recognised by their
attributes, so the reference's classes are read without being imported: a
leaf with ``block_idx`` is a block-sparse ``SparseQuantizedTensor`` (tested
first: it also has the dense leaf's four attributes), one with ``packed``,
``scales``, ``shape`` and ``group_size`` a ``QuantizedTensor``.  bfloat16
arrays (``ml_dtypes``) travel as their 16-bit patterns.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.sparsity import SparseQuantizedTensor

_QUANT_ATTRS = ("packed", "scales", "shape", "group_size")


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")      # writable: torch may write
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """JAX params tree (leaves already numpy) -> the port's params."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "block_idx"):
        return SparseQuantizedTensor(
            packed=_to_torch(tree.packed, device),
            scales=_to_torch(tree.scales, device),
            block_idx=_to_torch(tree.block_idx, device),
            shape=tuple(int(s) for s in tree.shape),
            density=float(tree.density), group_size=int(tree.group_size),
            tile_uniform=bool(tree.tile_uniform))
    if all(hasattr(tree, a) for a in _QUANT_ATTRS):
        return QuantizedTensor(
            packed=_to_torch(tree.packed, device),
            scales=_to_torch(tree.scales, device),
            shape=tuple(int(s) for s in tree.shape),
            group_size=int(tree.group_size))
    return _to_torch(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy`: numpy leaves, packed leaves as
    namespaces with the reference's attributes."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, SparseQuantizedTensor):
        return SimpleNamespace(packed=_to_numpy(tree.packed),
                               scales=_to_numpy(tree.scales),
                               block_idx=_to_numpy(tree.block_idx),
                               shape=tree.shape, density=tree.density,
                               group_size=tree.group_size,
                               tile_uniform=tree.tile_uniform)
    if isinstance(tree, QuantizedTensor):
        return SimpleNamespace(packed=_to_numpy(tree.packed),
                               scales=_to_numpy(tree.scales),
                               shape=tree.shape, group_size=tree.group_size)
    return _to_numpy(tree)
