"""The checkpoint leaf codec (port of ``write_state`` / ``read_state`` in
``repro/train/checkpoint.py``), over a dict tree of torch tensors.

On-disk format, the reference's exactly, so either package reads what the
other wrote::

    <dir>/
      manifest.json        # {"step", "extra", "leaves": [{"path", "id",
                           #   "file", "dtype"}, ...]}
      arrays/<id>.npy      # one file per leaf, ids in sorted-key order

A leaf's ``path`` joins its dict keys with ``/`` (``{"cache": {"k": t}}``
is ``cache/k``).  Leaves are bit-exact: bfloat16 goes out as its 16-bit
pattern (``t.view(torch.int16)``, saved as ``uint16``) tagged
``"bfloat16"``, the fp8 types as ``uint8`` likewise; int8, float32 and the
other numpy dtypes go as they are.  Nothing is cast by value.

Writes go through ``core.atomic.atomic_dir``.  The serving snapshot store
writes the engine's cache with this codec.  The reference's step-directory
checkpointer and its ``QuantizedTensor`` / ``SparseQuantizedTensor`` leaves
wait for the training slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.atomic import atomic_dir

# numpy has no bfloat16 or fp8: these travel as unsigned bit views + a tag
# (name -> (torch dtype of the same width, numpy dtype on disk))
VIEW_DTYPES = {"bfloat16": (torch.int16, np.uint16),
               "float8_e4m3fn": (torch.uint8, np.uint8),
               "float8_e5m2": (torch.uint8, np.uint8)}


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def tree_paths(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) in the reference's order: dict keys sorted, depth
    first."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from tree_paths(v, path + "/")
        else:
            yield path, v


def _to_savable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name in VIEW_DTYPES:
        bits, np_view = VIEW_DTYPES[name]
        return t.view(bits).numpy().view(np_view), name
    return t.numpy(), name


def write_state(final: str, state: dict[str, Any],
                extra: dict | None = None, step: int = 0) -> str:
    """Atomically write ``state`` (a dict tree of tensors) to directory
    ``final`` in the manifest + arrays format."""
    with atomic_dir(final) as tmp:
        os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (path, leaf) in enumerate(tree_paths(state)):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"leaf {path!r} is a {type(leaf).__name__}, "
                                "not a tensor")
            fn = f"{i:05d}.npy"
            arr, name = _to_savable(leaf)
            np.save(os.path.join(tmp, "arrays", fn), arr)
            manifest["leaves"].append({"path": path, "id": i, "file": fn,
                                       "dtype": name})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    return final


def read_state(d: str, like: dict[str, Any]
               ) -> tuple[dict[str, np.ndarray], dict]:
    """Read a ``write_state`` directory against ``like`` (a dict tree of
    tensors, for its paths, shapes and dtypes).  Returns ``(arrays,
    extra)``: ``arrays[path]`` is each leaf's numpy array as stored (a
    bfloat16 leaf as its ``uint16`` bit pattern, an fp8 one as ``uint8``).
    Raises on a path missing from the manifest and on a shape or dtype
    that differs from ``like``'s; never casts."""
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out: dict[str, np.ndarray] = {}
    for path, leaf in tree_paths(like):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"{d}: no leaf {path!r} in the manifest")
        if "file" not in entry:
            raise ValueError(f"{d}: leaf {path!r} is a packed "
                             f"{entry.get('kind')} leaf, not an array")
        want = dtype_name(leaf.dtype)
        if entry["dtype"] != want:
            raise ValueError(f"{d}: leaf {path!r} is {entry['dtype']}, "
                             f"expected {want}")
        arr = np.load(os.path.join(d, "arrays", entry["file"]))
        stored = (np.dtype(VIEW_DTYPES[want][1]).name
                  if want in VIEW_DTYPES else want)
        if arr.dtype.name != stored:
            raise ValueError(f"{d}: leaf {path!r} stored as "
                             f"{arr.dtype.name}, expected {stored}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{d}: leaf {path!r} has shape "
                             f"{tuple(arr.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        out[path] = arr
    return out, manifest["extra"]
