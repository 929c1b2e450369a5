"""Checkpoints (port of ``repro/train/checkpoint.py``) over a dict tree of
torch tensors: the leaf codec (``write_state`` / ``read_state``) and the
step-directory checkpointer (``save``, ``latest_step``, ``restore``).

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
writes the engine's cache with this codec.  A training checkpoint is one
such directory per step, ``<ckpt_dir>/step_%09d``, and ``save`` keeps the
newest ``keep`` of them; a checkpoint of ``{"params", "opt"}`` written by
either package restores in the other (the optimizer state's leaves are
``opt/step``, ``opt/m/...`` and ``opt/v/...`` in both).  The reference's
packed ``QuantizedTensor`` / ``SparseQuantizedTensor`` leaves are not
written here: training state is dense.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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


def save(ckpt_dir: str, step: int, state: dict[str, Any],
         extra: dict | None = None, keep: int = 3) -> str:
    """Write ``state`` (a dict tree of tensors) as ``step_%09d`` and prune
    all but the newest ``keep`` step directories."""
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    write_state(final, state, extra, step)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        (d for d in os.listdir(ckpt_dir) if re.match(r"step_\d+$", d)))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if re.match(r"step_\d+$", d)]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: dict[str, Any]
            ) -> tuple[dict[str, Any], dict]:
    """Step ``step``'s state as a new tree of tensors with ``like``'s
    structure, shapes, dtypes and devices (``read_state``'s checks: nothing
    is cast), and its ``extra``."""
    arrays, extra = read_state(os.path.join(ckpt_dir, f"step_{step:09d}"),
                               like)

    def load(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = load(v, f"{prefix}{k}/")
                continue
            arr = np.asarray(arrays[f"{prefix}{k}"], order="C")
            bits = VIEW_DTYPES.get(dtype_name(v.dtype), (None,))[0]
            t = (torch.from_numpy(arr) if bits is None else
                 torch.from_numpy(arr.view(dtype_name(bits))).view(v.dtype))
            out[k] = t.to(v.device)
        return out

    return load(like, ""), extra
