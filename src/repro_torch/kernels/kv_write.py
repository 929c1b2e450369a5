"""KV-cache write: CUDA kernel wrapper and its plain version.

One layer's new K/V rows (``k``/``v``, plus ``k_scale``/``v_scale`` for an
int8 cache) go into the cache IN PLACE: row ``b`` writes its chunk
positions ``j < q_lens[b]`` at logical positions ``starts[b] + j``, into
the slot cache ``(B, hkv, L, w)`` or, through ``page_table (B, n_pages)``,
into the shared pool ``(n_blocks + 1, hkv, bs, w)``.  Every other position
keeps its value, so a ``q_lens == 0`` row is untouched and the null block
is never written.  A decode write is the ``C == 1`` case: ``q_lens`` is
the write mask as 0/1 and ``starts`` the write index (a rolling window's
included).  Callers guarantee ``starts + q_lens <= span``.

No Pallas counterpart: the reference writes with XLA's dynamic-update-slice
(``repro/models/attention.py:139``, ``:153``, ``:269``).  The kernel
(``csrc/kv_write.cu``) reads ``starts`` and ``q_lens`` on the device, so a
serving step reads nothing back to the host and a CUDA graph replays it;
the plain version is the index writes the attention module used before,
which select rows with ``nonzero`` (a host read on the card).  A write is a
copy, so the two agree bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "kv_write"
LEAVES = ("k", "v", "k_scale", "v_scale")
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
                 ctypes.c_void_p]


def _chunk_write(leaf: torch.Tensor, new: torch.Tensor,
                 starts: torch.Tensor, q_lens: torch.Tensor) -> None:
    c = new.shape[2]
    j = torch.arange(c, device=new.device)
    rows, cols = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
    leaf[rows, :, starts.long()[rows] + cols] = \
        new[rows, :, cols].to(leaf.dtype)


def _paged_chunk_write(pool: torch.Tensor, new: torch.Tensor,
                       page_table: torch.Tensor, starts: torch.Tensor,
                       q_lens: torch.Tensor) -> None:
    c = new.shape[2]
    bs = pool.shape[2]
    j = torch.arange(c, device=new.device)
    rows, cols = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
    pos = starts.long()[rows] + cols
    blk = page_table.long()[rows, pos // bs]
    pool[blk, :, pos % bs] = new[rows, :, cols].to(pool.dtype)


def kv_write_torch(cache: dict, new: dict, starts: torch.Tensor,
                   q_lens: torch.Tensor,
                   page_table: torch.Tensor | None = None) -> None:
    """Plain version (CPU path and card reference): index writes of the
    live (row, position) pairs, selected with ``nonzero``."""
    for name, t in new.items():
        if page_table is None:
            _chunk_write(cache[name], t, starts, q_lens)
        else:
            _paged_chunk_write(cache[name], t, page_table, starts, q_lens)


def _copy_width(nbytes: int, *addresses: int) -> int:
    for vec in (16, 8, 4, 2):
        if nbytes % vec == 0 and all(a % vec == 0 for a in addresses):
            return vec
    return 1


def _device_rows(t: torch.Tensor, b: int, device, what: str) -> torch.Tensor:
    if t.shape != (b,) or t.device != device:
        raise ValueError(f"{NAME}: {what} must be ({b},) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def kv_write_cuda(cache: dict, new: dict, starts: torch.Tensor,
                  q_lens: torch.Tensor,
                  page_table: torch.Tensor | None = None) -> None:
    """Launch ``csrc/kv_write.cu`` on the current stream: every leaf of
    ``new`` in one launch.  Shapes, devices and layouts the kernel does
    not take raise here."""
    names = [n for n in LEAVES if n in new]
    if not names or len(names) != len(new):
        raise ValueError(f"{NAME}: leaves must be among {LEAVES}, got "
                         f"{sorted(new)}")
    first = new[names[0]]
    if first.dim() != 4 or not first.is_cuda:
        raise ValueError(f"{NAME}: new rows must be 4-D (B, hkv, C, w) CUDA "
                         "tensors")
    b, heads, c, _ = first.shape
    device = first.device
    starts = _device_rows(starts, b, device, "starts")
    q_lens = _device_rows(q_lens, b, device, "q_lens")
    paged = page_table is not None
    n_pages = 0
    if paged:
        if page_table.dim() != 2 or page_table.shape[0] != b or \
                page_table.device != device:
            raise ValueError(f"{NAME}: page_table must be (B={b}, n_pages) "
                             f"on {device}")
        page_table = page_table.to(torch.int32).contiguous()
        n_pages = page_table.shape[1]
    dst, src, strides, widths, vecs = [], [], [], [], []
    keep = []                               # alive until the launch
    span = None
    for name in names:
        leaf, rows = cache[name], new[name]
        if leaf.dim() != 4 or not leaf.is_contiguous() or \
                leaf.device != device:
            raise ValueError(f"{NAME}: cache leaf {name} must be a "
                             f"contiguous 4-D tensor on {device}")
        if rows.shape[:3] != (b, heads, c) or rows.shape[3] != leaf.shape[3]:
            raise ValueError(f"{NAME}: {name} rows {tuple(rows.shape)} vs "
                             f"cache {tuple(leaf.shape)}")
        if (leaf.shape[1] != heads or (not paged and leaf.shape[0] != b)
                or (span is not None and leaf.shape[2] != span)):
            raise ValueError(f"{NAME}: cache leaf {name} "
                             f"{tuple(leaf.shape)} does not fit rows "
                             f"{tuple(rows.shape)}")
        span = leaf.shape[2]
        rows = rows.to(leaf.dtype)
        if rows.shape[3] > 1 and rows.stride(3) != 1:
            rows = rows.contiguous()
        keep.append(rows)
        elt = rows.element_size()
        nbytes = rows.shape[3] * elt
        stride = [rows.stride(i) * elt if rows.shape[i] > 1 else 0
                  for i in range(3)]
        dst.append(leaf.data_ptr())
        src.append(rows.data_ptr())
        strides += stride
        widths.append(nbytes)
        vecs.append(_copy_width(nbytes, leaf.data_ptr(), rows.data_ptr(),
                                *stride))
    if b and c:
        n = len(names)
        fn = _build.function(NAME, "kv_write_launch", _ARGTYPES)
        rc = fn((ctypes.c_void_p * n)(*dst), (ctypes.c_void_p * n)(*src),
                (ctypes.c_longlong * (3 * n))(*strides),
                (ctypes.c_int * n)(*widths), (ctypes.c_int * n)(*vecs), n,
                starts.data_ptr(), q_lens.data_ptr(),
                page_table.data_ptr() if paged else None, b, heads, c, span,
                n_pages, _build.stream_ptr(device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
