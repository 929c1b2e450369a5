"""KV-cache write and the serving steps' q/k/v epilogue: CUDA kernel
wrappers and their plain versions.

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

The epilogue (``qkv_rope_write``) takes a layer's raw q/k/v projections and
does, in one launch, what the serving steps did in about 40 PyTorch
operations: the q/k/v bias adds, a ``qk_norm`` config's per-head RMSNorm
of q and k (``q_norm`` / ``k_norm``, eps 1e-6, between the bias and RoPE
as in ``repro/models/attention.py:48-50``), RoPE on q and k, quantizing
K/V for an int8 cache (``quantize_kv``), the cache write above, and q's
layout ``(B, hq, C, hd)`` for the attention kernel.  Its plain version is
that chain (``qkv_rope_write_torch``, whose norm is the rmsnorm kernel on
the card), and the kernel rounds where the chain rounds on the card and
sums a head's squares in the rmsnorm kernel's order, so the two agree
bitwise (``csrc/kv_write.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import rmsnorm_torch
from repro_torch.kernels.rope import apply_rope, rope_table
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "kv_write"
EPILOGUE = "qkv_rope_write"
LEAVES = ("k", "v", "k_scale", "v_scale")
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
                 ctypes.c_void_p]
_EPI_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_void_p)]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 5
                 + [ctypes.POINTER(ctypes.c_void_p)] * 2
                 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
MAX_HEAD_DIM = 256      # 4 RoPE pairs a lane in the epilogue (kv_write.cu)
QK_NORM_EPS = 1e-6      # layers.rmsnorm's


def qk_norm_head_dim_ok(hd: int) -> bool:
    """Whether the epilogue kernel takes the q/k norm at head dim ``hd``:
    its lanes hold a head as the rmsnorm kernel's warps hold a row when hd
    / 2 is a multiple of 32, or when the row is one warp (hd <= 32)."""
    return hd % 2 == 0 and (hd <= 32 or (hd // 2) % 32 == 0)


def quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) -> int8 values + per-vector absmax scale (round half to
    even, as ``jnp.round``)."""
    tf = t.to(torch.float32)
    a = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(a / 127.0, min=1e-10)
    q = torch.clamp(torch.round(tf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


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


# -- the q/k/v epilogue -------------------------------------------------------

def qkv_rope_write_torch(cache: dict, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, bias: tuple, *, n_heads: int,
                         theta: float | None, rope_base: torch.Tensor,
                         starts: torch.Tensor, q_lens: torch.Tensor,
                         page_table: torch.Tensor | None = None,
                         q_norm: torch.Tensor | None = None,
                         k_norm: torch.Tensor | None = None,
                         write=kv_write_torch,
                         norm=rmsnorm_torch) -> torch.Tensor:
    """Plain version: the serving steps' former chain.  ``q`` (B, C, hq*hd),
    ``k``/``v`` (B, C, hkv*hd) raw projections, ``bias`` their three biases
    (None each for none); each gets its bias (``linear``'s add), q and k
    their per-head ``norm`` with the gammas ``q_norm`` / ``k_norm`` (None:
    no norm), then RoPE at positions ``rope_base[b] + j`` (``theta`` None:
    no RoPE), K/V are quantized for an int8 cache and ``write`` puts row
    ``b``'s positions ``j < q_lens[b]`` at ``starts[b] + j``.  Returns q as
    (B, hq, C, hd) contiguous."""
    b, c, _ = q.shape
    hd = cache["k"].shape[-1]
    heads = (n_heads, cache["k"].shape[1], cache["k"].shape[1])
    out = []
    for t, bt, h in zip((q, k, v), bias, heads):
        if bt is not None:
            t = t + bt.to(t.dtype)
        out.append(t.reshape(b, c, h, hd).transpose(1, 2))
    q, k, v = out
    if (q_norm is None) != (k_norm is None):
        raise ValueError(f"{EPILOGUE}: q_norm and k_norm come together")
    if q_norm is not None:
        q = norm(q, q_norm, QK_NORM_EPS)
        k = norm(k, k_norm, QK_NORM_EPS)
    if theta is not None:
        pos = rope_base[:, None] + torch.arange(c, dtype=rope_base.dtype,
                                                device=q.device)[None, :]
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    write(cache, new, starts, q_lens, page_table=page_table)
    return q.contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return t.data_ptr() if t is not None else None


def rope_rows(leaf: torch.Tensor, page_table: torch.Tensor | None) -> int:
    """Rows of the RoPE table the epilogue reads: the cache's logical span
    (a paged row's pages times the block size), from shapes alone.  A step
    that keeps ``starts + q_lens <= span`` and RoPE positions equal to its
    write positions has every live position below it; one engine's steps
    all share one table."""
    span = leaf.shape[2]
    return span * page_table.shape[1] if page_table is not None else span


def qkv_rope_write_cuda(cache: dict, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, bias: tuple, *, n_heads: int,
                        theta: float | None, rope_base: torch.Tensor,
                        starts: torch.Tensor, q_lens: torch.Tensor,
                        page_table: torch.Tensor | None = None,
                        q_norm: torch.Tensor | None = None,
                        k_norm: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Launch the epilogue of ``csrc/kv_write.cu`` on the current stream.
    Its RoPE table (``rope.rope_table``) has ``rope_rows`` rows; the kernel
    refuses a live position outside it with a device-side assert (a
    rolling window's positions run past the span, so its decode keeps the
    unfused chain).  ``q_norm`` / ``k_norm``: the per-head RMSNorm gammas
    (hd,) of a ``qk_norm`` config, both or neither, at a head dim
    ``qk_norm_head_dim_ok`` takes.  Shapes, devices and layouts the kernel
    does not take raise here."""
    check_activation(q, EPILOGUE)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{EPILOGUE}: q, k, v must be (B, C, heads * hd)")
    b, c, _ = q.shape
    device, dtype = q.device, q.dtype
    leaf_k, leaf_v = cache["k"], cache["v"]
    blocks, hkv, span, hd = leaf_k.shape
    quant = "k_scale" in cache
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{EPILOGUE}: head_dim {hd} must be even and <= "
                         f"{MAX_HEAD_DIM}")
    for name, t, h in (("q", q, n_heads), ("k", k, hkv), ("v", v, hkv)):
        if t.shape != (b, c, h * hd) or t.dtype != dtype or \
                t.device != device:
            raise ValueError(f"{EPILOGUE}: {name} {tuple(t.shape)} "
                             f"{t.dtype} is not ({b}, {c}, {h * hd}) {dtype} "
                             f"on {device}")
    want = torch.int8 if quant else dtype
    leaves = [leaf_k, leaf_v] + ([cache["k_scale"], cache["v_scale"]]
                                 if quant else [])
    for leaf in leaves:
        if leaf.shape[:3] != (blocks, hkv, span) or \
                not leaf.is_contiguous() or leaf.device != device:
            raise ValueError(f"{EPILOGUE}: cache leaves must be contiguous "
                             f"({blocks}, {hkv}, {span}, ...) on {device}")
    if leaf_k.dtype != want or leaf_v.dtype != want or leaf_v.shape[3] != hd \
            or (quant and any(t.dtype != torch.float32 or t.shape[3] != 1
                              for t in leaves[2:])):
        raise ValueError(f"{EPILOGUE}: cache leaves must be {want} (int8: "
                         "with f32 (..., 1) scales)")
    paged = page_table is not None
    if not paged and blocks != b:
        raise ValueError(f"{EPILOGUE}: a slot cache of {blocks} rows for "
                         f"{b} rows")
    if paged:
        if page_table.dim() != 2 or page_table.shape[0] != b or \
                page_table.device != device:
            raise ValueError(f"{EPILOGUE}: page_table must be (B={b}, "
                             f"n_pages) on {device}")
        page_table = page_table.to(torch.int32).contiguous()
    idx = [_device_rows(t, b, device, what) for t, what in (
        (rope_base, "rope_base"), (starts, "starts"), (q_lens, "q_lens"))]
    srcs = [t if t.stride(2) == 1 else t.contiguous() for t in (q, k, v)]
    biases = []
    for bt, h in zip(bias, (n_heads, hkv, hkv)):
        if bt is not None:
            if bt.shape != (h * hd,) or bt.device != device:
                raise ValueError(f"{EPILOGUE}: a bias must be ({h * hd},) "
                                 f"on {device}")
            bt = bt.to(dtype).contiguous()
        biases.append(bt)
    if (q_norm is None) != (k_norm is None):
        raise ValueError(f"{EPILOGUE}: q_norm and k_norm come together")
    norms = []
    for gamma in (q_norm, k_norm):
        if gamma is not None:
            if not qk_norm_head_dim_ok(hd):
                raise ValueError(f"{EPILOGUE}: the q/k norm takes head dims "
                                 f"<= 32 or with hd / 2 a multiple of 32, "
                                 f"not {hd}")
            if gamma.shape != (hd,) or gamma.device != device:
                raise ValueError(f"{EPILOGUE}: a q/k norm gamma must be "
                                 f"({hd},) on {device}")
            gamma = gamma.to(dtype).contiguous()
        norms.append(gamma)
    cos_t = sin_t = None
    rows = rope_rows(leaf_k, page_table)
    if theta is not None:
        cos_t, sin_t = rope_table(hd, theta, rows, device)
    out = torch.empty((b, n_heads, c, hd), dtype=dtype, device=device)
    if b and c:
        fn = _build.function(NAME, "qkv_rope_write_launch", _EPI_ARGTYPES)
        rc = fn((ctypes.c_void_p * 3)(*[t.data_ptr() for t in srcs]),
                (ctypes.c_longlong * 6)(*[s for t in srcs
                                          for s in (t.stride(0),
                                                    t.stride(1))]),
                (ctypes.c_void_p * 3)(*[_ptr(t) for t in biases]),
                (ctypes.c_void_p * 2)(*[_ptr(t) for t in norms]),
                _ptr(cos_t), _ptr(sin_t),
                rows if cos_t is not None else 0,
                *[t.data_ptr() for t in idx], _ptr(page_table),
                out.data_ptr(),
                (ctypes.c_void_p * 2)(leaf_k.data_ptr(), leaf_v.data_ptr()),
                (ctypes.c_void_p * 2)(*[_ptr(cache.get(n)) for n in (
                    "k_scale", "v_scale")]),
                b, c, n_heads, hkv, hd, span,
                page_table.shape[1] if paged else 0, int(quant),
                DTYPE_CODES[dtype], _build.stream_ptr(device))
        _build.check(NAME, rc)
        _build.launches[EPILOGUE] += 1
    return out
