"""Mixed prefill/decode flash attention: CUDA kernel wrapper and its plain
version, for the slot and paged KV layouts with a float or an int8 cache.

Port of ``repro/kernels/decode_flash.py::mixed_flash_attention_pallas``
(``decode_flash_attention_pallas`` is its ``q_lens = 1`` case) and of the
blocked twins in ``repro/kernels/xla_attention.py``.  The kernel is
``csrc/decode_flash.cu``; its four variants (slot or paged, fp or int8 K/V)
are instantiations of one template.

Contract: q (B, hq, C, d); ``lengths`` (B,) = valid context including this
step's chunk; ``q_lens`` (B,) = live queries (query j of row b sits at
``lengths[b] - q_lens[b] + j``).  Intra-chunk causal, optional window, dead
queries return exact zeros.

* Slot layout: caches (B, hkv, MAX, d); the KV tile is
  ``kv_block_size(MAX, block_kv)``, fixed by the cache length alone.
* Paged layout: caches are shared pools (P, hkv, bs, d) and ``page_table``
  (B, n_pages) int32 maps logical tile ``ik`` of row ``b`` to pool block
  ``page_table[b, ik]``.  The KV tile IS the page size ``bs`` (8 to 128 on
  the card), and only tiles inside a row's live range are addressed, so
  unleased blocks and the null block are never read.  With
  ``block_kv = bs`` the slot walk reduces in the same order: paged ≡ slot
  bit for bit.
* int8 K/V: int8 caches plus f32 per-token scales ``k_scale``/``v_scale``
  shaped like the cache with a last axis of 1.  Each int8 value converts
  exactly; the K scale multiplies the finished score (then ``scale`` does),
  ``l`` sums the probabilities before the V scale, and ``p * v_scale`` is
  rounded to the activation dtype before P·V (scale-after-dot).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "mixed_flash_attention"
# launch-count name of each variant, by (paged, int8 K/V)
VARIANTS = {(False, False): NAME, (False, True): NAME + "_int8",
            (True, False): NAME + "_paged", (True, True): NAME + "_paged_int8"}
DEFAULT_BLOCK_KV = 128
PAGE_SIZES = range(8, 129)       # the reference's kernel wants >= 8; the tile
#                                  holds at most 128 keys
_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def kv_block_size(max_len: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """Largest divisor of ``max_len`` that is <= ``block_kv``."""
    bk = min(block_kv, max_len)
    while max_len % bk:
        bk -= 1
    return bk


def _rows(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).reshape(-1).expand(b)


def _tile(leaf, ik: int, bk: int, page_table) -> torch.Tensor:
    """Logical KV tile ``ik`` of every row, (B, hkv, bk, ...): a slice of
    the slot cache, or the pool blocks the page table names."""
    if page_table is None:
        return leaf[:, :, ik * bk:(ik + 1) * bk]
    return leaf[page_table[:, ik].long()]


def mixed_attention_torch(q, k_cache, v_cache, lengths, q_lens, *,
                          window=None, scale=None, k_scale=None,
                          v_scale=None, page_table=None,
                          block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """Plain version: the kernel's online softmax over KV tiles, vectorised
    over rows, in the kernel's order.  A tile the kernel skips is fully
    masked here, which leaves m, l and acc unchanged; keys at or past a
    row's length are zeroed as the kernel's loads zero them, so whatever a
    block holds there (the null block's garbage) never reaches a sum."""
    b, hq, c, d = q.shape
    hkv = k_cache.shape[1]
    rep = hq // hkv
    if page_table is not None:
        bk, n_blocks = k_cache.shape[2], page_table.shape[1]
    else:
        bk = kv_block_size(k_cache.shape[2], block_kv)
        n_blocks = k_cache.shape[2] // bk
    max_len = bk * n_blocks
    quant = k_scale is not None
    if quant:
        k_scale = k_scale.reshape(k_cache.shape[:3])
        v_scale = v_scale.reshape(k_cache.shape[:3])
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    dev = q.device
    lengths = _rows(lengths, b, dev).long()
    q_lens = _rows(q_lens, b, dev).long()
    q5 = q.reshape(b, hkv, rep, c, d).to(torch.float32)
    j = torch.arange(c, device=dev)
    q_pos = (lengths - q_lens)[:, None] + j[None, :]               # (b, c)
    lim = torch.clamp(lengths, max=max_len)
    alive = j[None, :] < q_lens[:, None]                           # (b, c)
    neg = torch.tensor(_NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    m = torch.full((b, hkv, rep, c), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, rep, c), device=dev)
    acc = torch.zeros((b, hkv, rep, c, d), device=dev)
    for ik in range(n_blocks):
        pos = ik * bk + torch.arange(bk, device=dev)
        loaded = (pos[None, :] < lim[:, None])[:, None, :]          # (b,1,bk)
        valid = ((pos[None, None, :] < lim[:, None, None])
                 & (pos[None, None, :] <= q_pos[:, :, None])
                 & alive[:, :, None])
        if window is not None:
            valid &= pos[None, None, :] > q_pos[:, :, None] - window
        vm = valid[:, None, None]                                  # (b,1,1,c,bk)
        kb = torch.where(loaded[..., None], _tile(k_cache, ik, bk, page_table)
                         .to(torch.float32), zero)
        vb = torch.where(loaded[..., None], _tile(v_cache, ik, bk, page_table)
                         .to(torch.float32), zero)
        s = torch.einsum("bgrcd,bgkd->bgrck", q5, kb)
        if quant:
            ks = torch.where(loaded, _tile(k_scale, ik, bk, page_table), zero)
            s = s * ks[:, :, None, None, :]
        s = s * scale
        s = torch.where(vm, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vm, torch.exp(s - m_new[..., None]), zero)
        l = l * alpha + p.sum(dim=-1)
        if quant:
            vs = torch.where(loaded, _tile(v_scale, ik, bk, page_table), zero)
            p = p * vs[:, :, None, None, :]
        pv = torch.einsum("bgrck,bgkd->bgrcd",
                          p.to(q.dtype).to(torch.float32), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l == 0, torch.ones((), device=dev), l)[..., None]
    return out.reshape(b, hq, c, d).to(q.dtype)


def _check_leaf(t, dtype, device, what: str) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")


def mixed_flash_attention_cuda(q, k_cache, v_cache, lengths, q_lens, *,
                               window=None, scale=None, k_scale=None,
                               v_scale=None, page_table=None,
                               block_kv: int = DEFAULT_BLOCK_KV
                               ) -> torch.Tensor:
    """Launch ``csrc/decode_flash.cu`` on the current stream: the variant
    the operands name (page table: paged; scales: int8 K/V).  Every shape,
    dtype and page size the kernel does not take raises here."""
    check_activation(q, NAME)
    b, hq, c, d = q.shape
    paged, quant = page_table is not None, k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together (int8 K/V)")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("caches must be 4-D, k and v alike")
    n_rows, hkv, span, dk = k_cache.shape
    if dk != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} vs q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    if d not in (32, 64, 128):
        raise ValueError(f"head_dim {d}: the kernel takes 32, 64 or 128")
    if paged:
        if page_table.dim() != 2 or page_table.shape[0] != b:
            raise ValueError(f"page_table {tuple(page_table.shape)} must be "
                             f"(B={b}, n_pages)")
        if page_table.device != q.device:
            raise ValueError("page_table must be on q's device")
        if span not in PAGE_SIZES:
            raise ValueError(
                f"page size {span}: the paged kernel takes pages of "
                f"{PAGE_SIZES.start} to {PAGE_SIZES.stop - 1} tokens")
        bk, max_len = span, page_table.shape[1] * span
        page_table = page_table.to(torch.int32).contiguous()
    else:
        if n_rows != b:
            raise ValueError(f"cache {tuple(k_cache.shape)} vs q "
                             f"{tuple(q.shape)}")
        bk, max_len = kv_block_size(span, block_kv), span
    kv_dtype = torch.int8 if quant else q.dtype
    _check_leaf(k_cache, kv_dtype, q.device, "k_cache")
    _check_leaf(v_cache, kv_dtype, q.device, "v_cache")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape not in (k_cache.shape[:3], (*k_cache.shape[:3], 1)):
                raise ValueError(f"{name} {tuple(t.shape)} vs cache "
                                 f"{tuple(k_cache.shape)}")
            _check_leaf(t, torch.float32, q.device, name)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    q = q.contiguous()
    lengths = _rows(lengths, b, q.device).to(torch.int32).contiguous()
    q_lens = _rows(q_lens, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b:
        def ptr(t):
            return None if t is None else t.data_ptr()
        fn = _build.function("decode_flash", "mixed_flash_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                ptr(k_scale), ptr(v_scale), ptr(page_table),
                lengths.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
                b, hq, hkv, c, d, max_len, bk, scale, window or 0,
                DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
        _build.check("decode_flash", rc)
        _build.launches[VARIANTS[(paged, quant)]] += 1
    return out
