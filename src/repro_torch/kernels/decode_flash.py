"""Mixed prefill/decode flash attention: CUDA kernel wrapper and its plain
version, for the slot KV layout with a float cache.

Port of ``repro/kernels/decode_flash.py::mixed_flash_attention_pallas``
(``decode_flash_attention_pallas`` is its ``q_lens = 1`` case) and of the
blocked twins in ``repro/kernels/xla_attention.py``.  The kernel is
``csrc/decode_flash.cu``.  The int8-KV and paged variants come in a later
slice.

Contract: q (B, hq, C, d); caches (B, hkv, MAX, d); ``lengths`` (B,) = valid
context including this step's chunk; ``q_lens`` (B,) = live queries (query
j of row b sits at ``lengths[b] - q_lens[b] + j``).  Intra-chunk causal,
optional window, dead queries return exact zeros.  The KV tile is
``kv_block_size(MAX, 128)``, fixed by the cache length alone.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "mixed_flash_attention"
DEFAULT_BLOCK_KV = 128
_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def kv_block_size(max_len: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """Largest divisor of ``max_len`` that is <= ``block_kv``."""
    bk = min(block_kv, max_len)
    while max_len % bk:
        bk -= 1
    return bk


def _rows(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).reshape(-1).expand(b)


def mixed_attention_torch(q, k_cache, v_cache, lengths, q_lens, *,
                          window=None, scale=None) -> torch.Tensor:
    """Plain version: the kernel's online softmax over KV tiles of
    ``kv_block_size(MAX)`` keys, vectorised over rows.  A tile the
    kernel skips is fully masked here, which leaves m, l and acc unchanged."""
    b, hq, c, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    bk = kv_block_size(max_len)
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
    m = torch.full((b, hkv, rep, c), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, rep, c), device=dev)
    acc = torch.zeros((b, hkv, rep, c, d), device=dev)
    for ik in range(max_len // bk):
        pos = ik * bk + torch.arange(bk, device=dev)
        valid = ((pos[None, None, :] < lim[:, None, None])
                 & (pos[None, None, :] <= q_pos[:, :, None])
                 & alive[:, :, None])
        if window is not None:
            valid &= pos[None, None, :] > q_pos[:, :, None] - window
        vm = valid[:, None, None]                                  # (b,1,1,c,bk)
        kb = k_cache[:, :, ik * bk:(ik + 1) * bk].to(torch.float32)
        vb = v_cache[:, :, ik * bk:(ik + 1) * bk].to(torch.float32)
        s = torch.einsum("bgrcd,bgkd->bgrck", q5, kb) * scale
        s = torch.where(vm, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vm, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=dev))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrck,bgkd->bgrcd",
                          p.to(q.dtype).to(torch.float32), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l == 0, torch.ones((), device=dev), l)[..., None]
    return out.reshape(b, hq, c, d).to(q.dtype)


def mixed_flash_attention_cuda(q, k_cache, v_cache, lengths, q_lens, *,
                               window=None, scale=None) -> torch.Tensor:
    """Launch ``csrc/decode_flash.cu`` on the current stream."""
    check_activation(q, NAME)
    b, hq, c, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("caches must be (B, hkv, MAX, d), k and v alike")
    _, hkv, max_len, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} vs q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    if d not in (32, 64, 128):
        raise ValueError(f"head_dim {d}: the kernel takes 32, 64 or 128")
    for t in (k_cache, v_cache):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError("caches must be contiguous, on q's device, in "
                             "q's dtype (int8 KV is a later slice)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    bk = kv_block_size(max_len)
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    q = q.contiguous()
    lengths = _rows(lengths, b, q.device).to(torch.int32).contiguous()
    q_lens = _rows(q_lens, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b:
        fn = _build.function("decode_flash", "mixed_flash_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
                b, hq, hkv, c, d, max_len, bk, scale, window or 0,
                DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
        _build.check("decode_flash", rc)
        _build.launches[NAME] += 1
    return out
