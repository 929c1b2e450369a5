"""Public kernel entry points, mirroring ``repro/kernels/ops.py``.

Each op picks its implementation by the tensors' device (``impl="auto"``):

* ``"cuda"``  — the hand-written sm_90a kernel.  Taken for CUDA tensors; it
  launches or raises, there is no fallback.
* ``"torch"`` — the plain PyTorch version with the same numerics contract
  (the role ``impl="xla"`` plays in the reference).  Taken for CPU tensors,
  and on the card only when asked for, to compare a kernel with it.
* ``"ref"``   — the dense oracle of ``kernels/ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.sparsity import SparseQuantizedTensor
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_flash import (
    DEFAULT_BLOCK_KV, mixed_attention_torch, mixed_flash_attention_cuda)
from repro_torch.kernels.dense_matmul import (
    dense_matmul_cuda, dense_matmul_torch)
from repro_torch.kernels.ffn_fused import ffn_w4a16_cuda, ffn_w4a16_torch
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_torch)
from repro_torch.kernels.kv_write import kv_write_cuda, kv_write_torch
from repro_torch.kernels.layernorm import layernorm_cuda, layernorm_torch
from repro_torch.kernels.mlstm_cell import mlstm_cell_cuda, mlstm_cell_torch
from repro_torch.kernels.slstm_scan import slstm_scan_cuda, slstm_scan_torch
from repro_torch.kernels.sparse_w4a16 import (
    sparse_w4a16_matmul_cuda, sparse_w4a16_matmul_torch)
from repro_torch.kernels.w4a16_matmul import (
    w4a16_matmul_cuda, w4a16_matmul_torch)

__all__ = ["w4a16_matmul", "sparse_w4a16_matmul", "dense_matmul",
           "ffn_w4a16", "layernorm", "attention", "decode_attention",
           "mixed_attention", "gather_paged_cache", "kv_write", "slstm_scan",
           "mlstm_cell"]


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl not in ("cuda", "torch", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def w4a16_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """x @ dequant(qt); group-exact W4A16 numerics on every path."""
    impl = _resolve(impl, x)
    if impl == "cuda":
        return w4a16_matmul_cuda(x, qt)
    if impl == "torch":
        return w4a16_matmul_torch(x, qt)
    return _ref.w4a16_matmul_ref(x, qt)


def sparse_w4a16_matmul(x: torch.Tensor, st: SparseQuantizedTensor, *,
                        impl: str = "auto") -> torch.Tensor:
    """x @ sparse_dequant(st); per-kept-block scale-after-dot on every
    path."""
    impl = _resolve(impl, x)
    if impl == "cuda":
        return sparse_w4a16_matmul_cuda(x, st)
    if impl == "torch":
        return sparse_w4a16_matmul_torch(x, st)
    return _ref.sparse_w4a16_matmul_ref(x, st)


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None, *,
                 impl: str = "auto") -> torch.Tensor:
    """x @ w for a 16-bit weight: an f32 sum per output in a fixed order,
    ``bias`` added in f32, one cast to x's dtype."""
    impl = _resolve(impl, x)
    if impl == "cuda":
        return dense_matmul_cuda(x, w, bias)
    if impl == "torch":
        return dense_matmul_torch(x, w, bias)
    return _ref.dense_matmul_ref(x, w, bias)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5, *, impl: str = "auto") -> torch.Tensor:
    """f32 LayerNorm, two passes (mean, then the mean of the squared
    deviations).  The plain version is the reference's formula, so
    ``"ref"`` takes it too."""
    impl = _resolve(impl, x)
    fn = layernorm_cuda if impl == "cuda" else layernorm_torch
    return fn(x, gamma, beta, eps)


def ffn_w4a16(x, gate, up, down, *, activation="swiglu", up_bias=None,
              down_bias=None, impl: str = "auto") -> torch.Tensor:
    """Whole FFN ``down(act(x@gate) * (x@up))`` as one operator.  Weights
    may be dense, ``QuantizedTensor``s or ``SparseQuantizedTensor``s; the
    CUDA path takes all-W4A16, sparse gate/up or all-16-bit weights (kernel
    6; ``ffn_fused.fused_variant``) and raises on other mixes.  The plain
    path keeps the unfused oracle for all-16-bit weights, as the
    reference's twin does."""
    impl = _resolve(impl, x)
    kw = dict(activation=activation, up_bias=up_bias, down_bias=down_bias)
    if impl == "cuda":
        return ffn_w4a16_cuda(x, gate, up, down, **kw)
    if impl == "torch":
        return ffn_w4a16_torch(x, gate, up, down, **kw)
    return _ref.ffn_ref(x, gate, up, down, **kw)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, impl: str = "auto") -> torch.Tensor:
    """Full-sequence flash attention (forward, whole-prompt prefill).  q
    (b, hq, sq, d), k/v (b, hkv, skv, d); the q block ends the context."""
    impl = _resolve(impl, q)
    kw = dict(causal=causal, window=window, scale=scale)
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if impl == "torch":
        return flash_attention_torch(q, k, v, **kw)
    return _ref.attention_ref(q, k, v, **kw)


def slstm_scan(gates_x, r, b, state=None, *, active=None,
               impl: str = "auto") -> torch.Tensor:
    """sLSTM hidden states ``(B, L, h, dh)`` f32 from ``gates_x (B, L, h,
    4dh)``, block-diagonal ``r (h, dh, 4dh)`` and ``b (h, 4dh)``.  Any L;
    ``state = (c, n, h, m)`` (each ``(B, h, dh)`` f32) is the scan's start
    and is updated in place where ``active`` (B,) allows (None: a fresh
    state, nothing written back)."""
    impl = _resolve(impl, gates_x)
    if impl == "cuda":
        return slstm_scan_cuda(gates_x, r, b, state, active)
    if impl == "torch":
        return slstm_scan_torch(gates_x, r, b, state, active)
    if active is not None:
        raise ValueError("the ref oracle takes no active mask")
    return _ref.slstm_scan_ref(gates_x, r, b, state)


def mlstm_cell(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m, *, active=None,
               impl: str = "auto"):
    """One mLSTM decode step: gate projections, the matrix-memory update of
    ``C`` (in place) and its readout; returns ``(y, n', m')``
    (``kernels/mlstm_cell.py``).  The plain version is the reference's
    algebra, so ``"ref"`` takes it too."""
    impl = _resolve(impl, q)
    fn = mlstm_cell_cuda if impl == "cuda" else mlstm_cell_torch
    return fn(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m, active)


def kv_write(cache: dict, new: dict, starts: torch.Tensor,
             q_lens: torch.Tensor, *, page_table: torch.Tensor | None = None,
             impl: str = "auto") -> None:
    """Write one layer's new K/V rows ``new[name]`` (B, hkv, C, w) into
    ``cache[name]`` in place: row ``b``'s positions ``j < q_lens[b]`` at
    ``starts[b] + j``, through ``page_table`` for a paged pool
    (``kernels/kv_write.py``).  Dead positions write nothing.  A write is a
    copy, so the plain version is also the oracle: ``"ref"`` takes it."""
    impl = _resolve(impl, next(iter(new.values())))
    fn = kv_write_cuda if impl == "cuda" else kv_write_torch
    fn(cache, new, starts, q_lens, page_table)


def gather_paged_cache(pool: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """Materialize a paged pool ``(P, g, bs, ...)`` as the contiguous
    per-slot cache ``(b, g, n_pages*bs, ...)`` a dense oracle expects (the
    layout inverse of the engine's block leasing; null-block pages gather
    whatever the null block holds, which true-length masking hides)."""
    g = pool[page_table.long()]                   # (b, n_pages, g, bs, ...)
    b, npg, heads, bs = g.shape[:4]
    g = g.movedim(2, 1)                           # (b, g, n_pages, bs, ...)
    return g.reshape(b, heads, npg * bs, *g.shape[4:])


def _materialize_ref_cache(q, k_cache, v_cache, k_scale, v_scale,
                           page_table):
    """The ref oracle's operand preparation: gather a paged pool
    contiguous, then drop int8 quantization through a full-precision copy."""
    if page_table is not None:
        k_cache = gather_paged_cache(k_cache, page_table)
        v_cache = gather_paged_cache(v_cache, page_table)
        if k_scale is not None:
            k_scale = gather_paged_cache(k_scale, page_table)
            v_scale = gather_paged_cache(v_scale, page_table)
    if k_scale is not None:
        from repro_torch.models.attention import dequantize_kv
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    return k_cache, v_cache


def mixed_attention(q, k_cache, v_cache, lengths, q_lens, *, window=None,
                    scale=None, k_scale=None, v_scale=None, page_table=None,
                    block_kv: int = DEFAULT_BLOCK_KV,
                    impl: str = "auto") -> torch.Tensor:
    """Mixed prefill/decode attention against the slot cache or, with
    ``page_table`` (B, n_pages), the shared paged pools; fp, or int8 K/V
    with ``k_scale``/``v_scale`` (dequant fused after the dot).
    ``block_kv`` caps the slot walk's KV tile (the paged tile is the page),
    so a slot walk can be pinned to the page size."""
    impl = _resolve(impl, q)
    if page_table is not None:
        page_table = torch.as_tensor(page_table, device=q.device)
    kw = dict(window=window, scale=scale)
    if impl == "ref":
        k_full, v_full = _materialize_ref_cache(q, k_cache, v_cache, k_scale,
                                                v_scale, page_table)
        return _ref.mixed_attention_ref(q, k_full, v_full, lengths, q_lens,
                                        **kw)
    kw.update(k_scale=k_scale, v_scale=v_scale, page_table=page_table,
              block_kv=block_kv)
    if impl == "cuda":
        return mixed_flash_attention_cuda(q, k_cache, v_cache, lengths,
                                          q_lens, **kw)
    return mixed_attention_torch(q, k_cache, v_cache, lengths, q_lens, **kw)


def decode_attention(q, k_cache, v_cache, length, *, window=None,
                     scale=None, k_scale=None, v_scale=None, page_table=None,
                     block_kv: int = DEFAULT_BLOCK_KV,
                     impl: str = "auto") -> torch.Tensor:
    """One-token decode attention: ``mixed_attention`` with ``q_lens = 1``
    (the same kernel, as in the reference)."""
    if q.shape[2] != 1:
        raise ValueError(f"decode attention is single-token (sq="
                         f"{q.shape[2]}); use mixed_attention")
    ones = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    return mixed_attention(q, k_cache, v_cache, length, ones, window=window,
                           scale=scale, k_scale=k_scale, v_scale=v_scale,
                           page_table=page_table, block_kv=block_kv,
                           impl=impl)
