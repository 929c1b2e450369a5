"""Public kernel entry points, mirroring ``repro/kernels/ops.py``.

Each op picks its implementation by the tensors' device (``impl="auto"``):

* ``"cuda"``  — the hand-written sm_90a kernel.  Taken for CUDA tensors; it
  launches or raises, there is no fallback.
* ``"torch"`` — the plain PyTorch version with the same numerics contract
  (the role ``impl="xla"`` plays in the reference).  Taken for CPU tensors,
  and on the card only when asked for, to compare a kernel with it.
* ``"ref"``   — the dense oracle of ``kernels/ref.py``.

``add_rmsnorm``, ``add_layernorm`` and ``qkv_rope_write`` fuse the PyTorch
glue of a step into a kernel; their plain versions are the former chains,
whose inner ops dispatch by device as before.  ``moe_router_route``,
``moe_ffn_w4a16`` and ``combine_add_rmsnorm`` are an MoE layer's router
product with its routing, its experts (two grouped kernels), and the
weighted sum of their outputs fused into the next norm; ``moe_route`` and
``moe_combine`` are the routing on given logits and the sum alone.
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
from repro_torch.kernels.kv_write import (
    dequantize_kv, kv_write_cuda, kv_write_torch, qkv_rope_write_cuda,
    qkv_rope_write_torch)
from repro_torch.kernels.layernorm import (
    add_layernorm_cuda, add_layernorm_torch, layernorm_cuda, layernorm_torch)
from repro_torch.kernels.mlstm_cell import mlstm_cell_cuda, mlstm_cell_torch
from repro_torch.kernels.moe_experts import moe_ffn_cuda, moe_ffn_torch
from repro_torch.kernels.moe_route import (
    moe_combine_cuda, moe_combine_torch, moe_route_cuda, moe_route_torch,
    moe_router_route_cuda)
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm_cuda, add_rmsnorm_torch, combine_add_rmsnorm_cuda,
    combine_add_rmsnorm_torch)
from repro_torch.kernels.slstm_scan import slstm_scan_cuda, slstm_scan_torch
from repro_torch.kernels.sparse_w4a16 import (
    sparse_w4a16_matmul_cuda, sparse_w4a16_matmul_torch)
from repro_torch.kernels.w4a16_matmul import (
    w4a16_matmul_cuda, w4a16_matmul_torch)

__all__ = ["w4a16_matmul", "sparse_w4a16_matmul", "dense_matmul",
           "ffn_w4a16", "layernorm", "attention", "decode_attention",
           "mixed_attention", "gather_paged_cache", "kv_write", "slstm_scan",
           "mlstm_cell", "add_rmsnorm", "add_layernorm", "qkv_rope_write",
           "moe_route", "moe_router_route", "moe_ffn_w4a16", "moe_combine",
           "combine_add_rmsnorm"]


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


def add_rmsnorm(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6, *, keep_sum: bool = True,
                impl: str = "auto"):
    """The residual add and the RMSNorm after it: ``(s, n)`` with ``s = x +
    h`` rounded to x's dtype (None unless ``keep_sum``) and ``n =
    rmsnorm(s)`` bitwise.  One launch on the card."""
    impl = _resolve(impl, x)
    fn = add_rmsnorm_cuda if impl == "cuda" else add_rmsnorm_torch
    return fn(x, h, gamma, eps, keep_sum)


def add_layernorm(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float = 1e-5, *,
                  keep_sum: bool = True, impl: str = "auto"):
    """The residual add and the LayerNorm after it: ``(s, n)`` with ``s = x
    + h`` rounded to x's dtype (None unless ``keep_sum``) and ``n =
    layernorm(s)`` bitwise.  One launch on the card."""
    impl = _resolve(impl, x)
    fn = add_layernorm_cuda if impl == "cuda" else add_layernorm_torch
    return fn(x, h, gamma, beta, eps, keep_sum)


def qkv_rope_write(cache: dict, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: tuple = (None, None, None), *,
                   n_heads: int, theta: float | None,
                   rope_base: torch.Tensor, starts: torch.Tensor,
                   q_lens: torch.Tensor,
                   page_table: torch.Tensor | None = None,
                   impl: str = "auto") -> torch.Tensor:
    """A serving step's q/k/v epilogue for one layer: the raw projections
    ``q`` (B, C, hq*hd), ``k``/``v`` (B, C, hkv*hd) get their ``bias``, q
    and k RoPE at positions ``rope_base[b] + j`` (``theta`` None: none),
    K/V are quantized for an int8 cache and row ``b``'s positions ``j <
    q_lens[b]`` written at ``starts[b] + j`` (through ``page_table`` for a
    paged pool), in place.  Returns q as (B, hq, C, hd).  Live positions
    must lie in the cache's logical span, the kernel's RoPE table
    (``kv_write.rope_rows``).  One launch on the card; the plain version is
    the former chain, whose write is ``kv_write``."""
    impl = _resolve(impl, q)
    kw = dict(n_heads=n_heads, theta=theta, rope_base=rope_base,
              starts=starts, q_lens=q_lens, page_table=page_table)
    if impl == "cuda":
        return qkv_rope_write_cuda(cache, q, k, v, bias, **kw)
    return qkv_rope_write_torch(cache, q, k, v, bias, write=kv_write, **kw)


def moe_route(logits: torch.Tensor, *, group: int, top_k: int,
              capacity: int, q_lens=None, impl: str = "auto"):
    """An MoE layer's routing of ``T = B * group`` tokens from the router's
    logits ``(T, E)`` (in x's dtype): the renormalised top-k, each kept
    assignment's row in the expert-major compact layout and each expert's
    rows (``kernels/moe_route.Route``).  ``q_lens`` (B,) int32: positions
    ``s >= q_lens[b]`` of a group take no row.  One launch on the card.
    The plain version is the reference's formula, so ``"ref"`` takes it
    too."""
    impl = _resolve(impl, logits)
    fn = moe_route_cuda if impl == "cuda" else moe_route_torch
    return fn(logits, group, top_k, capacity, q_lens)


def moe_router_route(x: torch.Tensor, router: torch.Tensor, *, group: int,
                     top_k: int, capacity: int, q_lens=None,
                     impl: str = "auto"):
    """The router's product ``x @ router`` (x (T, d), router (d, E) in x's
    dtype; logits in x's dtype, bitwise ``dense_matmul``'s) and
    ``moe_route`` on it: ``(logits, Route)``.  One launch on the card; the
    plain path is ``dense_matmul`` then ``moe_route``, each of that
    ``impl``."""
    impl = _resolve(impl, x)
    if impl == "cuda":
        return moe_router_route_cuda(x, router, group, top_k, capacity,
                                     q_lens)
    logits = dense_matmul(x, router, impl=impl)
    return logits, moe_route(logits, group=group, top_k=top_k,
                             capacity=capacity, q_lens=q_lens, impl=impl)


def moe_ffn_w4a16(x: torch.Tensor, route, gate, up, down, *,
                  activation: str = "swiglu",
                  impl: str = "auto") -> torch.Tensor:
    """Every expert's FFN on the token rows ``x`` (T, d) its route keeps:
    ``(T * k, d)``, row ``slot`` the output of that assignment.  The CUDA
    path is two grouped kernels and takes W4A16 experts at 32-, 64- or
    128-row groups (raises on others); the plain path takes any weight mix
    through the reference's numerics (``ffn_w4a16_torch`` per expert), and
    ``"ref"`` the dense oracle per expert."""
    impl = _resolve(impl, x)
    kw = dict(activation=activation)
    if impl == "cuda":
        return moe_ffn_cuda(x, route, gate, up, down, **kw)
    if impl == "torch":
        return moe_ffn_torch(x, route, gate, up, down, **kw)
    y = torch.zeros((route.rows.numel(), x.shape[1]), dtype=x.dtype,
                    device=x.device)
    for e, (n, o) in enumerate(zip(route.counts.tolist(),
                                   route.offsets.tolist())):
        if n:
            y[o:o + n] = _ref.ffn_ref(x[route.rows[o:o + n].long()],
                                      gate[e], up[e], down[e], **kw)
    return y


def moe_combine(y: torch.Tensor, slot: torch.Tensor, topw: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """Each token's ``sum_j y[slot[t, j]] * topw[t, j]`` in y's dtype, the
    weight and each product rounded to it, the sum from zero in j order;
    ``slot < 0`` adds nothing.  One launch on the card.  The plain version
    is the reference's formula, so ``"ref"`` takes it too."""
    impl = _resolve(impl, y)
    fn = moe_combine_cuda if impl == "cuda" else moe_combine_torch
    return fn(y, slot, topw)


def combine_add_rmsnorm(x: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
                        topw: torch.Tensor, gamma: torch.Tensor,
                        eps: float = 1e-6, *, keep_sum: bool = True,
                        impl: str = "auto"):
    """An MoE layer's output added to the residual and the RMSNorm after
    it: ``(s, n)`` with ``s = x + moe_combine(y, slot, topw)`` (slot and
    topw (..., k) of x's leading shape; s None unless ``keep_sum``) and ``n
    = rmsnorm(s)``, bitwise ``moe_combine`` then ``add_rmsnorm``.  One
    launch on the card, which never writes the combined output."""
    impl = _resolve(impl, x)
    fn = (combine_add_rmsnorm_cuda if impl == "cuda"
          else combine_add_rmsnorm_torch)
    return fn(x, y, slot, topw, gamma, eps, keep_sum)


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
                     block_kv: int = DEFAULT_BLOCK_KV, ones=None,
                     impl: str = "auto") -> torch.Tensor:
    """One-token decode attention: ``mixed_attention`` with ``q_lens = 1``
    (the same kernel, as in the reference); ``ones`` is that (B,) int32
    tensor when the caller already has it."""
    if q.shape[2] != 1:
        raise ValueError(f"decode attention is single-token (sq="
                         f"{q.shape[2]}); use mixed_attention")
    if ones is None:
        ones = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    return mixed_attention(q, k_cache, v_cache, length, ones, window=window,
                           scale=scale, k_scale=k_scale, v_scale=v_scale,
                           page_table=page_table, block_kv=block_kv,
                           impl=impl)
