"""RMSNorm with a fixed per-row reduction order, alone and with the residual
add fused in front: CUDA kernel wrappers, plain versions and the device
dispatch ``models/layers.rmsnorm`` calls.

The reference leaves rmsnorm and the residual adds to XLA
(``repro/models/layers.py:65``, ``repro/models/transformer.py:66``).  The
port needs a kernel for the norm because PyTorch's CUDA mean chooses its
reduction split from the number of rows, which would make a row's norm
depend on the batch and chunk width and break the engine's bitwise oracle
parity; ``csrc/rmsnorm.cu`` reduces every row in one fixed order.
``add_rmsnorm`` adds the residual in the same launch (``s = x + h``
rounded to x's dtype, as PyTorch's add rounds it), so its ``n`` is bitwise
``rmsnorm(x + h)``.  ``combine_add_rmsnorm`` adds an MoE layer's output
without its own launch: the k expert rows of each token's route, summed
with ``moe_combine``'s roundings as they fill the staged row, so its
``(s, n)`` are bitwise ``moe_combine`` followed by ``add_rmsnorm``.  The
kernel stages a row and gamma in shared memory with 16-byte copies: the
wrappers refuse a width above ``STAGE_BYTES`` or off a multiple of 16
bytes, and operands off a 16-byte boundary.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_route import MAX_TOP_K, moe_combine_torch
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, check_activation, check_aligned)

NAME = "rmsnorm"
ADD_NAME = "add_rmsnorm"
COMBINE_NAME = "combine_add_rmsnorm"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_ADD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])
_COMBINE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                     + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])
STAGE_BYTES = 47 * 1024     # a row and gamma in shared memory (rmsnorm.cu)


def rmsnorm_torch(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    return out.to(x.dtype)


def _check_gamma(x: torch.Tensor, gamma: torch.Tensor, what: str) -> None:
    check_activation(x, what)
    d = x.shape[-1]
    if gamma.shape != (d,) or gamma.dtype != x.dtype or \
            gamma.device != x.device:
        raise ValueError(f"{what}: gamma must be ({d},) {x.dtype} on "
                         f"{x.device}")
    row = d * x.element_size()
    if 2 * row > STAGE_BYTES or row % 16:
        raise ValueError(f"{what}: a row of {row} bytes; the kernel takes a "
                         f"multiple of 16 bytes up to {STAGE_BYTES // 2}")


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` on the current stream."""
    _check_gamma(x, gamma, NAME)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x2)
    check_aligned(NAME, x2, gamma)
    if x2.shape[0]:
        fn = _build.function(NAME, "rmsnorm_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), gamma.data_ptr(), out.data_ptr(), x2.shape[0],
                d, eps, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return out.reshape(x.shape)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6, *,
            impl: str = "auto") -> torch.Tensor:
    """``impl="auto"``: the kernel for a CUDA tensor, the plain version for
    a CPU one; ``"torch"`` forces the plain version (card comparisons)."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "cuda":
        return rmsnorm_cuda(x, gamma, eps)
    if impl == "torch":
        return rmsnorm_torch(x, gamma, eps)
    raise ValueError(f"unknown impl {impl!r}")


def add_rmsnorm_torch(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                      eps: float = 1e-6, keep_sum: bool = True):
    """Plain version: the former chain, ``s = x + h`` then ``rmsnorm(s)``
    (on a CUDA tensor the fixed-order kernel, so that the fused kernel is
    held bitwise against what the served path computed before it).
    Returns ``(s or None, n)``."""
    s = x + h
    return (s if keep_sum else None), rmsnorm(s, gamma, eps)


def add_rmsnorm_cuda(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                     eps: float = 1e-6, keep_sum: bool = True):
    """Launch the fused add + norm of ``csrc/rmsnorm.cu``: ``(s, n)`` with
    ``s = x + h`` written only when ``keep_sum`` (else None)."""
    _check_gamma(x, gamma, ADD_NAME)
    if h.shape != x.shape or h.dtype != x.dtype or h.device != x.device:
        raise ValueError(f"{ADD_NAME}: h {tuple(h.shape)} {h.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    h2 = h.reshape(-1, d).contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x2)
    s = torch.empty_like(x2) if keep_sum else None
    check_aligned(ADD_NAME, x2, h2, gamma)
    if x2.shape[0]:
        fn = _build.function(NAME, "add_rmsnorm_launch", _ADD_ARGTYPES)
        rc = fn(x2.data_ptr(), h2.data_ptr(), gamma.data_ptr(),
                s.data_ptr() if keep_sum else None, out.data_ptr(),
                x2.shape[0], d, eps, DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[ADD_NAME] += 1
    return (s.reshape(x.shape) if keep_sum else None), out.reshape(x.shape)


def combine_add_rmsnorm_torch(x: torch.Tensor, y: torch.Tensor,
                              slot: torch.Tensor, topw: torch.Tensor,
                              gamma: torch.Tensor, eps: float = 1e-6,
                              keep_sum: bool = True):
    """Plain version: ``moe_combine_torch`` then ``add_rmsnorm_torch``.
    x (..., d), slot and topw (..., k) of the same leading shape, y
    (rows, d).  Returns ``(s or None, n)``."""
    k = slot.shape[-1]
    m = moe_combine_torch(y, slot.reshape(-1, k), topw.reshape(-1, k))
    return add_rmsnorm_torch(x, m.reshape(x.shape), gamma, eps, keep_sum)


def combine_add_rmsnorm_cuda(x: torch.Tensor, y: torch.Tensor,
                             slot: torch.Tensor, topw: torch.Tensor,
                             gamma: torch.Tensor, eps: float = 1e-6,
                             keep_sum: bool = True):
    """Launch ``csrc/rmsnorm.cu``'s combine variant: ``(s, n)`` with ``s =
    x + moe_combine(y, slot, topw)`` written only when ``keep_sum`` (else
    None); the combined output is never written."""
    _check_gamma(x, gamma, COMBINE_NAME)
    d, k = x.shape[-1], slot.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    n = x2.shape[0]
    if (y.dim() != 2 or y.shape[1] != d or y.dtype != x.dtype
            or y.device != x.device or slot.dtype != torch.int32
            or topw.dtype != torch.float32 or slot.numel() != n * k
            or topw.shape != slot.shape or not 1 <= k <= MAX_TOP_K):
        raise ValueError(f"{COMBINE_NAME}: y (rows, {d}) {x.dtype}, slot "
                         f"int32 and topw f32 ({n}, k <= {MAX_TOP_K}); got y "
                         f"{tuple(y.shape)} {y.dtype}, slot "
                         f"{tuple(slot.shape)} {slot.dtype}, topw "
                         f"{tuple(topw.shape)} {topw.dtype}")
    y = y.contiguous()
    slot2 = slot.reshape(n, k).contiguous()
    topw2 = topw.reshape(n, k).contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x2)
    s = torch.empty_like(x2) if keep_sum else None
    check_aligned(COMBINE_NAME, x2, y, gamma)
    if n:
        fn = _build.function(NAME, "combine_add_rmsnorm_launch",
                             _COMBINE_ARGTYPES)
        rc = fn(x2.data_ptr(), y.data_ptr(), slot2.data_ptr(),
                topw2.data_ptr(), gamma.data_ptr(),
                s.data_ptr() if keep_sum else None, out.data_ptr(), n, d, k,
                eps, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[COMBINE_NAME] += 1
    return (s.reshape(x.shape) if keep_sum else None), out.reshape(x.shape)
