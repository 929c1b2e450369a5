"""LayerNorm with a fixed per-row reduction order, alone and with the
residual add fused in front: CUDA kernel wrappers and plain versions
(``ops.layernorm`` and ``ops.add_layernorm`` dispatch between them).

The reference leaves layernorm and the residual adds to XLA
(``repro/models/layers.py:72-80``, ``repro/models/transformer.py:62-71``).
The port needs a kernel for the norm for the reason it has
``csrc/rmsnorm.cu``: PyTorch's CUDA mean chooses its reduction split from
the number of rows, which would make a row's norm depend on the batch and
chunk width and break the engine's bitwise oracle parity;
``csrc/layernorm.cu`` reduces every row in one fixed order, in two passes
as the reference does.  ``add_layernorm`` adds the residual in the same
launch (``s = x + h`` rounded to x's dtype, as PyTorch's add rounds it), so
its ``n`` is bitwise ``layernorm(x + h)``.  The kernel stages a row, gamma
and beta in shared memory with 16-byte copies: the wrappers refuse a row
above ``MAX_ROW_BYTES`` or off a multiple of 16 bytes, and operands off a
16-byte boundary, before any launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, check_activation, check_aligned)

NAME = "layernorm"
ADD_NAME = "add_layernorm"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_ADD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])
MAX_ROW_BYTES = 64 * 1024   # a row; with gamma and beta 192 KB staged


def layernorm_torch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain version, the reference's formula in f32: the mean, then the
    mean of the squared deviations."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.to(torch.float32) + beta.to(torch.float32)
    return out.to(x.dtype)


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           what: str) -> None:
    check_activation(x, what)
    d = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (d,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} must be ({d},) {x.dtype} on "
                             f"{x.device}")
    row = d * x.element_size()
    if row > MAX_ROW_BYTES or row % 16:
        raise ValueError(f"{what}: a row of {row} bytes; the kernel takes a "
                         f"multiple of 16 bytes up to {MAX_ROW_BYTES}")


def prepare() -> None:
    """The kernel's one-time host call (its shared-memory opt-in), made by
    ``_build.prepare`` before any CUDA graph capture."""
    _build.check(NAME, _build.function(NAME, "layernorm_prepare", [])())


def layernorm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/layernorm.cu`` on the current stream."""
    _check(x, gamma, beta, NAME)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x2)
    check_aligned(NAME, x2, gamma, beta)
    if x2.shape[0]:
        fn = _build.function(NAME, "layernorm_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), x2.shape[0], d, eps, DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return out.reshape(x.shape)


def add_layernorm_torch(x: torch.Tensor, h: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = 1e-5, keep_sum: bool = True):
    """Plain version: the former chain, ``s = x + h`` then
    ``ops.layernorm(s)`` (on a CUDA tensor the fixed-order kernel, so that
    the fused kernel is held bitwise against what the served path computed
    before it).  Returns ``(s or None, n)``."""
    s = x + h
    fn = layernorm_cuda if s.is_cuda else layernorm_torch
    return (s if keep_sum else None), fn(s, gamma, beta, eps)


def add_layernorm_cuda(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-5,
                       keep_sum: bool = True):
    """Launch the fused add + norm of ``csrc/layernorm.cu``: ``(s, n)`` with
    ``s = x + h`` written only when ``keep_sum`` (else None)."""
    _check(x, gamma, beta, ADD_NAME)
    if h.shape != x.shape or h.dtype != x.dtype or h.device != x.device:
        raise ValueError(f"{ADD_NAME}: h {tuple(h.shape)} {h.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    h2 = h.reshape(-1, d).contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x2)
    s = torch.empty_like(x2) if keep_sum else None
    check_aligned(ADD_NAME, x2, h2, gamma, beta)
    if x2.shape[0]:
        fn = _build.function(NAME, "add_layernorm_launch", _ADD_ARGTYPES)
        rc = fn(x2.data_ptr(), h2.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), s.data_ptr() if keep_sum else None,
                out.data_ptr(), x2.shape[0], d, eps, DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[ADD_NAME] += 1
    return (s.reshape(x.shape) if keep_sum else None), out.reshape(x.shape)
