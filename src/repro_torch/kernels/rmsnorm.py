"""RMSNorm with a fixed per-row reduction order: CUDA kernel wrapper, plain
version and the device dispatch ``models/layers.rmsnorm`` calls.

The reference leaves rmsnorm to XLA (``repro/models/layers.py:65``).  The
port needs a kernel for it because PyTorch's CUDA mean chooses its
reduction split from the number of rows, which would make a row's norm
depend on the batch and chunk width and break the engine's bitwise oracle
parity; ``csrc/rmsnorm.cu`` reduces every row in one fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "rmsnorm"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])


def rmsnorm_torch(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    return out.to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` on the current stream."""
    check_activation(x, NAME)
    d = x.shape[-1]
    if gamma.shape != (d,) or gamma.dtype != x.dtype or \
            gamma.device != x.device:
        raise ValueError(f"gamma must be ({d},) {x.dtype} on {x.device}")
    x2 = x.reshape(-1, d).contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x2)
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
