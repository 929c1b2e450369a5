"""LayerNorm with a fixed per-row reduction order: CUDA kernel wrapper and
its plain version (``ops.layernorm`` dispatches between them).

The reference leaves layernorm to XLA (``repro/models/layers.py:72-80``).
The port needs a kernel for it for the reason it has ``csrc/rmsnorm.cu``:
PyTorch's CUDA mean chooses its reduction split from the number of rows,
which would make a row's norm depend on the batch and chunk width and break
the engine's bitwise oracle parity; ``csrc/layernorm.cu`` reduces every row
in one fixed order, in two passes as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "layernorm"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])


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


def layernorm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/layernorm.cu`` on the current stream."""
    check_activation(x, NAME)
    d = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (d,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must be ({d},) {x.dtype} on {x.device}")
    x2 = x.reshape(-1, d).contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        fn = _build.function(NAME, "layernorm_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), x2.shape[0], d, eps, DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return out.reshape(x.shape)
