"""RMSNorm, backward: CUDA kernel wrapper and its plain version.

The reference differentiates ``layers.rmsnorm`` (``repro/models/layers.py:
65``) in XLA; the port's training forward is the rmsnorm kernel, so its
gradient is the hand-written ``csrc/rmsnorm_bwd.cu`` (its note says how
the work is split and what bounds it).  With ``r = rsqrt(mean(x^2) +
eps)``, ``x^ = x * r`` and ``g = gamma * dy`` in f32:

    dx     = r * (g - x^ * mean(x^ * g))      in x's dtype
    dgamma = sum over rows of dy * x^         f32

The kernel takes a row of ``d = TPR * V * CPT`` values (``V`` of them in 16
bytes, ``TPR`` a power of two up to 256, ``CPT`` 1, 2 or 4): ``widths``
lists them.  Its dgamma sums each block of ``rows_per_block`` rows, then
the blocks in order (``plan``); the plain version sums the rows in one
``torch.sum``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, check_activation, check_aligned)

NAME = "rmsnorm_bwd"
THREADS = 256                 # a block (csrc/rmsnorm_bwd.cu)
TARGET_BLOCKS = 264           # two blocks an SM of the H100's 132
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])


def widths(dtype: torch.dtype) -> tuple[int, ...]:
    """The row widths the kernel is instantiated at for ``dtype``."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return tuple(v * (1 << i) for i in range(9)) + (v * 512, v * 1024)


def check_supported(x: torch.Tensor) -> None:
    """Raise unless the kernel takes x's dtype and width (on any device,
    so a training forward refuses before it runs)."""
    d = x.shape[-1]
    if x.dtype not in DTYPE_CODES or d not in widths(x.dtype):
        raise ValueError(f"{NAME}: width {d} in {x.dtype}; the kernel takes "
                         "float32 or bfloat16 rows of "
                         f"{widths(torch.bfloat16)} / {widths(torch.float32)}")


def plan(rows: int, d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(rows_per_block, blocks): about ``TARGET_BLOCKS`` blocks, each a
    whole number of the ``THREADS / TPR`` rows a block has in flight."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    group = THREADS // min(THREADS, d // v)
    per = -(-max(rows, 1) // TARGET_BLOCKS)
    per = -(-per // group) * group
    return per, -(-rows // per)


def rmsnorm_bwd_torch(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-6):
    """Plain version: ``(dx, dgamma)``, dgamma f32."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    g = gamma.to(torch.float32) * dy.to(torch.float32)
    c = torch.mean(xh * g, dim=-1, keepdim=True)
    dx = (r * (g - xh * c)).to(x.dtype)
    dgamma = (dy.to(torch.float32) * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx, dgamma


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """Launch ``csrc/rmsnorm_bwd.cu`` on the current stream (the rows, then
    the blocks' dgamma partials): ``(dx, dgamma)``, dgamma f32.  A width
    the kernel does not take raises here (before the device)."""
    d = x.shape[-1]
    check_supported(x)
    check_activation(x, NAME)
    if (gamma.shape != (d,) or gamma.dtype != x.dtype
            or gamma.device != x.device or dy.shape != x.shape
            or dy.dtype != x.dtype or dy.device != x.device):
        raise ValueError(f"{NAME}: gamma ({d},) and dy {tuple(x.shape)} in "
                         f"{x.dtype} on {x.device}")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    gamma = gamma.contiguous()
    dx = torch.empty_like(x2)
    rows = x2.shape[0]
    dgamma = torch.zeros((d,), dtype=torch.float32, device=x.device)
    check_aligned(NAME, x2, dy2, gamma, dx)
    if rows:
        per, blocks = plan(rows, d, x.dtype)
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=x.device)
        fn = _build.function(NAME, "rmsnorm_bwd_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), gamma.data_ptr(), dy2.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), dgamma.data_ptr(), rows, d,
                per, eps, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return dx.reshape(x.shape), dgamma
