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
lists them.  Its dgamma sums each block of ``rows_per_block`` rows (one
wave of blocks, ``plan``, from the card's SM count: the launch is
cooperative), then, once the grid has waited for itself, the blocks'
partial rows in a fixed order, 32 columns a block; the plain version sums
the rows in one ``torch.sum``.  The first design (one row in flight a
block, the partial rows added by a second, narrow launch) stays as
``csrc/rmsnorm_bwd_serial.cu`` (``rmsnorm_bwd_serial_cuda``, two blocks
an SM), off the training path: the yardstick the kernel is timed
against.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, check_activation, check_aligned)

NAME = "rmsnorm_bwd"
SERIAL_NAME = "rmsnorm_bwd_serial"
THREADS = 256                 # a block (csrc/rmsnorm_bwd.cu)
SMS = 132                     # the H100's (the plan's default)
SERIAL_TARGET_BLOCKS = 2 * SMS     # the yardstick's: two blocks an SM
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


def target_blocks(d: int, dtype: torch.dtype, sms: int = SMS) -> int:
    """The blocks that fit a card of ``sms`` SMs at once: two an SM, one
    where a thread holds 4 chunks of its row (d 8192 in bf16, 4096 in f32:
    its registers fill an SM).  The kernel's launch is cooperative, so its
    grid must fit."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return sms if d // v > 2 * THREADS else 2 * sms


def plan(rows: int, d: int, dtype: torch.dtype, target: int | None = None,
         sms: int = SMS) -> tuple[int, int]:
    """(rows_per_block, blocks): at most ``target`` blocks (by default
    ``target_blocks``, one wave), each a whole number of the ``THREADS /
    TPR`` rows a block has in flight a step."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    group = THREADS // min(THREADS, d // v)
    target = target or target_blocks(d, dtype, sms)
    per = -(-max(rows, 1) // target)
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


def _launch(name, symbol, target, x, gamma, dy, eps):
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
    # the kernel writes every column; no rows, no launch: zeros
    dgamma = (torch.empty if rows else torch.zeros)(
        (d,), dtype=torch.float32, device=x.device)
    check_aligned(NAME, x2, dy2, gamma, dx)
    if rows:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per, blocks = plan(rows, d, x.dtype, target, sms)
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=x.device)
        fn = _build.function(name, symbol, _ARGTYPES)
        rc = fn(x2.data_ptr(), gamma.data_ptr(), dy2.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), dgamma.data_ptr(), rows, d,
                per, eps, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check(name, rc)
        _build.launches[name] += 1
    return dx.reshape(x.shape), dgamma


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """Launch ``csrc/rmsnorm_bwd.cu`` on the current stream (one
    cooperative launch: the rows, then the blocks' dgamma partials):
    ``(dx, dgamma)``, dgamma f32.  A width the kernel does not take raises
    here (before the device)."""
    return _launch(NAME, "rmsnorm_bwd_launch", None, x, gamma, dy, eps)


def rmsnorm_bwd_serial_cuda(x: torch.Tensor, gamma: torch.Tensor,
                            dy: torch.Tensor, eps: float = 1e-6):
    """Launch the yardstick ``csrc/rmsnorm_bwd_serial.cu``, the same
    contract; on no training path."""
    return _launch(SERIAL_NAME, "rmsnorm_bwd_serial_launch",
                   SERIAL_TARGET_BLOCKS, x, gamma, dy, eps)
