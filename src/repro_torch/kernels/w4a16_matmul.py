"""W4A16 block-quantized matmul: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/w4a16_matmul.py::w4a16_matmul_pallas``; the kernel
is ``csrc/w4a16_matmul.cu`` (its note says what bounds it on the card).
``x (..., in) @ dequant(qt) -> (..., out)`` in x's dtype, with each
128-row group's f32 partial sum multiplied by the group's scale; an optional
f32 bias is added to the f32 sum before the cast (the down projection of the
ungated gelu FFN, as the reference's fused kernel adds its down bias).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import GROUP_SIZE, QuantizedTensor, unpack_int4
from repro_torch.kernels import _build

NAME = "w4a16_matmul"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def w4a16_matmul_f32(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version, f32 result: the groups in order, each group's exact
    f32 dot scaled after the dot (the TPU kernel's grid walk)."""
    in_f, out_f = qt.shape
    gs = qt.group_size
    xg = x.reshape(-1, in_f // gs, gs).to(torch.float32)
    q = unpack_int4(qt.packed, gs).to(torch.float32).reshape(
        in_f // gs, gs, out_f)
    scales = qt.scales.to(torch.float32)
    acc = torch.zeros(xg.shape[0], out_f, dtype=torch.float32,
                      device=x.device)
    for g in range(in_f // gs):
        acc = acc + (xg[:, g] @ q[g]) * scales[g]
    return acc.reshape(*x.shape[:-1], out_f)


def w4a16_matmul_torch(x: torch.Tensor, qt: QuantizedTensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (CPU path and card reference)."""
    y = w4a16_matmul_f32(x, qt)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def check_quantized(qt: QuantizedTensor, device: torch.device,
                    what: str) -> None:
    in_f, out_f = qt.shape
    if qt.group_size != GROUP_SIZE:
        raise ValueError(f"{what}: the kernel needs {GROUP_SIZE}-row groups")
    if in_f % GROUP_SIZE or out_f % 4:
        raise ValueError(f"{what}: shape {qt.shape} needs in % 128 == 0 and "
                         "out % 4 == 0")
    if qt.packed.shape != (in_f // 2, out_f) or qt.packed.dtype != torch.uint8:
        raise ValueError(f"{what}: packed must be uint8 {(in_f // 2, out_f)}")
    if (qt.scales.shape != (in_f // GROUP_SIZE, out_f)
            or qt.scales.dtype != torch.bfloat16):
        raise ValueError(f"{what}: scales must be bf16 "
                         f"{(in_f // GROUP_SIZE, out_f)}")
    for t in (qt.packed, qt.scales):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: weights must be contiguous on {device}")


def check_activation(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: activations must be float32 or bfloat16, "
                        f"got {x.dtype}")


def bias_f32(bias: torch.Tensor | None, n: int, device,
             what: str) -> torch.Tensor | None:
    """A bias as the kernels' epilogues read it: contiguous f32 ``(n,)``."""
    if bias is None:
        return None
    if bias.shape != (n,) or bias.device != device:
        raise ValueError(f"{what}: bias must be ({n},) on {device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    return bias.to(torch.float32).contiguous()


def aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` (contiguous), or a copy of it if its data does not start on an
    ``nbytes`` boundary."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def w4a16_matmul_cuda(x: torch.Tensor, qt: QuantizedTensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/w4a16_matmul.cu`` on the current stream."""
    check_activation(x, NAME)
    check_quantized(qt, x.device, NAME)
    in_f, out_f = qt.shape
    if x.shape[-1] != in_f:
        raise ValueError(f"contraction mismatch {x.shape[-1]} vs {in_f}")
    b = bias_f32(bias, out_f, x.device, NAME)
    # the bf16 tile's cp.async copies: x in 16-byte chunks, the weights in
    # 4- (packed) and 8-byte (scales) pieces at least
    x2 = aligned(x.reshape(-1, in_f).contiguous(), 16)
    packed, scales = aligned(qt.packed, 4), aligned(qt.scales, 8)
    n = x2.shape[0]
    out = torch.empty((n, out_f), dtype=x.dtype, device=x.device)
    if n:
        fn = _build.function(NAME, "w4a16_matmul_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(), n, in_f,
                out_f, DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return out.reshape(*x.shape[:-1], out_f)
