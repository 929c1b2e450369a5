"""16-bit-weight matmul with a fixed reduction order: CUDA kernel wrapper and
its plain version.

The reference leaves ``x @ w`` for a plain weight to XLA
(``repro/models/layers.py:43-61``: a dot in x's dtype with f32 accumulation,
one cast).  On the card the port runs it through ``csrc/dense_matmul.cu``
(bfloat16 on the tensor-core tile ``csrc/dense_mma_tile.cuh``, float32 on
the CUDA-core tile ``csrc/dense_tile.cuh``) rather than cuBLAS, which may
pick its split of the contraction from the row count and so make a row's
result depend on the batch: the engine's bitwise oracle parity needs every row to
be reduced in one fixed order.  The optional ``bias`` is the f32 epilogue
kernel 6's down stage uses (added to the f32 sum before the cast);
``models/layers.linear`` adds its bias after the cast, as the reference
does.  A weight that is the transposed view of a contiguous ``(out, in)``
bf16 matrix (the tied LM head, ``embed.T``) is read in place at any
``out`` (granite-moe-3b-a800m's 49155), with the same sums: no copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, bias_f32, check_activation)

NAME = "dense_matmul"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def dense_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version, f32 result: the weight in x's dtype (as the reference
    casts it), the product summed in f32."""
    return x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)


def dense_matmul_torch(x: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 product, the f32 bias, one
    cast to x's dtype."""
    y = dense_matmul_f32(x, w)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def dense_weight(w: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    """``w`` as the kernel takes it: 2-D, in x's dtype (the reference casts
    a weight to x's dtype before the dot; the copy is made only where the
    types differ), contiguous (a transposed view, such as a tied
    embedding's, is copied), on x's device, out % 4 == 0."""
    if w.dim() != 2:
        raise ValueError(f"{what}: weight must be 2-D, got {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: weight on {w.device}, x on {x.device}")
    if w.shape[1] % 4:
        raise ValueError(f"{what}: out_features {w.shape[1]} must be a "
                         "multiple of 4")
    w = w.to(x.dtype).contiguous()
    if w.data_ptr() % (4 * w.element_size()):
        raise ValueError(f"{what}: weight must be aligned to 4 elements")
    return w


def transposed_view(w: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether ``w`` (in, out) is the transpose of a contiguous (out, in)
    matrix of x's dtype the bf16 kernel reads in place."""
    return (w.dim() == 2 and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16 and w.device == x.device
            and w.shape[0] > 1 and w.stride() == (1, w.shape[0])
            and w.data_ptr() % 16 == 0)


def dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/dense_matmul.cu`` on the current stream; a transposed
    view (``transposed_view``) without a bias is read in place."""
    check_activation(x, NAME)
    trans = bias is None and transposed_view(w, x)
    if not trans:
        w = dense_weight(w, x, NAME)
    in_f, out_f = w.shape
    if x.shape[-1] != in_f:
        raise ValueError(f"contraction mismatch {x.shape[-1]} vs {in_f}")
    b = bias_f32(bias, out_f, x.device, NAME)
    x2 = x.reshape(-1, in_f).contiguous()
    n = x2.shape[0]
    out = torch.empty((n, out_f), dtype=x.dtype, device=x.device)
    if n:
        fn = _build.function(NAME, "dense_matmul_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(), n, in_f,
                out_f, DTYPE_CODES[x.dtype], int(trans),
                _build.stream_ptr(x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return out.reshape(*x.shape[:-1], out_f)
