"""Log-scale block-sparse W4A16 matmul: CUDA kernel wrapper and its plain
version.

Port of ``repro/kernels/sparse_w4a16.py::sparse_w4a16_matmul_pallas``; the
kernel is ``csrc/sparse_w4a16.cu`` (its note says what bounds it on the
card).  ``x (..., in) @ sparse_dequant(st) -> (..., out)`` in x's dtype:
each 128-wide output tile contracts only its kept 128-row blocks, gathered
from x by ``st.block_idx``, and each block's f32 partial sum is multiplied
by the block's scale; an optional f32 bias is added to the f32 sum before
the cast (a sparse down projection of the ungated gelu FFN, as the
reference's fused kernel adds its down bias).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import GROUP_SIZE, unpack_int4
from repro_torch.core.sparsity import SparseQuantizedTensor
from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, aligned, bias_f32, check_activation)

NAME = "sparse_w4a16_matmul"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def sparse_matmul_f32(x: torch.Tensor,
                      st: SparseQuantizedTensor) -> torch.Tensor:
    """Plain version, f32 result (twin of the reference's
    ``ffn_fused.sparse_matmul_f32``): gather each output tile's kept x
    blocks by ``block_idx``, exact f32 dot per kept block, the block's
    scale after the dot, kept blocks added in order."""
    in_f, out_f = st.shape
    g = st.group_size
    tiles, kept = st.block_idx.shape
    xb = x.reshape(-1, in_f // g, g).to(torch.float32)
    w = unpack_int4(st.packed.reshape(-1, g // 2, g), g).to(
        torch.float32).reshape(tiles, kept, g, g)
    xg = xb[:, st.block_idx.long()]                     # (N, tiles, S, g)
    scales = st.scales.to(torch.float32)
    acc = torch.zeros(xb.shape[0], tiles, g, dtype=torch.float32,
                      device=x.device)
    for s in range(kept):
        acc = acc + torch.einsum("ntg,tgo->nto", xg[:, :, s],
                                 w[:, s]) * scales[:, s]
    return acc.reshape(*x.shape[:-1], out_f)


def sparse_w4a16_matmul_torch(x: torch.Tensor, st: SparseQuantizedTensor,
                              bias: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (CPU path and card reference)."""
    y = sparse_matmul_f32(x, st)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def check_sparse(st: SparseQuantizedTensor, device: torch.device,
                 what: str) -> None:
    in_f, out_f = st.shape
    if st.group_size != GROUP_SIZE:
        raise ValueError(f"{what}: the kernel needs {GROUP_SIZE}-row blocks")
    if in_f % GROUP_SIZE or out_f % GROUP_SIZE:
        raise ValueError(f"{what}: shape {st.shape} needs in and out "
                         f"multiples of {GROUP_SIZE} (the sparse tile)")
    tiles, kept = out_f // GROUP_SIZE, st.kept_blocks
    want = {"packed": ((tiles, kept, GROUP_SIZE // 2, GROUP_SIZE),
                       torch.uint8),
            "scales": ((tiles, kept, GROUP_SIZE), torch.bfloat16),
            "block_idx": ((tiles, kept), torch.int32)}
    for field, (shape, dtype) in want.items():
        t = getattr(st, field)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {field} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: weights must be contiguous on {device}")


def sparse_operands(st: SparseQuantizedTensor):
    """The packed blocks and scales as the bf16 tile's cp.async copies take
    them: 4- (packed) and 8-byte (scales) aligned at least (16-byte aligned
    ones take one copy a chunk); a misaligned one is copied."""
    return aligned(st.packed, 4), aligned(st.scales, 8)


def sparse_w4a16_matmul_cuda(x: torch.Tensor, st: SparseQuantizedTensor,
                             bias: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Launch ``csrc/sparse_w4a16.cu`` on the current stream."""
    check_activation(x, NAME)
    check_sparse(st, x.device, NAME)
    in_f, out_f = st.shape
    if x.shape[-1] != in_f:
        raise ValueError(f"contraction mismatch {x.shape[-1]} vs {in_f}")
    b = bias_f32(bias, out_f, x.device, NAME)
    # the bf16 tile's x copies are 16-byte chunks
    x2 = aligned(x.reshape(-1, in_f).contiguous(), 16)
    packed, scales = sparse_operands(st)
    n = x2.shape[0]
    out = torch.empty((n, out_f), dtype=x.dtype, device=x.device)
    if n:
        fn = _build.function("sparse_w4a16", "sparse_w4a16_matmul_launch",
                             _ARGTYPES)
        rc = fn(x2.data_ptr(), st.block_idx.data_ptr(), packed.data_ptr(),
                scales.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr(), n, in_f, out_f, st.kept_blocks,
                DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check("sparse_w4a16", rc)
        _build.launches[NAME] += 1
    return out.reshape(*x.shape[:-1], out_f)
