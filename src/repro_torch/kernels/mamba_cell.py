"""Mamba2 decode cell: CUDA kernel wrapper, plain version and the device
dispatch ``models/ssm.mamba_decode`` calls.

The reference leaves this step of ``repro/models/ssm.py::mamba_decode``
(everything between ``in_proj`` and the gated norm, ``:152-176``) to XLA.
The port needs a kernel for it for the reason ``mlstm_cell.py`` gives: the
engine's oracle parity needs each row bitwise independent of the batch,
and PyTorch's CUDA products and sums choose their reduction split from the
row count; ``csrc/mamba_cell.cu`` reduces every row in one fixed order.

One call: ``proj (B, 2 di + 2 n + h)`` in the model dtype (z | xBC | dt,
the in_proj row), the conv ``window (B, K - 1, di + 2 n)`` and ``conv_w
(K, di + 2 n)``, ``conv_b (di + 2 n,)`` in the model dtype, ``A_log``,
``D`` and ``dt_bias (h,)`` f32 and the SSM ``state (B, h, n, P)`` f32.  The
window is shifted and the state advanced in place; the call returns ``y
(B, di)`` in the model dtype, the readout before the gated norm.  Rows
where ``active`` is False keep their window and state (their ``y`` is
still computed).

The kernel is two launches, counted as one: a conv pass (one thread a
channel of a row: the window's taps in order, ``silu(conv + conv_b)`` into
a scratch row, the window shifted) and a state pass (one block a (row,
head)).  The conv is its own launch because the B and C channels are
shared by every head of a row: a block a head shifting them in place would
race the blocks still reading the old window.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES

NAME = "mamba_cell"
CELL_THREADS = 256
MAX_CONV = 8
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2


def _widths(state, n_state: int, head_dim: int):
    """(rows, heads, d_inner, conv channels) of a call, from its state."""
    b, h = state.shape[0], state.shape[1]
    di = h * head_dim
    return b, h, di, di + 2 * n_state


def mamba_cell_torch(proj, window, conv_w, conv_b, A_log, D, dt_bias, state,
                     *, n_state: int, head_dim: int,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the reference's ``mamba_decode`` algebra step by step
    (CPU path and card reference); ``upd = (dt * B) * x`` and ``state *
    decay + upd`` as two roundings each."""
    b, h, di, conv_dim = _widths(state, n_state, head_dim)
    n = n_state
    f32 = torch.float32
    xbc_new = proj[:, di:di + conv_dim]
    win = torch.cat([window, xbc_new[:, None].to(window.dtype)], dim=1)
    conv = (win * conv_w[None]).sum(dim=1)
    xbc = F.silu(conv + conv_b)
    xs = xbc[:, :di].reshape(b, h, head_dim).to(f32)
    bm = xbc[:, di:di + n].to(f32)
    cm = xbc[:, di + n:].to(f32)
    dt = F.softplus(proj[:, di + conv_dim:].to(f32) + dt_bias)
    decay = torch.exp(dt * -torch.exp(A_log))
    upd = (dt[:, :, None, None] * bm[:, None, :, None]) * xs[:, :, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cm, new_state)
    y = (y + D[None, :, None] * xs).reshape(b, di).to(proj.dtype)
    if active is None:
        state.copy_(new_state)
        window.copy_(win[:, 1:])
    else:
        keep = active.to(torch.bool)
        state.copy_(torch.where(keep[:, None, None, None], new_state, state))
        window.copy_(torch.where(keep[:, None, None], win[:, 1:], window))
    return y


def cell_shape_ok(n_state: int, head_dim: int) -> bool:
    """Whether the state pass takes these widths: a head width of whole
    16-byte groups whose count divides the block (4 to 1024, a power of
    two) and a state of at least one row."""
    p4 = head_dim // 4
    return (head_dim % 4 == 0 and 1 <= p4 <= CELL_THREADS
            and CELL_THREADS % p4 == 0 and n_state >= 1)


def _check(proj, window, conv_w, conv_b, A_log, D, dt_bias, state, n_state,
           head_dim, active):
    if not proj.is_cuda:
        raise ValueError(f"{NAME}: the CUDA kernel takes CUDA tensors, got "
                         f"{proj.device}")
    if proj.dtype not in DTYPE_CODES:
        raise TypeError(f"{NAME}: activations must be float32 or bfloat16")
    if not cell_shape_ok(n_state, head_dim):
        raise ValueError(f"{NAME}: head width {head_dim}, state {n_state}: "
                         "the kernel takes a head width of 4 to 1024, a "
                         "power of two")
    b, h, di, conv_dim = _widths(state, n_state, head_dim)
    k = conv_w.shape[0]
    if not 2 <= k <= MAX_CONV:
        raise ValueError(f"{NAME}: {k} conv taps; the kernel takes 2 to "
                         f"{MAX_CONV}")
    dt = proj.dtype
    want = {"proj": (proj, (b, di + conv_dim + h), dt),
            "window": (window, (b, k - 1, conv_dim), dt),
            "conv_w": (conv_w, (k, conv_dim), dt),
            "conv_b": (conv_b, (conv_dim,), dt),
            "A_log": (A_log, (h,), torch.float32),
            "D": (D, (h,), torch.float32),
            "dt_bias": (dt_bias, (h,), torch.float32),
            "state": (state, (b, h, n_state, head_dim), torch.float32)}
    if active is not None:
        want["active"] = (active, (b,), torch.bool)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{NAME}: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != proj.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous on "
                             f"{proj.device}")
    if state.data_ptr() % 16:
        raise ValueError(f"{NAME}: the state must start on a 16-byte "
                         "boundary")


def mamba_cell_cuda(proj, window, conv_w, conv_b, A_log, D, dt_bias, state,
                    *, n_state: int, head_dim: int,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/mamba_cell.cu`` (its two passes) on the current
    stream."""
    proj = proj.contiguous()
    _check(proj, window, conv_w, conv_b, A_log, D, dt_bias, state, n_state,
           head_dim, active)
    b, h, di, conv_dim = _widths(state, n_state, head_dim)
    y = torch.empty((b, di), dtype=proj.dtype, device=proj.device)
    xbc = torch.empty((b, conv_dim), dtype=proj.dtype, device=proj.device)
    if b:
        fn = _build.function(NAME, "mamba_cell_launch", _ARGTYPES)
        rc = fn(proj.data_ptr(), window.data_ptr(), conv_w.data_ptr(),
                conv_b.data_ptr(), A_log.data_ptr(), D.data_ptr(),
                dt_bias.data_ptr(), state.data_ptr(), xbc.data_ptr(),
                y.data_ptr(), b, h, head_dim, n_state, conv_w.shape[0],
                proj.shape[1], DTYPE_CODES[proj.dtype],
                None if active is None else active.data_ptr(),
                _build.stream_ptr(proj.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return y
