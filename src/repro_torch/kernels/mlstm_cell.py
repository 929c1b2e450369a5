"""mLSTM decode cell: CUDA kernel wrapper, plain version and the device
dispatch ``models/xlstm.mlstm_decode`` calls.

The reference leaves this step of ``repro/models/xlstm.py::mlstm_decode``
(the gate projections and the state update with its readout, ``:205-217``)
to XLA.  The port needs a kernel for it because the engine's oracle parity
needs each row bitwise independent of the batch, and PyTorch's CUDA
products and sums choose their reduction split from the row count;
``csrc/mlstm_cell.cu`` reduces every row in one fixed order.

One call: ``xp (B, 2d)``, ``q``/``k``/``v (B, h, dh)`` and the 16-bit gate
weights ``w_i``/``w_f (2d, h)`` in the model dtype, the biases ``b_i``/``b_f
(h,)`` f32 and the state ``C (B, h, dh, dh)``, ``n (B, h, dh)``, ``m (B,
h)`` f32.  ``C`` is updated in place; the call returns ``(y, n', m')``
with ``y (B, h, dh)`` f32, the normalized readout.  Rows where ``active``
is False keep ``C`` and get ``n' = n``, ``m' = m``.

The kernel's geometry is ``cell_plan``'s, from the shape alone: a cluster
of 4 CTAs (one per quarter of C's rows) per (row, head, 1024-column tile),
256 threads of 4 adjacent columns each, 16-byte rows of C when dh % 4 == 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan import log_sigmoid
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES

NAME = "mlstm_cell"
MAX_DH = 4096                       # q and k / sqrt(dh) in shared memory
CELL_THREADS = 256
CELL_COLS = 4                       # adjacent columns of C a thread owns
CELL_QUARTERS = 4                   # CTAs of a cluster: quarters of C's rows
CELL_TILE = CELL_THREADS * CELL_COLS
STATIC_SMEM = (3 * 8 + CELL_TILE) * 4   # the reductions' and the fold's sums
_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class CellPlan:
    grid_x: int            # column tiles x quarters
    cluster: int           # CTAs of a cluster
    threads: int
    vec: bool              # 16-byte loads and stores of C's rows
    smem_bytes: int        # dynamic (q, k / sqrt(dh)) plus static


def cell_plan(heads: int, dh: int, dtype: torch.dtype) -> CellPlan:
    """The cell kernel's geometry for ``heads`` heads of width ``dh`` with
    activations in ``dtype``; raises on shapes the kernel does not take."""
    if heads < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"{NAME}: heads = {heads}, head width {dh}: need "
                         f"heads >= 1 and dh in 1..{MAX_DH}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{NAME}: activations must be float32 or bfloat16")
    tiles = -(-dh // CELL_TILE)
    return CellPlan(tiles * CELL_QUARTERS, CELL_QUARTERS, CELL_THREADS,
                    dh % CELL_COLS == 0, 2 * dh * 4 + STATIC_SMEM)


def mlstm_cell_torch(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m,
                     active: torch.Tensor | None = None):
    """Plain version: the reference's ``mlstm_decode`` algebra (CPU path
    and card reference)."""
    dh = q.shape[-1]
    ig = (xp @ w_i.to(xp.dtype)).to(torch.float32) + b_i
    fg = (xp @ w_f.to(xp.dtype)).to(torch.float32) + b_f
    logf = log_sigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    i_act = torch.exp(ig - m_new)
    f_act = torch.exp(logf + m - m_new)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    k_s = kf / math.sqrt(dh)
    c_new = C * f_act[..., None, None] + i_act[..., None, None] * (
        k_s[..., :, None] * vf[..., None, :])
    n_new = n * f_act[..., None] + i_act[..., None] * k_s
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    y = num / den[..., None]
    if active is None:
        C.copy_(c_new)
        return y, n_new, m_new
    keep = active.to(torch.bool)
    C.copy_(torch.where(keep[:, None, None, None], c_new, C))
    return (y, torch.where(keep[:, None, None], n_new, n),
            torch.where(keep[:, None], m_new, m))


def _check(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m, active):
    if not q.is_cuda:
        raise ValueError(f"{NAME}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    bsz, heads, dh = q.shape
    plan = cell_plan(max(heads, 1), dh, q.dtype)
    want = {"xp": (xp, (bsz, heads * dh), q.dtype),
            "k": (k, (bsz, heads, dh), q.dtype),
            "v": (v, (bsz, heads, dh), q.dtype),
            "w_i": (w_i, (heads * dh, heads), q.dtype),
            "w_f": (w_f, (heads * dh, heads), q.dtype),
            "b_i": (b_i, (heads,), torch.float32),
            "b_f": (b_f, (heads,), torch.float32),
            "C": (C, (bsz, heads, dh, dh), torch.float32),
            "n": (n, (bsz, heads, dh), torch.float32),
            "m": (m, (bsz, heads), torch.float32)}
    if active is not None:
        want["active"] = (active, (bsz,), torch.bool)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{NAME}: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous on "
                             f"{q.device}")
    if plan.vec and C.data_ptr() % 16:
        raise ValueError(f"{NAME}: C must start on a 16-byte boundary")
    return plan


def mlstm_cell_cuda(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m,
                    active: torch.Tensor | None = None):
    """Launch ``csrc/mlstm_cell.cu`` on the current stream."""
    xp, q, k, v = (t.contiguous() for t in (xp, q, k, v))
    plan = _check(xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m, active)
    bsz, heads, dh = q.shape
    y = torch.empty((bsz, heads, dh), dtype=torch.float32, device=q.device)
    n_new, m_new = torch.empty_like(n), torch.empty_like(m)
    if bsz and heads:
        fn = _build.function(NAME, "mlstm_cell_launch", _ARGTYPES)
        rc = fn(xp.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                w_i.data_ptr(), w_f.data_ptr(), b_i.data_ptr(),
                b_f.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                y.data_ptr(), n_new.data_ptr(), m_new.data_ptr(),
                None if active is None else active.data_ptr(), bsz, heads,
                dh, math.sqrt(dh), DTYPE_CODES[q.dtype], int(plan.vec),
                _build.stream_ptr(q.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return y, n_new, m_new
