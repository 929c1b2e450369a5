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

The served step is ``mamba_cell_gated``: the same operands plus the
layer's norm weight ``gamma (di,)``; it also applies the gated norm
``rmsnorm(y) * silu(z)`` (``kernels/rmsnorm.py``'s ``rmsnorm_gated``,
``z`` the first ``di`` columns of ``proj``, read at its row stride) and
returns the gated row ``(B, di)`` that out_proj reads.  On the card it is
one launch a layer (``mamba_cell_gated_kernel``): a block a (row, head)
loads its state tile by a bulk async copy while it convolves its own
x-channels and the row's B and C channels, and the row's last block (a
per-row arrival counter, ``arrivals``) shifts the shared B / C window and
runs the norm in the rmsnorm kernel's order, so its output, window and
state are bitwise ``mamba_cell`` followed by ``rmsnorm_gated``.  Its
plain version is that chain.  Launches that share a counter array must
not overlap in time, so each stream launches on an array of its own (a
captured graph on its capture stream's: the engine's graphs share a
memory pool, which already forbids replaying two of them at once); the
arrays are made before any CUDA graph capture (``prepare``).  The
two-pass ``mamba_cell`` stays as the chain's first half and the
yardstick the fused kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import rmsnorm_gated_torch
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES

NAME = "mamba_cell"
GATED_NAME = "mamba_cell_gated"
CELL_THREADS = 256
MAX_CONV = 8
MAX_ROWS = 4096             # a fused call's rows (a stream's counters)
COUNTER_STREAMS = 64        # streams a device's counters serve
SMEM_BYTES = 47 * 1024      # the fused kernel's shared memory, no opt-in
TAIL_STAGE_BYTES = 46 * 1024    # its last block stages y, gate and gamma
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
_GATED_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)
_arrivals: dict[int, torch.Tensor] = {}
_arrival_slots: dict[int, dict[int, int]] = {}


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


def mamba_cell_gated_torch(proj, window, conv_w, conv_b, A_log, D, dt_bias,
                           state, gamma, *, n_state: int, head_dim: int,
                           active: torch.Tensor | None = None,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ``mamba_cell_torch`` then ``rmsnorm_gated_torch`` on
    ``z = proj[:, :di]`` (the reference's algebra; on a CUDA tensor the
    norm is the rmsnorm kernel, as in that chain)."""
    y = mamba_cell_torch(proj, window, conv_w, conv_b, A_log, D, dt_bias,
                         state, n_state=n_state, head_dim=head_dim,
                         active=active)
    return rmsnorm_gated_torch(y, gamma, proj[:, :y.shape[1]], eps)


def gated_smem_bytes(heads: int, n_state: int, head_dim: int,
                     itemsize: int) -> int:
    """The fused kernel's dynamic shared memory: the state tile, B, C, x
    and y's partial sums (f32), or the last block's three staged rows (y,
    the gate and gamma), whichever is larger (``gated_smem`` in
    ``csrc/mamba_cell.cu``)."""
    groups = CELL_THREADS // (head_dim // 4)
    front = 4 * (n_state * head_dim + 2 * n_state + head_dim
                 + min(groups, n_state) * head_dim)
    return max(front, 3 * heads * head_dim * itemsize)


def gated_shape_ok(heads: int, n_state: int, head_dim: int,
                   itemsize: int) -> bool:
    """Whether the fused kernel takes these widths: the state pass's
    (``cell_shape_ok``), a row of ``heads * head_dim`` values of whole
    16-byte groups (the norm's 16-byte loads) whose three staged rows fit
    in ``TAIL_STAGE_BYTES``, and its shared memory within
    ``SMEM_BYTES``."""
    return (cell_shape_ok(n_state, head_dim)
            and (heads * head_dim * itemsize) % 16 == 0
            and 3 * heads * head_dim * itemsize <= TAIL_STAGE_BYTES
            and gated_smem_bytes(heads, n_state, head_dim, itemsize)
            <= SMEM_BYTES)


def arrivals(device, stream: int) -> torch.Tensor:
    """The per-row arrival counters (``MAX_ROWS`` int32, zero; every
    launch leaves them zero) of the launches on ``stream`` (a CUDA stream
    handle): one row of the device's table (``COUNTER_STREAMS`` rows, made
    once), given to each stream on its first launch.  Making the table
    inside a CUDA graph capture would record it into the graph, so that
    raises: ``prepare`` (or the step's first eager call) comes before."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    table = _arrivals.get(index)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{GATED_NAME}: the arrival counters of cuda:{index} are "
                "made inside a CUDA graph capture: run the step once (or "
                "_build.prepare()) before capturing it")
        table = torch.zeros((COUNTER_STREAMS, MAX_ROWS), dtype=torch.int32,
                            device=torch.device("cuda", index))
        torch.cuda.synchronize(index)     # zero before any stream reads it
        _arrivals[index] = table
    slots = _arrival_slots.setdefault(index, {})
    slot = slots.get(stream)
    if slot is None:
        if len(slots) == COUNTER_STREAMS:
            raise RuntimeError(
                f"{GATED_NAME}: more than {COUNTER_STREAMS} streams of "
                f"cuda:{index} launch the step")
        slot = slots[stream] = len(slots)
    return table[slot]


def prepare() -> None:
    """Make the current device's arrival counters (``_build.prepare``
    calls it before any CUDA graph capture)."""
    device = torch.device("cuda", torch.cuda.current_device())
    arrivals(device, _build.stream_ptr(device))


def mamba_cell_gated_cuda(proj, window, conv_w, conv_b, A_log, D, dt_bias,
                          state, gamma, *, n_state: int, head_dim: int,
                          active: torch.Tensor | None = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """Launch ``csrc/mamba_cell.cu``'s fused step on the current stream:
    the cell and the gated norm, one launch.  Refuses, before the device,
    any operand or width the kernel does not take."""
    b, h, di, _ = _widths(state, n_state, head_dim)
    if not gated_shape_ok(h, n_state, head_dim, proj.element_size()):
        raise ValueError(
            f"{GATED_NAME}: {h} heads of {head_dim}, state {n_state}, "
            f"{proj.dtype}: the kernel takes a head width of 4 to 1024 (a "
            "power of two), a row of whole 16-byte groups, at most "
            f"{TAIL_STAGE_BYTES} bytes for the row of y, the gate and gamma "
            f"and at most {SMEM_BYTES} bytes of shared memory")
    proj = proj.contiguous()
    _check(proj, window, conv_w, conv_b, A_log, D, dt_bias, state, n_state,
           head_dim, active)
    if b > MAX_ROWS:
        raise ValueError(f"{GATED_NAME}: {b} rows; the kernel takes at most "
                         f"{MAX_ROWS}")
    if (gamma.shape != (di,) or gamma.dtype != proj.dtype
            or gamma.device != proj.device or not gamma.is_contiguous()):
        raise ValueError(f"{GATED_NAME}: gamma must be ({di},) {proj.dtype} "
                         f"contiguous on {proj.device}")
    if (proj.data_ptr() | gamma.data_ptr()) % 16 or \
            (proj.shape[1] * proj.element_size()) % 16:
        raise ValueError(f"{GATED_NAME}: proj and gamma must start on a "
                         "16-byte boundary and proj's rows be 16-byte "
                         "strided")
    out = torch.empty((b, di), dtype=proj.dtype, device=proj.device)
    ys = torch.empty_like(out)
    if b:
        stream = _build.stream_ptr(proj.device)
        counters = arrivals(proj.device, stream)
        fn = _build.function(NAME, "mamba_cell_gated_launch", _GATED_ARGTYPES)
        rc = fn(proj.data_ptr(), window.data_ptr(), conv_w.data_ptr(),
                conv_b.data_ptr(), A_log.data_ptr(), D.data_ptr(),
                dt_bias.data_ptr(), state.data_ptr(), gamma.data_ptr(),
                out.data_ptr(), ys.data_ptr(), counters.data_ptr(), b, h,
                head_dim, n_state, conv_w.shape[0], proj.shape[1], eps,
                DTYPE_CODES[proj.dtype],
                None if active is None else active.data_ptr(), stream)
        _build.check(NAME, rc)
        _build.launches[GATED_NAME] += 1
    return out
