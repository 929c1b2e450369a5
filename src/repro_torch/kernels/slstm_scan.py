"""sLSTM recurrence: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/slstm_scan.py::slstm_scan_pallas``; the kernel is
``csrc/slstm_scan.cu`` (its note says what bounds it on the card).
``gates_x (B, L, h, 4dh)`` f32, the recurrent weights ``r (h, dh, 4dh)``
(f32 or bf16, widened to f32 exactly) and the bias ``b (h, 4dh)`` f32 give
the hidden states ``hs (B, L, h, dh)`` f32.  Beyond the reference: any L,
and an optional state ``(c, n, h, m)``, each ``(B, h, dh)`` f32, that the
scan starts from and writes back in place (rows where ``active`` is False
keep theirs); without one the scan starts from zeros with ``m = -1e30``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES

NAME = "slstm_scan"
MAX_DH = 1024                       # one thread per hidden unit
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fresh_state(batch: int, heads: int, dh: int, device) -> tuple:
    """(c, n, h, m) of a sequence's start: zeros, ``m = -1e30``."""
    zeros = [torch.zeros((batch, heads, dh), dtype=torch.float32,
                         device=device) for _ in range(3)]
    return (*zeros, torch.full((batch, heads, dh), -1e30,
                               dtype=torch.float32, device=device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The kernel's stable form: ``min(x, 0) - log1p(exp(-|x|))``."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def slstm_scan_torch(gates_x: torch.Tensor, r: torch.Tensor,
                     b: torch.Tensor, state: tuple | None = None,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the recurrence stepped in Python over t, in the
    kernel's order (CPU path and card reference)."""
    bsz, seq, heads, g4 = gates_x.shape
    dh = g4 // 4
    rf, bf = r.to(torch.float32), b.to(torch.float32)
    c, n, h, m = (fresh_state(bsz, heads, dh, gates_x.device)
                  if state is None else state)
    outs = []
    for t in range(seq):
        g = (gates_x[:, t] + torch.einsum("bhd,hde->bhe", h, rf)) + bf
        z = torch.tanh(g[..., :dh])
        ig = g[..., dh:2 * dh]
        logf = log_sigmoid(g[..., 2 * dh:3 * dh])
        o = torch.sigmoid(g[..., 3 * dh:])
        m_new = torch.maximum(logf + m, ig)
        i_act = torch.exp(ig - m_new)
        f_act = torch.exp(logf + m - m_new)
        c = f_act * c + i_act * z
        n = torch.maximum(f_act * n + i_act, torch.exp(-m_new))
        m = m_new
        h = o * c / n
        outs.append(h)
    hs = (torch.stack(outs, dim=1) if outs else
          gates_x.new_zeros((bsz, 0, heads, dh)))
    if state is not None and seq:
        keep = (None if active is None else
                active.to(torch.bool).reshape(-1, 1, 1))
        for dst, new in zip(state, (c, n, h, m)):
            dst.copy_(new if keep is None else torch.where(keep, new, dst))
    return hs


def _check(gates_x, r, b, state, active):
    if not gates_x.is_cuda:
        raise ValueError(f"{NAME}: the CUDA kernel takes CUDA tensors, got "
                         f"{gates_x.device}")
    if gates_x.dim() != 4 or gates_x.dtype != torch.float32:
        raise ValueError(f"{NAME}: gates_x must be (B, L, h, 4dh) float32")
    bsz, _, heads, g4 = gates_x.shape
    dh = g4 // 4
    if g4 % 4 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"{NAME}: 4dh = {g4} needs dh in 1..{MAX_DH}")
    if r.shape != (heads, dh, g4) or r.dtype not in DTYPE_CODES:
        raise ValueError(f"{NAME}: r must be ({heads}, {dh}, {g4}) float32 "
                         f"or bfloat16, got {tuple(r.shape)} {r.dtype}")
    if b.shape != (heads, g4) or b.dtype != torch.float32:
        raise ValueError(f"{NAME}: b must be ({heads}, {g4}) float32")
    tensors = [r, b] + list(state)
    for t in state:
        if t.shape != (bsz, heads, dh) or t.dtype != torch.float32:
            raise ValueError(f"{NAME}: each state tensor must be "
                             f"({bsz}, {heads}, {dh}) float32")
    if active is not None:
        if active.shape != (bsz,) or active.dtype != torch.bool:
            raise ValueError(f"{NAME}: active must be ({bsz},) bool")
        tensors.append(active)
    for t in tensors:
        if t.device != gates_x.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: operands must be contiguous on "
                             f"{gates_x.device}")


def slstm_scan_cuda(gates_x: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                    state: tuple | None = None,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/slstm_scan.cu`` on the current stream."""
    gates_x = gates_x.contiguous()
    bsz, seq, heads, g4 = gates_x.shape
    dh = g4 // 4
    if state is None:
        state = fresh_state(bsz, heads, dh, gates_x.device)
    _check(gates_x, r, b, state, active)
    hs = torch.empty((bsz, seq, heads, dh), dtype=torch.float32,
                     device=gates_x.device)
    if bsz and seq and heads:
        fn = _build.function(NAME, "slstm_scan_launch", _ARGTYPES)
        rc = fn(gates_x.data_ptr(), r.data_ptr(), b.data_ptr(),
                hs.data_ptr(), *(t.data_ptr() for t in state),
                None if active is None else active.data_ptr(),
                bsz, seq, heads, dh, DTYPE_CODES[r.dtype],
                _build.stream_ptr(gates_x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return hs
