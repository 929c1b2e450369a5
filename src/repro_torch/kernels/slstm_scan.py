"""sLSTM recurrence: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/slstm_scan.py::slstm_scan_pallas``; the kernels are
in ``csrc/slstm_scan.cu`` (its note says what bounds them on the card).
``gates_x (B, L, h, 4dh)`` f32, the recurrent weights ``r (h, dh, 4dh)``
(f32 or bf16, widened to f32 exactly) and the bias ``b (h, 4dh)`` f32 give
the hidden states ``hs (B, L, h, dh)`` f32.  Beyond the reference: any L,
and an optional state ``(c, n, h, m)``, each ``(B, h, dh)`` f32, that the
scan starts from and writes back in place (rows where ``active`` is False
keep theirs); without one the scan starts from zeros with ``m = -1e30``.

Two kernels compute it, chosen by ``scan_plan`` from the head count, the
head width and R's dtype alone, never from the batch: the cluster kernel
(bf16 R, dh a multiple of 32 up to 512: a cluster of dh / 32 CTAs per head
keeps R in shared memory) and the CUDA-core kernel (every other shape:
f32 R, whose slice at dh = 512 would not fit, and other widths).  Both
give every output one fmaf chain over d in order, so they agree
bitwise.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES

NAME = "slstm_scan"
MAX_DH = 1024                       # the CUDA-core kernel: a thread a unit
CLUSTER_UNITS = 32                  # hidden units a CTA of a cluster owns
CLUSTER_ROWS = 4                    # batch rows one cluster serves
MAX_CLUSTER = 16                    # CTAs a cluster may have on Hopper
SMEM_PER_BLOCK = 232_448            # shared memory a block may opt in to
KERNEL_CODES = {"cuda_core": 0, "cluster": 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])

# launches by kernel ("cluster" or "cuda_core"), beside _build.launches
routes: "collections.Counter[str]" = collections.Counter()
_capacity: dict[int, int] = {}


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    kernel: str            # "cluster" or "cuda_core"
    cluster: int           # CTAs a head takes at once (1: no cluster)
    threads: int           # threads a CTA
    smem_bytes: int        # dynamic shared memory a CTA asks for


def scan_plan(heads: int, dh: int, r_dtype: torch.dtype) -> ScanPlan:
    """The kernel for ``heads`` heads of width ``dh`` with R in
    ``r_dtype``.  The cluster kernel holds a CTA's R slice (dh x 128
    bf16) and a double-buffered h for ``CLUSTER_ROWS`` rows in shared
    memory; shapes it cannot take run the CUDA-core kernel; shapes neither
    takes raise."""
    if heads < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"{NAME}: heads = {heads}, dh = {dh}: need heads "
                         f">= 1 and dh in 1..{MAX_DH}")
    if r_dtype not in DTYPE_CODES:
        raise ValueError(f"{NAME}: R must be float32 or bfloat16, got "
                         f"{r_dtype}")
    if (r_dtype == torch.bfloat16 and dh % CLUSTER_UNITS == 0
            and dh // CLUSTER_UNITS <= MAX_CLUSTER):
        threads = 4 * CLUSTER_UNITS
        smem = dh * threads * 2 + 2 * CLUSTER_ROWS * dh * 4
        return ScanPlan("cluster", dh // CLUSTER_UNITS, threads, smem)
    return ScanPlan("cuda_core", 1, dh, dh * 4)


def cluster_capacity(dh: int) -> int:
    """Clusters of the cluster kernel at width ``dh`` the card holds at
    once (``cudaOccupancyMaxActiveClusters``).  Clusters beyond it wait
    for a free one: each serves its own (head, rows) and none waits on
    another."""
    if dh not in _capacity:
        count = ctypes.c_int(0)
        fn = _build.function(NAME, "slstm_scan_cluster_capacity",
                             [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        _build.check(NAME, fn(dh, ctypes.byref(count)))
        _capacity[dh] = count.value
    return _capacity[dh]


def chain_floor_cuda(steps: int, dh: int, device) -> torch.Tensor:
    """Launch the chain-floor probe: ``steps`` steps of one dh-long
    dependent fmaf chain over shared memory and one cluster barrier, on one
    cluster of dh / 32 CTAs: the least time the cluster kernel's steps can
    take with their order kept.  Not a scan; not counted in ``launches``."""
    out = torch.empty(4 * dh, dtype=torch.float32, device=device)
    fn = _build.function(NAME, "slstm_chain_floor_launch",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    _build.check(NAME, fn(out.data_ptr(), steps, dh,
                          _build.stream_ptr(out.device)))
    return out


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
        plan = scan_plan(heads, dh, r.dtype)
        if plan.kernel == "cluster" and cluster_capacity(dh) < 1:
            raise RuntimeError(
                f"{NAME}: the card holds no cluster of {plan.cluster} CTAs "
                f"with {plan.smem_bytes} bytes of shared memory each")
        fn = _build.function(NAME, "slstm_scan_launch", _ARGTYPES)
        rc = fn(gates_x.data_ptr(), r.data_ptr(), b.data_ptr(),
                hs.data_ptr(), *(t.data_ptr() for t in state),
                None if active is None else active.data_ptr(),
                bsz, seq, heads, dh, DTYPE_CODES[r.dtype],
                KERNEL_CODES[plan.kernel], _build.stream_ptr(gates_x.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
        routes[plan.kernel] += 1
    return hs
