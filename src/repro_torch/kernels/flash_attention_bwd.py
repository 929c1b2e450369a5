"""Full-sequence flash attention, backward: CUDA kernel wrapper and its
plain version.

No Pallas kernel of the reference has a backward: ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:101``) has no VJP, and the reference's
training differentiates its XLA twin (``repro/kernels/xla_attention.py:333``
``attention_chunked``).  The port's training forward is kernel 7
(``flash_attention_cuda(..., return_lse=True)``), so its gradient is the
hand-written ``csrc/flash_attention_bwd.cu`` (wgmma fed by TMA; its note
says how the work is split and what bounds it).  The first, ``mma.sync``
design stays as ``csrc/flash_attention_bwd_sync.cu``
(``flash_attention_bwd_sync_cuda``), off the training path: the yardstick
the kernel is timed against.

Contract: q, o, dO (B, hq, Sq, d), k, v (B, hkv, Skv, d), lse (B, hq, Sq)
f32 from the forward (+inf for a row that saw no key); the forward's
masks.  With ``p = exp(s * scale - lse)`` (0 where masked), ``D = sum_d dO
* O``, ``dS = p * (dO.V^T - D)``: ``dV = P^T.dO``, ``dK = scale * dS^T.Q``,
``dQ = scale * dS.K``, dK and dV summed over each KV head's query heads.
P and dS are rounded to q's dtype before their products (as the kernel's
bf16 operands are), every sum is f32, the outputs are cast to q's dtype
once.  A row that sees no key gets zero gradients.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _operand
from repro_torch.kernels.w4a16_matmul import check_activation

NAME = "flash_attention_bwd"
SYNC_NAME = "flash_attention_bwd_sync"
# the kernel's instantiations (bfloat16 only; float32 and head dims 112
# and 256 wait in ROADMAP queue 1, item 6c)
HEAD_DIMS = (32, 64, 128)
BLOCK = 64                # the kernel's query and key tiles
STATS = 2 * BLOCK         # a query tile's lse (log2 units) and D
_GRID_LIMIT = 65535
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def check_supported(q: torch.Tensor) -> None:
    """Raise unless the kernel takes q's dtype and head dim (on any
    device, so a training forward refuses before it runs)."""
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in HEAD_DIMS:
        raise ValueError(
            f"{NAME}: head_dim {d} in {q.dtype}; the kernel takes bfloat16 "
            f"at head dims {HEAD_DIMS}")


def _live_tiles(q0: int, n: int, sq: int, skv: int, causal: bool,
                window: int | None, block: int) -> range:
    """The forward's live key tiles of the query tile at q0 (n rows)."""
    q_first = skv - sq + q0
    q_last = q_first + n - 1
    t_hi = -(-skv // block)
    if causal:
        t_hi = min(t_hi, q_last // block + 1) if q_last >= 0 else 0
    t_lo = 0
    if window is not None and q_first - window + 1 > 0:
        t_lo = (q_first - window + 1) // block
    return range(t_lo, t_hi)


def flash_attention_bwd_torch(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int | None = None,
                              scale: float | None = None,
                              block: int = BLOCK):
    """Plain version in the kernel's tile order, f32, vectorised over batch
    and KV heads: dQ walks each ``block``-row query tile's live key tiles
    ascending; dK and dV walk the query heads r of a KV head in order and,
    in each, the query tiles iq ascending, into two partials by the parity
    of r + iq (the kernel's two warpgroups), added at the end.  Returns
    (dq, dk, dv) in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    rep = hq // hkv
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    dt, f32, dev = q.dtype, torch.float32, q.device
    q5 = q.reshape(b, hkv, rep, sq, d).to(f32)
    do5 = do.reshape(b, hkv, rep, sq, d).to(f32)
    lse5 = lse.reshape(b, hkv, rep, sq)
    delta = (do5 * o.reshape(b, hkv, rep, sq, d).to(f32)).sum(dim=-1)
    kf, vf = k.to(f32), v.to(f32)
    q_pos = torch.arange(sq, device=dev) + (skv - sq)
    k_pos = torch.arange(skv, device=dev)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    zero = torch.zeros((), device=dev)

    def probs(s, m, lse_rows):
        return torch.where(m, torch.exp(s - lse_rows[..., None]), zero)

    dq = torch.empty((b, hkv, rep, sq, d), dtype=f32, device=dev)
    for q0 in range(0, sq, block):
        n = min(block, sq - q0)
        qb, dob = q5[:, :, :, q0:q0 + n], do5[:, :, :, q0:q0 + n]
        acc = torch.zeros((b, hkv, rep, n, d), dtype=f32, device=dev)
        for it in _live_tiles(q0, n, sq, skv, causal, window, block):
            k0 = it * block
            kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kt) * scale
            p = probs(s, mask[q0:q0 + n, k0:k0 + block],
                      lse5[:, :, :, q0:q0 + n])
            dp = torch.einsum("bgrqd,bgkd->bgrqk", dob, vt)
            ds = p * (dp - delta[:, :, :, q0:q0 + n, None])
            acc = acc + torch.einsum("bgrqk,bgkd->bgrqd",
                                     ds.to(dt).to(f32), kt)
        dq[:, :, :, q0:q0 + n] = acc * scale

    dk = [torch.zeros((b, hkv, skv, d), dtype=f32, device=dev)
          for _ in range(2)]
    dv = [torch.zeros((b, hkv, skv, d), dtype=f32, device=dev)
          for _ in range(2)]
    for r in range(rep):
        for iq, q0 in enumerate(range(0, sq, block)):
            n, w = min(block, sq - q0), (r + iq) % 2
            qb, dob = q5[:, :, r, q0:q0 + n], do5[:, :, r, q0:q0 + n]
            s = torch.einsum("bgqd,bgkd->bgqk", qb, kf) * scale
            p = probs(s, mask[q0:q0 + n], lse5[:, :, r, q0:q0 + n])
            dp = torch.einsum("bgqd,bgkd->bgqk", dob, vf)
            ds = p * (dp - delta[:, :, r, q0:q0 + n, None])
            dv[w] = dv[w] + torch.einsum("bgqk,bgqd->bgkd",
                                         p.to(dt).to(f32), dob)
            dk[w] = dk[w] + torch.einsum("bgqk,bgqd->bgkd",
                                         ds.to(dt).to(f32), qb)
    return (dq.reshape(b, hq, sq, d).to(dt),
            ((dk[0] + dk[1]) * scale).to(dt), (dv[0] + dv[1]).to(dt))


def _checked(q, k, v, o, do, lse, window):
    """The operands the kernels take (contiguous, on q's device), or
    raise: every shape, dtype and device the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need 4-D q and k, v alike")
    check_supported(q)
    check_activation(q, NAME)
    b, hq, sq, d = q.shape
    _, hkv, skv, dk_ = k.shape
    if k.shape[0] != b or dk_ != d or hkv < 1 or hq % hkv:
        raise ValueError(f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"be q's {tuple(q.shape)}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be ({b}, {hq}, {sq}) float32 on "
                         f"{q.device}")
    if skv < 1 or b > _GRID_LIMIT or hq > _GRID_LIMIT:
        raise ValueError(f"Skv={skv}, B={b}, hq={hq}: need Skv >= 1 and at "
                         f"most {_GRID_LIMIT} rows and heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q = _operand(q, q, "q")
    k, v = _operand(k, q, "k"), _operand(v, q, "v")
    o, do = _operand(o, q, "o"), _operand(do, q, "dO")
    return q, k, v, o, do, lse.contiguous()


def _launch(name, symbol, scratch, q, k, v, o, do, lse, causal, window,
            scale):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b and sq:
        stats = torch.empty(scratch, dtype=torch.float32, device=q.device)
        fn = _build.function(name, symbol, _ARGTYPES)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq,
                skv, d, scale, int(causal), window or 0,
                _build.stream_ptr(q.device))
        _build.check(name, rc)
        _build.launches[name] += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None):
    """Launch ``csrc/flash_attention_bwd.cu`` on the current stream (two
    kernels: dQ with each row's D, then dK/dV).  Returns (dq, dk, dv).
    Every shape, dtype and device the kernel does not take raises here."""
    q, k, v, o, do, lse = _checked(q, k, v, o, do, lse, window)
    b, hq, sq, _ = q.shape
    return _launch(NAME, "flash_attention_bwd_launch",
                   (b * hq * -(-sq // BLOCK) * STATS,), q, k, v, o, do, lse,
                   causal, window, scale)


def flash_attention_bwd_sync_cuda(q, k, v, o, do, lse, *,
                                  causal: bool = True,
                                  window: int | None = None,
                                  scale: float | None = None):
    """Launch the ``mma.sync`` yardstick ``csrc/flash_attention_bwd_sync.cu``
    (three kernels: D, then dK/dV and dQ), the same contract; on no
    training path."""
    q, k, v, o, do, lse = _checked(q, k, v, o, do, lse, window)
    b, hq, sq, _ = q.shape
    return _launch(SYNC_NAME, "flash_attention_bwd_sync_launch",
                   (b * hq * sq,), q, k, v, o, do, lse, causal, window,
                   scale)
