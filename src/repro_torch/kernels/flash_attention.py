"""Full-sequence flash attention (forward): CUDA kernel wrapper and its
plain version.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas``, the
attention of ``forward``, whole-prompt ``prefill`` and its chunked form.
The kernel is ``csrc/flash_attention.cu`` (its note says what bounds it on
the card).

Contract: q (B, hq, Sq, d), k/v (B, hkv, Skv, d), hq % hkv == 0 (query
head h reads KV head h // (hq // hkv)); query i sits at position
``Skv - Sq + i`` (the q block ends the context).  Masks: causal, optional
sliding window (``q_pos - k_pos < window``), or non-causal.  Scores and
the online-softmax statistics are f32; probabilities are rounded to v's
dtype before P·V; the output is ``acc / l`` (``l == 0`` -> 1) in q's
dtype.  A masked key adds p = 0, which equals the reference bit for bit on
every row that sees at least one key; a row that sees none (causal with
Sq > Skv) returns zeros, where the TPU kernel returns a tile-dependent mean
of v and the dense oracle NaN.

The training forward (``return_lse=True``, on the kernel and the plain
version) also returns each query row's log-sum-exp
``lse = ln(sum_j exp(s_j * scale))`` over its visible keys, f32 (B, hq,
Sq), +inf for a row that sees no key, so that the backward
(``kernels/flash_attention_bwd.py``) recomputes ``p = exp(s * scale -
lse)`` as 0 there and gives that row zero gradients.  The bfloat16 kernel
keeps m in log2 units and converts once, ``lse = (m + log2 l) * ln 2``.
Its output is bitwise the serving forward's.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "flash_attention"
# the kernel's instantiations: bfloat16 (the tensor-core kernel) also takes
# zamba2-7b's 112, its rows staged 128 wide (csrc/mma.cuh's staged_dim);
# float32's CUDA-core kernel gives each thread D / 16 dims in chunks of 4
# (so not 112)
HEAD_DIMS = {torch.bfloat16: (32, 64, 112, 128, 256),
             torch.float32: (32, 64, 128, 256)}
# the CUDA kernel's tiles: 64 query rows per block, 64-key K/V tiles
BLOCK_Q = 64
BLOCK_KV = 64
_NEG_INF = -1e30
_GRID_LIMIT = 65535              # hq and B ride grid axes y and z
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_LSE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None, block_q: int = 256,
                          block_kv: int = 512, return_lse: bool = False):
    """Plain version: the TPU kernel's tiles in its order, vectorised over
    batch and heads (GQA as (hkv, rep) groups).  For each ``block_q`` query
    tile the ``block_kv`` key tiles are walked in ascending order, skipping
    those wholly above the causal diagonal or wholly before the window;
    f32 ``s * scale`` with the -1e30 mask, online m/l/acc in f32, p rounded
    to v's dtype before P·V.  Ragged last tiles are simply shorter.
    ``return_lse``: ``(out, lse)`` with ``lse = m + ln l`` (B, hq, Sq) f32,
    +inf where ``l == 0``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    rep = hq // hkv
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    bq, bk = min(block_q, sq), min(block_kv, skv)
    dev = q.device
    q5 = q.reshape(b, hkv, rep, sq, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    q_off = skv - sq
    out = torch.empty((b, hkv, rep, sq, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, hkv, rep, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    zero = torch.zeros((), device=dev)
    for q0 in range(0, sq, bq):
        qb = q5[:, :, :, q0:q0 + bq]
        n = qb.shape[3]
        q_first = q_off + q0
        q_pos = q_first + torch.arange(n, device=dev)
        m = torch.full((b, hkv, rep, n), _NEG_INF, device=dev)
        l = torch.zeros((b, hkv, rep, n), device=dev)
        acc = torch.zeros((b, hkv, rep, n, d), device=dev)
        for k0 in range(0, skv, bk):
            if causal and k0 > q_first + n - 1:
                continue
            if window is not None and k0 + bk - 1 < q_first - window + 1:
                continue
            kn = min(bk, skv - k0)
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb,
                             kf[:, :, k0:k0 + kn]) * scale
            k_pos = k0 + torch.arange(kn, device=dev)
            mask = torch.ones((n, kn), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask, s, torch.tensor(_NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bgkd->bgrqd",
                              p.to(v.dtype).to(torch.float32),
                              vf[:, :, k0:k0 + kn])
            acc = acc * alpha[..., None] + pv
            m = m_new
        safe = torch.where(l == 0, torch.ones((), device=dev), l)
        out[:, :, :, q0:q0 + n] = (acc / safe[..., None]).to(q.dtype)
        if return_lse:
            lse[:, :, :, q0:q0 + n] = torch.where(
                l == 0, torch.full((), torch.inf, device=dev),
                m + torch.log(safe))
    out = out.reshape(b, hq, sq, d)
    return (out, lse.reshape(b, hq, sq)) if return_lse else out


def _operand(t: torch.Tensor, like: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{what} must be {like.dtype} on {like.device}, got "
                         f"{t.dtype} on {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None,
                         return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on the current stream.  Every
    shape, dtype and device the kernel does not take raises here (the head
    dim first, so the refusal shows on any device).  ``return_lse``: the
    training forward (bfloat16 only), ``(out, lse)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need 4-D q and k, v alike")
    b, hq, sq, d = q.shape
    if q.dtype in HEAD_DIMS and d not in HEAD_DIMS[q.dtype]:
        raise ValueError(
            f"head_dim {d} in {q.dtype}: the kernel takes "
            + "; ".join(f"{str(t).split('.')[1]} {dims}"
                        for t, dims in HEAD_DIMS.items()))
    check_activation(q, NAME)
    bk_, hkv, skv, dk = k.shape
    if bk_ != b or dk != d:
        raise ValueError(f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    if skv < 1:
        raise ValueError("no keys (Skv = 0)")
    if b > _GRID_LIMIT or hq > _GRID_LIMIT:
        raise ValueError(f"B={b}, hq={hq}: at most {_GRID_LIMIT} each")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError(f"{NAME}: the log-sum-exp forward takes bfloat16, "
                         f"got {q.dtype}")
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    q = _operand(q, q, "q")
    k = _operand(k, q, "k")
    v = _operand(v, q, "v")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b and sq:
        if return_lse:
            fn = _build.function(NAME, "flash_attention_lse_launch",
                                 _LSE_ARGTYPES)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, hq, hkv, sq, skv, d, scale,
                    int(causal), window or 0, _build.stream_ptr(q.device))
        else:
            fn = _build.function(NAME, "flash_attention_launch", _ARGTYPES)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, hkv, sq, skv, d, scale, int(causal), window or 0,
                    DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
        _build.check(NAME, rc)
        _build.launches[NAME] += 1
    return (out, lse) if return_lse else out
