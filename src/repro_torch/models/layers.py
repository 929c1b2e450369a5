"""Shared layers (functional, dict params), port of ``repro/models/layers.py``.

Every weight matmul goes through :func:`linear`, which dispatches on the
parameter type: a dense tensor (the 16-bit op, ``ops.dense_matmul``), a
:class:`QuantizedTensor` (the W4A16 op) or a :class:`SparseQuantizedTensor`
(the sparse W4A16 op).  On the card every product and norm of a served path
goes through a kernel whose reduction order per row is fixed, whatever the
number of rows (cuBLAS and PyTorch's reductions may pick their split from
the row count, which would break the engine's bitwise oracle parity).
Quantizing a model for serving is a pure tree transform
(``core/compiler.quantize_model``); no model code changes.  Random init
takes an explicit ``torch.Generator``; its device is where the weights live.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.sparsity import SparseQuantizedTensor
from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm

Params = dict[str, Any]


# -- init ------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_f: int, out_f: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_f)
    w = torch.randn((in_f, out_f), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# -- linear ----------------------------------------------------------------

def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(w, QuantizedTensor):
        y = ops.w4a16_matmul(x, w)
    elif isinstance(w, SparseQuantizedTensor):
        y = ops.sparse_w4a16_matmul(x, w)
    else:
        y = ops.dense_matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# -- norms -----------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """f32 RMSNorm; on the card through the fixed-order kernel."""
    return _rmsnorm(x, gamma, eps)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """f32 LayerNorm; on the card through the fixed-order kernel."""
    return ops.layernorm(x, gamma, beta, eps)


def norm_init(cfg, device) -> Params:
    d = cfg.d_model
    p = {"gamma": torch.ones((d,), dtype=cfg.dtype, device=device)}
    if cfg.norm != "rmsnorm":
        p["beta"] = torch.zeros((d,), dtype=cfg.dtype, device=device)
    return p


def apply_norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if "beta" in p:
        return layernorm(x, p["gamma"], p["beta"])
    return rmsnorm(x, p["gamma"])


# -- rotary embeddings -----------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (b, h, s, d); positions (b, s) int.  Angles in f32 from the int
    positions, as the reference computes them."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[:, None, :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg, batch: int, seq: int, offset: int = 0,
                  device=None) -> torch.Tensor:
    """Position ids (batch, seq) ``offset .. offset + seq - 1`` of every row
    (standard RoPE; M-RoPE's 3-axis ids come with the vlm family)."""
    if cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE positions come with the vlm family")
    base = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return base[None, :].expand(batch, seq)


# -- FFN -------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"gate": dense_init(gen, d, f, cfg.dtype),
                "up": dense_init(gen, d, f, cfg.dtype),
                "down": dense_init(gen, f, d, cfg.dtype)}
    return {"up": dense_init(gen, d, f, cfg.dtype),
            "up_bias": torch.zeros((f,), dtype=cfg.dtype, device=gen.device),
            "down": dense_init(gen, f, d, cfg.dtype),
            "down_bias": torch.zeros((d,), dtype=cfg.dtype,
                                     device=gen.device)}


def mlp_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One MLP = one operator (``ops.ffn_w4a16``, the device's path): on
    the card the fused FFN kernels, quantized, sparse or 16-bit (kernel 6);
    on the CPU the plain version, which keeps the unfused composition for
    16-bit weights, as the reference does.

    A difference by design from the reference's ``mlp_apply``, which keeps
    16-bit MLPs unfused on every device so its training path stays
    differentiable: on the card a 16-bit MLP takes kernel 6, which applies
    the activation to f32 sums and rounds the hidden once, where the unfused
    composition rounds each projection to x's dtype (the two agree within
    the reference's own ``tests/test_ffn_fused.py`` tolerance).  A training
    path keeps the unfused composition."""
    return ops.ffn_w4a16(x, p.get("gate"), p["up"], p["down"],
                         activation=cfg.activation, up_bias=p.get("up_bias"),
                         down_bias=p.get("down_bias"))
