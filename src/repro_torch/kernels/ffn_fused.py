"""Fused W4A16 FFN: CUDA path and its plain version.

Port of ``repro/kernels/ffn_fused.py::ffn_fused_w4a16_pallas`` (quant
variant) and of its blocked twin ``ffn_w4a16_xla``.  The CUDA path is two
hand kernels: ``csrc/ffn_fused.cu`` computes ``act(x@gate) * (x@up)`` with
per-group scale-after-dot and writes the hidden in x's dtype, then
``csrc/w4a16_matmul.cu`` contracts it with ``down``.  The reference rounds
each hidden tile to x's dtype before the down contraction too, so the split
changes no arithmetic; it costs one launch and the hidden's round trip
through device memory (see PERF.md).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import _build, ref
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, check_activation, check_quantized, w4a16_matmul_cuda,
    w4a16_matmul_f32)

NAME = "ffn_fused_w4a16"
GATED_ACTIVATIONS = ("swiglu", "geglu")
_ACT_CODES = {"swiglu": 1, "geglu": 2}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def _check_gated_bias(activation, up_bias, down_bias):
    if activation in GATED_ACTIVATIONS and (up_bias is not None
                                            or down_bias is not None):
        raise ValueError("gated activations take no FFN biases")


def _act(name: str, g, u):
    if name == "swiglu":
        return torch.nn.functional.silu(g) * u
    if name == "geglu":
        return torch.nn.functional.gelu(g, approximate="tanh") * u
    if name == "gelu":
        return torch.nn.functional.gelu(u, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def ffn_gate_up_torch(x: torch.Tensor, gate: QuantizedTensor,
                      up: QuantizedTensor, activation: str) -> torch.Tensor:
    """Plain version of ``csrc/ffn_fused.cu``: the hidden in x's dtype."""
    g = w4a16_matmul_f32(x, gate)
    u = w4a16_matmul_f32(x, up)
    return _act(activation, g, u).to(x.dtype)


def ffn_w4a16_torch(x, gate, up, down, *, activation="swiglu", up_bias=None,
                    down_bias=None) -> torch.Tensor:
    """Plain version (twin of ``ffn_w4a16_xla``): f32 scale-after-dot per
    quant group, activation on the f32 sums, hidden cast to x's dtype for
    the down contraction.  Unquantized weights take the unfused oracle."""
    _check_gated_bias(activation, up_bias, down_bias)
    ws = (gate, up, down) if activation in GATED_ACTIVATIONS else (up, down)
    if not any(isinstance(w, QuantizedTensor) for w in ws):
        return ref.ffn_ref(x, gate, up, down, activation=activation,
                           up_bias=up_bias, down_bias=down_bias)

    def mm(x_, w):
        if isinstance(w, QuantizedTensor):
            return w4a16_matmul_f32(x_, w)
        return x_.to(torch.float32) @ w.to(torch.float32)

    u = mm(x, up)
    if up_bias is not None:
        u = u + up_bias.to(torch.float32)
    g = mm(x, gate) if activation in GATED_ACTIVATIONS else None
    out = mm(_act(activation, g, u).to(x.dtype), down)
    if down_bias is not None:
        out = out + down_bias.to(torch.float32)
    return out.to(x.dtype)


def ffn_gate_up_cuda(x: torch.Tensor, gate: QuantizedTensor,
                     up: QuantizedTensor, activation: str) -> torch.Tensor:
    """Launch ``csrc/ffn_fused.cu``: the (tokens, d_ff) hidden in x's dtype."""
    check_activation(x, NAME)
    if activation not in _ACT_CODES:
        raise NotImplementedError(
            f"activation {activation!r}: the ungated gelu FFN with biases "
            "is not ported to CUDA yet (a later slice); swiglu and geglu are")
    check_quantized(gate, x.device, f"{NAME} gate")
    check_quantized(up, x.device, f"{NAME} up")
    d, f = up.shape
    if gate.shape != up.shape or x.shape[-1] != d:
        raise ValueError(f"FFN shapes: x {tuple(x.shape)}, gate {gate.shape},"
                         f" up {up.shape}")
    x2 = x.reshape(-1, d).contiguous()
    n = x2.shape[0]
    hidden = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n:
        fn = _build.function("ffn_fused", "ffn_gate_up_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), gate.packed.data_ptr(),
                gate.scales.data_ptr(), up.packed.data_ptr(),
                up.scales.data_ptr(), hidden.data_ptr(), n, d, f,
                _ACT_CODES[activation], DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check("ffn_fused", rc)
        _build.launches[NAME] += 1
    return hidden.reshape(*x.shape[:-1], f)


def ffn_w4a16_cuda(x, gate, up, down, *, activation="swiglu", up_bias=None,
                   down_bias=None) -> torch.Tensor:
    """The CUDA path: gate/up/activation kernel, then the down projection
    through the W4A16 kernel."""
    _check_gated_bias(activation, up_bias, down_bias)
    if not all(isinstance(w, QuantizedTensor) for w in (gate, up, down)):
        raise NotImplementedError(
            "the CUDA FFN takes W4A16 gate/up/down; 16-bit weights go "
            "through ops.ffn_w4a16's plain path on CPU only in this slice")
    hidden = ffn_gate_up_cuda(x, gate, up, activation)
    return w4a16_matmul_cuda(hidden, down)
