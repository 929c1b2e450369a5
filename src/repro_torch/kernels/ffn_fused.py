"""Fused FFN, dense-quantized, log-scale sparse and 16-bit: CUDA paths and
their plain versions.

Port of ``repro/kernels/ffn_fused.py``: ``ffn_fused_w4a16_pallas`` (quant
variant, gated and the ungated gelu with biases), ``ffn_fused_sparse_pallas``
(sparse variant), ``ffn_fused_dense_pallas`` (fp variant, 16-bit weights)
and their blocked twin ``ffn_w4a16_xla``.  Each CUDA path is two hand
kernels:

* ``"quant"``: ``csrc/ffn_fused.cu`` computes ``act(x@gate) * (x@up)``
  (or ``gelu(x@up + up_bias)``) with per-group scale-after-dot and writes
  the hidden in x's dtype, then ``csrc/w4a16_matmul.cu`` contracts it with
  ``down`` (adding ``down_bias`` in f32 before its cast);
* ``"sparse"``: ``csrc/ffn_fused_sparse.cu`` does the same for block-sparse
  gate/up (or up alone with ``up_bias``), only for the hidden tiles
  ``down`` keeps (all of them for a dense-quantized down), then
  ``csrc/sparse_w4a16.cu`` (sparse down, its own ``block_idx``) or
  ``csrc/w4a16_matmul.cu`` (dense down) contracts them, adding
  ``down_bias`` in f32 before the cast;
* ``"fp"``: ``csrc/ffn_fused_dense.cu`` computes the hidden from 16-bit
  gate/up in f32, then ``csrc/dense_matmul.cu`` contracts it with ``down``
  (the down bias as its f32 epilogue).

The reference rounds each hidden tile to x's dtype before the down
contraction too, so the split changes no arithmetic; it costs one launch
and the hidden's round trip through device memory (see PERF.md).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.quant import GROUP_SIZE, QuantizedTensor
from repro_torch.core.sparsity import SparseQuantizedTensor
from repro_torch.kernels import _build, ref
from repro_torch.kernels.dense_matmul import (
    dense_matmul_cuda, dense_matmul_f32, dense_weight)
from repro_torch.kernels.sparse_w4a16 import (
    check_sparse, sparse_matmul_f32, sparse_operands, sparse_w4a16_matmul_cuda)
from repro_torch.kernels.w4a16_matmul import (
    DTYPE_CODES, MMA_GROUP_SIZES, aligned, bias_f32, check_activation,
    check_quantized, group_sizes, w4a16_matmul_cuda, w4a16_matmul_f32)

NAME = "ffn_fused_w4a16"
GELU_NAME = "ffn_fused_w4a16_gelu"        # the ungated variant's launches
DENSE_NAME = "ffn_fused_dense"
GATED_ACTIVATIONS = ("swiglu", "geglu")
# the epilogue codes of csrc/common.cuh
_ACT_CODES = {"swiglu": 1, "geglu": 2, "gelu": 3}
SPARSE_NAME = "ffn_fused_sparse"
SPARSE_GELU_NAME = "ffn_fused_sparse_gelu"   # the ungated variant's launches
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
_DENSE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_SPARSE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
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


def _check_activation_name(activation: str) -> None:
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")


def _mm_f32(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, QuantizedTensor):
        return w4a16_matmul_f32(x, w)
    if isinstance(w, SparseQuantizedTensor):
        return sparse_matmul_f32(x, w)
    return dense_matmul_f32(x, w)


def ffn_gate_up_torch(x: torch.Tensor, gate, up, activation: str,
                      up_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the first stage, ``csrc/ffn_fused.cu`` (W4A16
    weights) or ``csrc/ffn_fused_dense.cu`` (16-bit weights): f32 sums (per
    quant group, scale after the dot), the up bias in f32, the activation
    on the f32 sums, the hidden in x's dtype."""
    u = _mm_f32(x, up)
    if up_bias is not None:
        u = u + up_bias.to(torch.float32)
    g = _mm_f32(x, gate) if activation in GATED_ACTIVATIONS else None
    return _act(activation, g, u).to(x.dtype)


def _ffn_f32(x, gate, up, down, activation, up_bias, down_bias):
    """The fused kernels' numerics for any weight mix: the first stage of
    :func:`ffn_gate_up_torch`, then the down contraction in f32, the down
    bias in f32, one cast."""
    out = _mm_f32(ffn_gate_up_torch(x, gate, up, activation, up_bias), down)
    if down_bias is not None:
        out = out + down_bias.to(torch.float32)
    return out.to(x.dtype)


def ffn_w4a16_torch(x, gate, up, down, *, activation="swiglu", up_bias=None,
                    down_bias=None) -> torch.Tensor:
    """Plain version (twin of ``ffn_w4a16_xla``, any weight mix): the fused
    numerics of :func:`_ffn_f32`.  All-16-bit weights take the unfused
    oracle, as the reference's twin does (``repro/kernels/ops.py:96-98``);
    kernel 6's own plain version is :func:`ffn_fused_dense_torch`."""
    _check_gated_bias(activation, up_bias, down_bias)
    ws = (gate, up, down) if activation in GATED_ACTIVATIONS else (up, down)
    if not any(isinstance(w, (QuantizedTensor, SparseQuantizedTensor))
               for w in ws):
        return ref.ffn_ref(x, gate, up, down, activation=activation,
                           up_bias=up_bias, down_bias=down_bias)
    return _ffn_f32(x, gate, up, down, activation, up_bias, down_bias)


def ffn_fused_dense_torch(x, gate, up, down, *, activation="swiglu",
                          up_bias=None, down_bias=None) -> torch.Tensor:
    """Plain version of kernel 6 (``ffn_fused_dense_pallas``, 16-bit
    weights): gate/up in f32, the activation on the f32 sums, the hidden
    rounded once to x's dtype, down in f32 with its bias, one cast.  The
    unfused composition (``ref.ffn_ref``) rounds each projection to x's
    dtype instead."""
    _check_gated_bias(activation, up_bias, down_bias)
    return _ffn_f32(x, gate, up, down, activation, up_bias, down_bias)


def _hidden_launch(x, d, f, launch):
    """Flatten x, allocate the (tokens, f) hidden, call ``launch(x2, hidden,
    n)`` when there are tokens; the hidden in x's leading shape."""
    x2 = x.reshape(-1, d).contiguous()
    n = x2.shape[0]
    hidden = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n:
        launch(x2, hidden, n)
    return hidden.reshape(*x.shape[:-1], f)


def ffn_gate_up_cuda(x: torch.Tensor, gate: QuantizedTensor | None,
                     up: QuantizedTensor, activation: str,
                     up_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/ffn_fused.cu``: the (tokens, d_ff) hidden in x's dtype.
    Gated (gate and up) or ``"gelu"`` (up alone, with ``up_bias``)."""
    check_activation(x, NAME)
    _check_activation_name(activation)
    gated = activation in GATED_ACTIVATIONS
    _check_gated_bias(activation, up_bias, None)
    groups = group_sizes(x, not gated)
    check_quantized(up, x.device, f"{NAME} up", groups)
    d, f = up.shape
    if gated:
        check_quantized(gate, x.device, f"{NAME} gate", groups)
    if ((gated and (gate.shape != up.shape
                    or gate.group_size != up.group_size))
            or x.shape[-1] != d):
        raise ValueError(f"FFN shapes: x {tuple(x.shape)}, gate "
                         f"{gate.shape if gated else None}, up {up.shape}")
    ub = bias_f32(up_bias, f, x.device, f"{NAME} up_bias")

    # the bf16 tile's cp.async copies: x in 16-byte chunks, the weights in
    # 4- (packed) and 8-byte (scales) pieces at least
    pk = [aligned(w.packed, 4) if w is not None else None
          for w in (gate if gated else None, up)]
    sc = [aligned(w.scales, 8) if w is not None else None
          for w in (gate if gated else None, up)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch(x2, hidden, n):
        x2 = aligned(x2, 16)
        fn = _build.function("ffn_fused", "ffn_gate_up_launch", _ARGTYPES)
        rc = fn(x2.data_ptr(), ptr(pk[0]), ptr(sc[0]), ptr(pk[1]),
                ptr(sc[1]), ptr(ub), hidden.data_ptr(), n, d, f,
                up.group_size, _ACT_CODES[activation], DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check("ffn_fused", rc)
        _build.launches[NAME if gated else GELU_NAME] += 1
    return _hidden_launch(x, d, f, launch)


def ffn_dense_gate_up_cuda(x: torch.Tensor, gate: torch.Tensor | None,
                           up: torch.Tensor, activation: str,
                           up_bias: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Launch ``csrc/ffn_fused_dense.cu`` (kernel 6's first stage): the
    (tokens, d_ff) hidden in x's dtype from 16-bit gate and up (gated) or up
    alone with ``up_bias`` (``"gelu"``)."""
    check_activation(x, DENSE_NAME)
    _check_activation_name(activation)
    gated = activation in GATED_ACTIVATIONS
    _check_gated_bias(activation, up_bias, None)
    up = dense_weight(up, x, f"{DENSE_NAME} up")
    d, f = up.shape
    if gated:
        gate = dense_weight(gate, x, f"{DENSE_NAME} gate")
    if (gated and gate.shape != up.shape) or x.shape[-1] != d:
        raise ValueError(f"FFN shapes: x {tuple(x.shape)}, gate "
                         f"{tuple(gate.shape) if gated else None}, up "
                         f"{tuple(up.shape)}")
    ub = bias_f32(up_bias, f, x.device, f"{DENSE_NAME} up_bias")

    def launch(x2, hidden, n):
        fn = _build.function("ffn_fused_dense", "ffn_dense_gate_up_launch",
                             _DENSE_ARGTYPES)
        rc = fn(x2.data_ptr(), gate.data_ptr() if gated else None,
                up.data_ptr(), None if ub is None else ub.data_ptr(),
                hidden.data_ptr(), n, d, f, _ACT_CODES[activation],
                DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
        _build.check("ffn_fused_dense", rc)
        _build.launches[DENSE_NAME] += 1
    return _hidden_launch(x, d, f, launch)


def kept_f_tiles(down) -> torch.Tensor | None:
    """The hidden tiles the down projection reads: a tile_uniform sparse
    down's kept blocks (one list for all its output tiles), or ``None``
    for a dense-quantized down (every tile)."""
    if isinstance(down, SparseQuantizedTensor):
        return down.block_idx[0]
    return None


def tile_subset(st: SparseQuantizedTensor,
                tiles: torch.Tensor) -> SparseQuantizedTensor:
    """The output tiles ``tiles`` of one sparse matrix, as a narrower one."""
    t = tiles.long()
    return dataclasses.replace(
        st, packed=st.packed[t], scales=st.scales[t],
        block_idx=st.block_idx[t], shape=(st.shape[0], t.numel() * GROUP_SIZE))


def ffn_gate_up_sparse_torch(x: torch.Tensor,
                             gate: SparseQuantizedTensor | None,
                             up: SparseQuantizedTensor, activation: str,
                             f_tiles: torch.Tensor | None,
                             up_bias: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain version of ``csrc/ffn_fused_sparse.cu``: the hidden columns of
    the f-tiles in ``f_tiles`` (all when ``None``), ``(tokens,
    n_tiles * 128)`` in x's dtype; gated, or ``"gelu"`` (up alone, with
    ``up_bias`` over all d_ff columns)."""
    gated = activation in GATED_ACTIVATIONS
    if f_tiles is not None:
        up = tile_subset(up, f_tiles)
        gate = tile_subset(gate, f_tiles) if gated else None
        if up_bias is not None:
            up_bias = up_bias.reshape(-1, GROUP_SIZE)[f_tiles.long()
                                                      ].reshape(-1)
    u = sparse_matmul_f32(x, up)
    if up_bias is not None:
        u = u + up_bias.to(torch.float32)
    g = sparse_matmul_f32(x, gate) if gated else None
    return _act(activation, g, u).to(x.dtype)


def ffn_gate_up_sparse_cuda(x: torch.Tensor,
                            gate: SparseQuantizedTensor | None,
                            up: SparseQuantizedTensor, activation: str,
                            f_tiles: torch.Tensor | None,
                            up_bias: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Launch ``csrc/ffn_fused_sparse.cu``: a (tokens, d_ff) hidden in x's
    dtype whose columns are written only for the f-tiles in ``f_tiles``
    (all tiles when ``None``).  The other columns are left unwritten, and
    the gate/up blocks of their tiles are never read.  Gated (gate and up)
    or ``"gelu"`` (up alone, with ``up_bias``)."""
    check_activation(x, SPARSE_NAME)
    _check_activation_name(activation)
    gated = activation in GATED_ACTIVATIONS
    _check_gated_bias(activation, up_bias, None)
    check_sparse(up, x.device, f"{SPARSE_NAME} up")
    d, f = up.shape
    if gated:
        check_sparse(gate, x.device, f"{SPARSE_NAME} gate")
    if ((gated and (gate.shape != up.shape
                    or gate.kept_blocks != up.kept_blocks))
            or x.shape[-1] != d):
        raise ValueError(
            f"FFN shapes: x {tuple(x.shape)}, gate "
            f"{(gate.shape, gate.kept_blocks) if gated else None}, up "
            f"{up.shape} ({up.kept_blocks} kept)")
    ub = bias_f32(up_bias, f, x.device, f"{SPARSE_NAME} up_bias")
    n_tiles = f // GROUP_SIZE
    if f_tiles is not None:
        if (f_tiles.dtype != torch.int32 or f_tiles.dim() != 1
                or f_tiles.device != x.device or not f_tiles.is_contiguous()):
            raise ValueError("f_tiles must be a contiguous int32 vector on "
                             f"{x.device}")
        n_tiles = f_tiles.numel()
    g_idx, g_pk, g_sc = ((gate.block_idx, *sparse_operands(gate)) if gated
                         else (None, None, None))
    u_pk, u_sc = sparse_operands(up)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch(x2, hidden, n):
        if not n_tiles:
            return
        x2 = aligned(x2, 16)
        fn = _build.function("ffn_fused_sparse", "ffn_fused_sparse_launch",
                             _SPARSE_ARGTYPES)
        rc = fn(x2.data_ptr(), ptr(f_tiles), n_tiles, ptr(g_idx), ptr(g_pk),
                ptr(g_sc), up.block_idx.data_ptr(), u_pk.data_ptr(),
                u_sc.data_ptr(), ptr(ub), hidden.data_ptr(), n, d, f,
                up.kept_blocks, _ACT_CODES[activation], DTYPE_CODES[x.dtype],
                _build.stream_ptr(x.device))
        _build.check("ffn_fused_sparse", rc)
        _build.launches[SPARSE_NAME if gated else SPARSE_GELU_NAME] += 1
    return _hidden_launch(x, d, f, launch)


def fused_variant(gate, up, down, activation: str) -> str | None:
    """Which CUDA FFN path takes these weights (port of the reference's
    ``fused_variant``, a static choice from types and flags): ``"quant"``
    (all W4A16), ``"sparse"`` (sparse gate/up; down dense-quantized or
    tile_uniform sparse), ``"fp"`` (all 16-bit floating tensors, d, d_ff
    and out multiples of 128, as the reference's ``:715-717``), or
    ``None``."""
    gated = activation in GATED_ACTIVATIONS
    ws = (gate, up, down) if gated else (up, down)
    if all(isinstance(w, QuantizedTensor) for w in ws):
        # the bf16 tile takes 32-, 64- and 128-row groups (the MoE experts'
        # groups); the launch refuses a group its dtype or epilogue does not
        # take
        if all(w.group_size in MMA_GROUP_SIZES for w in ws):
            return "quant"
        return None
    if all(isinstance(w, torch.Tensor) and w.is_floating_point()
           and w.dim() == 2 for w in ws):
        (d, f), out_f = up.shape, down.shape[1]
        if (down.shape[0] != f or (gated and gate.shape != up.shape)
                or d % GROUP_SIZE or f % GROUP_SIZE or out_f % GROUP_SIZE):
            return None
        return "fp"
    if (isinstance(up, SparseQuantizedTensor)
            and (not gated or isinstance(gate, SparseQuantizedTensor))):
        if gated and (gate.shape != up.shape
                      or gate.kept_blocks != up.kept_blocks):
            return None
        if isinstance(down, QuantizedTensor):
            return "sparse"
        if isinstance(down, SparseQuantizedTensor) and down.tile_uniform:
            return "sparse"
    return None


def ffn_fused_sparse_cuda(x, gate, up, down, *, activation="swiglu",
                          up_bias=None, down_bias=None) -> torch.Tensor:
    """The sparse CUDA path: gate/up/activation (or gelu of up with its
    bias) for the f-tiles ``down`` keeps, then the down projection, with
    ``down_bias`` in f32 before the cast, through the sparse W4A16 kernel
    (its own ``block_idx`` reads exactly those tiles) or, for a dense down,
    the W4A16 kernel."""
    _check_gated_bias(activation, up_bias, down_bias)
    f_tiles = kept_f_tiles(down)
    hidden = ffn_gate_up_sparse_cuda(x, gate, up, activation, f_tiles,
                                     up_bias)
    if f_tiles is None:
        return w4a16_matmul_cuda(hidden, down, down_bias)
    return sparse_w4a16_matmul_cuda(hidden, down, down_bias)


def ffn_fused_dense_cuda(x, gate, up, down, *, activation="swiglu",
                         up_bias=None, down_bias=None) -> torch.Tensor:
    """Kernel 6, the fp path: ``csrc/ffn_fused_dense.cu`` for the hidden,
    then ``csrc/dense_matmul.cu`` for down with ``down_bias`` added in f32
    before the cast."""
    _check_gated_bias(activation, up_bias, down_bias)
    hidden = ffn_dense_gate_up_cuda(x, gate, up, activation, up_bias)
    return dense_matmul_cuda(hidden, down, down_bias)


def ffn_w4a16_cuda(x, gate, up, down, *, activation="swiglu", up_bias=None,
                   down_bias=None) -> torch.Tensor:
    """The CUDA path, chosen by :func:`fused_variant`; any other weight mix
    raises."""
    _check_gated_bias(activation, up_bias, down_bias)
    variant = fused_variant(gate, up, down, activation)
    if variant == "quant":
        hidden = ffn_gate_up_cuda(x, gate, up, activation, up_bias)
        return w4a16_matmul_cuda(hidden, down, down_bias)
    if variant == "sparse":
        return ffn_fused_sparse_cuda(x, gate, up, down, activation=activation,
                                     up_bias=up_bias, down_bias=down_bias)
    if variant == "fp":
        return ffn_fused_dense_cuda(x, gate, up, down, activation=activation,
                                    up_bias=up_bias, down_bias=down_bias)
    raise NotImplementedError(
        "the CUDA FFN takes W4A16 gate/up/down, block-sparse gate/up with "
        "a dense-quantized or tile_uniform sparse down, or all-16-bit "
        "weights with widths that are multiples of 128; other mixes (16-bit "
        "and packed weights together, a non-tile_uniform sparse down) go "
        "through ops.ffn_w4a16's plain path on CPU only")
