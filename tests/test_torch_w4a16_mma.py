"""How the bf16 W4A16 tensor-core tile reads the reference's nibble layout,
modelled on the CPU.

``csrc/w4a16_mma_tile.cuh`` feeds ``mma.sync`` m16n8k16 straight from the
packed bytes (no repack): k16 step s of a 128-row group takes rows 8s..8s+7
(the low nibbles of packed rows 8s..8s+7) and 64+8s..64+8s+7 (their high
nibbles), a lane's two B registers come from the same two packed bytes, and
the A fragment is x's 16-byte chunks s and 8 + s.  These tests rebuild the
fragments with the kernel's own bit operations in numpy, hold them against
``unpack_int4``, and hold a product summed in the kernel's order against the
plain version and the reference's Pallas kernel (interpret mode) on the same
numpy inputs.  Kernel 2's bf16 gate/up stage runs the same tile with two
weights against one staged x tile (shared A fragments, one partial and one
accumulator per weight) and the activation on the two f32 sums; the last
tests model that order against the plain stage and the reference's fused
FFN.  The kernels themselves are held against the plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro.kernels.ffn_fused import ffn_fused_w4a16_pallas  # noqa: E402
from repro.kernels.w4a16_matmul import w4a16_matmul_pallas  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.quant import GROUP_SIZE, unpack_int4  # noqa: E402
from repro_torch.kernels.ffn_fused import ffn_gate_up_torch  # noqa: E402
from repro_torch.kernels.w4a16_matmul import w4a16_matmul_torch  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _dequant_pair(q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``w4_dequant_pair``: the nibbles at bits 0-3 and 16-19 of q as bf16
    (nibble XOR 8 in the mantissa of 128.0), then the bf16x2 fma x * 1 - 136
    (exact: small integers)."""
    v = (q & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    lo = _bf16_bits_to_f32(v & np.uint32(0xFFFF))
    hi = _bf16_bits_to_f32(v >> np.uint32(16))
    return lo - 136.0, hi - 136.0


def _b_fragments(packed_group: np.ndarray, s: int, t: int):
    """The lane values of k16 step s for lanes with t = lane % 4, every
    column: bytes of packed rows 8s + 2t and 8s + 2t + 1 placed as
    ``__byte_perm(w0, w1, j | j << 4 | (4 + j) << 8 | (4 + j) << 12)`` does
    (bits 0-15 and 16-31), b0 from q and b1 from q >> 4.  Returns
    ``(b0 pair, b1 pair)``: the B values at k = 2t, 2t + 1 and 8 + 2t,
    8 + 2t + 1."""
    w0 = packed_group[8 * s + 2 * t].astype(np.uint32)
    w1 = packed_group[8 * s + 2 * t + 1].astype(np.uint32)
    eight = np.uint32(8)
    q = w0 | (w0 << eight) | (w1 << 2 * eight) | (w1 << 3 * eight)
    return _dequant_pair(q), _dequant_pair(q >> np.uint32(4))


def test_dequant_pair_is_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint32)
    q = b | (b[::-1] << np.uint32(16))

    def signed(n):
        return ((n.astype(np.int32) ^ 8) - 8).astype(np.float32)

    lo, hi = _dequant_pair(q)
    np.testing.assert_array_equal(lo, signed(b & 0xF))
    np.testing.assert_array_equal(hi, signed(b[::-1] & 0xF))
    lo, hi = _dequant_pair(q >> np.uint32(4))
    np.testing.assert_array_equal(lo, signed(b >> 4))
    np.testing.assert_array_equal(hi, signed((b[::-1] >> 4) & 0xF))


def _weights(rng, in_f, out_f):
    """The reference's quantized weight and the port's, via interop."""
    w = rng.normal(size=(in_f, out_f)).astype(np.float32) / np.sqrt(in_f)
    jqt = jax_quantize(jnp.asarray(w))
    leaf = type("QT", (), {"packed": np.asarray(jqt.packed),
                           "scales": np.asarray(jqt.scales),
                           "shape": jqt.shape,
                           "group_size": jqt.group_size})()
    return jqt, interop.params_from_numpy({"w": leaf}, "cpu")["w"]


def test_k16_steps_take_the_rows_the_note_names():
    """Step s, lane t of each group: b0 holds rows 8s + 2t and + 1, b1 rows
    64 + 8s + 2t and + 1, as ``unpack_int4`` gives them; over the 8 steps
    every row of the group is taken exactly once."""
    rng = np.random.default_rng(0)
    _, tqt = _weights(rng, 3 * GROUP_SIZE, 40)
    packed = tqt.packed.numpy()
    w = unpack_int4(tqt.packed).numpy().astype(np.float32)
    for g in range(3):
        pg = packed[g * 64:(g + 1) * 64]
        wg = w[g * GROUP_SIZE:(g + 1) * GROUP_SIZE]
        seen = []
        for s in range(8):
            for t in range(4):
                (b00, b01), (b10, b11) = _b_fragments(pg, s, t)
                r = 8 * s + 2 * t
                np.testing.assert_array_equal(b00, wg[r])
                np.testing.assert_array_equal(b01, wg[r + 1])
                np.testing.assert_array_equal(b10, wg[64 + r])
                np.testing.assert_array_equal(b11, wg[64 + r + 1])
                seen += [r, r + 1, 64 + r, 64 + r + 1]
        assert sorted(seen) == list(range(GROUP_SIZE))


@pytest.mark.parametrize("tokens", [1, 17])
def test_kernel_order_matches_plain_and_reference(tokens):
    """The product summed as the kernel sums it: per group, from +0 over
    the 8 k16 steps, A = x's chunks s and 8 + s, B from the packed bytes;
    the f32 partial times the group's scale added to the running sum in
    group order.  It equals the plain version and the reference's Pallas
    kernel (interpret mode) within the reference's f32 tolerance."""
    rng = np.random.default_rng(tokens)
    in_f, out_f = 2 * GROUP_SIZE, 72
    jqt, tqt = _weights(rng, in_f, out_f)
    x = rng.normal(size=(tokens, in_f)).astype(np.float32)
    packed = tqt.packed.numpy()
    scales = tqt.scales.to(torch.float32).numpy()
    acc = np.zeros((tokens, out_f), np.float32)
    for g in range(in_f // GROUP_SIZE):
        pg = packed[g * 64:(g + 1) * 64]
        xg = x[:, g * GROUP_SIZE:(g + 1) * GROUP_SIZE]
        part = np.zeros((tokens, out_f), np.float32)
        for s in range(8):
            a = np.concatenate([xg[:, 8 * s:8 * s + 8],
                                xg[:, 64 + 8 * s:64 + 8 * s + 8]], axis=1)
            b = np.zeros((16, out_f), np.float32)
            for t in range(4):
                (b00, b01), (b10, b11) = _b_fragments(pg, s, t)
                b[2 * t], b[2 * t + 1] = b00, b01
                b[8 + 2 * t], b[8 + 2 * t + 1] = b10, b11
            part = part + a @ b
        acc = acc + part * scales[g]
    want = w4a16_matmul_torch(torch.from_numpy(x), tqt).numpy()
    np.testing.assert_allclose(acc, want, **TOL)
    np.testing.assert_allclose(
        acc, np.asarray(w4a16_matmul_pallas(jnp.asarray(x), jqt,
                                            interpret=True)), **TOL)


def _tile_sums(x, weights):
    """The W4A16 tile's f32 sums for one or more weights against the same
    x, in its order: for each 128-row group, each weight's partial from +0
    over the 8 k16 steps (A = x's chunks s and 8 + s, shared by the
    weights; B from that weight's packed bytes), then times that weight's
    group scale, added to its running sum in group order."""
    tokens, in_f = x.shape
    out_f = weights[0].shape[1]
    accs = [np.zeros((tokens, out_f), np.float32) for _ in weights]
    packed = [w.packed.numpy() for w in weights]
    scales = [w.scales.to(torch.float32).numpy() for w in weights]
    for g in range(in_f // GROUP_SIZE):
        xg = x[:, g * GROUP_SIZE:(g + 1) * GROUP_SIZE]
        parts = [np.zeros((tokens, out_f), np.float32) for _ in weights]
        for s in range(8):
            a = np.concatenate([xg[:, 8 * s:8 * s + 8],
                                xg[:, 64 + 8 * s:64 + 8 * s + 8]], axis=1)
            for wi, pk in enumerate(packed):
                pg = pk[g * 64:(g + 1) * 64]
                b = np.zeros((16, out_f), np.float32)
                for t in range(4):
                    (b00, b01), (b10, b11) = _b_fragments(pg, s, t)
                    b[2 * t], b[2 * t + 1] = b00, b01
                    b[8 + 2 * t], b[8 + 2 * t + 1] = b10, b11
                parts[wi] = parts[wi] + a @ b
        for wi in range(len(weights)):
            accs[wi] = accs[wi] + parts[wi] * scales[wi][g]
    return accs


def _epilogue(activation, sums, up_bias):
    """common.cuh's epilogue on the f32 sums (gate, up) or (up,)."""
    def gelu_tanh(v):
        return 0.5 * v * (1.0 + np.tanh(0.7978845608028654
                                        * (v + 0.044715 * v ** 3)))
    if activation == "gelu":
        return gelu_tanh(sums[0] + up_bias).astype(np.float32)
    g, u = sums
    act = g / (1.0 + np.exp(-g)) if activation == "swiglu" else gelu_tanh(g)
    return (act * u).astype(np.float32)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("tokens", [1, 17])
def test_gate_up_tile_order_matches_plain_and_reference(activation, tokens):
    """Kernel 2's bf16 stage modelled in the tile's order (gate and up as
    two weights of one tile, or up alone for gelu with its f32 bias): each
    weight's sums are the one-weight tile's, bitwise, and the activated
    hidden equals the plain stage; followed by the down projection in f32
    it equals the reference's fused FFN (interpret mode), all within the
    reference's f32 tolerance."""
    rng = np.random.default_rng(40 + tokens)
    d, f = 2 * GROUP_SIZE, 2 * GROUP_SIZE
    gated = activation != "gelu"
    gj, gt = _weights(rng, d, f)
    uj, ut = _weights(rng, d, f)
    dj, dt = _weights(rng, f, d)
    x = rng.normal(size=(tokens, d)).astype(np.float32)
    ub = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    ws = (gt, ut) if gated else (ut,)
    sums = _tile_sums(x, ws)
    for wi, w in enumerate(ws):
        np.testing.assert_array_equal(sums[wi], _tile_sums(x, (w,))[0])
    hidden = _epilogue(activation, sums, ub)
    tx = torch.from_numpy(x)
    tub = None if gated else torch.from_numpy(ub)
    np.testing.assert_allclose(
        hidden, ffn_gate_up_torch(tx, gt if gated else None, ut, activation,
                                  tub).numpy(), **TOL)
    out = w4a16_matmul_torch(torch.from_numpy(hidden), dt).numpy()
    jkw = {} if gated else {"up_bias": jnp.asarray(ub)}
    want = ffn_fused_w4a16_pallas(jnp.asarray(x), gj if gated else None, uj,
                                  dj, activation=activation, interpret=True,
                                  **jkw)
    np.testing.assert_allclose(out, np.asarray(want), **TOL)
