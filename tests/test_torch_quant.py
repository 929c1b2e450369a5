"""The port's int4 packing, quantization and compiler against the JAX
reference: bit-exact, including out widths that are not multiples of 512,
the log-scale sparse strategies, and the numpy interchange round trip."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import sparsity as jsparsity  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize_model  # noqa: E402
from repro.core.compiler import quantized_bytes as jax_quantized_bytes  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import sparsity as tsparsity  # noqa: E402
from repro_torch.core.compiler import (  # noqa: E402
    TokenBuckets, quantize_model, quantized_bytes)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (in, out): out widths 384, 200, 1000 and 4 are not multiples of 512
SHAPES = [(128, 384), (256, 200), (512, 1000), (128, 4)]


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.05
    jqt = jquant.quantize(jnp.asarray(w))
    tqt = tquant.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jqt.packed), tqt.packed.numpy())
    np.testing.assert_array_equal(_f32(jqt.scales),
                                  tqt.scales.float().numpy())
    assert tqt.shape == tuple(jqt.shape) and tqt.group_size == 128
    np.testing.assert_array_equal(
        _f32(jquant.dequantize(jqt, jnp.float32)),
        tquant.dequantize(tqt, torch.float32).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_unpack_bitwise(shape):
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, size=shape).astype(np.int8)
    packed = tquant.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(jquant.pack_int4(jnp.asarray(q))),
                                  packed.numpy())
    # byte r of each 128-row group: row r low nibble, row r + 64 high nibble
    assert int(packed[0, 0]) == (int(q[0, 0]) & 0xF) | \
        ((int(q[64, 0]) & 0xF) << 4)
    raw = rng.integers(0, 256, size=(shape[0] // 2, shape[1])).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jquant.unpack_int4(jnp.asarray(raw))),
        tquant.unpack_int4(torch.from_numpy(raw)).numpy())
    np.testing.assert_array_equal(
        tquant.unpack_int4(packed).numpy(), q)


def test_stacked_quantize_equals_per_matrix():
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 256, 200)).astype(np.float32))
    stacked = tquant.quantize(w)
    for i in range(3):
        one = tquant.quantize(w[i])
        assert torch.equal(stacked[i].packed, one.packed)
        assert torch.equal(stacked[i].scales, one.scales)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("qwen-7b")
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    return params, jax_quantize_model(params, "dense")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_model_matches_reference(jax_params):
    dense, jq = jax_params
    tq = quantize_model(interop.params_from_numpy(
        jax.tree.map(np.asarray, dense), "cpu"), "dense")
    tl = dict(_leaves(tq))
    for name, leaf in _leaves(jq):
        got = tl[name]
        if isinstance(leaf, jquant.QuantizedTensor):
            assert isinstance(got, tquant.QuantizedTensor), name
            np.testing.assert_array_equal(np.asarray(leaf.packed),
                                          got.packed.numpy())
            np.testing.assert_array_equal(_f32(leaf.scales),
                                          got.scales.float().numpy())
        else:
            assert isinstance(got, torch.Tensor), name
            np.testing.assert_array_equal(_f32(leaf), got.float().numpy())
    assert quantized_bytes(tq) == jax_quantized_bytes(jq)


def test_interop_roundtrip_preserves_every_leaf(jax_params):
    _, jq = jax_params
    src = jax.tree.map(np.asarray, jq)
    port = interop.params_from_numpy(src, "cpu")
    back = interop.params_to_numpy(port)
    bl = dict(_leaves(back))
    n = 0
    for name, leaf in _leaves(src):
        got = bl[name]
        if isinstance(leaf, jquant.QuantizedTensor):
            for attr in ("packed", "scales"):
                a, b = getattr(leaf, attr), getattr(got, attr)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
            assert tuple(leaf.shape) == got.shape
            assert leaf.group_size == got.group_size
        else:
            assert leaf.dtype == got.dtype and leaf.shape == got.shape, name
            np.testing.assert_array_equal(leaf, got)
        n += 1
    assert n == len(bl)


def test_interop_bfloat16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = interop.params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# d_model 1024 and d_ff 768 make wo, gate and up block-sparse; down (6
# blocks, m = 2) is tile_uniform sparse at 0.5 and dense-quantized at 0.25
SPARSE_OVERRIDES = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=2,
                        head_dim=128, d_ff=768, vocab_size=256)
SPARSE_KINDS = {"strategy1": ("sparse", "sparse"),
                "strategy2": ("sparse", "sparse"),
                "strategy3": ("sparse", "dense")}     # (gate/up, down)


@pytest.fixture(scope="module")
def jax_sparse_base():
    cfg = jax_smoke_config("qwen-7b", **SPARSE_OVERRIDES)
    return japi.init_params(cfg, jax.random.PRNGKey(0))


def _assert_leaves_equal(jtree, ttree):
    tl = dict(_leaves(ttree))
    for name, leaf in _leaves(jtree):
        got = tl[name]
        if isinstance(leaf, jsparsity.SparseQuantizedTensor):
            assert isinstance(got, tsparsity.SparseQuantizedTensor), name
            for attr in ("shape", "density", "group_size", "tile_uniform"):
                assert getattr(got, attr) == getattr(leaf, attr), (name, attr)
            np.testing.assert_array_equal(np.asarray(leaf.block_idx),
                                          got.block_idx.numpy())
        elif isinstance(leaf, jquant.QuantizedTensor):
            assert isinstance(got, tquant.QuantizedTensor), name
        else:
            assert isinstance(got, torch.Tensor), name
            np.testing.assert_array_equal(_f32(leaf), got.float().numpy())
            continue
        np.testing.assert_array_equal(np.asarray(leaf.packed),
                                      got.packed.numpy())
        np.testing.assert_array_equal(_f32(leaf.scales),
                                      got.scales.float().numpy())


@pytest.mark.parametrize("strategy", ["strategy1", "strategy2", "strategy3"])
def test_sparse_strategies_match_reference(jax_sparse_base, strategy):
    """Same leaf types, flags and arrays (bitwise), same byte count."""
    jq = jax_quantize_model(jax_sparse_base, strategy)
    tq = quantize_model(interop.params_from_numpy(
        jax.tree.map(np.asarray, jax_sparse_base), "cpu"), strategy)
    _assert_leaves_equal(jq, tq)
    assert quantized_bytes(tq) == jax_quantized_bytes(jq)
    mlp = tq["blocks"]["mlp"]
    kinds = tuple("sparse" if isinstance(mlp[k], tsparsity.
                                         SparseQuantizedTensor) else "dense"
                  for k in ("gate", "down"))
    assert kinds == SPARSE_KINDS[strategy]
    assert isinstance(tq["blocks"]["attn"]["wo"],
                      tsparsity.SparseQuantizedTensor)
    assert isinstance(tq["blocks"]["attn"]["wq"], tquant.QuantizedTensor)
    if kinds[1] == "sparse":
        assert mlp["down"].tile_uniform and not mlp["gate"].tile_uniform


def test_interop_roundtrip_preserves_sparse_leaves(jax_sparse_base):
    """numpy -> port -> numpy keeps every sparse leaf's arrays and flags
    (PR 11 read a sparse leaf as a dense QuantizedTensor)."""
    jq = jax.tree.map(np.asarray, jax_quantize_model(jax_sparse_base,
                                                     "strategy2"))
    port = interop.params_from_numpy(jq, "cpu")
    back = interop.params_to_numpy(port)
    _assert_leaves_equal(jq, interop.params_from_numpy(back, "cpu"))
    src = jq["blocks"]["mlp"]["down"]
    got = back["blocks"]["mlp"]["down"]
    for attr in ("packed", "scales", "block_idx"):
        a, b = getattr(src, attr), getattr(got, attr)
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert (got.shape, got.density, got.group_size, got.tile_uniform) == (
        tuple(src.shape), src.density, src.group_size, src.tile_uniform)


def test_none_strategy_is_identity():
    p = {"wq": torch.zeros(128, 128)}
    assert quantize_model(p, "none") is p


def test_token_buckets():
    b = TokenBuckets(max_tokens=64)
    assert [b.bucket(n) for n in (1, 16, 17, 33, 64)] == [16, 16, 32, 64, 64]
    assert b.all_buckets() == [16, 32, 64]
    with pytest.raises(ValueError):
        b.bucket(65)
