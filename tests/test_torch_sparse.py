"""The port's log-scale sparse W4A16 path against the JAX reference on the
CPU: block selection and packing (bitwise), the plain versions of the two
sparse kernels, the model's steps and the engine's token streams.

The models are ``qwen-7b-smoke`` and ``starcoder2-7b-smoke`` (LayerNorm,
the ungated gelu FFN with biases) at d_model 1024, 8 query heads over 2 KV
heads of 128, d_ff 768, vocab 256, 2 layers, f32; weights from the
reference (``init_params`` at PRNGKey(0); starcoder2's biases and LayerNorm
shifts made random from a numpy seed, since they start at zero; then
``quantize_model``) reach the port through numpy and
``repro_torch.interop``.  Under strategy1-3 ``wo``, ``gate`` and ``up`` are
block-sparse; ``down`` has 6 blocks, so it groups them in pairs (m = 2) as
qwen-7b's 86-block ``down`` does: a tile_uniform sparse tensor at density
0.5 (strategy1, 2) and a dense ``QuantizedTensor`` at 0.25 (strategy3,
where ``round(0.5) == 0``).  Both branches of the sparse FFN run, gated and
gelu.

Tolerances: kernels in f32 at 2e-4, as the reference's own kernel tests
(sums taken in another order by another library); logits and caches at
1e-4, as ``test_torch_model.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import sparsity as jsparsity  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import sparsity as tsparsity  # noqa: E402
from repro_torch.core.compiler import quantize_model  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ffn_fused, ops  # noqa: E402
from repro_torch.kernels.ffn_fused import ffn_w4a16_torch  # noqa: E402
from repro_torch.kernels.sparse_w4a16 import (  # noqa: E402
    sparse_matmul_f32, sparse_w4a16_matmul_torch)
from repro_torch.kernels.w4a16_matmul import w4a16_matmul_torch  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors.  On a loaded
    machine (the suite runs test files in parallel) intra-op threads wait
    for each other far longer than the work takes, so these tests run the
    port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
OVERRIDES = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=2,
                 head_dim=128, d_ff=768, vocab_size=256)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _assert_sparse_equal(jst, tst):
    np.testing.assert_array_equal(np.asarray(jst.packed), tst.packed.numpy())
    np.testing.assert_array_equal(_f32(jst.scales), tst.scales.float().numpy())
    np.testing.assert_array_equal(np.asarray(jst.block_idx),
                                  tst.block_idx.numpy())
    assert tst.block_idx.dtype == torch.int32
    assert tuple(jst.shape) == tst.shape
    assert (jst.density, jst.tile_uniform) == (tst.density, tst.tile_uniform)


def _port(jleaf):
    return interop.params_from_numpy(
        {"w": jax.tree.map(np.asarray, jleaf)}, "cpu")["w"]


def _weight(rng, in_f, out_f):
    return rng.normal(size=(in_f, out_f)).astype(np.float32) / np.sqrt(in_f)


def _sparse(rng, in_f, out_f, density, m=8, tile_uniform=False):
    jst = jsparsity.block_sparsify_quantize(
        jnp.asarray(_weight(rng, in_f, out_f)), density, blocks_per_group=m,
        tile_uniform=tile_uniform)
    return jst, _port(jst)


# -- block selection and packing ---------------------------------------------

@pytest.mark.parametrize("tile_uniform", [False, True])
@pytest.mark.parametrize("density", [0.5, 0.25, 0.125])
def test_block_sparsify_quantize_bitwise(density, tile_uniform):
    w = _weight(np.random.default_rng(0), 1024, 384)
    jst = jsparsity.block_sparsify_quantize(jnp.asarray(w), density,
                                            tile_uniform=tile_uniform)
    tst = tsparsity.block_sparsify_quantize(torch.from_numpy(w), density,
                                            tile_uniform=tile_uniform)
    _assert_sparse_equal(jst, tst)
    assert tst.kept_blocks == int(density * 8) * 1024 // (128 * 8)
    assert tst.nbytes_model == jst.nbytes_model
    np.testing.assert_array_equal(
        np.asarray(jsparsity.sparse_dequantize(jst, jnp.float32)),
        tsparsity.sparse_dequantize(tst, torch.float32).numpy())
    if tile_uniform:
        assert bool((tst.block_idx == tst.block_idx[:1]).all())


def test_stacked_layers_quantize_matrix_by_matrix():
    """A stacked (layers, in, out) leaf: the reference vmaps the selection,
    the port loops; each layer keeps its own blocks, bitwise."""
    w = np.random.default_rng(1).normal(size=(3, 768, 256)).astype(
        np.float32)
    jst = jax_quantize({"down": jnp.asarray(w)}, "strategy1")["down"]
    tst = quantize_model({"down": torch.from_numpy(w)}, "strategy1")["down"]
    assert tst.tile_uniform and tst.packed.shape[0] == 3
    _assert_sparse_equal(jst, tst)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda s: jsparsity.sparse_dequantize(
            s, jnp.float32))(jst)),
        tsparsity.sparse_dequantize(tst, torch.float32).numpy())
    one = tsparsity.block_sparsify_quantize(torch.from_numpy(w[1]), 0.5,
                                            blocks_per_group=2,
                                            tile_uniform=True)
    assert torch.equal(tst[1].block_idx, one.block_idx)
    assert torch.equal(tst[1].packed, one.packed)


# -- the plain versions of the sparse kernels ---------------------------------

@pytest.mark.parametrize("tile_uniform", [False, True])
@pytest.mark.parametrize("tokens", [1, 33])
def test_sparse_matmul_plain_matches_reference(tokens, tile_uniform):
    rng = np.random.default_rng(tokens)
    jst, tst = _sparse(rng, 1024, 384, 0.5, tile_uniform=tile_uniform)
    x = rng.normal(size=(tokens, 1024)).astype(np.float32)
    got = ops.sparse_w4a16_matmul(torch.from_numpy(x), tst).numpy()
    jx = jnp.asarray(x)
    for impl in ("xla", "pallas"):
        np.testing.assert_allclose(
            got, np.asarray(jops.sparse_w4a16_matmul(jx, jst, impl=impl)),
            **KERNEL_TOL)
    np.testing.assert_allclose(
        got, ops.sparse_w4a16_matmul(torch.from_numpy(x), tst,
                                     impl="ref").numpy(), **KERNEL_TOL)
    assert np.array_equal(got, sparse_matmul_f32(torch.from_numpy(x),
                                                 tst).numpy())


@pytest.mark.parametrize("tokens", [1, 33])
def test_sparse_matmul_plain_with_bias_matches_reference(tokens):
    """Kernel 4's plain version with the f32 bias a sparse down projection
    of the gelu FFN carries: the reference's product, then the bias added
    to the f32 sum before the cast (the reference's fused kernel adds its
    down bias so)."""
    rng = np.random.default_rng(10 + tokens)
    jst, tst = _sparse(rng, 768, 1024, 0.5, m=2, tile_uniform=True)
    x = rng.normal(size=(tokens, 768)).astype(np.float32)
    b = rng.normal(size=(1024,)).astype(np.float32)
    got = sparse_w4a16_matmul_torch(torch.from_numpy(x), tst,
                                    torch.from_numpy(b))
    assert torch.equal(got, sparse_matmul_f32(torch.from_numpy(x), tst)
                       + torch.from_numpy(b))
    jx = jnp.asarray(x)
    for impl in ("xla", "pallas"):
        want = np.asarray(jops.sparse_w4a16_matmul(jx, jst, impl=impl)) + b
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    bf = sparse_w4a16_matmul_torch(torch.from_numpy(x).bfloat16(), tst,
                                   torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("down_kind", ["sparse", "dense"])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("tokens", [3, 40])
def test_sparse_ffn_plain_matches_reference(tokens, activation, down_kind):
    """d 1024, d_ff 768: sparse gate/up (gelu: up alone, with random up and
    down biases) at density 0.25, down either the tile_uniform sparse
    tensor (m = 2) or dense-quantized, as the compiler's strategies 2 and 3
    make them."""
    rng = np.random.default_rng(tokens)
    gj, gt = _sparse(rng, 1024, 768, 0.25)
    uj, ut = _sparse(rng, 1024, 768, 0.25)
    if down_kind == "sparse":
        dj, dt = _sparse(rng, 768, 1024, 0.5, m=2, tile_uniform=True)
    else:
        from repro.core.quant import quantize as jquantize
        dj = jquantize(jnp.asarray(_weight(rng, 768, 1024)))
        dt = _port(dj)
    x = rng.normal(size=(tokens, 1024)).astype(np.float32)
    jb, tb = {}, {}
    if activation == "gelu":
        gj = gt = None
        for name, n in (("up_bias", 768), ("down_bias", 1024)):
            b = rng.normal(size=(n,)).astype(np.float32) * 0.5
            jb[name], tb[name] = jnp.asarray(b), torch.from_numpy(b)
    got = ffn_w4a16_torch(torch.from_numpy(x), gt, ut, dt,
                          activation=activation, **tb).numpy()
    assert ffn_fused.fused_variant(gt, ut, dt, activation) == "sparse"
    jx = jnp.asarray(x)
    for impl in ("xla", "pallas", "ref"):
        want = jops.ffn_w4a16(jx, gj, uj, dj, activation=activation,
                              impl=impl, **jb)
        np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(
        got, ops.ffn_w4a16(torch.from_numpy(x), gt, ut, dt,
                           activation=activation, impl="ref", **tb).numpy(),
        **KERNEL_TOL)
    # the card's two stages, in their plain versions: the kept f-tiles'
    # hidden, then down over exactly those tiles with the down bias
    tiles = ffn_fused.kept_f_tiles(dt)
    hidden = torch.zeros(tokens, 768)
    kept = (torch.arange(768) if tiles is None else
            (tiles.long()[:, None] * 128 + torch.arange(128)).reshape(-1))
    hidden[:, kept] = ffn_fused.ffn_gate_up_sparse_torch(
        torch.from_numpy(x), gt, ut, activation, tiles, tb.get("up_bias"))
    down = (sparse_w4a16_matmul_torch(hidden, dt, tb.get("down_bias"))
            if tiles is not None else
            w4a16_matmul_torch(hidden, dt, tb.get("down_bias")))
    assert np.array_equal(down.numpy(), got)


def test_sparse_gate_up_plain_computes_only_kept_tiles():
    """The plain version of the sparse gate/up kernel, restricted to the
    f-tiles a tile_uniform down keeps, equals those columns of the whole
    hidden."""
    rng = np.random.default_rng(4)
    _, gate = _sparse(rng, 1024, 768, 0.25)
    _, up = _sparse(rng, 1024, 768, 0.25)
    _, down = _sparse(rng, 768, 1024, 0.5, m=2, tile_uniform=True)
    x = torch.from_numpy(rng.normal(size=(5, 1024)).astype(np.float32))
    tiles = ffn_fused.kept_f_tiles(down)
    assert tiles.tolist() == down.block_idx[0].tolist() and len(tiles) == 3
    cols = (tiles.long()[:, None] * 128 + torch.arange(128)).reshape(-1)
    whole = ffn_fused.ffn_gate_up_sparse_torch(x, gate, up, "swiglu", None)
    kept = ffn_fused.ffn_gate_up_sparse_torch(x, gate, up, "swiglu", tiles)
    assert whole.shape == (5, 768) and kept.shape == (5, 384)
    np.testing.assert_allclose(kept.numpy(), whole[:, cols].numpy(),
                               rtol=1e-6, atol=1e-6)
    # the gelu stage takes the up bias of the real hidden columns
    ub = torch.from_numpy(rng.normal(size=(768,)).astype(np.float32))
    whole = ffn_fused.ffn_gate_up_sparse_torch(x, None, up, "gelu", None, ub)
    kept = ffn_fused.ffn_gate_up_sparse_torch(x, None, up, "gelu", tiles, ub)
    assert kept.shape == (5, 384)
    np.testing.assert_allclose(kept.numpy(), whole[:, cols].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_fused_variant_and_refused_mixes():
    rng = np.random.default_rng(5)
    _, gate = _sparse(rng, 256, 256, 0.5, m=2)
    _, up = _sparse(rng, 256, 256, 0.5, m=2)
    _, down_tu = _sparse(rng, 256, 256, 0.5, m=2, tile_uniform=True)
    _, down_free = _sparse(rng, 256, 256, 0.5, m=2)
    qt = _port(jax_quantize({"down": jnp.asarray(_weight(rng, 256, 256))},
                            "dense")["down"])
    dense = torch.zeros(256, 256)
    fv = ffn_fused.fused_variant
    assert fv(qt, qt, qt, "swiglu") == "quant"
    assert fv(gate, up, down_tu, "swiglu") == "sparse"
    assert fv(gate, up, qt, "geglu") == "sparse"
    assert fv(None, up, down_tu, "gelu") == "sparse"      # ungated gelu
    assert fv(None, up, qt, "gelu") == "sparse"
    assert fv(None, up, down_free, "gelu") is None
    assert fv(gate, up, down_free, "swiglu") is None    # not tile_uniform
    assert fv(qt, up, qt, "swiglu") is None
    assert fv(dense, dense, dense, "swiglu") == "fp"        # kernel 6
    assert fv(dense[:, :200], dense[:, :200], dense[:200], "swiglu") is None
    x = torch.zeros(2, 256)
    with pytest.raises(NotImplementedError, match="tile_uniform"):
        ops.ffn_w4a16(x, gate, up, down_free, impl="cuda")


def test_mlp_apply_routes_sparse_weights_to_the_device_path(monkeypatch):
    """A sparse MLP takes ``impl="auto"`` (the kernels on the card), not
    the dense oracle."""
    rng = np.random.default_rng(6)
    p = {k: _sparse(rng, 256, 256, 0.5, m=2)[1] for k in ("gate", "up")}
    p["down"] = _sparse(rng, 256, 256, 0.5, m=2, tile_uniform=True)[1]
    seen = []
    real = ops.ffn_w4a16

    def spy(*a, impl="auto", **kw):
        seen.append(impl)
        return real(*a, impl=impl, **kw)

    monkeypatch.setattr(ops, "ffn_w4a16", spy)
    cfg = get_smoke_config("qwen-7b", d_model=256, d_ff=256)
    x = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    out = layers.mlp_apply(cfg, p, x)
    assert seen == ["auto"]
    assert torch.equal(out, ffn_w4a16_torch(x, p["gate"], p["up"],
                                            p["down"]))


def test_card_dispatch_reaches_the_sparse_gelu_kernels(monkeypatch):
    """On the card (``ops._resolve`` patched to "cuda"), a gelu MLP with
    sparse up and a tile_uniform sparse or dense-quantized down reaches
    ``ffn_gate_up_sparse_cuda`` with the up bias and the f-tiles down
    keeps, then the down kernel with the down bias; no plain version or
    oracle runs."""
    rng = np.random.default_rng(7)
    calls = []

    def gate_up(x, gate, up, activation, f_tiles, up_bias=None):
        calls.append(("ffn_fused_sparse_gelu", gate, activation, f_tiles,
                      up_bias))
        return torch.zeros(*x.shape[:-1], up.shape[1])

    def down_stub(name):
        def fn(x, w, bias=None):
            calls.append((name, bias))
            return torch.zeros(*x.shape[:-1], w.shape[1])
        return fn

    def refuse(*a, **k):
        raise AssertionError("a plain version or the oracle ran on the "
                             "card's path")
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ffn_fused, "ffn_gate_up_sparse_cuda", gate_up)
    monkeypatch.setattr(ffn_fused, "sparse_w4a16_matmul_cuda",
                        down_stub("sparse_w4a16_matmul"))
    monkeypatch.setattr(ffn_fused, "w4a16_matmul_cuda",
                        down_stub("w4a16_matmul"))
    for name in ("ffn_w4a16_torch", "ffn_gate_up_sparse_torch",
                 "sparse_matmul_f32", "w4a16_matmul_f32"):
        monkeypatch.setattr(ffn_fused, name, refuse)
    monkeypatch.setattr(ops, "ffn_w4a16_torch", refuse)
    monkeypatch.setattr(ops._ref, "ffn_ref", refuse)
    cfg = get_smoke_config("starcoder2-7b", d_model=256, d_ff=256)
    x = torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32))
    up = _sparse(rng, 256, 256, 0.5, m=2)[1]
    downs = {"sparse_w4a16_matmul":
             _sparse(rng, 256, 256, 0.5, m=2, tile_uniform=True)[1],
             "w4a16_matmul": _port(jax_quantize(
                 {"down": jnp.asarray(_weight(rng, 256, 256))},
                 "dense")["down"])}
    ub, db = (torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
              for _ in range(2))
    for name, down in downs.items():
        calls.clear()
        p = {"up": up, "up_bias": ub, "down": down, "down_bias": db}
        out = layers.mlp_apply(cfg, p, x)
        assert out.shape == x.shape
        (stage, gate, act, tiles, got_ub), (second, got_db) = calls
        assert (stage, gate, act, second) == (
            "ffn_fused_sparse_gelu", None, "gelu", name)
        assert got_ub is ub and got_db is db
        assert (tiles is None) == (name == "w4a16_matmul")
        if tiles is not None:
            assert torch.equal(tiles, down.block_idx[0])


# -- the model and the engine -------------------------------------------------

# (arch, strategy) cases; the qwen-7b ones keep their earlier ids
MODEL_CASES = {"strategy2": ("qwen-7b", "strategy2"),
               "strategy3": ("qwen-7b", "strategy3"),
               "starcoder2-strategy2": ("starcoder2-7b", "strategy2"),
               "starcoder2-strategy3": ("starcoder2-7b", "strategy3")}
_DENSE = {}
_MODELS = {}


def _jax_dense(arch):
    """The reference's smoke model at the sparse-compatible widths; for
    starcoder2, its biases and LayerNorm shifts drawn at random (they start
    at zero), so the sparse gelu FFN's biases are exercised."""
    if arch not in _DENSE:
        jcfg = jax_smoke_config(arch, **OVERRIDES)
        params = japi.init_params(jcfg, jax.random.PRNGKey(0))
        if arch == "starcoder2-7b":
            rng = np.random.default_rng(3)

            def rand(path, leaf):
                name = str(path[-1])
                if "bias" in name or "beta" in name or name in (
                        "['bq']", "['bk']", "['bv']"):
                    return jnp.asarray(rng.normal(
                        size=leaf.shape).astype(np.float32) * 0.1,
                        leaf.dtype)
                return leaf
            params = jax.tree_util.tree_map_with_path(rand, params)
        _DENSE[arch] = (jcfg, params)
    return _DENSE[arch]


def _models(arch, strategy):
    if (arch, strategy) not in _MODELS:
        jcfg, dense = _jax_dense(arch)
        jparams = jax_quantize(dense, strategy)
        tcfg = get_smoke_config(arch, **OVERRIDES)
        tparams = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[(arch, strategy)] = (jcfg, jparams, tcfg, tparams)
    return _MODELS[(arch, strategy)]


def test_starcoder2_sparse_model_takes_the_gelu_path():
    """At these widths starcoder2-7b under strategy2 has sparse wo and up,
    a tile_uniform sparse down, random FFN biases, and its MLP takes the
    sparse CUDA path."""
    _, jparams, tcfg, tparams = _models("starcoder2-7b", "strategy2")
    attn, mlp = tparams["blocks"]["attn"], tparams["blocks"]["mlp"]
    assert (tcfg.activation, tcfg.norm) == ("gelu", "layernorm")
    assert "gate" not in mlp
    assert isinstance(attn["wo"], tsparsity.SparseQuantizedTensor)
    assert isinstance(mlp["up"], tsparsity.SparseQuantizedTensor)
    assert mlp["down"].tile_uniform
    assert float(mlp["up_bias"].abs().max()) > 0
    one = {k: v[0] for k, v in mlp.items()}
    assert ffn_fused.fused_variant(None, one["up"], one["down"],
                                   "gelu") == "sparse"
    np.testing.assert_array_equal(
        mlp["down_bias"].numpy(),
        np.asarray(jparams["blocks"]["mlp"]["down_bias"]))


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_mixed_and_decode_steps_match_reference(case):
    arch, strategy = MODEL_CASES[case]
    jcfg, jparams, tcfg, tparams = _models(arch, strategy)
    down = tparams["blocks"]["mlp"]["down"]
    assert isinstance(down, tsparsity.SparseQuantizedTensor
                      if strategy == "strategy2" else QuantizedTensor)
    rng = np.random.default_rng(0)
    b, c, max_len = 2, 8, 32
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    for lengths, q_lens in [([0, 0], [8, 5]), ([8, 5], [3, 8])]:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(lengths, jnp.int32),
                                     jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache,
                                    torch.from_numpy(toks).long(), lengths,
                                    q_lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    lengths = np.asarray([12, 14], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(lengths))
    tl, tcache = api.decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(toks).long(), lengths)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_mixed_step_equals_sequential_decode(case):
    """Chunked admission reproduces sequential decode.  On the card this is
    bitwise (``chip_smoke.py`` phase 4, 32 layers); on the CPU the plain
    versions' matmuls change shape with the chunk, so it holds within 1e-5
    and the greedy token is equal, as for the dense model."""
    _, _, tcfg, tparams = _models(*MODEL_CASES[case])
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    seq = api.init_cache(tcfg, 1, 32, "cpu")
    for t, tok in enumerate(prompt):
        sl, seq = api.decode_step(tcfg, tparams, seq,
                                  torch.tensor([[int(tok)]]), [t + 1])
    mix, length = api.init_cache(tcfg, 1, 32, "cpu"), 0
    while length < len(prompt):
        ql = min(8, len(prompt) - length)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[length:length + ql]
        ml, mix = api.mixed_step(tcfg, tparams, mix,
                                 torch.from_numpy(chunk[None]), [length],
                                 [ql])
        length += ql
    np.testing.assert_allclose(ml.numpy(), sl.numpy(), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(mix[k].numpy(), seq[k].numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert int(ml.argmax()) == int(sl.argmax())


def _workload(vocab):
    rng = np.random.default_rng(2)
    return [(100 + i,
             rng.integers(0, vocab, int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 6)))
            for i in range(5)]


@pytest.mark.parametrize("arch", ["qwen-7b", "starcoder2-7b"])
def test_engine_streams_equal_jax_engine(arch):
    jcfg, jparams, tcfg, tparams = _models(arch, "strategy2")
    kw = dict(batch_size=2, max_len=64, chunk_size=16)
    jengine = JaxEngine(jcfg, jparams, **kw)
    engine = Engine(tcfg, tparams, device="cpu", **kw)
    for rid, prompt, n in _workload(tcfg.vocab_size):
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.output for r in jengine.run()}
    done = engine.run()
    assert done.drained and {r.rid: r.output for r in done} == want
    for r in done:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu"), r.rid


def test_sparse_leaf_is_not_read_as_dense():
    """The interop fault PR 11 had: a sparse leaf carries the dense leaf's
    four attributes too, and must come across as sparse."""
    _, jparams, _, tparams = _models("qwen-7b", "strategy2")
    wo = tparams["blocks"]["attn"]["wo"]
    assert isinstance(wo, tsparsity.SparseQuantizedTensor)
    assert (wo.shape, wo.density, wo.group_size, wo.tile_uniform) == (
        (1024, 1024), 0.5, 128, False)
    _assert_sparse_equal(jparams["blocks"]["attn"]["wo"], wo)
