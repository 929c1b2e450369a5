"""The port's 16-bit serving path and starcoder2-7b against the JAX
reference, on the CPU.

* Kernel level, float32 within the reference's kernel tolerance (2e-4):
  kernel 6's plain version (``ffn_fused_dense_torch``) against
  ``ffn_fused_dense_pallas`` in interpret mode; kernel 2's gelu-with-biases
  plain version against ``ffn_fused_w4a16_pallas`` in interpret mode;
  ``dense_matmul_torch`` against the reference's ``layers.linear`` on a
  16-bit weight (a ragged 300-column output too); the layernorm plain
  version against ``layers.layernorm``; each plain version row-invariant
  (within f32 rounding here: the CPU's matmul picks its kernel by row count;
  bitwise is the CUDA kernels' property, held on the card).
* The card's dispatch, with the device resolution patched to ``"cuda"``: a
  16-bit ``linear``, a 16-bit MLP and a layernorm reach their fixed-order
  kernels and no PyTorch product, reduction or unfused oracle.
* Model level: starcoder2-7b-smoke (LayerNorm, the ungated gelu FFN with
  biases, q/k/v biases, RoPE theta 1e5) with weights carried from the
  reference by ``interop``: ``forward``, ``decode_step`` and ``mixed_step``
  logits and every cache leaf within 1e-4; the engine's token streams
  against the JAX engine's for strategy ``none``, and for ``dense`` with the
  widths raised to multiples of 128 in both packages (d_model 256, head_dim
  64, d_ff 512; at d_model 144 the reference's compiler keeps every weight
  16-bit).  qwen-7b-smoke ``none``: the engine against its own oracle.
  The launcher with ``--arch starcoder2-7b``.

    PYTHONPATH=src python -m pytest tests/test_torch_dense16.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.core.quant import quantize as jax_quantize_2d  # noqa: E402
from repro.kernels.ffn_fused import (  # noqa: E402
    ffn_fused_dense_pallas, ffn_fused_w4a16_pallas)
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.compiler import quantize_model  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ffn_fused, ops, ref  # noqa: E402
from repro_torch.kernels.dense_matmul import dense_matmul_torch  # noqa: E402
from repro_torch.kernels.ffn_fused import (  # noqa: E402
    ffn_fused_dense_torch, ffn_gate_up_torch, ffn_w4a16_torch,
    fused_variant)
from repro_torch.kernels.layernorm import layernorm_torch  # noqa: E402
from repro_torch.kernels.w4a16_matmul import w4a16_matmul_torch  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than the
    work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the rows of one call against the same rows computed alone: sums of the
# same terms, which the CPU's library may add in another order
ROW_TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = "starcoder2-7b"
# widths that tile: every matrix of the smoke model is quantized "dense"
TILED = dict(d_model=256, head_dim=64, d_ff=512)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# -- kernel 6 (16-bit weights) and kernel 2's gelu variant --------------------

def _ffn_operands(seed, activation, tokens, d=256, f=256):
    rng = np.random.default_rng(seed)
    gated = activation != "gelu"
    w = {"gate": _normal(rng, d, f, scale=d ** -0.5) if gated else None,
         "up": _normal(rng, d, f, scale=d ** -0.5),
         "down": _normal(rng, f, d, scale=f ** -0.5)}
    b = ({} if gated else {"up_bias": _normal(rng, f, scale=0.1),
                           "down_bias": _normal(rng, d, scale=0.1)})
    return _normal(rng, tokens, d), w, b


@pytest.mark.parametrize("tokens", [1, 57])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_kernel6_plain_matches_pallas_interpret(activation, tokens):
    x, w, b = _ffn_operands(tokens, activation, tokens)
    jw = {k: None if v is None else jnp.asarray(v) for k, v in w.items()}
    want = ffn_fused_dense_pallas(
        jnp.asarray(x), jw["gate"], jw["up"], jw["down"],
        activation=activation, interpret=True,
        **{k: jnp.asarray(v) for k, v in b.items()})
    tw = {k: None if v is None else _t(v) for k, v in w.items()}
    tb = {k: _t(v) for k, v in b.items()}
    got = ffn_fused_dense_torch(_t(x), tw["gate"], tw["up"], tw["down"],
                                activation=activation, **tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the first stage alone is the activation of the f32 sums
    hidden = ffn_gate_up_torch(_t(x), tw["gate"], tw["up"], activation,
                               tb.get("up_bias"))
    assert hidden.shape == (tokens, 256)
    np.testing.assert_allclose(
        dense_matmul_torch(hidden, tw["down"], tb.get("down_bias")).numpy(),
        got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("tokens", [1, 57])
def test_kernel2_gelu_plain_matches_pallas_interpret(tokens):
    x, w, b = _ffn_operands(tokens + 100, "gelu", tokens)
    jup, jdown = (jax_quantize_2d(jnp.asarray(w[k])) for k in ("up", "down"))
    want = ffn_fused_w4a16_pallas(
        jnp.asarray(x), None, jup, jdown, activation="gelu", interpret=True,
        **{k: jnp.asarray(v) for k, v in b.items()})
    tp = interop.params_from_numpy(
        jax.tree.map(np.asarray, {"up": jup, "down": jdown}), "cpu")
    tb = {k: _t(v) for k, v in b.items()}
    got = ffn_w4a16_torch(_t(x), None, tp["up"], tp["down"],
                          activation="gelu", **tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the two CUDA stages' plain versions compose to the same FFN
    hidden = ffn_gate_up_torch(_t(x), None, tp["up"], "gelu", tb["up_bias"])
    staged = w4a16_matmul_torch(hidden, tp["down"], tb["down_bias"])
    np.testing.assert_array_equal(staged.numpy(), got.numpy())
    assert fused_variant(None, tp["up"], tp["down"], "gelu") == "quant"


@pytest.mark.parametrize("out_f", [256, 300])
@pytest.mark.parametrize("tokens", [1, 33])
def test_dense_matmul_plain_matches_reference_linear(tokens, out_f):
    rng = np.random.default_rng(tokens * 3 + out_f)
    w = _normal(rng, 192, out_f, scale=192 ** -0.5)
    x = _normal(rng, tokens, 192)
    bias = _normal(rng, out_f, scale=0.1)
    want = jlayers.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = layers.linear(_t(x), _t(w), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = dense_matmul_torch(_t(x), _t(w))
    np.testing.assert_allclose(plain.numpy(), np.asarray(
        jlayers.linear(jnp.asarray(x), jnp.asarray(w))), **TOL)
    for impl in ("torch", "ref"):
        np.testing.assert_allclose(
            ops.dense_matmul(_t(x), _t(w), _t(bias), impl=impl).numpy(),
            (plain + _t(bias)).numpy(), **TOL)


@pytest.mark.parametrize("d", [144, 4608])
def test_layernorm_plain_matches_reference(d):
    rng = np.random.default_rng(d)
    x = _normal(rng, 5, d) * 3 + 1
    gamma = 1 + _normal(rng, d, scale=0.1)
    beta = _normal(rng, d, scale=0.1)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(gamma),
                             jnp.asarray(beta))
    for got in (layernorm_torch(_t(x), _t(gamma), _t(beta)),
                layers.layernorm(_t(x), _t(gamma), _t(beta)),
                ops.layernorm(_t(x), _t(gamma), _t(beta), impl="ref")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


PLAIN_VERSIONS = {
    "dense_matmul": lambda x, w: dense_matmul_torch(x, w["up"],
                                                    w["down_bias"]),
    "kernel6_gated": lambda x, w: ffn_fused_dense_torch(
        x, w["gate"], w["up"], w["down"]),
    "kernel6_gelu": lambda x, w: ffn_fused_dense_torch(
        x, None, w["up"], w["down"], activation="gelu",
        up_bias=w["up_bias"], down_bias=w["down_bias"]),
    "kernel2_gelu": lambda x, w: ffn_w4a16_torch(
        x, None, w["up_q"], w["down_q"], activation="gelu",
        up_bias=w["up_bias"], down_bias=w["down_bias"]),
    "layernorm": lambda x, w: layernorm_torch(x, w["gamma"], w["beta"]),
}


@pytest.mark.parametrize("name", list(PLAIN_VERSIONS))
def test_plain_versions_are_row_invariant(name):
    """A row computed alone equals the same row of a 64-row call (to f32
    rounding here; bitwise for the CUDA kernels on the card)."""
    rng = np.random.default_rng(11)
    d = 256
    w = {k: _t(_normal(rng, d, d, scale=d ** -0.5))
         for k in ("gate", "up", "down")}
    w.update(up_bias=_t(_normal(rng, d, scale=0.1)),
             down_bias=_t(_normal(rng, d, scale=0.1)),
             gamma=_t(1 + _normal(rng, d, scale=0.1)),
             beta=_t(_normal(rng, d, scale=0.1)))
    w["up_q"] = quantize_model({"up": w["up"]}, "dense")["up"]
    w["down_q"] = quantize_model({"down": w["down"]}, "dense")["down"]
    x = _t(_normal(rng, 64, d))
    fn = PLAIN_VERSIONS[name]
    full = fn(x, w)
    for rows in (slice(0, 1), slice(3, 7), slice(60, 64)):
        np.testing.assert_allclose(fn(x[rows], w).numpy(),
                                   full[rows].numpy(), **ROW_TOL)


# -- the card's dispatch -------------------------------------------------------

def test_card_dispatch_reaches_the_fixed_order_kernels(monkeypatch):
    """With the device resolved to ``"cuda"``, a 16-bit ``linear`` reaches
    ``dense_matmul``'s kernel, a 16-bit MLP kernel 6 (then ``dense_matmul``
    for down), a layernorm its kernel: no ``torch.matmul``, ``@``, torch
    mean or ``ffn_ref`` runs (each is made to raise)."""
    calls = []

    def stub(name, out_shape):
        def fn(x, w, *args, **kw):
            calls.append(name)
            return torch.zeros(out_shape(x, w), dtype=x.dtype)
        return fn

    def refuse(*a, **k):
        raise AssertionError("a PyTorch product, reduction or the unfused "
                             "oracle ran on the card's path")
    cols = (lambda x, w: (*x.shape[:-1], w.shape[1]))
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "dense_matmul_cuda", stub("dense_matmul", cols))
    monkeypatch.setattr(ffn_fused, "dense_matmul_cuda",
                        stub("dense_matmul", cols))
    monkeypatch.setattr(
        ffn_fused, "ffn_dense_gate_up_cuda",
        lambda x, g, u, act, ub=None: stub("ffn_fused_dense", cols)(x, u))
    monkeypatch.setattr(ops, "layernorm_cuda",
                        stub("layernorm", lambda x, g: x.shape))
    cfgs = {a: get_smoke_config(a, **TILED) for a in ("qwen-7b", ARCH)}
    params = {a: api.init_params(c, torch.Generator().manual_seed(0))
              for a, c in cfgs.items()}
    x = torch.ones(3, 256)
    for attr in ("matmul", "mean"):
        monkeypatch.setattr(torch, attr, refuse)
    for attr in ("__matmul__", "mean"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    monkeypatch.setattr(ref, "ffn_ref", refuse)
    blk = {a: {k: {n: v[0] for n, v in p["blocks"][k].items()}
               for k in ("attn", "mlp", "ln_mlp")}
           for a, p in params.items()}
    layers.linear(x, blk[ARCH]["attn"]["wq"], blk[ARCH]["attn"]["bq"])
    assert calls == ["dense_matmul"]
    for arch in ("qwen-7b", ARCH):
        calls.clear()
        out = layers.mlp_apply(cfgs[arch], blk[arch]["mlp"], x)
        assert out.shape == x.shape
        assert calls == ["ffn_fused_dense", "dense_matmul"], arch
    calls.clear()
    layers.apply_norm(cfgs[ARCH], blk[ARCH]["ln_mlp"], x)
    assert calls == ["layernorm"]


def test_mlp_apply_keeps_the_unfused_composition_on_the_cpu(monkeypatch):
    """On the CPU a 16-bit MLP takes ``impl="auto"``, whose plain path is
    the unfused oracle, bitwise as before (and as the reference)."""
    seen = []
    real = ops.ffn_w4a16

    def spy(*a, impl="auto", **kw):
        seen.append(impl)
        return real(*a, impl=impl, **kw)
    monkeypatch.setattr(ops, "ffn_w4a16", spy)
    for arch in ("qwen-7b", ARCH):
        cfg = get_smoke_config(arch)
        p = api.init_params(cfg, torch.Generator().manual_seed(1))
        mlp = {k: v[0] for k, v in p["blocks"]["mlp"].items()}
        x = torch.from_numpy(_normal(np.random.default_rng(0), 5,
                                     cfg.d_model))
        got = layers.mlp_apply(cfg, mlp, x)
        want = ref.ffn_ref(x, mlp.get("gate"), mlp["up"], mlp["down"],
                           activation=cfg.activation,
                           up_bias=mlp.get("up_bias"),
                           down_bias=mlp.get("down_bias"))
        assert torch.equal(got, want), arch
    assert seen == ["auto", "auto"]


# -- starcoder2-7b against the reference ----------------------------------------

_MODELS = {}


def _models(strategy, **over):
    key = (strategy, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_smoke_config(ARCH), **over)
        jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
        if strategy != "none":
            jparams = jax_quantize(jparams, strategy)
        tparams = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[key] = (jcfg, jparams, get_smoke_config(ARCH, **over),
                        tparams)
    return _MODELS[key]


MODEL_CASES = {"none": ("none", {}), "dense": ("dense", TILED)}


def _assert_cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in tcache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache[name]),
                                   **MODEL_TOL, err_msg=name)


def test_starcoder2_configs_mirror_reference():
    for full in (True, False):
        want = (jax_config if full else jax_smoke_config)(ARCH)
        got = (get_config if full else get_smoke_config)(ARCH)
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    cfg = get_config(ARCH)
    assert (cfg.norm, cfg.activation, cfg.qkv_bias) == ("layernorm", "gelu",
                                                        True)
    assert all(w % 128 == 0 for w in (cfg.d_model, cfg.d_ff, cfg.vocab_size,
                                      cfg.n_heads * cfg.head_dim))


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_starcoder2_interop_carries_every_leaf(case):
    """beta, the q/k/v biases and the FFN biases cross as they are; a
    16-bit tree round-trips bitwise; ``dense`` packs every matrix."""
    strategy, over = MODEL_CASES[case]
    _, jparams, _, tparams = _models(strategy, **over)
    blocks = tparams["blocks"]
    for group, names in (("ln_attn", ("gamma", "beta")),
                         ("ln_mlp", ("gamma", "beta")),
                         ("attn", ("bq", "bk", "bv")),
                         ("mlp", ("up_bias", "down_bias"))):
        for n in names:
            np.testing.assert_array_equal(
                blocks[group][n].numpy(),
                np.asarray(jparams["blocks"][group][n]))
    assert "beta" in tparams["ln_f"] and "gate" not in blocks["mlp"]
    packed = isinstance(blocks["mlp"]["up"], QuantizedTensor)
    assert packed == (strategy == "dense")
    if strategy == "dense":
        assert all(isinstance(blocks[g][n], QuantizedTensor)
                   for g, n in (("attn", "wq"), ("attn", "wk"),
                                ("mlp", "down")))
        assert isinstance(tparams["lm_head"], QuantizedTensor)
    else:
        back = interop.params_to_numpy(tparams)
        src = jax.tree.map(np.asarray, jparams)
        for (a, b) in zip(jax.tree.leaves(src), jax.tree.leaves(back)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_starcoder2_forward_matches_reference(case):
    strategy, over = MODEL_CASES[case]
    jcfg, jparams, tcfg, tparams = _models(strategy, **over)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    jl, _ = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, taux = api.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    assert tl.shape == (2, 19, jcfg.vocab_size) and float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_starcoder2_steps_match_reference(case):
    """mixed_step (idle rows included), then decode_step: logits and every
    cache leaf within 1e-4 of the reference's."""
    strategy, over = MODEL_CASES[case]
    jcfg, jparams, tcfg, tparams = _models(strategy, **over)
    rng = np.random.default_rng(1)
    b, c, max_len = 2, 8, 32
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    for lengths, q_lens in [([0, 0], [8, 5]), ([8, 5], [3, 8]),
                            ([11, 13], [0, 2])]:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(lengths, jnp.int32),
                                     jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache, _t(toks).long(),
                                    lengths, q_lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray([12, 16], jnp.int32))
    tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(toks).long(),
                                 [12, 16])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)


def _work(vocab, n=6):
    rng = np.random.default_rng(2)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20))).astype(
        np.int32), int(rng.integers(2, 8))) for i in range(n)]


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_starcoder2_engine_streams_equal_jax_engine(case):
    strategy, over = MODEL_CASES[case]
    jcfg, jparams, tcfg, tparams = _models(strategy, **over)
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    for rid, prompt, n in _work(jcfg.vocab_size):
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.output for r in jengine.run()}
    done = engine.run()
    assert {r.rid: r.output for r in done} == want


def test_qwen_16bit_engine_matches_its_oracle():
    cfg = get_smoke_config("qwen-7b")
    params = quantize_model(api.init_params(cfg, torch.Generator()
                                            .manual_seed(0)), "none")
    mlp = params["blocks"]["mlp"]
    assert not any(isinstance(mlp[k], QuantizedTensor) for k in mlp)
    engine = Engine(cfg, params, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    work = _work(cfg.vocab_size)
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    done = engine.run()
    assert len(done) == len(work)
    for r in done:
        assert r.output == reference_decode(cfg, params, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu")


@pytest.mark.parametrize("strategy", ["none", "dense"])
def test_launcher_serves_starcoder2_on_cpu(capsys, strategy):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", ARCH, "--strategy", strategy,
                "--requests", "2", "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and f"strategy={strategy}" in out
    assert "'completed': 2" in out
