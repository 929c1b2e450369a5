"""The port's full-sequence surface against the JAX reference: the plain
flash-attention version, ``forward``, whole-prompt and chunked
``prefill``, and ChatGLM2-6B's serving steps.

* Kernel level: ``flash_attention_torch`` against
  ``flash_attention_pallas`` in interpret mode at divisible shapes with
  small tiles, and against the reference's ``impl="xla"`` attention
  (``attention_ref``, or ``attention_chunked`` from 2048 keys on) at
  ragged ones; causal, sliding window and non-causal, GQA rep 1/2/4;
  float32 within 1e-5 (sums taken in another order by another library).
* Model level: quantized ``qwen-7b-smoke`` and ``chatglm-6b-smoke`` in
  float32, weights from the reference through numpy: ``api.forward`` and
  ``api.prefill`` (logits and every cache leaf, fp and int8 slot caches)
  within 1e-4, int8 values within one step where a projection rounds
  across a boundary; ``_prefill_chunked`` with ``PREFILL_CHUNK`` patched in
  both packages, with and without a window, and with a cache shorter than
  the prompt (the update's clamp); the paged layout's ``_bulk_prefill``
  route; chatglm's ``mixed_step``/``decode_step`` and engine.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_torch)
from repro_torch.models import api, attention, layers, transformer  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than
    the work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 K/V: one stored value may differ by one step where the two packages'
# f32 projections round across a boundary, moving the logits by up to ~1e-2
INT8_MODEL_TOL = dict(rtol=1e-2, atol=1e-2)
ARCHS = ("qwen-7b", "chatglm-6b")


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.array(a))


# -- kernel level --------------------------------------------------------------

MODES = {"causal": dict(causal=True, window=None, sq=32, skv=64),
         "window": dict(causal=True, window=24, sq=32, skv=64),
         "non-causal": dict(causal=False, window=None, sq=16, skv=64)}


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_flash_matches_pallas_interpret(mode, rep):
    """Divisible shapes, 16 x 32 tiles: the plain version walks the TPU
    kernel's tiles in its order (the causal and window skips included)."""
    m = MODES[mode]
    q, k, v = _qkv(rep, 1, 2 * rep, 2, m["sq"], m["skv"], 32)
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=m["causal"],
        window=m["window"], block_q=16, block_kv=32, interpret=True)
    got = flash_attention_torch(_t(q), _t(k), _t(v), causal=m["causal"],
                                window=m["window"], block_q=16, block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


RAGGED = {"causal-300": dict(causal=True, window=None, sq=300, skv=300,
                             rep=4),
          "offset-window": dict(causal=True, window=9, sq=13, skv=50, rep=2),
          "non-causal": dict(causal=False, window=None, sq=11, skv=45, rep=1),
          # 2048 keys and more: the reference's xla path is attention_chunked
          "chunked-ref": dict(causal=True, window=None, sq=260, skv=2100,
                              rep=2)}


@pytest.mark.parametrize("case", list(RAGGED))
def test_plain_flash_matches_reference_at_ragged_shapes(case):
    c = RAGGED[case]
    q, k, v = _qkv(7, 2, 2 * c["rep"], 2, c["sq"], c["skv"], 32)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=c["causal"], window=c["window"], impl="xla")
    for impl in ("torch", "auto"):
        got = ops.attention(_t(q), _t(k), _t(v), causal=c["causal"],
                            window=c["window"], impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


def test_reference_kernel_refuses_a_ragged_prompt_the_port_takes():
    """``flash_attention_pallas`` needs Sq % min(256, Sq) == 0: a 300-token
    prompt cannot prefill through it (ROADMAP queue 3).  The port's plain
    version takes it, and so does its CUDA kernel (card tests)."""
    q, k, v = _qkv(3, 1, 2, 1, 300, 300, 32)
    with pytest.raises(ValueError, match="sq=300"):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True)
    assert flash_attention_torch(_t(q), _t(k), _t(v)).shape == (1, 2, 300,
                                                                 32)


@pytest.mark.parametrize("mode", list(MODES))
def test_ops_attention_ref_and_torch_match_the_oracle(mode):
    m = MODES[mode]
    q, k, v = _qkv(11, 2, 4, 2, m["sq"], m["skv"], 32)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=m["causal"], window=m["window"], impl="xla")
    for impl in ("ref", "torch"):
        got = ops.attention(_t(q), _t(k), _t(v), causal=m["causal"],
                            window=m["window"], impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 1, 8, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(q, k, v, impl="pallas")


# -- model level ---------------------------------------------------------------

_MODELS = {}


def _models(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = jax_smoke_config(arch)
        jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                               "dense")
        tparams = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[key] = (jcfg, jparams, get_smoke_config(arch), tparams)
    jcfg, jparams, tcfg, tparams = _MODELS[key]
    return (dataclasses.replace(jcfg, **over), jparams,
            dataclasses.replace(tcfg, **over), tparams)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _assert_int8_close(got, want):
    """(layers, ...) int8 leaves: at most one step apart, and in layer 0,
    whose inputs agree to f32 rounding, only where a projection rounds
    across a boundary (a rare event, never a pattern).  Where attention
    reads the int8 cache (the paged route), a flip in layer 0 moves every
    later query's scores, so later layers flip more often, still by one
    step."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff[0] != 0).mean() < 1e-3, (diff[0] != 0).sum()
    assert (diff != 0).mean() < 1e-2, (diff != 0).sum()


def _assert_cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in tcache.items():
        got, want = leaf.numpy(), np.asarray(jcache[name])
        assert got.shape == want.shape, name
        if got.dtype == np.int8:
            _assert_int8_close(got, want)
        else:
            np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=name)


def test_positions_for_matches_reference():
    cfg = get_smoke_config("qwen-7b")
    got = layers.positions_for(cfg, 3, 5, offset=7)
    want = jlayers.positions_for(jax_smoke_config("qwen-7b"), 3, 5, offset=7)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        layers.positions_for(dataclasses.replace(cfg, rope_type="mrope"), 1, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    toks = _tokens(0, 2, 24, jcfg.vocab_size)
    jl, jaux = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, taux = api.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    assert tl.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert float(taux) == float(jaux) == 0.0
    # the last position is what prefill returns (bitwise on the card)
    pl, _ = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()}, 32)
    np.testing.assert_allclose(pl.numpy(), tl[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)


PREFILL = {"fp": ({}, 40), "int8": ({"kv_quant": "int8"}, 40),
           # a cache shorter than the prompt keeps the last 16 tokens
           "fp-short-cache": ({}, 16), "int8-short-cache": (
               {"kv_quant": "int8"}, 16)}


@pytest.mark.parametrize("case", list(PREFILL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, case):
    over, max_len = PREFILL[case]
    jcfg, jparams, tcfg, tparams = _models(arch, **over)
    tol = INT8_MODEL_TOL if "int8" in case else MODEL_TOL
    toks = _tokens(1, 2, 21, jcfg.vocab_size)
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              max_len)
    tl, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()},
                             max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _assert_cache_close(tcache, jcache)
    if max_len > 21:
        # decode on top of the prefilled cache
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        jd, _ = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                 jnp.asarray([22, 22], jnp.int32))
        td, _ = api.decode_step(tcfg, tparams, tcache, _t(nxt).long(),
                                [22, 22])
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)


CHUNKED = {"full": ({}, 64), "window": ({"window": 8}, 64),
           # 48 tokens into a 40-token cache: the last chunk's write start
           # clamps from 32 to 24, as jax.lax.dynamic_update_slice does
           "clamped": ({}, 40)}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_chunked_prefill_matches_reference(case, monkeypatch):
    over, max_len = CHUNKED[case]
    jcfg, jparams, tcfg, tparams = _models("qwen-7b", **over)
    toks = _tokens(2, 2, 48, jcfg.vocab_size)
    one_l, one_cache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()},
                                   max_len)
    monkeypatch.setattr(jtransformer, "PREFILL_CHUNK", 16)
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 16)
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              max_len)
    calls = []
    real = transformer._prefill_chunked
    monkeypatch.setattr(transformer, "_prefill_chunked",
                        lambda *a: calls.append(1) or real(*a))
    tl, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()},
                             max_len)
    assert calls == [1]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)
    if case == "clamped":
        return
    # chunked == one-shot: a window no longer than a chunk sees only the
    # previous chunk, so both attend over the same keys
    np.testing.assert_allclose(tl.numpy(), one_l.numpy(), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   one_cache[name].numpy(), **MODEL_TOL)
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jd, _ = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                             jnp.asarray([49, 49], jnp.int32))
    td, _ = api.decode_step(tcfg, tparams, tcache, _t(nxt).long(), [49, 49])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **MODEL_TOL)


def test_chunked_prefill_refuses_what_it_cannot_write(monkeypatch):
    """int8 K/V (the reference's chunked prefill casts K/V to int8 and drops
    the scales), a paged pool, and a prompt that is not whole chunks."""
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 16)
    _, _, tcfg, tparams = _models("qwen-7b")
    toks = _t(_tokens(3, 1, 32, tcfg.vocab_size)).long()
    with pytest.raises(NotImplementedError, match="kv_quant"):
        transformer.prefill(dataclasses.replace(tcfg, kv_quant="int8"),
                            tparams, toks, 40)
    with pytest.raises(ValueError, match="paged"):
        transformer.prefill(dataclasses.replace(tcfg, kv_layout="paged"),
                            tparams, toks, 40)
    with pytest.raises(AssertionError):
        transformer.prefill(tcfg, tparams, toks[:, :20], 40)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_prefill_runs_as_one_mixed_step(kv_quant, monkeypatch):
    """A paged cache has no full-sequence prefill: ``api.prefill`` runs the
    whole prompt as one ``mixed_step`` chunk under the default page table
    (the reference's ``_bulk_prefill``), and ``attn_prefill`` refuses the
    layout as the reference's does."""
    over = dict(kv_layout="paged", kv_block_size=8, kv_quant=kv_quant)
    jcfg, jparams, tcfg, tparams = _models("chatglm-6b", **over)
    toks = _tokens(4, 2, 19, jcfg.vocab_size)
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              32)
    seen = []
    real = transformer.mixed_step
    monkeypatch.setattr(transformer, "mixed_step",
                        lambda *a, **k: seen.append(a[3].shape) or
                        real(*a, **k))
    monkeypatch.setattr(transformer, "prefill", None)   # never reached
    tl, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()}, 32)
    assert seen == [(2, 19)]
    tol = INT8_MODEL_TOL if kv_quant == "int8" else MODEL_TOL
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert tcache["k"].shape == np.asarray(jcache["k"]).shape
    # the reference routes the dead tail of the chunk to the null block
    _assert_cache_close({n: t[:, :-1] for n, t in tcache.items()},
                        {n: np.asarray(t)[:, :-1] for n, t in jcache.items()})
    layer = transformer.layer_params(tparams["blocks"], 0)
    cache = attention.init_kv_cache(tcfg, 2, 32, "cpu")
    x = torch.zeros((2, 19, tcfg.d_model))
    with pytest.raises(ValueError, match="paged KV caches have no"):
        attention.attn_prefill(tcfg, layer["attn"], x,
                               layers.positions_for(tcfg, 2, 19), cache)


# -- chatglm-6b serving --------------------------------------------------------

def test_chatglm_steps_match_reference():
    """ChatGLM2-6B's smoke model through mixed_step (idle rows included)
    and decode_step: logits and caches within 1e-4."""
    jcfg, jparams, tcfg, tparams = _models("chatglm-6b")
    assert tcfg.name == jcfg.name == "chatglm-6b-smoke"
    rng = np.random.default_rng(0)
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
    jl, _ = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                             jnp.asarray([12, 16], jnp.int32))
    tl, _ = api.decode_step(tcfg, tparams, tcache, _t(toks).long(), [12, 16])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


def test_chatglm_full_config_mirrors_reference():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    want, got = jax_config("chatglm-6b"), get_config("chatglm-6b")
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.n_heads // got.n_kv_heads, got.d_ff // 128) == (16, 107)
    assert got.vocab_size % 512 == 0


def test_chatglm_engine_streams_equal_jax_engine():
    jcfg, jparams, tcfg, tparams = _models("chatglm-6b")
    rng = np.random.default_rng(2)
    work = [(i, rng.integers(0, jcfg.vocab_size,
                             int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 8))) for i in range(6)]
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    for rid, prompt, n in work:
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.output for r in jengine.run()}
    done = engine.run()
    assert {r.rid: r.output for r in done} == want
    for r in done:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu")


def test_launcher_serves_chatglm_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", "chatglm-6b", "--requests", "2",
                "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=chatglm-6b-smoke" in out
    assert "'completed': 2" in out
