"""The port's model against the JAX reference on quantized ``qwen-7b-smoke``.

Weights come from the reference (``init_params`` at PRNGKey(0), then
``quantize_model(..., "dense")``) and reach the port through numpy and
``repro_torch.interop``.  Logits and caches of ``mixed_step`` and
``decode_step`` match within 1e-4 in float32: the two frameworks differ
only in summation order and in the last bit of cos/sin/exp/rsqrt, which
two layers of f32 arithmetic keep well below that."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {"default": {}, "tied-softcap": {"tie_embeddings": True,
                                            "logit_softcap": 30.0}}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    over = VARIANTS[request.param]
    jcfg = jax_smoke_config("qwen-7b", **over)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tcfg = get_smoke_config("qwen-7b", **over)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, tcfg, tparams


def _cache_close(jcache, tcache):
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


def test_mixed_and_decode_steps_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    b, c, max_len = 2, 8, 32
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    steps = [([0, 0], [8, 5]), ([8, 5], [3, 8]), ([11, 13], [0, 2])]
    for lengths, q_lens in steps:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(lengths, jnp.int32),
                                     jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache,
                                    torch.from_numpy(toks).long(),
                                    lengths, q_lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _cache_close(jcache, tcache)
    # decode on top: per-row lengths include the new token
    lengths = np.asarray([12, 16], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(lengths))
    tl, tcache = api.decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(toks).long(), lengths)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(jcache, tcache)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))


def test_c1_delegation_leaves_idle_rows_untouched(models):
    jcfg, jparams, tcfg, tparams = models
    cache = api.init_cache(tcfg, 2, 16, "cpu")
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10]])
    _, cache = api.mixed_step(tcfg, tparams, cache, toks, [0, 0], [4, 4])
    before = {k: v.clone() for k, v in cache.items()}
    logits, cache = api.mixed_step(tcfg, tparams, cache,
                                   torch.tensor([[11], [12]]), [4, 4], [1, 0])
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])
    assert torch.equal(cache["v"][:, 1], before["v"][:, 1])
    assert not torch.equal(cache["k"][:, 0], before["k"][:, 0])
    assert torch.equal(logits[1], torch.zeros_like(logits[1]))
    jl, _ = japi.mixed_step(jcfg, jparams, japi.init_cache(jcfg, 2, 16),
                            jnp.asarray([[11], [12]], jnp.int32),
                            jnp.asarray([0, 0], jnp.int32),
                            jnp.asarray([1, 0], jnp.int32))
    assert np.array_equal(np.asarray(jl)[1], np.zeros_like(np.asarray(jl)[1]))


def _seq_feed(cfg, params, cache, toks):
    logits = None
    for t, tok in enumerate(toks):
        logits, cache = api.decode_step(cfg, params, cache,
                                        torch.tensor([[int(tok)]]), [t + 1])
    return logits, cache


def _chunk_feed(cfg, params, cache, toks, c):
    logits, length = None, 0
    while length < len(toks):
        ql = min(c, len(toks) - length)
        chunk = np.zeros(c, np.int64)
        chunk[:ql] = toks[length:length + ql]
        logits, cache = api.mixed_step(cfg, params, cache,
                                       torch.from_numpy(chunk[None]),
                                       [length], [ql])
        length += ql
    return logits, cache


def test_mixed_step_equals_sequential_decode(models):
    """Chunked admission reproduces sequential decode.  On the card this is
    bitwise (``chip_smoke.py`` phase 4); on the CPU the plain versions'
    matmuls change shape with the chunk, so it holds within 1e-5 and the
    greedy tokens are equal."""
    _, _, tcfg, tparams = models
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    sl, scache = _seq_feed(tcfg, tparams, api.init_cache(tcfg, 1, 32, "cpu"),
                           prompt)
    ml, mcache = _chunk_feed(tcfg, tparams,
                             api.init_cache(tcfg, 1, 32, "cpu"), prompt, 8)
    np.testing.assert_allclose(ml.numpy(), sl.numpy(), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(mcache[k].numpy(), scache[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert int(ml.argmax()) == int(sl.argmax())


@pytest.mark.parametrize("override", [{"family": "hybrid"},
                                      {"rope_type": "mrope"},
                                      {"family": "moe"}])
def test_unported_configs_raise(override):
    cfg = get_smoke_config("qwen-7b", **override)
    with pytest.raises(NotImplementedError, match="later slice|not ported"):
        api.init_cache(cfg, 1, 16, "cpu")
    with pytest.raises(NotImplementedError):
        api.init_params(cfg, torch.Generator().manual_seed(0))


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_smoke_config("zamba2-7b")


def test_init_params_from_generator_is_deterministic():
    cfg = get_smoke_config("qwen-7b")
    a = api.init_params(cfg, torch.Generator().manual_seed(3))
    b = api.init_params(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(a["blocks"]["mlp"]["down"], b["blocks"]["mlp"]["down"])
    assert a["blocks"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads * cfg.head_dim)
    assert a["lm_head"].dtype == torch.float32
