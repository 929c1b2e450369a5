"""The port's compile cache and scheduler knobs against the JAX engine's.

``CompileCache`` is the reference's, restated for captured CUDA graphs: on
the CPU each entry is the executable run eagerly, so after the same
workload the port's engine holds the same keys, misses by kind and budget
as the JAX engine.  ``prefill_token_budget`` x ``prefill_policy`` give the
same token streams and tick counts as the reference's scheduler.

Models: quantized ``qwen-7b-smoke`` at d_model 128, d_ff 256, vocab 512
(``tests/test_serving.py``'s widths) with a slot cache, a paged pool of
8-token pages and an int8 cache, and the xLSTM smoke config; 2 slots,
max_len 64, chunk 32 (buckets 16 and 32) or 8 for the xLSTM."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import CompileCache as JaxCompileCache  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.compiler import CompileCache  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many ops on tiny tensors: one intra-op thread keeps the suite's
    parallel workers from waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = dict(d_model=128, d_ff=256, vocab_size=512)
LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", kv_block_size=8),
           "int8": dict(kv_quant="int8")}


def _workload(vocab, n=6, seed=3):
    """Prompts of 3-40 tokens, so chunks take both buckets of a 32-wide
    engine, and 2-6 new tokens."""
    rng = np.random.default_rng(seed)
    return [(100 + i,
             rng.integers(0, vocab, int(rng.integers(3, 41))).astype(np.int32),
             int(rng.integers(2, 7)))
            for i in range(n)]


def _models(arch, **over):
    jcfg = jax_smoke_config(arch, **over)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config(arch, **over), tparams


def _serve(engine, request_cls, work):
    for rid, prompt, n in work:
        engine.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=n))
    return {r.rid: r.output for r in engine.run()}


@pytest.mark.parametrize("cls", [CompileCache, JaxCompileCache])
def test_compile_cache_counts_hits_and_misses(cls):
    """The port's cache and the reference's answer the same call sequence
    with the same entries, counters and keys; ``build`` runs on a miss
    only."""
    built = []

    def build(tag):
        def fn():
            built.append(tag)
            return tag
        return fn
    cache = cls()
    assert len(cache) == 0 and not cache and cache.keys() == []
    calls = [("mixed", 16), ("decode", 2), ("mixed", 16), ("mixed", 32),
             ("insert", 2), ("decode", 2), ("mixed", 32)]
    got = [cache.get(name, b, build((name, b))) for name, b in calls]
    assert got == calls
    assert built == [("mixed", 16), ("decode", 2), ("mixed", 32),
                     ("insert", 2)]
    assert (cache.hits, cache.misses, len(cache)) == (3, 4, 4)
    assert cache.misses_by_name == {"mixed": 2, "decode": 1, "insert": 1}
    assert cache.keys() == [("mixed", 16), ("decode", 2), ("mixed", 32),
                            ("insert", 2)]


def test_engine_keeps_a_given_empty_compile_cache():
    """An empty cache is falsy: the engine keeps the caller's object (the
    reference's ``is not None`` rule), so engines can share it."""
    cfg = get_smoke_config("qwen-7b", **OVERRIDES)
    params = interop.params_from_numpy(jax.tree.map(
        np.asarray, japi.init_params(jax_smoke_config("qwen-7b", **OVERRIDES),
                                     jax.random.PRNGKey(0))), "cpu")
    shared = CompileCache()
    a = Engine(cfg, params, batch_size=2, max_len=64, chunk_size=32,
               compile_cache=shared, device="cpu")
    b = Engine(cfg, params, batch_size=2, max_len=64, chunk_size=32,
               compile_cache=shared, device="cpu")
    assert a.cache_compiles is shared and b.cache_compiles is shared
    assert a.compile_budget == len(a.chunk_buckets.all_buckets()) + 2 == 4
    work = _workload(cfg.vocab_size, n=3)
    _serve(a, Request, work)
    misses = shared.misses
    assert 0 < misses <= a.compile_budget
    # the second engine reuses every executable the first one built
    streams = _serve(b, Request, work)
    assert shared.misses == misses and shared.hits > 0
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(cfg, params, prompt, n,
                                                max_len=64, device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_keys_match_jax_engine(layout):
    """Same workload, same keys, misses by kind and budget as the JAX
    engine; the streams agree too, and a second run on the same engine
    misses nothing."""
    jcfg, jparams, tcfg, tparams = _models("qwen-7b", **OVERRIDES,
                                           **LAYOUTS[layout])
    work = _workload(tcfg.vocab_size)
    kw = dict(batch_size=2, max_len=64, chunk_size=32)
    engine = Engine(tcfg, tparams, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, **kw)
    streams = _serve(engine, Request, work)
    assert streams == _serve(jengine, JaxRequest, work)
    got, want = engine.cache_compiles, jengine.cache_compiles
    assert sorted(got.keys()) == sorted(want.keys())
    assert got.misses_by_name == want.misses_by_name
    assert {k for k, _ in got.keys()} == {"mixed", "decode"}
    assert engine.compile_budget == jengine.compile_budget
    assert got.misses <= engine.compile_budget
    misses = got.misses
    again = _serve(engine, Request,
                   [(rid + 100, p, n) for rid, p, n in work])
    assert got.misses == misses
    assert {rid - 100: out for rid, out in again.items()} == streams


def test_xlstm_engine_keys_match_jax_engine():
    """The recurrent family adds the ``("insert", B)`` admission copy."""
    jcfg, jparams, tcfg, tparams = _models("xlstm-1.3b")
    work = _workload(tcfg.vocab_size, n=4, seed=4)
    kw = dict(batch_size=2, max_len=64, chunk_size=8)
    engine = Engine(tcfg, tparams, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, **kw)
    assert _serve(engine, Request, work) == _serve(jengine, JaxRequest, work)
    got, want = engine.cache_compiles, jengine.cache_compiles
    assert sorted(got.keys()) == sorted(want.keys())
    assert ("insert", 2) in got.keys()
    assert got.misses_by_name == want.misses_by_name
    assert engine.compile_budget == jengine.compile_budget
    assert got.misses <= engine.compile_budget


@pytest.fixture(scope="module")
def knob_models():
    return _models("qwen-7b", **OVERRIDES)


@pytest.fixture(scope="module")
def jax_knob_cache():
    """One JAX compile cache for every knob setting: the budget and the
    policy change no executable."""
    return JaxCompileCache()


@pytest.mark.parametrize("policy", ["mixed", "stall"])
@pytest.mark.parametrize("budget", [None, 8])
def test_scheduler_knobs_match_jax_engine(knob_models, jax_knob_cache,
                                          budget, policy):
    """``prefill_token_budget`` x ``prefill_policy``: the same streams,
    ticks and mixed ticks as the JAX engine."""
    jcfg, jparams, tcfg, tparams = knob_models
    work = _workload(tcfg.vocab_size, n=5, seed=5)
    kw = dict(batch_size=3, max_len=64, chunk_size=32,
              prefill_token_budget=budget, prefill_policy=policy)
    engine = Engine(tcfg, tparams, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, compile_cache=jax_knob_cache, **kw)
    assert _serve(engine, Request, work) == _serve(jengine, JaxRequest, work)
    assert (engine.steps, engine.mixed_ticks) == (jengine.steps,
                                                  jengine.mixed_ticks)
    assert engine.dispatches == engine.steps


def test_defaults_keep_the_unbudgeted_mixed_schedule(knob_models):
    """The defaults are the budget-free "mixed" policy: every mid-prefill
    row advances by a whole chunk each tick."""
    _, _, tcfg, tparams = knob_models
    work = _workload(tcfg.vocab_size, n=5, seed=5)
    a = Engine(tcfg, tparams, batch_size=3, max_len=64, chunk_size=32,
               device="cpu")
    b = Engine(tcfg, tparams, batch_size=3, max_len=64, chunk_size=32,
               prefill_token_budget=None, prefill_policy="mixed",
               device="cpu")
    assert _serve(a, Request, work) == _serve(b, Request, work)
    assert (a.steps, a.mixed_ticks) == (b.steps, b.mixed_ticks)


@pytest.mark.parametrize("policy", ["fifo", "", None])
def test_unknown_policy_raises(knob_models, policy):
    _, _, tcfg, tparams = knob_models
    with pytest.raises(ValueError, match="prefill_policy"):
        Engine(tcfg, tparams, prefill_policy=policy, device="cpu")
