"""The port's speculative decoding against the JAX package.

* The drafter: ``PromptLookupDrafter`` gives the reference's drafts on the
  same seeded histories.
* ``mixed_step(all_logits=True)``: every chunk position's logits against
  the reference's within ``MODEL_TOL`` (``INT8_MODEL_TOL`` for int8 K/V,
  as ``tests/test_torch_paged.py`` defines them) and, bitwise, against the
  port's sequential ``decode_step`` at each position, with every cache
  leaf.
* The engine with ``spec_k=4`` on slot, int8-KV, paged and paged-int8
  caches: the reference's repetition-heavy workload (``tests/test_spec.py``
  ``_rep_reqs``), token streams equal to the JAX engine's and to the
  port's ``reference_decode``, ``spec_stats()`` counters and compile keys
  equal to the JAX engine's; a garbage drafter (rewinds on nearly every
  verify tick) and a ``sample`` hook; the xLSTM's fallback to plain
  decode; the rollback primitive's block accounting.

Model: quantized ``qwen-7b-smoke`` at d_model 128, d_ff 256, vocab 512
(``tests/test_serving.py``'s widths), 2 or 3 slots, max_len 48, chunk 8
(buckets 4 and 8)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.draft import PromptLookupDrafter as JaxDrafter  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.draft import (  # noqa: E402
    PromptLookupDrafter, make_drafter)
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many ops on tiny tensors: one intra-op thread keeps the suite's
    parallel workers from waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = dict(d_model=128, d_ff=256, vocab_size=512)
LAYOUTS = {"slot": {}, "int8": dict(kv_quant="int8"),
           "paged": dict(kv_layout="paged", kv_block_size=8),
           "paged-int8": dict(kv_layout="paged", kv_block_size=8,
                              kv_quant="int8")}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
INT8_MODEL_TOL = dict(rtol=1e-2, atol=1e-2)
SPEC_COUNTERS = ("spec_k", "spec_requested", "spec_supported", "spec_ticks",
                 "verify_rows", "draft_tokens", "accepted_tokens", "rewinds")


@pytest.fixture(scope="module")
def models():
    """The reference's quantized smoke weights and the port's copy."""
    jcfg = jax_smoke_config("qwen-7b", **OVERRIDES)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config("qwen-7b", **OVERRIDES), tparams


def _cfgs(models, layout):
    jcfg, jparams, tcfg, tparams = models
    return (dataclasses.replace(jcfg, **LAYOUTS[layout]), jparams,
            dataclasses.replace(tcfg, **LAYOUTS[layout]), tparams)


# -- the drafter ---------------------------------------------------------------

@pytest.mark.parametrize("ngram_min,ngram_max", [(1, 1), (1, 3), (2, 4)])
def test_drafter_matches_reference(ngram_min, ngram_max):
    """A seeded fuzz of observes (whole prompts and single tokens), drafts
    of 0-6 tokens and resets over three slots: the port's drafter gives
    the reference's drafts and history lengths at every step."""
    rng = np.random.default_rng(ngram_max)
    port = PromptLookupDrafter(ngram_min=ngram_min, ngram_max=ngram_max)
    ref = JaxDrafter(ngram_min=ngram_min, ngram_max=ngram_max)
    for _ in range(400):
        slot = int(rng.integers(0, 3))
        op = rng.integers(0, 10)
        if op == 0:
            port.reset(slot)
            ref.reset(slot)
        elif op < 4:
            toks = rng.integers(0, 5, int(rng.integers(1, 9))).tolist()
            port.observe(slot, toks)
            ref.observe(slot, toks)
        else:
            k = int(rng.integers(0, 7))
            assert port.draft(slot, k) == ref.draft(slot, k)
        assert port.history_len(slot) == ref.history_len(slot)


def test_drafter_registry_and_validation():
    assert isinstance(make_drafter("plookup"), PromptLookupDrafter)
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("oracle")
    with pytest.raises(ValueError, match="ngram_min"):
        PromptLookupDrafter(ngram_max=0)


# -- mixed_step(all_logits=True) ----------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_all_logits_matches_reference_and_sequential_decode(models, layout):
    """Rows at lengths 0, 5, 13 and 29 (paged: a scrambled page table)
    verify 4 and then 8 positions with ragged ``q_lens`` (a dead row among
    them): every position's logits within the reference's tolerance, and
    bitwise the port's sequential ``decode_step`` at that position, with
    every cache leaf; positions past a row's ``q_lens`` are padding."""
    jcfg, jparams, tcfg, tparams = _cfgs(models, layout)
    paged = tcfg.kv_layout == "paged"
    tol = INT8_MODEL_TOL if tcfg.kv_quant == "int8" else MODEL_TOL
    b, max_len = 4, 48
    rng = np.random.default_rng(3)
    lens = np.asarray([0, 5, 13, 29], np.int32)
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    kw = {}
    if paged:
        table = rng.permutation(jcache["k"].shape[1] - 1).reshape(b, -1)
        kw["page_table"] = table.astype(np.int32)
    # prefill each row to its length (one mixed step in both packages)
    toks = rng.integers(0, jcfg.vocab_size, (b, 32)).astype(np.int32)
    _, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                jnp.zeros(b, jnp.int32), jnp.asarray(lens),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    _, tcache = api.mixed_step(tcfg, tparams, tcache,
                               torch.from_numpy(toks).long(), [0] * b, lens,
                               **kw)
    seq = {k: v.clone() for k, v in tcache.items()}
    for w, q_lens in ((4, [4, 0, 3, 4]), (8, [8, 5, 0, 8])):
        q_lens = np.asarray(q_lens, np.int32)
        toks = rng.integers(0, jcfg.vocab_size, (b, w)).astype(np.int32)
        jl, jcache = japi.mixed_step(
            jcfg, jparams, jcache, jnp.asarray(toks), jnp.asarray(lens),
            jnp.asarray(q_lens), all_logits=True,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tl, tcache = api.mixed_step(tcfg, tparams, tcache,
                                    torch.from_numpy(toks).long(), lens,
                                    q_lens, all_logits=True, **kw)
        assert tl.shape == (b, w, tcfg.vocab_size)
        live = np.arange(w)[None, :] < q_lens[:, None]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **tol)
        for j in range(w):
            mask = torch.from_numpy(j < q_lens)
            sl, seq = api.decode_step(
                tcfg, tparams, seq, torch.from_numpy(toks[:, j:j + 1]).long(),
                torch.from_numpy(lens + np.minimum(j, q_lens - 1) + 1),
                write_mask=mask, **kw)
            for r in np.flatnonzero(j < q_lens):
                assert torch.equal(tl[r, j], sl[r]), (w, r, j)
        for name in tcache:
            assert torch.equal(tcache[name], seq[name]), (w, name)
        lens = lens + q_lens


def test_all_logits_one_column_delegates_to_decode(models):
    """C == 1 keeps the decode delegation: (B, 1, V), zeros on a dead
    row, bitwise the plain (B, V) result."""
    _, _, tcfg, tparams = models
    toks = torch.tensor([[3], [7]])
    a, _ = api.mixed_step(tcfg, tparams, api.init_cache(tcfg, 2, 16, "cpu"),
                          toks, [0, 0], [1, 0], all_logits=True)
    p, _ = api.mixed_step(tcfg, tparams, api.init_cache(tcfg, 2, 16, "cpu"),
                          toks, [0, 0], [1, 0])
    assert a.shape == (2, 1, tcfg.vocab_size)
    assert torch.equal(a[:, 0], p) and not a[1].any()


# -- the engine ------------------------------------------------------------------

def _rep_work(vocab, n, seed, max_new=(4, 12)):
    """``tests/test_spec.py``'s ``_rep_reqs``: a 2-5 token pattern tiled 3
    times, so prompt lookup drafts from the first decode tick."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pat = rng.integers(0, vocab, int(rng.integers(2, 6)))
        out.append((i, np.tile(pat, 3).astype(np.int32),
                    int(rng.integers(*max_new))))
    return out


def _serve(engine, request_cls, work):
    reqs = [request_cls(rid=rid, prompt=p, max_new_tokens=n)
            for rid, p, n in work]
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == len(reqs) and all(r.done for r in reqs)
    return {r.rid: r.output for r in reqs}


def _assert_pool_intact(engine):
    stats = engine.pool_stats()
    assert stats["free"] == stats["total"] == engine.pool_blocks
    assert stats["leased"] == 0 and stats["reserved_outstanding"] == 0
    assert sorted(engine.alloc.free) == list(range(engine.pool_blocks))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_engine_matches_jax_engine_and_oracle(models, layout):
    """``spec_k=4``: streams equal to the JAX engine's and to the port's
    oracle; equal speculation counters (so the same verify rows, accepts
    and rewinds), ticks, compile keys and budget; one dispatch a tick,
    ``audit()`` green every tick and the pool whole after the drain."""
    jcfg, jparams, tcfg, tparams = _cfgs(models, layout)
    work = _rep_work(tcfg.vocab_size, 5, seed=2)
    kw = dict(batch_size=2, max_len=48, chunk_size=8, spec_k=4)
    engine = Engine(tcfg, tparams, audit_every=1, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, **kw)
    streams = _serve(engine, Request, work)
    assert streams == _serve(jengine, JaxRequest, work)
    stats, want = engine.spec_stats(), jengine.spec_stats()
    assert {k: stats[k] for k in SPEC_COUNTERS} == \
        {k: want[k] for k in SPEC_COUNTERS}
    assert stats["draft_tokens"] > 0 and stats["accepted_tokens"] > 0
    assert (engine.steps, engine.mixed_ticks) == (jengine.steps,
                                                  jengine.mixed_ticks)
    assert engine.dispatches == engine.steps == engine.audits
    got = engine.cache_compiles
    assert sorted(got.keys()) == sorted(jengine.cache_compiles.keys())
    assert engine.chunk_buckets.all_buckets() == [4, 8]
    assert engine.compile_budget == jengine.compile_budget == 4
    assert got.misses <= engine.compile_budget
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(tcfg, tparams, prompt, n,
                                                max_len=48, device="cpu")
    if engine.paged:
        _assert_pool_intact(engine)


class _GarbageDrafter:
    """``tests/test_spec.py``'s adversarial drafter: in-vocab, almost
    surely wrong drafts, so verify rows degenerate into one real token and
    a rewind."""

    def __init__(self, vocab):
        self.vocab, self._n = vocab, 0

    def reset(self, slot):
        pass

    def observe(self, slot, tokens):
        pass

    def draft(self, slot, k):
        self._n += 1
        return [(self._n * 7 + j * 3 + 1) % self.vocab for j in range(k)]


def test_garbage_drafts_cost_throughput_not_correctness(models):
    """Rewinds on nearly every verify tick on a paged pool: the same
    counters as the JAX engine, the oracle's streams and a whole pool."""
    jcfg, jparams, tcfg, tparams = _cfgs(models, "paged")
    work = _rep_work(tcfg.vocab_size, 6, seed=5, max_new=(6, 12))
    kw = dict(batch_size=3, max_len=48, chunk_size=8, spec_k=4)
    engine = Engine(tcfg, tparams, drafter=_GarbageDrafter(512),
                    audit_every=1, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, drafter=_GarbageDrafter(512), **kw)
    streams = _serve(engine, Request, work)
    assert streams == _serve(jengine, JaxRequest, work)
    stats, want = engine.spec_stats(), jengine.spec_stats()
    assert {k: stats[k] for k in SPEC_COUNTERS} == \
        {k: want[k] for k in SPEC_COUNTERS}
    assert stats["rewinds"] > 0
    _assert_pool_intact(engine)
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(tcfg, tparams, prompt, n,
                                                max_len=48, device="cpu")


def test_sample_hook_disables_drafting(models):
    """Acceptance is defined against greedy tokens, so a ``sample`` hook
    suppresses verify rows: spec on and off give the hook's streams."""
    _, _, tcfg, tparams = models

    def second_best(logits):
        return int(np.argsort(logits)[-2])

    outs = []
    for spec_k in (0, 4):
        engine = Engine(tcfg, tparams, batch_size=2, max_len=32,
                        chunk_size=8, spec_k=spec_k, device="cpu")
        reqs = [Request(rid=rid, prompt=p, max_new_tokens=n)
                for rid, p, n in _rep_work(tcfg.vocab_size, 3, seed=4)]
        for r in reqs:
            engine.submit(r)
        engine.run(sample=second_best)
        assert engine.spec_ticks == 0 and engine.spec_drafted == 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_spec_k_is_capped_and_validated(models):
    _, _, tcfg, tparams = models
    engine = Engine(tcfg, tparams, chunk_size=8, spec_k=20, device="cpu")
    assert engine.spec_k == 7 and engine.spec_requested == 20
    plain = Engine(tcfg, tparams, chunk_size=32, device="cpu")
    assert plain.drafter is None and plain.chunk_buckets.all_buckets() == [
        16, 32]
    with pytest.raises(ValueError, match="spec_k"):
        Engine(tcfg, tparams, spec_k=-1, device="cpu")


def test_recurrent_family_falls_back_to_plain_decode():
    """The xLSTM folds every token into its state: no rewind, so spec_k
    falls to 0 (recorded in the stats), as in the reference, and the
    engine still serves the oracle's streams."""
    jcfg = jax_smoke_config("xlstm-1.3b")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_smoke_config("xlstm-1.3b")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    engine = Engine(tcfg, tparams, batch_size=2, max_len=32, chunk_size=8,
                    spec_k=4, device="cpu")
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=32,
                        chunk_size=8, spec_k=4)
    assert engine.spec_k == jengine.spec_k == 0 and engine.drafter is None
    stats = engine.spec_stats()
    assert {k: stats[k] for k in SPEC_COUNTERS} == \
        {k: jengine.spec_stats()[k] for k in SPEC_COUNTERS}
    assert stats["spec_requested"] == 4 and not stats["spec_supported"]
    assert engine.chunk_buckets.all_buckets() == [8]
    work = _rep_work(tcfg.vocab_size, 2, seed=3, max_new=(3, 5))
    streams = _serve(engine, Request, work)
    assert engine.spec_ticks == 0
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(tcfg, tparams, prompt, n,
                                                max_len=32, device="cpu")


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "audio", "ssm",
                                    "hybrid"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_serving_gates_answer_as_the_reference(family, layout):
    over = dict(family=family, kv_layout=layout)
    jcfg = dataclasses.replace(jax_smoke_config("qwen-7b"), **over)
    tcfg = dataclasses.replace(get_smoke_config("qwen-7b"), **over)
    assert api.supports_speculation(tcfg) == japi.supports_speculation(jcfg)
    assert (api.supports_prefix_cache(tcfg)
            == japi.supports_prefix_cache(jcfg))


# -- rollback: block accounting ---------------------------------------------------

def _paged_engine(models):
    _, _, tcfg, tparams = _cfgs(models, "paged")
    return Engine(tcfg, tparams, batch_size=3, max_len=32, chunk_size=4,
                  spec_k=2, device="cpu")


def test_rewind_returns_whole_tail_blocks(models):
    """``tests/test_spec.py``'s case: a rewind re-nulls and frees every
    block wholly past the new length and credits the reservation; the
    same length is a no-op; past ``max_len`` raises; the pool comes back
    whole."""
    engine = _paged_engine(models)
    engine._slots[0].req = Request(rid=0, prompt=np.arange(4, dtype=np.int32))
    engine._live_rids.add(0)           # a running rid is live: audit() asks
    engine._slot_reserve[0] = 3
    engine._lease_to(0, 17)                  # 3 blocks at block_size 8
    engine._slots[0].length = 17
    leased = list(engine._slot_blocks[0])
    engine._rewind_slot(0, 9)                # ceil(9 / 8) = 2 survive
    assert engine._slots[0].length == 9
    assert engine._slot_blocks[0] == leased[:2]
    assert engine._page_table[0, 2] == engine._null_block
    assert leased[2] in engine.alloc.free
    assert engine._slot_reserve[0] == 1
    engine.audit()
    engine._rewind_slot(0, 9)
    assert engine._slot_blocks[0] == leased[:2]
    engine._rewind_slot(0, 8)                # a block boundary: 1 block
    assert engine._slot_blocks[0] == leased[:1]
    assert engine._slot_reserve[0] == 2
    with pytest.raises(ValueError, match="exceeds max_len"):
        engine._rewind_slot(0, engine.max_len + 1)
    engine._free_slot(0)
    _assert_pool_intact(engine)


def test_rewind_double_free_detected(models):
    engine = _paged_engine(models)
    engine._slots[0].req = Request(rid=0, prompt=np.arange(4, dtype=np.int32))
    engine._slot_reserve[0] = 2
    engine._lease_to(0, 16)                  # 2 blocks
    engine._slot_blocks[0][-1] = engine.alloc.free[0]   # corrupt: alias
    with pytest.raises(RuntimeError, match="double free"):
        engine._rewind_slot(0, 1)
