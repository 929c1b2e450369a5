"""The port's prefix sharing with copy-on-write against the JAX package.

* ``RadixPrefixCache`` and ``BlockAllocator``: a seeded host fuzz of the
  engine's operations (match, admit with shared, copy-on-write and fresh
  blocks, cache insert, rewind, retire, LRU eviction, clear) drives the
  port's pair and the reference's: the same results, refcounts and free
  lists at every step, and the pool whole after the drain.
* ``api.copy_pool_block`` on converted caches (fp and int8 paged pools):
  every leaf equal to the reference's after the copy.
* The engine with ``prefix_cache=True``, alone and with ``spec_k=4``, on a
  paged and a paged int8 pool: waves of requests sharing a system prompt
  (a block-aligned hit, a copy-on-write hit mid-block, a prompt cached
  whole) under pool pressure (cold leaves evicted).  Streams equal to the
  JAX engine's and the port's ``reference_decode``; ``prefix_stats()`` and
  ``spec_stats()`` counters equal to the JAX engine's; ``audit()`` green
  every tick (refcounts against the slots and the cache); the pool whole
  after ``drop_prefix_cache()``.  Slot layouts and the xLSTM run without
  sharing, as in the reference.

Model: quantized ``qwen-7b-smoke`` at d_model 128, d_ff 256, vocab 512,
8-token pages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.prefix import BlockAllocator as JaxAllocator  # noqa: E402
from repro.serving.prefix import RadixPrefixCache as JaxRadix  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)
from repro_torch.serving.prefix import (  # noqa: E402
    BlockAllocator, RadixPrefixCache)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many ops on tiny tensors: one intra-op thread keeps the suite's
    parallel workers from waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OVERRIDES = dict(d_model=128, d_ff=256, vocab_size=512, kv_layout="paged",
                 kv_block_size=8)
PREFIX_COUNTERS = ("enabled", "requested", "hits", "hit_tokens",
                   "cow_copies", "evictions", "cached_blocks",
                   "shared_blocks")
SPEC_COUNTERS = ("spec_k", "spec_ticks", "verify_rows", "draft_tokens",
                 "accepted_tokens", "rewinds")


# -- the host side -------------------------------------------------------------

class _Pair:
    """One package's allocator and radix cache, driven as the engine does."""

    def __init__(self, alloc, cache):
        self.alloc, self.cache = alloc, cache

    def admit(self, prompt):
        """``Engine._prefix_plan`` + ``_admit``: shared blocks increfed,
        a copy-on-write block leased, the rest of the prompt leased."""
        bs = self.cache.block_size
        full, partial = self.cache.match(prompt)
        consumed, cow = len(full) * bs, None
        if partial is not None:
            n = min(partial[1], len(prompt) - 1 - consumed)
            if n > 0:
                cow, consumed = partial[0], consumed + n
        elif consumed >= len(prompt):
            cow = full.pop()
        need = -(-len(prompt) // bs) - len(full)
        if self.alloc.n_free < need:
            return None, (full, partial)
        for blk in full:
            self.alloc.incref(blk)
        owned = list(full)
        while len(owned) < -(-len(prompt) // bs):
            owned.append(self.alloc.lease())
        return owned, (full, partial, cow)


def test_radix_cache_and_allocator_match_reference():
    """Seeded fuzz over 5 seeds x 150 operations (a 6-token vocabulary so
    prompts collide): every match, insert, eviction and clear returns what
    the reference's returns, and refcounts and free lists stay equal."""
    for seed in (0, 1, 7, 23, 101):
        rng = np.random.default_rng(seed)
        bs, n_blocks = 4, 12
        port = _Pair(BlockAllocator(n_blocks), RadixPrefixCache(bs))
        ref = _Pair(JaxAllocator(n_blocks), JaxRadix(bs))
        slots: list[dict] = []
        for _ in range(150):
            op = rng.choice(["admit", "retire", "rewind", "insert", "evict",
                             "match", "clear"], p=[.3, .15, .1, .2, .12, .1,
                                                   .03])
            if op == "admit" and len(slots) < 4:
                prompt = rng.integers(0, 6, int(rng.integers(1, 4 * bs))
                                      ).tolist()
                got, want = port.admit(prompt), ref.admit(prompt)
                assert got == want
                if got[0] is not None:
                    slots.append({"prompt": prompt, "blocks": got[0]})
            elif op == "retire" and slots:
                s = slots.pop(int(rng.integers(len(slots))))
                for blk in s["blocks"]:
                    assert port.alloc.decref(blk) == ref.alloc.decref(blk)
            elif op == "rewind" and slots:
                s = slots[int(rng.integers(len(slots)))]
                if len(s["blocks"]) > 1:
                    blk = s["blocks"].pop()
                    assert port.alloc.decref(blk) == ref.alloc.decref(blk)
                    s["prompt"] = s["prompt"][:len(s["blocks"]) * bs]
            elif op == "insert" and slots:
                s = slots[int(rng.integers(len(slots)))]
                nfull = len(s["prompt"]) // bs
                if nfull:
                    args = (s["prompt"][:nfull * bs], s["blocks"][:nfull])
                    fresh = port.cache.insert(*args)
                    assert fresh == ref.cache.insert(*args)
                    for blk in fresh:
                        port.alloc.incref(blk)
                        ref.alloc.incref(blk)
            elif op == "evict":
                keep = set(rng.choice(n_blocks, 3).tolist())
                got = port.cache.evict_lru(
                    keep=lambda b: b in keep or port.alloc.ref(b) > 1)
                want = ref.cache.evict_lru(
                    keep=lambda b: b in keep or ref.alloc.ref(b) > 1)
                assert got == want
                if got is not None:
                    assert port.alloc.decref(got) is ref.alloc.decref(want)
            elif op == "match":
                prompt = rng.integers(0, 6, int(rng.integers(1, 20))).tolist()
                assert port.cache.match(prompt) == ref.cache.match(prompt)
            elif op == "clear":
                got = port.cache.clear()
                assert got == ref.cache.clear()
                for blk in got:
                    port.alloc.decref(blk)
                    ref.alloc.decref(blk)
            port.alloc.check()
            assert (port.alloc.free, port.alloc.refs) == (ref.alloc.free,
                                                          ref.alloc.refs)
            assert port.alloc.n_shared() == ref.alloc.n_shared()
            assert len(port.cache) == len(ref.cache)
            assert sorted(port.cache.blocks()) == sorted(ref.cache.blocks())
        for s in slots:
            for blk in s["blocks"]:
                port.alloc.decref(blk)
        for blk in port.cache.clear():
            port.alloc.decref(blk)
        port.alloc.check()
        assert port.alloc.n_free == n_blocks and port.alloc.n_live == 0


def test_radix_cache_units():
    """``tests/test_prefix.py``'s radix cases on the port's cache."""
    c = RadixPrefixCache(4)
    toks = list(range(12))
    assert c.insert(toks, [10, 11, 12]) == [10, 11, 12]
    assert c.match(toks + [99]) == ([10, 11, 12], None)
    assert c.match([0, 1, 2, 3, 4, 5, 77, 77]) == ([10], (11, 2))
    assert c.match([0, 1, 2, 3, 66, 66, 66, 66]) == ([10], None)
    assert c.insert(toks[:4] + [9] * 4, [8, 5]) == [5]   # first author wins
    with pytest.raises(ValueError, match="fully-written"):
        c.insert([0, 1, 2], [7])
    assert sorted(c.clear()) == [5, 10, 11, 12]
    assert len(c) == 0 and c.match([0, 1]) == ([], None)
    with pytest.raises(ValueError, match="block_size"):
        RadixPrefixCache(0)


# -- copy_pool_block -------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_copy_pool_block_matches_reference(kv_quant):
    """Random pool leaves (scales included) through both packages' copy:
    every leaf equal; a slot layout is refused by both."""
    jcfg = jax_smoke_config("qwen-7b", kv_quant=kv_quant, **OVERRIDES)
    tcfg = get_smoke_config("qwen-7b", kv_quant=kv_quant, **OVERRIDES)
    rng = np.random.default_rng(1)
    leaves = {}
    for name, leaf in japi.init_cache(jcfg, 2, 32).items():
        a = np.asarray(leaf)
        leaves[name] = (rng.integers(-127, 128, a.shape).astype(a.dtype)
                        if a.dtype == np.int8 else
                        rng.normal(size=a.shape).astype(a.dtype))
    jcache = {k: jnp.asarray(v) for k, v in leaves.items()}
    tcache = interop.params_from_numpy(leaves, "cpu")
    for src, dst in ((3, 5), (0, 7), (2, 2)):
        jcache = japi.copy_pool_block(jcfg, jcache, src, dst)
        api.copy_pool_block(tcfg, tcache, torch.tensor([src]),
                            torch.tensor([dst]))
    for name in leaves:
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]), err_msg=name)
    assert not np.array_equal(tcache["k"].numpy(), leaves["k"])
    slot = dataclasses.replace(tcfg, kv_layout="slot")
    with pytest.raises(ValueError, match="prefix-shareable"):
        api.copy_pool_block(slot, api.init_cache(slot, 1, 16, "cpu"), 0, 1)
    with pytest.raises(ValueError, match="prefix-shareable"):
        japi.copy_pool_block(dataclasses.replace(jcfg, kv_layout="slot"),
                             {}, 0, 1)


# -- the engine ------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen-7b", **OVERRIDES)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config("qwen-7b", **OVERRIDES), tparams


def _waves(vocab):
    """Three waves around a 20-token system prompt (two pages and a half):
    wave 0 authors it (and a 32-token prompt of four whole pages); wave 1
    hits it mid-block (copy-on-write), block-aligned, and with the author's
    prompt repeated whole (the last page demoted to copy-on-write); a cold
    40-token request squeezes the 12-block pool so cache leaves go."""
    rng = np.random.default_rng(13)
    system = rng.integers(0, vocab, 20).tolist()
    author = system + rng.integers(0, vocab, 12).tolist()

    def tail(n):
        return rng.integers(0, vocab, n).tolist()
    return [
        [system + tail(5), author],
        [system + tail(3), author[:24] + tail(6), author, system + tail(9)],
        [tail(40), system + tail(2), author[:28] + tail(4)],
    ]


def _serve_waves(engine, request_cls, waves, max_new=5):
    reqs, rid = [], 0
    for wave in waves:
        batch = []
        for p in wave:
            batch.append(request_cls(rid=rid, prompt=np.asarray(p, np.int32),
                                     max_new_tokens=max_new))
            rid += 1
        for r in batch:
            engine.submit(r)
        engine.run()
        reqs += batch
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], [r.prompt for r in reqs]


def _assert_pool_whole(engine):
    engine.drop_prefix_cache()
    engine.alloc.check()
    stats = engine.pool_stats()
    assert stats["leased"] == 0 and stats["reserved_outstanding"] == 0
    assert stats["free"] == stats["total"]


@pytest.mark.parametrize("spec_k", [0, 4], ids=["prefix", "prefix-spec"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefix_engine_matches_jax_engine_and_oracle(models, kv_quant,
                                                     spec_k):
    jcfg, jparams, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant, kv_pool_blocks=12)
    tcfg = dataclasses.replace(tcfg, kv_quant=kv_quant, kv_pool_blocks=12)
    kw = dict(batch_size=2, max_len=48, chunk_size=8, prefix_cache=True,
              spec_k=spec_k)
    engine = Engine(tcfg, tparams, audit_every=1, device="cpu", **kw)
    jengine = JaxEngine(jcfg, jparams, **kw)
    waves = _waves(tcfg.vocab_size)
    streams, prompts = _serve_waves(engine, Request, waves)
    assert streams == _serve_waves(jengine, JaxRequest, waves)[0]
    stats, want = engine.prefix_stats(), jengine.prefix_stats()
    assert {k: stats[k] for k in PREFIX_COUNTERS} == \
        {k: want[k] for k in PREFIX_COUNTERS}
    assert stats["hits"] >= 4 and stats["cow_copies"] >= 2
    assert stats["evictions"] > 0
    got, jwant = engine.spec_stats(), jengine.spec_stats()
    assert {k: got[k] for k in SPEC_COUNTERS} == \
        {k: jwant[k] for k in SPEC_COUNTERS}
    assert (got["draft_tokens"] > 0) == bool(spec_k)
    assert engine.pool_stats()["cow_copies"] == stats["cow_copies"]
    assert (engine.steps, engine.admission_stalls) == (
        jengine.steps, jengine.admission_stalls)
    cc = engine.cache_compiles
    assert sorted(cc.keys()) == sorted(jengine.cache_compiles.keys())
    assert ("cow", 0) in cc.keys()
    assert engine.compile_budget == jengine.compile_budget
    assert cc.misses <= engine.compile_budget
    assert engine.audits == engine.steps
    for p, out in zip(prompts, streams):
        assert out == reference_decode(tcfg, tparams, p, 5, max_len=48,
                                       device="cpu")
    _assert_pool_whole(engine)


def test_prefix_on_off_streams_equal(models):
    """Sharing changes where K/V lives, never what it holds: the streams
    of the cache-on engine are the cache-off engine's."""
    _, _, tcfg, tparams = models
    waves = _waves(tcfg.vocab_size)
    outs = []
    for on in (False, True):
        engine = Engine(tcfg, tparams, batch_size=2, max_len=48,
                        chunk_size=8, prefix_cache=on, device="cpu")
        outs.append(_serve_waves(engine, Request, waves)[0])
        assert engine.prefix_sharing == on
    assert outs[0] == outs[1]


def test_cached_blocks_outlive_their_author(models):
    """``tests/test_prefix.py``'s case: the cache holds its own reference,
    so a system prompt stays resident after its author retires and later
    requests map it read-only (two hits of 16 tokens, one slot)."""
    _, _, tcfg, tparams = models
    system = np.random.default_rng(4).integers(0, 512, 16).tolist()
    engine = Engine(tcfg, tparams, batch_size=1, max_len=96, chunk_size=8,
                    prefix_cache=True, audit_every=1, device="cpu")
    _serve_waves(engine, Request,
                 [[system + [1, 2, 3]], [system + [4, 5]], [system + [6]]])
    stats = engine.pool_stats()
    assert engine.prefix_hits == 2 and stats["prefix_hit_tokens"] == 32
    assert stats["leased"] == stats["cached_blocks"] == 2
    _assert_pool_whole(engine)


def test_sharing_falls_back_where_the_reference_does(models):
    """A slot layout and the xLSTM cannot share blocks: ``prefix_cache``
    is recorded as requested and the engine runs without it (no
    ``("cow", 0)`` key, the plain budget)."""
    _, _, tcfg, tparams = models
    slot = dataclasses.replace(tcfg, kv_layout="slot")
    engine = Engine(slot, tparams, batch_size=2, max_len=48, chunk_size=8,
                    prefix_cache=True, device="cpu")
    stats = engine.prefix_stats()
    assert stats["requested"] and not stats["enabled"]
    assert engine.prefix is None and engine.compile_budget == 3
    assert engine.drop_prefix_cache() == 0
    xcfg = get_smoke_config("xlstm-1.3b")
    assert not api.supports_prefix_cache(xcfg)
    assert not api.supports_prefix_cache(dataclasses.replace(
        xcfg, kv_layout="paged"))
