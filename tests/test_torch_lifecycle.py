"""The port's request lifecycle against the JAX engine's: each case of
``tests/test_lifecycle.py`` (submit and admission edge cases, cancel at
every stage, deadlines on an injected clock, explicit truncation, lossless
bounded preemption under pool pressure and priorities, ``summarize``'s
outcome counts) runs the port's engine beside the reference's on the same
numpy params and prompts.  Statuses, outputs, ``preemptions``,
``resilience_stats()`` and ``summarize``'s counts are held equal, and the
port's streams equal its own ``reference_decode``.  An xLSTM case (forced
preemptions, re-admission through the ``("insert", B)`` fresh row) is held
against the port's oracle.

Models: quantized ``qwen-7b-smoke`` at d_model 128, d_ff 256, vocab 512
(slot); ``qwen-7b-smoke`` at d_model 64, d_ff 128, vocab 256 with a 6-block
pool of 8-token pages (paged), as in the reference's tests."""

import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.chaos import ChaosMonkey  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, RunResult, TERMINAL_STATES, reference_decode)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many ops on tiny tensors: one intra-op thread keeps the suite's
    parallel workers from waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OUTCOME_KEYS = ("n", "total_tokens", "completed", "errors", "cancelled",
                "deadline_missed", "preempted", "preemptions")


class Pair:
    """One model in both packages: engines and requests of either."""

    def __init__(self, overrides, seed, quantize):
        jcfg = jax_smoke_config("qwen-7b", **overrides)
        jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
        if quantize:
            jparams = jax_quantize(jparams, "dense")
        self.jcfg, self.jparams = jcfg, jparams
        self.cfg = get_smoke_config("qwen-7b", **overrides)
        self.params = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")

    def engine(self, pkg, **kw):
        if pkg == "jax":
            return jengine.Engine(self.jcfg, self.jparams, **kw)
        return Engine(self.cfg, self.params, device="cpu", **kw)

    @staticmethod
    def request(pkg, **kw):
        return (jengine.Request if pkg == "jax" else Request)(**kw)

    def oracle(self, prompt, n, max_len):
        return reference_decode(self.cfg, self.params, prompt, n,
                                max_len=max_len, device="cpu")


@pytest.fixture(scope="module")
def setup():
    return Pair(dict(d_model=128, d_ff=256, vocab_size=512), 0, True)


@pytest.fixture(scope="module")
def paged_setup():
    return Pair(dict(d_model=64, d_ff=128, vocab_size=256, kv_layout="paged",
                     kv_block_size=8, kv_pool_blocks=6), 1, False)


def _prompt(rng, n, vocab=512):
    return rng.integers(0, vocab, n).astype(np.int32)


def _run_some(eng, n, **kw):
    """run(max_steps=n) where truncation is the point."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return eng.run(max_steps=n, **kw)


def _record(eng, reqs, results=()):
    """What the two engines must agree on."""
    summary = type(eng).summarize(list(reqs))
    return {"requests": [(r.rid, r.status, r.output, r.preemptions, r.error)
                         for r in reqs],
            "resilience": eng.resilience_stats(),
            "summary": {k: summary.get(k) for k in OUTCOME_KEYS},
            "results": [[r.rid for r in res] for res in results]}


def _both(scenario):
    """Run ``scenario(pkg)`` for both packages; the records must be equal.
    Returns the port's."""
    got = {pkg: scenario(pkg) for pkg in ("port", "jax")}
    assert got["port"][0] == got["jax"][0]
    return got["port"][1]


# -- submit / admission edge cases ----------------------------------------

def test_prompt_exactly_max_len_admits(setup):
    """len(prompt) == max_len is admissible: the request emits exactly one
    token (the cache is full after prefill) and matches the oracle."""
    prompt = _prompt(np.random.default_rng(0), 32)

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=32, chunk_size=16)
        r = setup.request(pkg, rid=0, prompt=prompt, max_new_tokens=8)
        eng.submit(r)
        done = eng.run()
        return _record(eng, [r], [done]), r

    r = _both(scenario)
    assert r.status == "done" and len(r.output) == 1
    assert r.output == setup.oracle(prompt, 8, 32)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_max_new_tokens_zero_rejected(setup, pkg):
    eng = setup.engine(pkg, batch_size=2, max_len=64, chunk_size=16)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(setup.request(pkg, rid=900, prompt=np.zeros(4, np.int32),
                                 max_new_tokens=0))


def test_duplicate_rid_rejected_while_live(setup):
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=64, chunk_size=16)
        rng = np.random.default_rng(1)
        first = setup.request(pkg, rid=7, prompt=_prompt(rng, 4),
                              max_new_tokens=2)
        eng.submit(first)
        with pytest.raises(ValueError, match="rid already queued"):
            eng.submit(setup.request(pkg, rid=7, prompt=_prompt(rng, 4),
                                     max_new_tokens=2))
        eng.run()
        # the rid is free again once its first holder is terminal
        again = setup.request(pkg, rid=7, prompt=_prompt(rng, 4),
                              max_new_tokens=2)
        eng.submit(again)
        done = eng.run()
        return _record(eng, [first, again], [done]), again

    assert _both(scenario).status == "done"


# -- cancel at every lifecycle stage --------------------------------------

def test_cancel_before_admit(setup):
    """A queued request cancels without ever touching a slot; the rest of
    the queue is unaffected and still matches the oracle."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16)
        rng = np.random.default_rng(2)
        keep = setup.request(pkg, rid=0, prompt=_prompt(rng, 5),
                             max_new_tokens=3)
        doomed = setup.request(pkg, rid=1, prompt=_prompt(rng, 5),
                               max_new_tokens=3)
        eng.submit(keep)
        eng.submit(doomed)
        assert eng.cancel(1) is True
        assert doomed.status == "cancelled" and doomed.done
        assert doomed.output == [] and doomed.finished_at is not None
        done = eng.run()
        return _record(eng, [keep, doomed], [done]), (keep, done)

    keep, done = _both(scenario)
    assert [r.rid for r in done] == [0]
    assert keep.output == setup.oracle(keep.prompt, 3, 64)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cancel_unknown_rid_is_false(setup, pkg):
    eng = setup.engine(pkg, batch_size=2, max_len=64, chunk_size=16)
    assert eng.cancel(12345) is False


def test_cancel_mid_flight_frees_row_and_spares_neighbors(setup):
    """Cancelling a RUNNING request from inside a sample hook, mid-tick,
    frees only its slot; the surviving row's stream is still the
    oracle's, and the cancelled request is not echoed through run()."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=64, chunk_size=16)
        rng = np.random.default_rng(3)
        a = setup.request(pkg, rid=0, prompt=_prompt(rng, 6),
                          max_new_tokens=8)
        b = setup.request(pkg, rid=1, prompt=_prompt(rng, 6),
                          max_new_tokens=8)
        eng.submit(a)
        eng.submit(b)
        fired = []

        def sample(row):
            if len(a.output) == 2 and not fired:
                fired.append(eng.cancel(1))
            return int(np.argmax(row))

        done = eng.run(sample=sample)
        assert fired == [True]
        assert eng._slots[0].req is None and eng._slots[1].req is None
        return _record(eng, [a, b], [done]), (a, b, done)

    a, b, done = _both(scenario)
    assert b.status == "cancelled" and len(b.output) < 8
    assert a.status == "done" and a.output == setup.oracle(a.prompt, 8, 64)
    assert {r.rid for r in done} == {0}


def test_cancel_a_hooks_own_row(setup):
    """cancel() from inside the sample hook for the hook's OWN row (one
    slot, so the hook's row is the running request), once at the row's
    first token (the end of its prefill) and once mid-decode: the row
    retires cancelled with what it had emitted, the token of that sample
    is not emitted, and the next request is untouched."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16)
        rng = np.random.default_rng(12)
        reqs = [setup.request(pkg, rid=i, prompt=_prompt(rng, 6 + i),
                              max_new_tokens=6) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        cut = {0: 0, 2: 3}          # rid -> output length at its cancel

        def sample(row):
            r = eng._slots[0].req
            if r is not None and cut.get(r.rid) == len(r.output):
                assert eng.cancel(r.rid)
            return int(np.argmax(row))

        done = eng.run(sample=sample)
        return _record(eng, reqs, [done]), reqs

    reqs = _both(scenario)
    assert [r.status for r in reqs] == ["cancelled", "done", "cancelled"]
    assert reqs[0].output == [] and len(reqs[2].output) == 3
    for r in reqs:
        assert r.output == setup.oracle(r.prompt, 6, 64)[:len(r.output)]


@pytest.mark.parametrize("stage", ["mid-prefill", "mid-decode"])
def test_cancel_between_runs_frees_slot_and_blocks(paged_setup, stage):
    """cancel() between two ``run(max_steps=1)`` calls, while the request
    is mid-prefill (a 30-token prompt in 16-token chunks) or mid-decode:
    its slot and blocks go back, the pool audits green, its partial
    output is a prefix of the oracle's and the neighbour finishes
    unchanged."""
    setup = paged_setup
    rng = np.random.default_rng(14)
    prompts = [_prompt(rng, 30, 256), _prompt(rng, 7, 256)]

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=48, chunk_size=16,
                           audit_every=1)
        reqs = [setup.request(pkg, rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _run_some(eng, 1 if stage == "mid-prefill" else 4)
        victim = reqs[0]
        assert victim.status == "running"
        assert (eng._slots[0].pos < 30) == (stage == "mid-prefill")
        assert eng.cancel(0) and eng.cancel(0) is False
        assert eng._slots[0].req is None and not eng._slot_blocks[0]
        eng.audit()
        done = eng.run()
        rec = _record(eng, reqs, [done])
        rec["pool"] = eng.pool_stats()
        return rec, (eng, reqs)

    eng, reqs = _both(scenario)
    assert reqs[0].status == "cancelled" and reqs[1].status == "done"
    assert (reqs[0].output == []) == (stage == "mid-prefill")
    assert eng.cancels == 1
    for r in reqs:
        assert r.output == setup.oracle(r.prompt, 8, 48)[:len(r.output)]
    assert eng.alloc.n_free == eng.pool_blocks


# -- deadlines -------------------------------------------------------------

def test_deadline_zero_misses_deterministically(setup):
    """deadline_s=0.0 expires at the FIRST sweep, queued or already
    running; neighbours without deadlines are untouched."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16)
        rng = np.random.default_rng(4)
        reqs = [setup.request(pkg, rid=0, prompt=_prompt(rng, 5),
                              max_new_tokens=4, deadline_s=0.0),
                setup.request(pkg, rid=1, prompt=_prompt(rng, 5),
                              max_new_tokens=4, deadline_s=0.0),
                setup.request(pkg, rid=2, prompt=_prompt(rng, 5),
                              max_new_tokens=4)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        return _record(eng, reqs, [done]), (eng, reqs, done)

    eng, (doomed, queued_doomed, survivor), done = _both(scenario)
    assert doomed.status == "deadline_missed" and doomed.output == []
    assert queued_doomed.status == "deadline_missed"
    assert survivor.status == "done" and len(survivor.output) == 4
    assert eng.deadline_misses == 2
    assert {r.rid for r in done} == {0, 1, 2}


class Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def test_nonzero_deadline_fires_on_injected_clock(setup):
    """On an injected clock a NONZERO deadline misses exactly when the
    clock crosses submit + deadline_s, and not one step before."""
    def scenario(pkg):
        clock = Clock(1000.0)
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16,
                           clock=clock)
        rng = np.random.default_rng(11)
        r = setup.request(pkg, rid=0, prompt=_prompt(rng, 5),
                          max_new_tokens=4, deadline_s=30.0)
        eng.submit(r)
        assert r.submitted_at == 1000.0
        clock.t = 1029.9                 # inside the budget: runs to done
        eng.run()
        late = setup.request(pkg, rid=1, prompt=_prompt(rng, 5),
                             max_new_tokens=4, deadline_s=30.0)
        eng.submit(late)
        clock.t = 1060.0                 # 30.1 s after ITS submit
        eng.run()
        rec = _record(eng, [r, late])
        rec["times"] = [(q.submitted_at, q.first_token_at, q.finished_at)
                        for q in (r, late)]
        return rec, (eng, r, late)

    eng, r, late = _both(scenario)
    assert r.status == "done" and len(r.output) == 4
    assert late.status == "deadline_missed" and late.output == []
    assert eng.deadline_misses == 1


@pytest.mark.parametrize("enforce", [True, False])
def test_deadlines_not_enforced_when_disabled(setup, enforce):
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16,
                           enforce_deadlines=enforce)
        r = setup.request(pkg, rid=0,
                          prompt=_prompt(np.random.default_rng(5), 5),
                          max_new_tokens=3, deadline_s=0.0)
        eng.submit(r)
        eng.run()
        return _record(eng, [r]), (eng, r)

    eng, r = _both(scenario)
    if enforce:
        assert r.status == "deadline_missed" and eng.deadline_misses == 1
    else:
        assert r.status == "done" and eng.deadline_misses == 0


# -- run() truncation is explicit ------------------------------------------

def test_run_truncation_is_explicit(setup):
    """max_steps exhaustion with work in flight returns truncated=True (and
    warns) instead of silently dropping it; draining later clears every
    flag."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16)
        rng = np.random.default_rng(6)
        reqs = [setup.request(pkg, rid=i, prompt=_prompt(rng, 5),
                              max_new_tokens=8) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        with pytest.warns(RuntimeWarning, match="NOT drained"):
            part = eng.run(max_steps=2)
        rest = eng.run()
        flags = [(x.truncated, x.drained, x.in_flight, x.queued, x.stalled)
                 for x in (part, rest)]
        rec = _record(eng, reqs, [part, rest])
        rec["flags"] = flags
        return rec, (part, rest)

    part, rest = _both(scenario)
    assert isinstance(part, RunResult)
    assert part.truncated and not part.drained
    assert part.in_flight == 1 and part.queued == 1 and part == []
    assert rest.drained and not rest.truncated and not rest.stalled
    assert {r.rid for r in rest} == {0, 1}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_run_drained_has_no_warning(setup, pkg):
    eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16)
    eng.submit(setup.request(pkg, rid=0,
                             prompt=_prompt(np.random.default_rng(7), 4),
                             max_new_tokens=2))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        res = eng.run()
    assert res.drained


# -- preemption -------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix-donation", "plain-recompute"])
def test_preemption_lossless_paged(paged_setup, prefix_cache):
    """A hog mid-generation is preempted by a head it cannot share the pool
    with; both finish bitwise equal to their never-preempted streams, with
    the victim's blocks donated to the radix cache (sharing) or recomputed
    (no sharing), ``audit()`` green every tick."""
    setup = paged_setup

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=48, chunk_size=16,
                           prefix_cache=prefix_cache, max_preemptions=2,
                           audit_every=1)
        rng = np.random.default_rng(8)
        hog = setup.request(pkg, rid=0, prompt=_prompt(rng, 8, 256),
                            max_new_tokens=24)
        head = setup.request(pkg, rid=1, prompt=_prompt(rng, 16, 256),
                             max_new_tokens=16)
        eng.submit(hog)
        _run_some(eng, 6)                 # the hog emits a few tokens first
        assert 0 < len(hog.output) < 24
        eng.submit(head)                  # 6 blocks cannot hold both
        done = eng.run()
        assert done.drained
        eng.audit()
        rec = _record(eng, [hog, head], [done])
        rec["pool"] = eng.pool_stats()
        return rec, (eng, hog, head)

    eng, hog, head = _both(scenario)
    rng = np.random.default_rng(8)
    oracle = {0: setup.oracle(_prompt(rng, 8, 256), 24, 48),
              1: setup.oracle(_prompt(rng, 16, 256), 16, 48)}
    assert eng.preemptions >= 1 and 1 <= hog.preemptions <= 2
    assert head.preemptions <= 2
    assert hog.status == head.status == "done"
    assert hog.output == oracle[0] and head.output == oracle[1]
    assert hog.first_token_at is not None
    assert (eng.prefix is not None) == prefix_cache


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix-donation", "plain-recompute"])
def test_peak_pool_blocks_equals_the_reference(paged_setup, prefix_cache):
    """``peak_pool_blocks`` (the high-water count of blocks in use, taken
    after each dispatch) after the preemption workload above equals the
    JAX engine's, before, during and after the preemption."""
    setup = paged_setup

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=48, chunk_size=16,
                           prefix_cache=prefix_cache, max_preemptions=2,
                           audit_every=1)
        rng = np.random.default_rng(8)
        eng.submit(setup.request(pkg, rid=0, prompt=_prompt(rng, 8, 256),
                                 max_new_tokens=24))
        peaks = [eng.peak_pool_blocks]
        _run_some(eng, 6)
        peaks.append(eng.peak_pool_blocks)
        eng.submit(setup.request(pkg, rid=1, prompt=_prompt(rng, 16, 256),
                                 max_new_tokens=16))
        assert eng.run().drained
        peaks.append(eng.peak_pool_blocks)
        return peaks, eng

    eng = _both(scenario)
    assert 0 < eng.peak_pool_blocks <= eng.pool_blocks


def test_preemption_disabled_by_default(paged_setup):
    """max_preemptions=0 (the default) keeps stall-only admission: pool
    pressure stalls the head, nothing is evicted."""
    setup = paged_setup

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=2, max_len=48, chunk_size=16)
        rng = np.random.default_rng(9)
        reqs = [setup.request(pkg, rid=i, prompt=_prompt(rng, 8, 256),
                              max_new_tokens=24) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        rec = _record(eng, reqs, [done])
        rec["stalls"] = eng.admission_stalls
        return rec, (eng, reqs, done)

    eng, reqs, done = _both(scenario)
    assert done.drained and eng.preemptions == 0
    assert eng.admission_stalls > 0
    assert all(r.status == "done" for r in reqs)


def test_priority_preemption_on_slot_layout(setup):
    """A higher-priority head evicts a lower-priority running request on
    the slot layout too (plain evict and recompute); the victim still
    finishes losslessly, after the head."""
    rng = np.random.default_rng(10)
    low_prompt, high_prompt = _prompt(rng, 6), _prompt(rng, 6)

    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16,
                           max_preemptions=1)
        low = setup.request(pkg, rid=0, prompt=low_prompt,
                            max_new_tokens=20, priority=0)
        eng.submit(low)
        _run_some(eng, 4)
        assert 0 < len(low.output) < 20
        high = setup.request(pkg, rid=1, prompt=high_prompt,
                             max_new_tokens=3, priority=1)
        eng.submit(high)
        done = eng.run()
        assert done.drained
        rec = _record(eng, [low, high], [done])
        rec["folded"] = low.folded
        return rec, (eng, low, high)

    eng, low, high = _both(scenario)
    assert low.preemptions == 1 and eng.preemptions == 1
    assert high.finished_at < low.finished_at
    assert low.output == setup.oracle(low_prompt, 20, 64)
    assert high.output == setup.oracle(high_prompt, 3, 64)


def test_equal_priority_is_not_preempted_when_batch_full(setup):
    """Priority preemption is strict: an equal-priority head waits for a
    free slot instead of thrashing a peer."""
    def scenario(pkg):
        eng = setup.engine(pkg, batch_size=1, max_len=64, chunk_size=16,
                           max_preemptions=2)
        rng = np.random.default_rng(11)
        a = setup.request(pkg, rid=0, prompt=_prompt(rng, 5),
                          max_new_tokens=6)
        b = setup.request(pkg, rid=1, prompt=_prompt(rng, 5),
                          max_new_tokens=6)
        eng.submit(a)
        _run_some(eng, 2)
        eng.submit(b)
        eng.run()
        return _record(eng, [a, b]), (eng, a, b)

    eng, a, b = _both(scenario)
    assert eng.preemptions == 0
    assert a.status == b.status == "done"


def test_xlstm_forced_preemption_readmits_through_insert():
    """The xLSTM (slot layout, recurrent state): chaos forces a preemption
    of every running request once (``max_preemptions=1``); each re-admits
    through the ``("insert", B)`` fresh row and re-prefills its folded
    prompt, and its stream equals the port's oracle."""
    cfg = get_smoke_config("xlstm-1.3b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 9))),
                    max_new_tokens=5) for i in range(3)]
    lens = [len(r.prompt) for r in reqs]
    oracle = {r.rid: reference_decode(cfg, params, r.prompt, 5, max_len=32,
                                      device="cpu") for r in reqs}
    monkey = ChaosMonkey(seed=0, preempt_rate=1.0)
    eng = Engine(cfg, params, batch_size=2, max_len=32, chunk_size=8,
                 max_preemptions=1, chaos=monkey, audit_every=1,
                 device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert done.drained and len(done) == 3
    assert all(r.status == "done" and r.preemptions == 1 for r in reqs)
    assert eng.preemptions == 3 == monkey.injected["preemptions"]
    for r in reqs:
        assert r.output == oracle[r.rid], r.rid
        assert r.folded > 0 and len(r.prompt) == lens[r.rid] + r.folded
    # every admission (3 first ones, 3 re-admissions) copied a fresh row
    assert eng.cache_compiles.misses_by_name.get("insert") == 1
    assert eng.cache_compiles.hits >= 5
    assert eng.cache_compiles.misses <= eng.compile_budget


# -- summarize lifecycle counts, registry, defaults ------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_summarize_omits_empty_buckets_and_counts_outcomes(pkg):
    make = Pair.request
    r_done = make(pkg, rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=3)
    r_done.status = "done"
    r_done.output = [1, 2]
    r_err = make(pkg, rid=1, prompt=np.zeros(4, np.int32), max_new_tokens=3)
    r_err.status = "error"
    r_err.preemptions = 2
    r_miss = make(pkg, rid=2, prompt=np.zeros(4, np.int32), max_new_tokens=3)
    r_miss.status = "deadline_missed"
    eng = jengine.Engine if pkg == "jax" else Engine
    s = eng.summarize([r_done, r_err, r_miss])
    # no request ever produced a first token: the mean keys are OMITTED,
    # never nan
    assert "mean_ttft_s" not in s and "mean_tokens_per_s" not in s
    assert s["completed"] == 1 and s["errors"] == 1
    assert s["deadline_missed"] == 1 and s["cancelled"] == 0
    assert s["preempted"] == 1 and s["preemptions"] == 2
    assert all(not (isinstance(v, float) and np.isnan(v))
               for v in s.values())


def test_terminal_states_registry():
    assert TERMINAL_STATES == jengine.TERMINAL_STATES
    assert set(TERMINAL_STATES) == {"done", "error", "cancelled",
                                    "deadline_missed"}


def test_defaults_equal_the_reference():
    """Every lifecycle default of the engine and of a request is the
    reference's: check_finite=True, enforce_deadlines=True,
    max_preemptions=0, audit_every=0, no chaos; a request queued at
    priority 0 with no deadline."""
    def defaults(fn, names):
        params = inspect.signature(fn).parameters
        return {n: params[n].default for n in names}

    names = ("max_preemptions", "enforce_deadlines", "check_finite",
             "audit_every", "chaos", "spec_k", "prefix_cache",
             "prefill_policy", "chunk_size", "batch_size", "max_len")
    assert defaults(Engine.__init__, names) == \
        defaults(jengine.Engine.__init__, names)
    assert defaults(Engine.__init__, ("check_finite", "enforce_deadlines",
                                      "max_preemptions")) == {
        "check_finite": True, "enforce_deadlines": True,
        "max_preemptions": 0}
    fields = ("priority", "deadline_s", "status", "error", "preemptions",
              "folded", "done")
    assert defaults(Request, fields) == defaults(jengine.Request, fields)
    with pytest.raises(ValueError, match="max_preemptions"):
        Engine(get_smoke_config("qwen-7b"), None, max_preemptions=-1,
               device="cpu")
    assert RunResult().drained and not RunResult(stalled=True).drained
