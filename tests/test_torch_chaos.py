"""The port's fault injection and row quarantine against the reference's
(``tests/test_chaos.py``, but for its multi-device mesh cell).

* ``ChaosMonkey``: the port's monkey draws what the reference's draws, seam
  by seam, for the same seed.
* Quarantine: NaN rows (chaos, and a real NaN from a poisoned embedding
  row), a throwing ``sample`` hook, garbage drafts, a deadline storm and the
  audit's teeth, each beside the JAX engine where the run is the same.
* The soak: every one of the six cells drains with its done streams equal
  to the port's ``reference_decode``; the ``slot`` and ``paged-all`` cells
  equal the JAX engine's under the same chaos seed, request by request
  (status, output, preemptions) and in ``resilience_stats()``.
* The reference's fault: on a paged pool, a poisoned embedding row puts
  NaN K/V into the null block (dead rows write there, and their padding
  token is id 0), and every later request that reads it is quarantined.
  The port skips dead writes, so only the poisoned row faults."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import chaos  # noqa: E402
from repro_torch.serving.chaos import (  # noqa: E402
    SOAK_CELLS, ChaosConfig, ChaosMonkey, EngineKilled, run_soak_cell)
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


OVERRIDES = dict(d_model=64, d_ff=128, vocab_size=256, kv_layout="paged",
                 kv_block_size=8, kv_pool_blocks=24)


def _models(overrides, seed, poison=None):
    """(jax cfg, jax params, port cfg, port params) from one PRNG key;
    ``poison``: an embedding row set to NaN in both."""
    jcfg = jax_smoke_config("qwen-7b", **overrides)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    if poison is not None:
        jparams["embed"] = jparams["embed"].at[poison].set(jnp.nan)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config("qwen-7b", **overrides), tparams


@pytest.fixture(scope="module")
def setup():
    return _models(OVERRIDES, 0)


def _work(rng, n, max_new=6):
    return [(i, rng.integers(0, 256, int(rng.integers(4, 17))).astype(
        np.int32), max_new) for i in range(n)]


def _engines(setup, work, **kw):
    """One engine per package, the same requests submitted to each."""
    jcfg, jparams, tcfg, tparams = setup
    out = {}
    for pkg in ("port", "jax"):
        if pkg == "jax":
            kw_j = dict(kw)
            if "chaos" in kw_j:
                kw_j["chaos"] = jchaos.ChaosMonkey(kw_j["chaos"].config)
            eng = jengine.Engine(jcfg, jparams, **kw_j)
            make = jengine.Request
        else:
            eng = Engine(tcfg, tparams, device="cpu", **kw)
            make = Request
        reqs = [make(rid=i, prompt=p, max_new_tokens=n) for i, p, n in work]
        for r in reqs:
            eng.submit(r)
        out[pkg] = (eng, reqs)
    return out


def _outcomes(reqs):
    return [(r.rid, r.status, r.output, r.preemptions, r.error)
            for r in reqs]


def _oracle(setup, work, max_len=64):
    _, _, tcfg, tparams = setup
    return {i: reference_decode(tcfg, tparams, p, n, max_len=max_len,
                                device="cpu") for i, p, n in work}


# -- the injector ------------------------------------------------------------

def _trace(m, n=60):
    t = []
    for _ in range(n):
        t.append(m.deny_reservation())
        t.append(m.forced_preempt([0, 1, 2]))
        t.append(tuple(m.corrupt_rows([0, 1, 2, 3])))
        t.append(tuple(m.garble_draft([5, 6, 7], 256)))
        try:
            m.maybe_kill()
            t.append(False)
        except (EngineKilled, jchaos.EngineKilled):
            t.append(True)
    return t


def test_chaos_monkey_draws_what_the_reference_draws():
    """The same seed gives the same faults, seam by seam, in both
    packages (so runs compare event by event), and in one package twice;
    another seed gives others."""
    rates = dict(seed=7, deny_rate=0.3, preempt_rate=0.3, nan_rate=0.3,
                 garbage_draft_rate=0.3, kill_rate=0.05)
    port = ChaosMonkey(ChaosConfig(**rates))
    ref = jchaos.ChaosMonkey(jchaos.ChaosConfig(**rates))
    trace = _trace(port)
    assert trace == _trace(ref)
    assert port.stats() == ref.stats()
    assert _trace(ChaosMonkey(**rates)) == trace
    other = ChaosMonkey(**{**rates, "seed": 8})
    assert _trace(other) != trace
    # a scheduled kill fires once at its tick and draws nothing
    m = ChaosMonkey(seed=0, kill_after=3)
    m.maybe_kill()
    m.maybe_kill()
    with pytest.raises(EngineKilled, match="tick 3"):
        m.maybe_kill()
    m.maybe_kill()
    assert m.injected["kills"] == 1
    assert m._rng.random() == np.random.default_rng(0).random()


def test_soak_cell_is_reproducible():
    """Same (cell, seed): identical outcomes and injection counters, end to
    end through the port's engine."""
    kw = dict(seed=3, n_requests=6, device="cpu")
    first = run_soak_cell("paged", "paged", "none", 0, False, **kw)
    assert first == run_soak_cell("paged", "paged", "none", 0, False, **kw)


def test_zero_rates_inject_nothing(setup):
    """All-zero rates: the run is the chaos-free one, bitwise the oracle's
    in both packages, with nothing injected."""
    work = _work(np.random.default_rng(1), 4)
    oracle = _oracle(setup, work)
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    chaos=ChaosMonkey(seed=0), audit_every=1)
    for eng, _ in runs.values():
        eng.run()
    eng, reqs = runs["port"]
    assert all(r.status == "done" and r.output == oracle[r.rid]
               for r in reqs)
    assert all(v == 0 for v in eng.chaos.injected.values())
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])


# -- per-row fault isolation ------------------------------------------------

def test_nan_rate_one_quarantines_everything_pool_intact(setup):
    """nan_rate=1.0: every advancing row faults at its first dispatch; all
    requests end ``error`` with no output and the pool is whole."""
    work = _work(np.random.default_rng(2), 5)
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    chaos=ChaosMonkey(seed=0, nan_rate=1.0), audit_every=1)
    for eng, _ in runs.values():
        assert eng.run().drained
    eng, reqs = runs["port"]
    assert all(r.status == "error" and r.error == "non-finite logits"
               and r.output == [] for r in reqs)
    assert eng.row_faults == 5 and eng.alloc.n_free == eng.pool_blocks
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])
    assert eng.resilience_stats() == runs["jax"][0].resilience_stats()
    eng.audit()


def test_nan_row_never_donated_to_prefix_cache(setup):
    """A faulted row's blocks are freed, never donated: chaos NaN rows
    fault before any prompt completes, so nothing is cacheable."""
    work = _work(np.random.default_rng(3), 3)
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    prefix_cache=True,
                    chaos=ChaosMonkey(seed=0, nan_rate=1.0), audit_every=1)
    for eng, _ in runs.values():
        eng.run()
    eng, reqs = runs["port"]
    assert all(r.status == "error" for r in reqs)
    assert not eng.prefix.blocks() and eng.alloc.n_free == eng.pool_blocks
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])


def test_real_nan_row_on_its_last_chunk_is_not_donated():
    """A real non-finite row (a poisoned token in the last chunk of a
    three-page prompt) faults on that chunk: its two full pages written
    before it are not donated, so a later request with the same first 16
    tokens gets no prefix hit, and its stream is the oracle's."""
    poison = 255
    setup = _models(OVERRIDES, 0, poison=poison)
    rng = np.random.default_rng(15)
    head = rng.integers(0, 255, 16).astype(np.int32)
    bad = np.concatenate([head, rng.integers(0, 255, 8)]).astype(np.int32)
    bad[20] = poison
    later = np.concatenate([head, rng.integers(0, 255, 5)]).astype(np.int32)
    work = [(0, bad, 4), (1, later, 4)]
    runs = _engines(setup, work, batch_size=1, max_len=64, chunk_size=16,
                    prefix_cache=True, audit_every=1)
    for eng, _ in runs.values():
        eng.run()
    eng, reqs = runs["port"]
    assert [r.status for r in reqs] == ["error", "done"]
    assert eng.row_faults == 1 and eng.prefix_hits == 0
    assert reqs[1].output == _oracle(setup, work[1:])[1]
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])


def test_sample_hook_exception_quarantines_only_that_row(setup):
    """A throwing sample hook errors the row it fired on; the other request
    still finishes bitwise equal to the oracle."""
    rng = np.random.default_rng(4)
    work = [(i, rng.integers(0, 256, 6).astype(np.int32), 6)
            for i in range(2)]
    oracle = _oracle(setup, work)
    runs = _engines(setup, work, batch_size=1, max_len=64, chunk_size=16,
                    audit_every=1)
    for eng, (a, b) in runs.values():
        def sample(row, b=b):
            if b.status == "running":     # one slot: b's own row
                raise RuntimeError("boom")
            return int(np.argmax(row))
        assert eng.run(sample=sample).drained
    eng, (a, b) = runs["port"]
    assert a.status == "done" and a.output == oracle[0]
    assert b.status == "error" and "boom" in b.error
    assert eng.row_faults == 1 and eng.alloc.n_free == eng.pool_blocks
    assert _outcomes(runs["port"][1]) == _outcomes(runs["jax"][1])


@pytest.mark.parametrize("check_finite", [True, False])
def test_chaos_nan_rows_with_a_hook_and_without_the_check(setup,
                                                          check_finite):
    """A chaos NaN row with a ``sample`` hook: the hook sees a NaN row; with
    ``check_finite=False`` nothing is quarantined and the hook's token (or
    the greedy one) stands, as in the reference."""
    work = _work(np.random.default_rng(16), 4)
    seen = {}
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    check_finite=check_finite, audit_every=1,
                    chaos=ChaosMonkey(seed=5, nan_rate=0.3))
    for pkg, (eng, _) in runs.items():
        def sample(row, pkg=pkg):
            seen[pkg] = seen.get(pkg, 0) + int(np.isnan(row).any())
            return int(np.argmax(np.nan_to_num(row, nan=-np.inf)))
        eng.run(sample=sample)
    eng, reqs = runs["port"]
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])
    assert eng.resilience_stats() == runs["jax"][0].resilience_stats()
    assert eng.chaos.injected["nan_rows"] > 0
    assert (eng.row_faults > 0) == check_finite
    assert seen.get("port", 0) == seen.get("jax", 0)
    assert (seen.get("port", 0) > 0) == (not check_finite)


# -- garbage drafts ---------------------------------------------------------

def test_garbage_drafts_are_lossless(setup):
    """garbage_draft_rate=1.0: every draft is junk; verification rejects it
    and outputs stay bitwise the oracle's."""
    work = _work(np.random.default_rng(5), 4, max_new=8)
    oracle = _oracle(setup, work)
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    spec_k=3, chaos=ChaosMonkey(seed=0,
                                                garbage_draft_rate=1.0),
                    audit_every=1)
    for eng, _ in runs.values():
        eng.run()
    eng, reqs = runs["port"]
    assert all(r.status == "done" and r.output == oracle[r.rid]
               for r in reqs)
    assert eng.chaos.injected["garbled_drafts"] > 0
    assert eng.spec_stats()["acceptance_rate"] < 0.25
    assert eng.spec_stats() == runs["jax"][0].spec_stats()
    assert eng.chaos.stats() == runs["jax"][0].chaos.stats()


# -- deadline storm ---------------------------------------------------------

def test_deadline_storm_kills_only_deadlined_rows(setup):
    """Half the workload carries deadline_s=0.0: those all miss, the rest
    drain bitwise correct."""
    work = _work(np.random.default_rng(6), 6)
    oracle = _oracle(setup, work)
    runs = _engines(setup, work, batch_size=2, max_len=64, chunk_size=16,
                    audit_every=1)
    for eng, reqs in runs.values():
        for r in reqs:
            if r.rid % 2:
                r.deadline_s = 0.0
        eng.run()
    eng, reqs = runs["port"]
    for r in reqs:
        if r.rid % 2:
            assert r.status == "deadline_missed"
        else:
            assert r.status == "done" and r.output == oracle[r.rid]
    assert eng.deadline_misses == 3 and eng.alloc.n_free == eng.pool_blocks
    assert _outcomes(reqs) == _outcomes(runs["jax"][1])


# -- the audit has teeth ----------------------------------------------------

def test_audit_catches_corrupted_state(setup):
    """audit() fails on a corrupt engine, or its per-tick green proves
    nothing."""
    _, _, tcfg, tparams = setup
    eng = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                 device="cpu")
    eng.submit(Request(rid=0, prompt=np.random.default_rng(7).integers(
        0, 256, 8).astype(np.int32), max_new_tokens=4))
    eng.run()
    eng.audit()
    eng._slot_reserve[0] = eng.pool_blocks + 1     # over-reservation
    with pytest.raises(AssertionError):
        eng.audit()
    eng._slot_reserve[0] = 0
    eng.audit()
    eng._slot_blocks[0] = [0]                      # a dead slot's block
    with pytest.raises(AssertionError):
        eng.audit()
    eng._slot_blocks[0] = []
    eng.audit()
    eng._slots[1].req = Request(rid=99, prompt=np.zeros(2, np.int32))
    with pytest.raises(AssertionError, match="untracked"):
        eng.audit()                                # a rid nobody submitted


# -- the soak -----------------------------------------------------------------

@pytest.mark.parametrize("cell", SOAK_CELLS, ids=lambda c: c[0])
def test_soak_cell_drains_to_the_oracle(cell):
    """Each cell on the port's own weights: every request terminal, done
    streams bitwise the oracle's, faulted ones a prefix of it, the audit
    green every tick, no block leaked."""
    stats = run_soak_cell(*cell, seed=0, n_requests=8, device="cpu")
    assert sum(stats["outcomes"].values()) == 8
    assert stats["outcomes"].get("done", 0) >= 1
    assert stats["audits"] > 0 and stats["chaos"]["seed"] == 1


@pytest.mark.parametrize("label", ["slot", "paged-all"])
def test_soak_cell_equals_the_jax_engine(label):
    """The reference's soak cell (10 requests, seed 0, its weights) through
    both engines under the same chaos seed: status, output and
    preemptions of every request, and ``resilience_stats()``, equal; the
    port's done streams equal its oracle."""
    _, layout, quant, spec_k, prefix = next(c for c in SOAK_CELLS
                                            if c[0] == label)
    over = dict(d_model=64, d_ff=128, vocab_size=256, kv_layout=layout,
                kv_quant=quant)
    if layout == "paged":
        over.update(kv_block_size=8, kv_pool_blocks=40)
    setup = _models(over, 0)
    work = chaos.soak_requests(256, prefix, seed=0)
    runs = _engines(setup, work, batch_size=4, max_len=chaos.SOAK_MAX_LEN,
                    chunk_size=16, prefill_token_budget=32, spec_k=spec_k,
                    prefix_cache=prefix, max_preemptions=2, audit_every=1,
                    chaos=chaos.soak_monkey(0, spec_k))
    for eng, _ in runs.values():
        eng.run(max_steps=4000)
    eng, reqs = runs["port"]
    jeng, jreqs = runs["jax"]
    assert _outcomes(reqs) == _outcomes(jreqs)
    assert eng.resilience_stats() == jeng.resilience_stats()
    oracle = _oracle(setup, work, max_len=chaos.SOAK_MAX_LEN)
    chaos.check_soak(label, reqs, oracle, eng, jengine.RunResult())
    assert sum(v for k, v in eng.chaos.injected.items() if k != "kills")
    # the two harnesses agree on the cell's counters
    ref = jchaos.run_soak_cell(label, layout, quant, spec_k, prefix,
                               seed=0, n_requests=10)
    assert run_soak_cell(label, layout, quant, spec_k, prefix, seed=0,
                         params=setup[3], device="cpu") == ref


# -- a real non-finite row ---------------------------------------------------

PROBE_LENGTHS = (12, 9, 14, 7, 10, 11)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_real_nan_row_quarantines_only_its_row(layout):
    """``embed`` row 0 set to NaN; only prompt 0 holds token 0 (at index 3).
    With ``check_finite=True`` the port quarantines exactly that row on
    both layouts, and every other stream equals the port's oracle on the
    same poisoned weights.  The JAX engine does too on the slot layout; on
    the paged one it also quarantines rids 2-5, although neither their
    prompts nor their oracle streams hold token 0: the reference's fault,
    recorded here.  Its dead rows feed token 0 (padding) and route their
    writes to the null block, which then holds NaN K/V that every later
    row's paged attention reads; the port skips dead writes."""
    over = dict(d_model=64, d_ff=128, vocab_size=256)
    if layout == "paged":
        over.update(kv_layout="paged", kv_block_size=8, kv_pool_blocks=12)
    setup = _models(over, 1, poison=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in PROBE_LENGTHS]
    prompts[0][3] = 0
    work = [(i, p, 6) for i, p in enumerate(prompts)]
    oracle = _oracle(setup, work[1:], max_len=48)
    assert not any(0 in s for s in oracle.values())
    runs = _engines(setup, work, batch_size=2, max_len=48, chunk_size=8,
                    audit_every=1)
    for eng, _ in runs.values():
        eng.run()
    eng, reqs = runs["port"]
    assert [r.status for r in reqs] == ["error"] + ["done"] * 5
    assert reqs[0].error == "non-finite logits" and eng.row_faults == 1
    for r in reqs[1:]:
        assert r.output == oracle[r.rid], r.rid
    jeng, jreqs = runs["jax"]
    if layout == "slot":
        assert _outcomes(jreqs) == _outcomes(reqs)
    else:
        assert [r.status for r in jreqs] == ["error", "done"] + \
            ["error"] * 4
        assert jreqs[1].output == reqs[1].output
        k = np.asarray(jeng.cache["k"])
        assert np.isnan(k[:, jeng._null_block]).any()
        assert not any(np.isnan(t.float().numpy()).any()
                       for t in (eng.cache["k"][:, eng._null_block],
                                 eng.cache["v"][:, eng._null_block]))
