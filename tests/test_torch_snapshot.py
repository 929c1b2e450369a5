"""The port's durable serving against the reference's
(``tests/test_snapshot.py``): atomic snapshot dirs, the write-ahead
journal, ``Engine.restore``'s replay and fold, torn snapshots and
journals, deadlines as remaining budget across a restart, warmed compile
keys, store pruning, drafter histories and the kill/restore soak.

Each of the reference's cases runs the port's engine beside the JAX engine
on the same numpy params (``interop.params_from_numpy``) and the same
requests: the durable records (journaled streams and statuses, replayed
terminals) are held equal across packages, and the port's streams equal
its own ``reference_decode``.  Across packages besides:

* the checkpoint leaf codec: the same numpy leaves (bf16, int8, f32)
  written by either package's ``write_state`` read back by the other's
  ``read_state``, bitwise, both ways;
* the port's journals read by the reference's ``journaled_streams``;
* ``host.json`` after the same workload (prefix sharing, speculation,
  forced preemptions) and the same snapshot tick: slots, queue, requests,
  page table, free list, refcounts, radix and drafter dumps, compile keys
  and every counter both engines keep equal, and every journal equal event
  by event; the saved pools agree wherever a live row's page table reads
  them (float32 within ``POOL_TOL``; the port skips dead writes where the
  reference routes them to the null block, so unread blocks differ);
* the port's ``run_restart_cell`` equals the reference's on the ``slot``
  and ``paged-all`` cells;
* an xLSTM mid-flight restore (re-admission through ``("insert", B)``)
  drains to the port's oracle.

Model: ``qwen-7b-smoke`` at d_model 64, d_ff 128, vocab 256, float32, a
24-block pool of 8-token pages, as in the reference's tests."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import compiler as jcompiler  # noqa: E402
from repro.core.atomic import atomic_dir as jax_atomic_dir  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import snapshot as jsnap  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.atomic import atomic_dir  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import snapshot as snaplib  # noqa: E402
from repro_torch.serving.chaos import (  # noqa: E402
    SOAK_CELLS, ChaosConfig, ChaosMonkey, run_restart_cell)
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)
from repro_torch.train import checkpoint  # noqa: E402

# float32 K/V of the two packages' saved pools (their matmuls sum in
# other orders)
POOL_TOL = 1e-4


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


class Pkg:
    """One package's engine, request, restore and snapshot module over
    the same numpy params.  The JAX engines of one speculation setting
    share a compile cache (same shapes, and the restore reuses its
    engine's, as the reference's tests do)."""

    def __init__(self, name, jcfg, jparams, cfg, params):
        self.name = name
        self.jcfg, self.jparams, self.cfg, self.params = (jcfg, jparams,
                                                          cfg, params)
        self.snap = jsnap if name == "jax" else snaplib
        self._jcc: dict = {}

    def engine(self, **kw):
        if self.name == "jax":
            if "chaos" in kw:
                kw["chaos"] = jchaos.ChaosMonkey(kw["chaos"].config)
            kw.setdefault("compile_cache", self._jcc.setdefault(
                bool(kw.get("spec_k")), jcompiler.CompileCache()))
            return jengine.Engine(self.jcfg, self.jparams, **kw)
        return Engine(self.cfg, self.params, device="cpu", **kw)

    def restore(self, wd, **kw):
        if self.name == "jax":
            return jengine.Engine.restore(wd, self.jparams, **kw)
        return Engine.restore(wd, self.params, device="cpu", **kw)

    def request(self, **kw):
        return (jengine.Request if self.name == "jax" else Request)(**kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("qwen-7b", **OVERRIDES)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    cfg = get_smoke_config("qwen-7b", **OVERRIDES)
    return {name: Pkg(name, jcfg, jparams, cfg, params)
            for name in ("port", "jax")}


class FakeClock:
    """Injectable engine clock: time moves only when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _work(seed, n, max_new=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, int(rng.integers(4, 17))).astype(
        np.int32), max_new) for i in range(n)]


def _reqs(pkg, work):
    return [pkg.request(rid=i, prompt=p, max_new_tokens=n)
            for i, p, n in work]


def _oracle(setup, work):
    port = setup["port"]
    return {i: reference_decode(port.cfg, port.params, p, n, max_len=64,
                                device="cpu") for i, p, n in work}


def _run_some(eng, n):
    """run(max_steps=n) where truncation is the point."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return eng.run(max_steps=n)


def _free_expected(eng):
    """Blocks free after a drain: all but what the radix cache holds."""
    held = len(eng.prefix.blocks()) if eng.prefix is not None else 0
    return eng.pool_blocks - held


def _both(setup, root, scenario):
    """``scenario(pkg, wd)`` in both packages, each in its own store under
    ``root``; the records must be equal.  Returns the port's (record,
    extra)."""
    got = {name: scenario(pkg, os.path.join(root, name))
           for name, pkg in setup.items()}
    assert got["port"][0] == got["jax"][0]
    return got["port"]


# -- atomic directory helper ------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_atomic_dir_commit_and_replace(tmp_path, pkg):
    atomic = atomic_dir if pkg == "port" else jax_atomic_dir
    final = str(tmp_path / "out")
    with atomic(final) as tmp:
        with open(os.path.join(tmp, "a.txt"), "w") as f:
            f.write("one")
    assert open(os.path.join(final, "a.txt")).read() == "one"
    assert not os.path.exists(final + ".tmp")
    # a second commit REPLACES the first
    with atomic(final) as tmp:
        with open(os.path.join(tmp, "b.txt"), "w") as f:
            f.write("two")
    assert os.listdir(final) == ["b.txt"]
    # a stale .tmp from a killed writer is cleared first
    os.makedirs(final + ".tmp")
    with open(os.path.join(final + ".tmp", "stale"), "w") as f:
        f.write("x")
    with atomic(final) as tmp:
        assert os.listdir(tmp) == []
    assert os.listdir(final) == []


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_atomic_dir_abort_leaves_previous(tmp_path, pkg):
    atomic = atomic_dir if pkg == "port" else jax_atomic_dir
    final = str(tmp_path / "out")
    with atomic(final) as tmp:
        with open(os.path.join(tmp, "a.txt"), "w") as f:
            f.write("good")
    with pytest.raises(RuntimeError):
        with atomic(final) as tmp:
            with open(os.path.join(tmp, "a.txt"), "w") as f:
                f.write("torn")
            raise RuntimeError("die mid-write")
    assert open(os.path.join(final, "a.txt")).read() == "good"
    assert not os.path.exists(final + ".tmp")


def test_atomic_dir_fsyncs_the_parent_after_the_rename(tmp_path,
                                                       monkeypatch):
    from repro_torch.core import atomic
    seen = []
    real = atomic._fsync_dir
    monkeypatch.setattr(atomic, "_fsync_dir", lambda p: (
        seen.append((p, os.path.isdir(os.path.join(p, "out")))), real(p)))
    with atomic.atomic_dir(str(tmp_path / "out")):
        pass
    assert seen == [(str(tmp_path), True)]


def test_no_snapshot_dir_opens_no_file_and_fsyncs_nothing(setup,
                                                        monkeypatch):
    """The default engine (no ``snapshot_dir``) serves, cancels and
    submits without opening a file or calling fsync, and writes no
    journal event."""
    import builtins
    port = setup["port"]
    eng = port.engine(batch_size=2, max_len=64, chunk_size=16,
                      prefix_cache=True, spec_k=3)

    def refuse(*a, **k):
        raise AssertionError(f"durability I/O without a snapshot_dir: {a}")

    monkeypatch.setattr(os, "fsync", refuse)
    monkeypatch.setattr(builtins, "open", refuse)
    for r in _reqs(port, _work(14, 3)):
        eng.submit(r)
    _run_some(eng, 2)
    assert eng.cancel(2)
    assert eng.run().drained
    monkeypatch.undo()
    assert eng._journal is None and not eng.journal_commits
    assert eng.durability_stats()["snapshots_taken"] == 0


# -- the leaf codec, across packages ------------------------------------------

def _leaves():
    rng = np.random.default_rng(0)
    return {"cache": {
        "k": rng.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16),
        "q": rng.integers(-128, 128, (5, 7)).astype(np.int8),
        "s": rng.standard_normal((3, 1)).astype(np.float32)},
        "z": rng.standard_normal(6).astype(np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else interop.params_from_numpy(v, "cpu")
            for k, v in tree.items()}


def _bits(a):
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_leaf_codec_is_bitwise_across_packages(tmp_path, writer):
    """bf16, int8 and f32 leaves written by one package's ``write_state``
    and read by the other's ``read_state`` (and by its own) come back bit
    for bit; the manifests are the same file."""
    leaves = _leaves()
    like = _torch_tree(leaves)
    d = str(tmp_path / "state")
    if writer == "port":
        checkpoint.write_state(d, like, extra={"e": 1}, step=3)
    else:
        jcheckpoint.write_state(d, leaves, extra={"e": 1}, step=3)
    port, extra = checkpoint.read_state(d, like)
    assert extra == {"e": 1}
    flat = {"cache/k": leaves["cache"]["k"], "cache/q": leaves["cache"]["q"],
            "cache/s": leaves["cache"]["s"], "z": leaves["z"]}
    assert sorted(port) == sorted(flat)
    for path, a in flat.items():
        assert port[path].dtype == _bits(a).dtype
        assert np.array_equal(port[path], _bits(a)), path
    jstate, _ = jcheckpoint.read_state(d, jax.tree.map(
        lambda a: jax.numpy.zeros(a.shape, a.dtype), leaves))
    for got, want in zip(jax.tree.leaves(jstate), jax.tree.leaves(leaves)):
        assert np.array_equal(_bits(np.asarray(got)), _bits(want))
    other = str(tmp_path / "other")
    (jcheckpoint.write_state(other, leaves, extra={"e": 1}, step=3)
     if writer == "port" else
     checkpoint.write_state(other, like, extra={"e": 1}, step=3))
    assert (json.load(open(os.path.join(d, "manifest.json"))) ==
            json.load(open(os.path.join(other, "manifest.json"))))


def test_read_state_refuses_a_missing_leaf_and_another_shape_or_dtype(
        tmp_path):
    like = _torch_tree(_leaves())
    d = str(tmp_path / "state")
    checkpoint.write_state(d, like)
    with pytest.raises(KeyError, match="extra"):
        checkpoint.read_state(d, {**like, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.read_state(d, {**like, "z": torch.zeros(5)})
    with pytest.raises(ValueError, match="float32"):
        checkpoint.read_state(d, {**like, "z": torch.zeros(
            6, dtype=torch.bfloat16)})


def test_load_cache_copies_in_place_and_checks_first(setup):
    """``export_cache`` is a bitwise host copy; ``load_cache_`` writes it
    back into the SAME tensors (never a rebound dict), and refuses a leaf
    of another shape or dtype before writing any."""
    cfg = get_smoke_config("qwen-7b", **OVERRIDES, kv_quant="int8")
    cache = api.init_cache(cfg, 2, 64, "cpu")
    gen = torch.Generator().manual_seed(0)
    for v in cache.values():
        v.copy_(torch.randint(-127, 128, v.shape, generator=gen).to(v.dtype))
    saved = api.export_cache(cfg, cache)
    assert all(saved[k] is not cache[k] for k in cache)
    arrays = {k: v.numpy().copy() for k, v in saved.items()}
    ids = {k: id(v) for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    for v in cache.values():
        v.zero_()
    assert api.load_cache_(cfg, cache, arrays) is cache
    assert {k: id(v) for k, v in cache.items()} == ids
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    bad = dict(arrays, v_scale=arrays["v_scale"].astype(np.float64))
    for v in cache.values():
        v.zero_()
    with pytest.raises(ValueError, match="v_scale"):
        api.load_cache_(cfg, cache, bad)
    assert not any(v.any() for v in cache.values())
    with pytest.raises(KeyError):
        api.load_cache_(cfg, cache, {"k": arrays["k"]})


# -- torn stores are never observed -----------------------------------------

def test_snapshots_ignore_torn_dirs(setup, tmp_path):
    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd)
        good = pkg.snap.latest_snapshot(wd)
        # a .tmp dir and a higher-epoch dir missing its device manifest
        # must both be invisible
        os.makedirs(os.path.join(wd, "snap_000099.tmp"))
        torn = os.path.join(wd, "snap_000007")
        os.makedirs(torn)
        with open(os.path.join(torn, "host.json"), "w") as f:
            f.write("{}")
        assert pkg.snap.latest_snapshot(wd) == good
        # either package's reader sees the same complete snapshots
        assert jsnap.snapshots(wd) == snaplib.snapshots(wd)
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        assert restored.run().drained
        assert pkg.snap.latest_snapshot(wd) == good
        return os.path.basename(good[1]), None

    _both(setup, tmp_path, scenario)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_journal_torn_tail_ignored(tmp_path, pkg):
    read = (snaplib if pkg == "port" else jsnap).read_journal
    path = str(tmp_path / "journal_000000.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"ev": "submit", "rid": 0}) + "\n")
        f.write(json.dumps({"ev": "emit", "rid": 0, "tok": 7}) + "\n")
        f.write('{"ev": "emit", "rid": 0, "to')      # kill mid-write
    assert [e["ev"] for e in read(path)] == ["submit", "emit"]


# -- mid-flight snapshot + restore ------------------------------------------

def test_midflight_restore_drains_bitwise(setup, tmp_path):
    """A snapshot mid-flight, three more ticks into the journal only, then
    a restore: the restored engine drains every request with the tokens
    the never-killed engine emits, audits green and leaks nothing."""
    work = _work(1, 6)

    def scenario(pkg, wd):
        reqs = _reqs(pkg, work)
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         audit_every=1, snapshot_dir=wd)
        for r in reqs:
            eng.submit(r)
        assert not _run_some(eng, 5).drained
        eng.snapshot()
        _run_some(eng, 3)
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        assert restored.run().drained
        restored.audit()
        assert restored.alloc.n_free == _free_expected(restored)
        return pkg.snap.journaled_streams(wd), restored

    (streams, status), restored = _both(setup, tmp_path, scenario)
    oracle = _oracle(setup, work)
    assert status == {i: "done" for i in oracle}
    assert streams == oracle


def test_restore_replays_journal_tail(setup, tmp_path):
    """With only the baseline snapshot on disk the whole run lives in the
    journal: restore replays it and reports every request terminal."""
    work = _work(2, 4)

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd, snapshot_every=0)
        for r in _reqs(pkg, work):
            eng.submit(r)
        assert eng.run().drained
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        rec = sorted((r.rid, r.status, r.output)
                     for r in restored.restored_terminal)
        assert restored.run().drained
        assert restored.alloc.n_free == _free_expected(restored)
        return rec, None

    rec, _ = _both(setup, tmp_path, scenario)
    oracle = _oracle(setup, work)
    assert rec == [(i, "done", oracle[i]) for i in range(4)]


def test_counters_and_cfg_roundtrip(setup, tmp_path):
    port = setup["port"]
    assert snaplib.cfg_from_dict(snaplib.cfg_to_dict(port.cfg)) == port.cfg
    d = snaplib.cfg_to_dict(get_smoke_config("qwen-7b"))
    assert d["dtype"] == "float32"
    assert snaplib.cfg_to_dict(get_smoke_config(
        "qwen-7b", dtype=torch.bfloat16))["dtype"] == "bfloat16"
    # the port's dtype names are the reference's
    assert jsnap.cfg_to_dict(setup["jax"].jcfg)["dtype"] == \
        snaplib.cfg_to_dict(port.cfg)["dtype"]
    # the reference's config JSON (its execution knobs and M-RoPE
    # sections, a list after JSON) loads into the port's config
    assert snaplib.cfg_from_dict(json.loads(json.dumps(
        jsnap.cfg_to_dict(setup["jax"].jcfg)))) == port.cfg
    work = _work(3, 3)

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd)
        for r in _reqs(pkg, work):
            eng.submit(r)
        eng.run()
        eng.snapshot()
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        for k in pkg.snap._COUNTERS:
            if k in ("snapshots_taken", "audits"):
                continue            # restore neither snapshots nor keeps
            assert getattr(restored, k) == getattr(eng, k), k
        assert restored.audits == eng.audits + 1   # restore's own audit
        return {k: getattr(restored, k) for k in jsnap._COUNTERS}, None

    _both(setup, tmp_path, scenario)
    assert set(snaplib._COUNTERS) == set(jsnap._COUNTERS) | {
        "dispatched_columns"}


# -- prefix cache survives the crash ----------------------------------------

def test_restored_prefix_cache_drop_returns_all_blocks(setup, tmp_path):
    rng = np.random.default_rng(4)
    system = rng.integers(0, 256, 16)
    work = [(i, np.concatenate([system, rng.integers(0, 256, 4)]).astype(
        np.int32), 4) for i in range(4)]

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         prefix_cache=True, audit_every=1, snapshot_dir=wd)
        for r in _reqs(pkg, work):
            eng.submit(r)
        _run_some(eng, 6)
        eng.snapshot()
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        assert restored.run().drained
        restored.audit()
        # the radix cache holds one reference per cached block: dropping
        # it returns the pool whole
        cached = restored.prefix.dump()
        assert cached["nodes"]
        assert restored.drop_prefix_cache() > 0
        assert restored.alloc.n_free == restored.pool_blocks
        restored.audit()
        return (pkg.snap.journaled_streams(wd), cached), None

    ((streams, _), _), _ = _both(setup, tmp_path, scenario)
    assert streams == _oracle(setup, work)


# -- deadlines restore as remaining budget ----------------------------------

def test_deadline_restored_as_remaining_budget(setup, tmp_path):
    """50 s deadline, 20 s used before the kill, any downtime: the
    restored request has exactly 30 s left."""
    def scenario(pkg, wd):
        clock = FakeClock(100.0)
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd, clock=clock)
        eng.submit(pkg.request(
            rid=0, prompt=np.random.default_rng(5).integers(
                0, 256, 8).astype(np.int32),
            max_new_tokens=4, deadline_s=50.0))
        clock.t = 120.0                          # 20 s burned while queued
        eng.snapshot()
        clock2 = FakeClock(5000.0)               # dead for a while
        restored = pkg.restore(wd, clock=clock2,
                               compile_cache=eng.cache_compiles)
        (req,) = restored._queue
        remaining = req.deadline_s - (clock2() - req.submitted_at)
        assert remaining == pytest.approx(30.0)
        clock2.t = 5000.0 + 30.0 + 1e-3          # past the budget
        assert restored.run().drained
        return (req.status, remaining), None

    rec, _ = _both(setup, tmp_path, scenario)
    assert rec[0] == "deadline_missed"


def test_fresh_deadline_not_aged_by_fake_clock(setup, tmp_path):
    def scenario(pkg, wd):
        clock = FakeClock(7.0)
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd, clock=clock)
        eng.submit(pkg.request(
            rid=0, prompt=np.random.default_rng(6).integers(
                0, 256, 8).astype(np.int32),
            max_new_tokens=4, deadline_s=50.0))
        eng.snapshot()                           # no time used
        clock2 = FakeClock(0.0)
        restored = pkg.restore(wd, clock=clock2,
                               compile_cache=eng.cache_compiles)
        (req,) = restored._queue
        left = req.deadline_s - (clock2() - req.submitted_at)
        assert left == pytest.approx(50.0)
        assert restored.run().drained
        return (req.status, req.output), None

    (status, _), _ = _both(setup, tmp_path, scenario)
    assert status == "done"


# -- accounting across the boundary -----------------------------------------

def test_summarize_consistent_across_boundary(setup, tmp_path):
    """The requests finished before the kill, those replayed as terminal
    and those finished after the restore cover every request once, and
    ``summarize`` over them is coherent."""
    work = _work(7, 6)

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd, snapshot_every=4)
        for r in _reqs(pkg, work):
            eng.submit(r)
        pre = _run_some(eng, 9)
        assert pre and not pre.drained
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        res = restored.run()
        assert res.drained
        pre_rids = {r.rid for r in pre}
        post_rids = {r.rid for r in res}
        replay_rids = {r.rid for r in restored.restored_terminal}
        assert not pre_rids & post_rids
        assert sorted(pre_rids | post_rids) == list(range(6))
        assert replay_rids <= pre_rids
        union = ([r for r in pre if r.rid not in replay_rids] +
                 list(restored.restored_terminal) + list(res))
        assert sorted(r.rid for r in union) == list(range(6))
        summary = type(restored).summarize(union)
        streams, _ = pkg.snap.journaled_streams(wd)
        assert summary["total_tokens"] == float(
            sum(len(streams[i]) for i in range(6)))
        assert summary["mean_ttft_s"] >= 0.0
        assert all(r.finished_at is not None for r in union)
        return ((sorted(pre_rids), sorted(replay_rids), sorted(post_rids),
                 summary["n"], summary["completed"],
                 summary["total_tokens"]), streams)

    (_, _, _, n, completed, _), streams = _both(setup, tmp_path, scenario)
    assert n == completed == 6
    assert streams == _oracle(setup, work)


# -- warm executables -------------------------------------------------------

def test_restore_warms_saved_compile_keys(setup, tmp_path):
    """Every saved key is built before the first tick: through a shared
    cache with no new miss, and through a fresh one with one miss per
    saved key and none on the restored engine's first tick."""
    work = _work(8, 4)

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd)
        for r in _reqs(pkg, work):
            eng.submit(r)
        _run_some(eng, 4)
        eng.snapshot()
        host = json.load(open(os.path.join(
            pkg.snap.latest_snapshot(wd)[1], "host.json")))
        saved = [tuple(k) for k in host["compile_keys"]]
        assert any(n == "mixed" for n, _ in saved)
        if pkg.name == "port":
            # a fresh cache, on a copy of the store: one miss per saved
            # key, all at the restore, none on the first tick
            copy = wd + "_copy"
            shutil.copytree(wd, copy)
            fresh = pkg.restore(copy)
            assert fresh.cache_compiles.keys() == saved
            assert fresh.cache_compiles.misses == len(saved)
            _run_some(fresh, 1)
            assert fresh.steps == eng.steps + 1
            assert fresh.cache_compiles.misses == len(saved)
        cc = eng.cache_compiles
        before = cc.misses
        restored = pkg.restore(wd, compile_cache=cc)
        assert cc.misses == before
        assert set(saved) <= set(restored.cache_compiles.keys())
        assert restored.run().drained
        return saved, None

    _both(setup, tmp_path, scenario)


# -- store hygiene -----------------------------------------------------------

def test_prune_keeps_journals(setup, tmp_path):
    work = _work(9, 3)

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         snapshot_dir=wd, snapshot_keep=2)
        for r in _reqs(pkg, work):
            eng.submit(r)
        _run_some(eng, 3)
        for _ in range(4):
            eng.snapshot()
        eng.run()
        assert len(pkg.snap.snapshots(wd)) == 2
        journals = sorted(d for d in os.listdir(wd)
                          if d.startswith("journal_"))
        assert len(journals) == 5               # baseline + 4: never pruned
        return (journals, pkg.snap.journaled_streams(wd)), None

    (_, (streams, status)), _ = _both(setup, tmp_path, scenario)
    assert status == {i: "done" for i in range(3)}
    assert streams == _oracle(setup, work)


# -- drafter state ------------------------------------------------------------

def test_drafter_history_survives_restore(setup, tmp_path):
    pat = np.random.default_rng(10).integers(0, 256, 4)
    work = [(i, np.tile(pat, 3).astype(np.int32), 24) for i in range(3)]

    def scenario(pkg, wd):
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16, spec_k=3,
                         snapshot_dir=wd)
        for r in _reqs(pkg, work):
            eng.submit(r)
        _run_some(eng, 3)
        eng.snapshot()
        dump = eng.drafter.dump()
        assert dump["history"]
        restored = pkg.restore(wd, compile_cache=eng.cache_compiles)
        assert restored.drafter.dump() == dump
        assert restored.run().drained
        return (dump, pkg.snap.journaled_streams(wd)), None

    (_, (streams, _)), _ = _both(setup, tmp_path, scenario)
    assert streams == _oracle(setup, work)


# -- kill/restore soak -------------------------------------------------------

def test_restart_soak_cell_smoke():
    """The reference's smoke cell (slot, seed 1, six requests) through the
    port: at least one kill, every request terminal."""
    stats = run_restart_cell("slot", "slot", "none", 0, False, seed=1,
                             n_requests=6, device="cpu")
    assert stats["kills"] >= 1
    assert sum(stats["outcomes"].values()) == 6


@pytest.mark.parametrize("label", ["slot", "paged-all"])
def test_restart_cell_equals_the_reference(label):
    """The reference's kill/restore cell (seed 0, ten requests, its
    weights) through both harnesses: lives, kills, snapshots, durable
    outcomes and every counter equal."""
    _, layout, quant, spec_k, prefix = next(c for c in SOAK_CELLS
                                            if c[0] == label)
    over = dict(d_model=64, d_ff=128, vocab_size=256, kv_layout=layout,
                kv_quant=quant)
    if layout == "paged":
        over.update(kv_block_size=8, kv_pool_blocks=40)
    jparams = japi.init_params(jax_smoke_config("qwen-7b", **over),
                               jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    ref = jchaos.run_restart_cell(label, layout, quant, spec_k, prefix,
                                  seed=0, n_requests=10)
    got = run_restart_cell(label, layout, quant, spec_k, prefix, seed=0,
                           params=params, device="cpu")
    assert got == ref
    assert got["kills"] >= 1


# -- host.json and journals across packages ---------------------------------

def test_host_manifest_and_journals_equal_the_jax_engine(setup, tmp_path):
    """The same workload (a shared system prompt, repeating suffixes,
    speculation, forced preemptions from the same chaos seed, one fake
    clock) and the same snapshot tick in both packages: every field of
    ``host.json`` both keep is equal, as are the journals; the port reads
    the reference's journals and the reference the port's; live rows'
    blocks agree across packages and the port's saved pool is its live
    pool bitwise."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, 256, 16)
    work = [(i, np.concatenate([system, np.tile(rng.integers(
        0, 256, 3), 3)]).astype(np.int32), 10) for i in range(5)]
    out = {}
    for name, pkg in setup.items():
        wd = str(tmp_path / name)
        clock = FakeClock(1.0)
        eng = pkg.engine(batch_size=2, max_len=64, chunk_size=16,
                         prefix_cache=True, spec_k=3, max_preemptions=2,
                         audit_every=1, clock=clock, snapshot_dir=wd,
                         chaos=ChaosMonkey(ChaosConfig(seed=3,
                                                       preempt_rate=0.3)),
                         # its own cache: host.json lists the cache's keys
                         compile_cache=(jcompiler.CompileCache()
                                        if name == "jax" else None))
        for r in _reqs(pkg, work):
            eng.submit(r)
        for _ in range(7):
            _run_some(eng, 1)
            clock.t += 0.5
        eng.snapshot()
        live = {k: v.clone() for k, v in eng.cache.items()} \
            if name == "port" else None
        _run_some(eng, 3)
        host = json.load(open(os.path.join(
            pkg.snap.latest_snapshot(wd)[1], "host.json")))
        out[name] = (wd, host, live, eng)
    (pwd, phost, plive, peng), (jwd, jhost, _, jeng) = (out["port"],
                                                      out["jax"])
    assert phost["requests"] and phost["prefix"]["nodes"]
    assert phost["drafter"]["history"]
    assert any(r["preemptions"] and r["folded"] for r in phost["requests"])
    for key in ("version", "epoch", "kwargs", "draft_wait", "draft_penalty",
                "slots", "requests", "queue", "compile_keys", "prefix",
                "drafter", "paged"):
        assert phost[key] == jhost[key], key
    shared = set(phost["counters"]) & set(jhost["counters"])
    assert shared == set(jsnap._COUNTERS)
    assert {k: phost["counters"][k] for k in shared} == \
        {k: jhost["counters"][k] for k in shared}
    pcfg, jcfg = phost["cfg"], jhost["cfg"]
    assert {k: pcfg[k] for k in pcfg} == {k: jcfg[k] for k in pcfg}
    # the journals, event by event, and each package reading the other's
    pj = sorted(d for d in os.listdir(pwd) if d.startswith("journal_"))
    assert pj == sorted(d for d in os.listdir(jwd)
                        if d.startswith("journal_"))
    for d in pj:
        assert snaplib.read_journal(os.path.join(pwd, d)) == \
            jsnap.read_journal(os.path.join(jwd, d))
    assert jsnap.journaled_streams(pwd) == snaplib.journaled_streams(pwd)
    assert snaplib.journaled_streams(jwd) == jsnap.journaled_streams(pwd)
    # the device state: bitwise within the port, within POOL_TOL where a
    # live row's page table reads it across packages
    snap = snaplib.latest_snapshot(pwd)[1]
    parr, _ = checkpoint.read_state(os.path.join(snap, "device"),
                                    {"cache": peng.cache})
    for k, v in plive.items():
        assert np.array_equal(parr[f"cache/{k}"], v.numpy()), k
    jsnapdir = jsnap.latest_snapshot(jwd)[1]
    jarr, _ = jcheckpoint.read_state(os.path.join(jsnapdir, "device"),
                                     {"cache": jeng.cache})
    bs = phost["cfg"]["kv_block_size"]
    read = sorted({blk for s, row in zip(phost["slots"],
                                         phost["paged"]["page_table"])
                   if s["rid"] is not None
                   for blk in row[:-(-s["length"] // bs)]})
    assert read
    for k in ("k", "v"):
        np.testing.assert_allclose(
            parr[f"cache/{k}"][:, read],
            np.asarray(jarr["cache"][k])[:, read], rtol=0, atol=POOL_TOL)


def test_restore_refuses_a_snapshot_it_cannot_hold(setup, tmp_path):
    """Another block-home count, a request with audio frames and a
    corrupt device leaf each raise; nothing falls back."""
    port = setup["port"]
    wd = str(tmp_path / "s")
    eng = port.engine(batch_size=2, max_len=64, chunk_size=16,
                      snapshot_dir=wd)
    for r in _reqs(port, _work(12, 2)):
        eng.submit(r)
    _run_some(eng, 2)
    eng.snapshot()
    snap = snaplib.latest_snapshot(wd)[1]
    hpath = os.path.join(snap, "host.json")
    host = json.load(open(hpath))
    for edit, match in (
            (lambda h: h["paged"].update(n_homes=2), "block homes"),
            (lambda h: h["requests"][0].update(frames=[[0.0]]), "audio")):
        h = json.loads(json.dumps(host))
        edit(h)
        json.dump(h, open(hpath, "w"))
        with pytest.raises((RuntimeError, ValueError), match=match):
            port.restore(wd)
    json.dump(host, open(hpath, "w"))
    np.save(os.path.join(snap, "device", "arrays", "00000.npy"),
            np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        port.restore(wd)


# -- the xLSTM: re-admission through ("insert", B) -------------------------

def test_xlstm_midflight_restore_drains_to_the_oracle(tmp_path):
    """The xLSTM's recurrent state snapshots and loads bitwise; the rows
    in flight fold and re-admit through the ``("insert", B)`` fresh row,
    and every stream equals the port's oracle."""
    cfg = get_smoke_config("xlstm-1.3b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 9))),
                    max_new_tokens=6) for i in range(3)]
    oracle = {r.rid: reference_decode(cfg, params, r.prompt, 6, max_len=32,
                                      device="cpu") for r in reqs}
    wd = str(tmp_path / "s")
    eng = Engine(cfg, params, batch_size=2, max_len=32, chunk_size=8,
                 audit_every=1, snapshot_dir=wd, device="cpu")
    for r in reqs:
        eng.submit(r)
    _run_some(eng, 4)
    eng.snapshot()
    live = api.export_cache(cfg, eng.cache)
    _run_some(eng, 2)
    restored = Engine.restore(wd, params, device="cpu")
    assert ("insert", 2) in restored.cache_compiles.keys()
    # the snapshot's state was loaded bitwise (nothing ran since)
    for (p, a), (_, b) in zip(checkpoint.tree_paths(live),
                              checkpoint.tree_paths(restored.cache)):
        assert torch.equal(a, b), p
    hits = restored.cache_compiles.hits
    assert restored.run().drained
    assert restored.cache_compiles.hits > hits      # inserts re-admitted
    streams, status = snaplib.journaled_streams(wd)
    assert status == {r.rid: "done" for r in reqs}
    assert streams == oracle


# -- the launcher -----------------------------------------------------------

def test_launcher_kill_and_restore_equals_an_unkilled_run(tmp_path, capsys):
    """``--chaos-kill-after 6`` kills a run with ``--snapshot-dir`` and
    ``--snapshot-every 4``; ``--restore`` finishes it, and the durable
    streams equal those of a run that was never killed."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--kv-layout", "paged", "--prefix-cache",
            "--requests", "4", "--max-new-tokens", "8", "--batch", "2",
            "--max-len", "96", "--snapshot-every", "4"]
    whole, killed = str(tmp_path / "whole"), str(tmp_path / "killed")
    serve.main(base + ["--snapshot-dir", whole])
    out = capsys.readouterr().out
    assert "'completed': 4" in out and "durability: " in out
    serve.main(base + ["--snapshot-dir", killed, "--chaos",
                       "--chaos-deny-rate", "0", "--chaos-preempt-rate",
                       "0", "--chaos-nan-rate", "0",
                       "--chaos-kill-after", "6"])
    out = capsys.readouterr().out
    assert "killed at tick 6" in out and "summary:" not in out
    streams, status = snaplib.journaled_streams(killed)
    assert set(status.values()) != {"done"}      # work was in flight
    serve.main(["--device", "cpu", "--snapshot-dir", killed, "--restore"])
    out = capsys.readouterr().out
    assert "restored from" in out and "durability: " in out
    want = snaplib.journaled_streams(whole)
    assert want[1] == {i: "done" for i in range(4)}
    assert snaplib.journaled_streams(killed) == want
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--restore"])
    assert "--restore requires --snapshot-dir" in capsys.readouterr().err
