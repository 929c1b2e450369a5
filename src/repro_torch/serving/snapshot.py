"""Durable serving: atomic engine snapshots and a write-ahead request
journal (port of ``repro/serving/snapshot.py``).

An edge device loses power and has its process killed as a matter of
course.  The durability contract has three parts:

* **Point-in-time snapshots.**  ``save(engine)`` writes the device cache
  (the paged pool and its int8 scales, or the slot cache, or the xLSTM's
  state; bitwise through the checkpoint leaf codec) with the whole host
  control plane: slot leases, page tables, ``BlockAllocator`` refcounts,
  the radix cache's token -> block chains, every live ``Request``'s
  lifecycle fields (status, accepted output, ``folded``, preemptions, the
  deadline as REMAINING budget), drafter histories, the engine's counters
  and its compile keys.  A write is atomic (``core.atomic.atomic_dir``):
  a snapshot cut short is never seen by restore, the previous complete one
  wins.

* **Write-ahead journal.**  An append-only JSONL of submit / emit /
  terminal events, fsync'd once a tick (and at once for a submit or a
  cancel outside a tick).  Snapshot epoch N owns ``journal_N.jsonl``,
  which records what happened AFTER snapshot N; the engine opens the next
  epoch's journal only after the next snapshot commits, so a (snapshot,
  journal) pair on disk is always a consistent recovery point.  A chaos
  kill fires at the top of a tick, after the previous tick's fsync, so an
  emitted token is never lost and never journaled twice.

* **Restore and replay.**  ``restore_engine(dir, params)`` (the body of
  ``Engine.restore``) builds the engine on its device, captures the saved
  compile keys (on the card one CUDA graph each, over dead inputs, then
  the rest of the engine's bounded key set, so no tick after the restore
  captures), loads the device state IN PLACE into
  the tensors those graphs read (``api.load_cache_``: the cache is never
  rebound, because a graph replays only on the cache it was captured
  with), rebuilds the host plane and replays the epoch's journal: submits
  requeue, emits extend their request's output, terminals retire (into
  ``engine.restored_terminal``: the dead process's request objects are
  gone).  A live request whose output grew past the snapshot is folded
  into its prompt by ``_fold_slot`` (preemption's primitive) and requeued
  at the FRONT in admission order, so its streams resume BITWISE equal to
  the never-killed engine's (and to ``reference_decode``).  Journals are
  never pruned: every epoch's emits, concatenated, are each request's full
  durable stream, exactly once and in order (``journaled_streams``).

``host.json``'s keys and the journal's event schema are the reference's,
so either package reads the other's files.  One card means one block
home: a snapshot records ``"n_homes": 1`` and refuses another count at
load.  The port serves no audio family, so a request's ``frames`` is
always null.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.atomic import atomic_dir
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Engine, Request, _Slot
from repro_torch.train import checkpoint

SNAPSHOT_VERSION = 1
_SNAP_RE = re.compile(r"snap_(\d+)$")
_JOURNAL_RE = re.compile(r"journal_(\d+)\.jsonl$")

# engine counters that round-trip verbatim through the host manifest: the
# reference's, and the port's ``dispatched_columns``
_COUNTERS = (
    "steps", "dispatches", "mixed_ticks", "_occupancy_sum",
    "peak_pool_blocks", "peak_resident_tokens", "admission_stalls",
    "prefix_hits", "prefix_hit_tokens", "cow_copies", "prefix_evictions",
    "preemptions", "deadline_misses", "row_faults", "cancels", "audits",
    "spec_ticks", "spec_rows", "spec_drafted", "spec_accepted",
    "spec_rewinds", "_admit_seq", "snapshots_taken", "dispatched_columns",
)


# -- paths ------------------------------------------------------------------

def snap_path(root: str, epoch: int) -> str:
    return os.path.join(root, f"snap_{epoch:06d}")


def journal_path(root: str, epoch: int) -> str:
    return os.path.join(root, f"journal_{epoch:06d}.jsonl")


def snapshots(root: str) -> list[tuple[int, str]]:
    """Every COMPLETE snapshot under ``root``, epoch-ascending.  A dir is
    complete only with both its host manifest and its device manifest, so
    ``.tmp`` dirs and half-written ones are invisible here."""
    out = []
    if not os.path.isdir(root):
        return out
    for d in os.listdir(root):
        m = _SNAP_RE.match(d)
        if not m:
            continue
        p = os.path.join(root, d)
        if (os.path.isfile(os.path.join(p, "host.json")) and
                os.path.isfile(os.path.join(p, "device", "manifest.json"))):
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_snapshot(root: str) -> tuple[int, str]:
    snaps = snapshots(root)
    if not snaps:
        raise FileNotFoundError(f"no complete snapshot under {root!r}")
    return snaps[-1]


# -- write-ahead journal ----------------------------------------------------

class Journal:
    """Append-only JSONL event log.  ``append`` is line-buffered (a dying
    engine still leaves whole lines); ``commit`` is the durability point:
    flush + ``os.fsync``, once a tick."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self.appended = 0

    def append(self, ev: dict) -> None:
        self._f.write(json.dumps(ev) + "\n")
        self.appended += 1

    def commit(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.commit()
            self._f.close()


def read_journal(path: str) -> list[dict]:
    """Parse a journal; a torn trailing line (a kill mid-write) ends it:
    everything before it was a complete record."""
    events: list[dict] = []
    if not os.path.exists(path):
        return events
    with open(path) as f:
        for line in f:
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return events


def journaled_streams(root: str) -> tuple[dict[int, list[int]],
                                          dict[int, str]]:
    """The durable record of every request across every epoch, in order:
    ``(streams, status)``.  ``streams[rid]`` is the full emitted stream
    (each token is journaled once, when it is first generated);
    ``status[rid]`` the last journaled lifecycle word ("submitted" until a
    terminal event lands).  The kill/restore soak holds it against
    ``reference_decode``."""
    streams: dict[int, list[int]] = collections.defaultdict(list)
    status: dict[int, str] = {}
    epochs = sorted(
        (int(m.group(1)), os.path.join(root, d))
        for d in os.listdir(root)
        if (m := _JOURNAL_RE.match(d)) is not None)
    for _, path in epochs:
        for ev in read_journal(path):
            if ev["ev"] == "emit":
                streams[ev["rid"]].append(int(ev["tok"]))
            elif ev["ev"] == "submit":
                status.setdefault(ev["rid"], "submitted")
            elif ev["ev"] == "terminal":
                status[ev["rid"]] = ev["status"]
    return dict(streams), status


# -- config / request codecs ------------------------------------------------

def cfg_to_dict(cfg: ModelConfig) -> dict:
    """The config as JSON, its dtype by the reference's name
    (``"bfloat16"``, ``"float32"``)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = checkpoint.dtype_name(cfg.dtype)
    return d


# the reference's execution knobs the port has no field for (JAX's layer
# scan and Pallas switch): a config it wrote loads without them
_REFERENCE_ONLY = ("scan_layers", "use_kernels")


def cfg_from_dict(d: dict) -> ModelConfig:
    """The config of ``cfg_to_dict``'s JSON, the port's or the reference's
    (whose execution knobs ``_REFERENCE_ONLY`` are dropped); any other
    field the port lacks raises ``ValueError``."""
    d = {k: v for k, v in d.items() if k not in _REFERENCE_ONLY}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    if set(d) - known:
        raise ValueError(f"config fields {sorted(set(d) - known)} are not "
                         "the port's")
    d["dtype"] = getattr(torch, d["dtype"])
    if isinstance(d.get("mrope_sections"), list):       # JSON has no tuple
        d["mrope_sections"] = tuple(d["mrope_sections"])
    return ModelConfig(**d)


def _no_frames(rid: int, frames) -> None:
    if frames is not None:
        raise ValueError(f"request {rid} carries audio frames: durable "
                         "serving of the audio family comes in a later "
                         "slice of the port")


def _dump_req(req: Request, now: float) -> dict:
    """One LIVE request as JSON.  Times go out as ages and offsets from the
    engine's clock at save: a restored process has another clock base, so
    the deadline is stored as the REMAINING budget and downtime does not
    count against it."""
    age = now - req.submitted_at
    return {
        "rid": req.rid,
        "prompt": np.asarray(req.prompt).tolist(),
        "max_new": req.max_new_tokens,
        "frames": None,
        "priority": req.priority,
        "deadline_remaining": (None if req.deadline_s is None
                               else req.deadline_s - age),
        "output": [int(t) for t in req.output],
        "status": req.status,
        "error": req.error,
        "preemptions": req.preemptions,
        "folded": req.folded,
        "age": age,
        "ttft": (None if req.first_token_at is None
                 else req.first_token_at - req.submitted_at),
        "token_offsets": [t - req.submitted_at for t in req.token_times],
    }


def _load_req(d: dict, now: float) -> Request:
    _no_frames(d["rid"], d["frames"])
    req = Request(rid=d["rid"], prompt=np.asarray(d["prompt"], np.int64),
                  max_new_tokens=d["max_new"], priority=d["priority"])
    req.output = [int(t) for t in d["output"]]
    req.status = d["status"]
    req.error = d["error"]
    req.preemptions = d["preemptions"]
    req.folded = d["folded"]
    req.submitted_at = now - d["age"]
    # remaining budget: the miss fires ``deadline_remaining`` seconds after
    # the restore, however long the process was dead
    req.deadline_s = (None if d["deadline_remaining"] is None
                      else d["deadline_remaining"] + d["age"])
    req.first_token_at = (None if d["ttft"] is None
                          else req.submitted_at + d["ttft"])
    req.token_times = [req.submitted_at + o for o in d["token_offsets"]]
    return req


# -- save -------------------------------------------------------------------

def _ctor_kwargs(eng: Engine) -> dict:
    return {
        "batch_size": eng.batch, "max_len": eng.max_len,
        "eos_id": eng.eos_id, "chunk_size": eng.chunk_size,
        "prefill_token_budget": eng.prefill_token_budget,
        "prefill_policy": eng.prefill_policy,
        "spec_k": eng.spec_requested,
        "prefix_cache": eng.prefix_requested,
        "max_preemptions": eng.max_preemptions,
        "enforce_deadlines": eng.enforce_deadlines,
        "check_finite": eng.check_finite,
        "audit_every": eng.audit_every,
        "snapshot_every": eng.snapshot_every,
        "snapshot_keep": eng.snapshot_keep,
        "journal": eng.journal_enabled,
    }


def _dump_host(eng: Engine, epoch: int) -> dict:
    now = eng.clock()
    live: dict[int, Request] = {}
    for s in eng._slots:
        if s.req is not None:
            live[s.req.rid] = s.req
    for r in eng._queue:
        live[r.rid] = r
    host: dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "epoch": epoch,
        "cfg": cfg_to_dict(eng.cfg),
        "kwargs": _ctor_kwargs(eng),
        "counters": {k: getattr(eng, k) for k in _COUNTERS},
        "draft_wait": list(eng._draft_wait),
        "draft_penalty": list(eng._draft_penalty),
        "slots": [{
            "rid": None if s.req is None else s.req.rid,
            "length": s.length, "pos": s.pos,
            "last_token": s.last_token, "seq": s.seq,
        } for s in eng._slots],
        "requests": [_dump_req(r, now) for r in live.values()],
        "queue": [r.rid for r in eng._queue],
        "compile_keys": [[name, bucket]
                         for name, bucket in eng.cache_compiles.keys()],
        "prefix": None if eng.prefix is None else eng.prefix.dump(),
        "drafter": None if eng.drafter is None else eng.drafter.dump(),
    }
    if eng.paged:
        host["paged"] = {
            "page_table": eng._page_table.tolist(),
            "slot_blocks": [list(b) for b in eng._slot_blocks],
            "slot_reserve": list(eng._slot_reserve),
            "n_homes": 1,
            "reserve_home": [[r] for r in eng._slot_reserve],
            "free": list(eng.alloc.free),
            "refs": list(eng.alloc.refs),
        }
    return host


def _write_snapshot(eng: Engine, root: str, epoch: int) -> str:
    """Write snapshot ``epoch``: the device cache comes to the host first
    (after the tick's fetch, so the stream has nothing left to run), then
    both manifests go into one atomic dir.  Records the bytes and the two
    times in ``eng.snapshot_log``."""
    t0 = time.perf_counter()
    cache = api.export_cache(eng.cfg, eng.cache)
    t1 = time.perf_counter()
    final = snap_path(root, epoch)
    with atomic_dir(final) as tmp:
        with open(os.path.join(tmp, "host.json"), "w") as f:
            json.dump(_dump_host(eng, epoch), f)
        checkpoint.write_state(os.path.join(tmp, "device"),
                               {"cache": cache}, extra={"epoch": epoch},
                               step=epoch)
    eng.snapshot_log.append({
        "epoch": epoch, "step": eng.steps,
        "bytes": sum(t.numel() * t.element_size()
                     for _, t in checkpoint.tree_paths(cache)),
        "export_s": t1 - t0, "write_s": time.perf_counter() - t1})
    return final


def _prune(root: str, keep: int) -> None:
    """Drop all but the newest ``keep`` complete snapshots.  Journals are
    never pruned: their epochs concatenated are the full durable
    stream."""
    if not keep:
        return
    for _, path in snapshots(root)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def save(eng: Engine) -> str:
    """Write snapshot epoch N+1 and rotate the journal to it.

    The order is the crash-consistency argument: commit the OLD journal,
    write the new snapshot atomically, and only then close the old
    journal and open the new epoch's; a kill anywhere in between leaves a
    complete (snapshot, journal) pair on disk."""
    root = eng.snapshot_dir
    epoch = eng._snap_epoch + 1
    eng._commit()
    final = _write_snapshot(eng, root, epoch)
    if eng._journal is not None:
        eng._journal.close()
    eng._snap_epoch = epoch
    if eng.journal_enabled:
        eng._journal = Journal(journal_path(root, epoch))
    eng.snapshots_taken += 1
    _prune(root, eng.snapshot_keep)
    return final


def attach(eng: Engine, root: str) -> None:
    """Start durability on a FRESH engine: take the baseline snapshot (so
    restore always has a complete one to stand on) and open its journal.
    ``Engine.__init__`` calls it when ``snapshot_dir`` is set; a store left
    by an earlier run just gives a higher epoch."""
    os.makedirs(root, exist_ok=True)
    eng.snapshot_dir = root
    snaps = snapshots(root)
    eng._snap_epoch = snaps[-1][0] if snaps else -1
    save(eng)


# -- restore ----------------------------------------------------------------

def _warm_executables(eng: Engine, keys: list) -> None:
    """Build the entry of every saved compile key, in the saved order,
    before the device state loads: on the card each mixed, decode and cow
    key is captured as a graph over dead inputs (which writes nothing
    live).  On the card the rest of the engine's bounded key set is
    captured after them: a fold re-admits through chunk widths the dead
    engine may never have used, and a capture costs a tick's time, so no
    tick of a restored engine captures.  On the CPU an entry costs
    nothing to build, and the saved keys alone are built, as in the
    reference."""
    for name, bucket in keys:
        eng._entry(name, bucket)
    if eng.device.type == "cuda":
        for name, bucket in eng._key_space():
            eng._entry(name, bucket)


def _load_host(eng: Engine, host: dict) -> None:
    now = eng.clock()
    reqs = {d["rid"]: _load_req(d, now) for d in host["requests"]}
    eng._queue = collections.deque(reqs[rid] for rid in host["queue"])
    for i, sd in enumerate(host["slots"]):
        eng._slots[i] = _Slot(
            req=None if sd["rid"] is None else reqs[sd["rid"]],
            length=sd["length"], pos=sd["pos"],
            last_token=sd["last_token"], seq=sd["seq"])
    eng._live_rids = set(reqs)
    if eng.paged:
        pg = host["paged"]
        homes = int(pg.get("n_homes", 1))
        if homes != eng.alloc.n_homes:
            raise RuntimeError(
                f"snapshot was taken with {homes} block homes but the "
                f"restoring engine derived {eng.alloc.n_homes} — restore "
                "under the same device mesh the snapshot was saved under")
        eng._page_table = np.asarray(pg["page_table"], np.int32)
        eng._slot_blocks = [list(bs) for bs in pg["slot_blocks"]]
        eng._slot_reserve = list(pg["slot_reserve"])
        if "reserve_home" in pg and pg["reserve_home"] != [
                [r] for r in eng._slot_reserve]:
            raise RuntimeError("snapshot's per-home reservations do not "
                               "sum to its slot reservations")
        eng.alloc.free = [int(x) for x in pg["free"]]
        eng.alloc.refs = [int(x) for x in pg["refs"]]
    if eng.prefix is not None and host["prefix"] is not None:
        eng.prefix.load(host["prefix"])
    if eng.drafter is not None and host["drafter"] is not None:
        eng.drafter.ngram_max = host["drafter"]["ngram_max"]
        eng.drafter.ngram_min = host["drafter"]["ngram_min"]
        eng.drafter.load(host["drafter"])
    for k in _COUNTERS:
        setattr(eng, k, host["counters"][k])
    eng._draft_wait = list(host["draft_wait"])
    eng._draft_penalty = list(host["draft_penalty"])


def _find_live(eng: Engine, rid: int) -> Request:
    for s in eng._slots:
        if s.req is not None and s.req.rid == rid:
            return s.req
    for r in eng._queue:
        if r.rid == rid:
            return r
    raise RuntimeError(f"journal references unknown live rid {rid}")


def _replay(eng: Engine, events: list[dict]) -> set[int]:
    """Apply one epoch's journal to the freshly loaded snapshot state, in
    order.  Returns the live rids whose output grew past the snapshot:
    they must be folded, because the loaded device state covers only the
    snapshot's lengths."""
    emitted: set[int] = set()
    for ev in events:
        kind = ev["ev"]
        if kind == "submit":
            _no_frames(ev["rid"], ev["frames"])
            eng.submit(Request(
                rid=ev["rid"], prompt=np.asarray(ev["prompt"], np.int64),
                max_new_tokens=ev["max_new"], priority=ev["priority"],
                deadline_s=ev["deadline"]))
        elif kind == "emit":
            req = _find_live(eng, ev["rid"])
            now = eng.clock()
            if req.first_token_at is None:
                req.first_token_at = now
            req.output.append(int(ev["tok"]))
            req.token_times.append(now)
            emitted.add(ev["rid"])
        elif kind == "terminal":
            rid = ev["rid"]
            req = None
            for r in list(eng._queue):
                if r.rid == rid:
                    eng._queue.remove(r)
                    req = r
                    break
            if req is None:
                for i, s in enumerate(eng._slots):
                    if s.req is not None and s.req.rid == rid:
                        req = s.req
                        eng._free_slot(i)
                        break
            if req is None:
                continue            # already terminal (a duplicate event)
            req.error = ev.get("error")
            if ev["status"] == "deadline_missed":
                eng.deadline_misses += 1
            elif ev["status"] == "cancelled":
                eng.cancels += 1
            elif ev["status"] == "error":
                eng.row_faults += 1
            eng._terminal(req, ev["status"])
            eng.restored_terminal.append(req)
            emitted.discard(rid)
    return emitted


def _fold_replayed(eng: Engine, emitted: set[int]) -> None:
    """Fold every live request whose output grew past the snapshot.

    Slot residents fold through preemption's primitive (donating their
    loaded blocks to the radix cache, so re-admission is mostly a
    page-table copy) and requeue at the FRONT in admission order; a
    restore fold does not count against ``max_preemptions``.  Queued
    requests (admitted and preempted wholly after the snapshot) fold
    their prompt only."""
    resident = sorted(
        ((s.seq, i) for i, s in enumerate(eng._slots)
         if s.req is not None and s.req.rid in emitted),
        reverse=True)
    for _, i in resident:
        # front-requeue in reverse seq order leaves the queue seq-ascending
        req = eng._slots[i].req
        eng._fold_slot(i)
        req.status = "queued"
        eng._free_slot(i)
        eng._queue.appendleft(req)
    for r in eng._queue:
        if r.rid in emitted and len(r.output) > r.folded:
            r.prompt = np.concatenate([
                np.asarray(r.prompt, np.int64),
                np.asarray(r.output[r.folded:], np.int64)])
            r.folded = len(r.output)


def _sync(eng: Engine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def restore_engine(root: str, params: Any, **overrides) -> Engine:
    """Rebuild a process-equivalent engine from the latest complete
    snapshot and its journal (the module docstring has the contract;
    ``Engine.restore`` is its public face).  ``overrides`` replace
    constructor arguments: ``chaos``, ``compile_cache``, ``clock`` and
    ``device`` (the card unless the caller passes ``"cpu"``).  The phases'
    seconds land in ``engine.restore_seconds``."""
    t0 = time.perf_counter()
    epoch, snapdir = latest_snapshot(root)
    with open(os.path.join(snapdir, "host.json")) as f:
        host = json.load(f)
    cfg = cfg_from_dict(host["cfg"])
    kwargs = dict(host["kwargs"])
    kwargs.update(overrides)
    eng = Engine(cfg, params, **kwargs)     # snapshot_dir wired after replay
    _sync(eng)
    t1 = time.perf_counter()
    _warm_executables(eng, host["compile_keys"])
    _sync(eng)
    t2 = time.perf_counter()
    arrays, _ = checkpoint.read_state(os.path.join(snapdir, "device"),
                                      {"cache": eng.cache})
    api.load_cache_(cfg, eng.cache, {p.removeprefix("cache/"): a
                                     for p, a in arrays.items()})
    _sync(eng)
    t3 = time.perf_counter()
    _load_host(eng, host)
    emitted = _replay(eng, read_journal(journal_path(root, epoch)))
    _fold_replayed(eng, emitted)
    eng.audit()
    # durability resumes on the SAME epoch: events after the restore append
    # to its journal, so the epochs concatenated stay the exactly-once
    # stream
    eng.snapshot_dir = root
    eng._snap_epoch = epoch
    if eng.journal_enabled:
        eng._journal = Journal(journal_path(root, epoch))
    eng.restore_seconds = {"build": t1 - t0, "capture": t2 - t1,
                           "load": t3 - t2,
                           "replay": time.perf_counter() - t3}
    return eng
