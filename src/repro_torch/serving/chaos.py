"""Fault injection for the port's serving engine (port of
``repro/serving/chaos.py``).

The engine's resilience claims (preemption is lossless and bounded, a bad
row quarantines without touching its batch-mates, ``sum(reserve) <= free``
and the allocator's refcount partition survive anything) are checked under
adversarial schedules.  ``ChaosMonkey`` injects deterministic faults at the
host seams the engine defends:

* **reservation denials** (``deny_rate``): ``_admit_head`` treats a denial
  as a shortfall with no victim, and the head stalls a tick;
* **forced preemptions** (``preempt_rate``): a random running slot still
  under its bound is evicted and requeued at the front;
* **NaN logit rows** (``nan_rate``): a random advancing row's logits turn
  NaN on the host, where a device fault would surface; the engine must
  quarantine the row (``status="error"``) and not donate its blocks;
* **garbage drafts** (``garbage_draft_rate``): a verify row's draft is
  replaced by random ids of the same length, which greedy verification
  must reject losslessly;
* **process death** (``kill_rate``, ``kill_after``): ``EngineKilled`` at
  the top of a tick, after the previous tick's journal fsync; the engine
  is abandoned and ``Engine.restore`` picks up from its snapshot store.

Every fault stream draws from one seeded ``numpy.random.default_rng``, at
the same seams and in the same order as the reference's monkey, so one
seed injects the same faults into both engines and a run of the port can
be held against a run of the reference event by event.

``run_soak`` is the acceptance harness: every engine mixture of
``SOAK_CELLS`` (slot and paged, int8 K/V, speculation, prefix sharing)
runs a faulted engine with ``audit_every=1`` and asserts each surviving
request's stream is bitwise ``reference_decode`` on its ORIGINAL prompt:
faults may cut a row short, never corrupt a neighbour.  ``run_restart_soak``
(``--restart``) adds seeded process kills to the same mixtures: each kill
abandons the engine, a fresh ``Engine.restore`` resumes from disk, and the
durable record (every journal epoch) must hold the same contract.
Runnable directly (on the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.serving.chaos --seed 0
    PYTHONPATH=src python -m repro_torch.serving.chaos --restart
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.compiler import CompileCache
from repro_torch.models import api
from repro_torch.serving.engine import Engine, Request, reference_decode


@dataclasses.dataclass
class ChaosConfig:
    """Per-seam injection rates (probability per opportunity, in [0, 1])."""
    seed: int = 0
    deny_rate: float = 0.0           # P(reservation denied) per admit try
    preempt_rate: float = 0.0        # P(forced preemption) per tick
    nan_rate: float = 0.0            # P(row -> NaN) per advancing row
    garbage_draft_rate: float = 0.0  # P(draft garbled) per verify row
    kill_rate: float = 0.0           # P(process death) per tick top
    kill_after: int | None = None    # deterministic death at the Nth tick


class EngineKilled(RuntimeError):
    """Simulated process death, raised by ``ChaosMonkey.maybe_kill`` at the
    top of a tick.  What the engine had not journaled or snapshotted dies
    with it; ``Engine.restore`` recovers the rest, and the kill/restore
    soak holds the recovered streams bitwise against the oracle."""


class ChaosMonkey:
    """Deterministic fault injector the engine consults at its host seams.

    Built from a ``ChaosConfig`` or keyword rates and attached with
    ``Engine(..., chaos=monkey)``.  All randomness flows from one seeded
    generator, so identical (seed, workload) pairs inject identical
    faults."""

    def __init__(self, config: ChaosConfig | None = None, **rates: Any):
        self.config = config if config is not None else ChaosConfig(**rates)
        self._rng = np.random.default_rng(self.config.seed)
        self.injected = {"denials": 0, "preemptions": 0,
                         "nan_rows": 0, "garbled_drafts": 0, "kills": 0}
        self._ticks_to_kill = self.config.kill_after

    # -- seams (called by Engine.run / Engine._admit_head) -----------------

    def maybe_kill(self) -> None:
        """Once per tick, at the top: simulated process death.  Draws from
        the generator only when ``kill_rate`` is set, so a kill-free
        monkey's other streams do not move."""
        if self._ticks_to_kill is not None:
            self._ticks_to_kill -= 1
            if self._ticks_to_kill <= 0:
                self._ticks_to_kill = None
                self.injected["kills"] += 1
                raise EngineKilled("chaos: process killed at tick "
                                   f"{self.config.kill_after} (scheduled)")
        if (self.config.kill_rate and
                self._rng.random() < self.config.kill_rate):
            self.injected["kills"] += 1
            raise EngineKilled("chaos: process killed at tick top")

    def deny_reservation(self) -> bool:
        """One admission attempt: True = pretend the pool cannot reserve."""
        if self._rng.random() < self.config.deny_rate:
            self.injected["denials"] += 1
            return True
        return False

    def forced_preempt(self, eligible: list[int]) -> int | None:
        """Once per tick: a running slot to evict, or None.  Only slots
        still under their preemption bound are offered."""
        if eligible and self._rng.random() < self.config.preempt_rate:
            self.injected["preemptions"] += 1
            return int(self._rng.choice(eligible))
        return None

    def corrupt_rows(self, advancing: list[int]) -> list[int]:
        """Once per tick: the advancing rows whose logits turn NaN this
        dispatch (one draw per row)."""
        hit = [i for i in advancing
               if self._rng.random() < self.config.nan_rate]
        self.injected["nan_rows"] += len(hit)
        return hit

    def garble_draft(self, draft: list[int], vocab: int) -> list[int]:
        """Maybe replace one verify row's draft with junk of the same
        length (the engine sized its leases by it)."""
        if self._rng.random() < self.config.garbage_draft_rate:
            self.injected["garbled_drafts"] += 1
            return self._rng.integers(0, vocab, len(draft)).tolist()
        return draft

    def stats(self) -> dict[str, Any]:
        return {**dataclasses.asdict(self.config), **self.injected}


# -- soak harness ----------------------------------------------------------

# every engine mixture the resilience contract must survive on one card:
# (label, kv_layout, kv_quant, spec_k, prefix_cache).  The reference's
# seventh cell, "paged-mesh", shards decode over several devices.
SOAK_CELLS = [
    ("slot",            "slot",  "none", 0, False),
    ("paged",           "paged", "none", 0, False),
    ("paged-int8",      "paged", "int8", 0, False),
    ("paged-spec",      "paged", "none", 3, False),
    ("paged-prefix",    "paged", "none", 0, True),
    ("paged-all",       "paged", "int8", 3, True),
]

SOAK_MAX_LEN = 96


def soak_config(kv_layout: str, kv_quant: str, device="cpu"):
    """The reference soak's model: qwen-7b-smoke at d_model 64, d_ff 128,
    vocab 256, float32; a paged pool of 40 8-token blocks.  On the card
    d_model is 128, the narrowest the CUDA FFN takes for 16-bit weights
    (every width a multiple of 128)."""
    over = ({"kv_block_size": 8, "kv_pool_blocks": 40}
            if kv_layout == "paged" else {})
    d_model = 128 if torch.device(device).type == "cuda" else 64
    return get_smoke_config("qwen-7b", d_model=d_model, d_ff=128,
                            vocab_size=256, kv_layout=kv_layout,
                            kv_quant=kv_quant, **over)


def soak_requests(vocab: int, prefix_cache: bool, *, seed: int = 0,
                  n_requests: int = 10) -> list[tuple[int, np.ndarray, int]]:
    """The soak's workload as (rid, prompt, max_new_tokens), drawn as the
    reference's ``run_soak_cell`` draws it: prompts of 4-32 tokens, and
    with sharing every third one a 24-token hot prefix and 2-8 more."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 24)
    work = []
    for rid in range(n_requests):
        if rid % 3 == 0 and prefix_cache:
            prompt = np.concatenate(
                [shared, rng.integers(0, vocab, rng.integers(2, 9))])
        else:
            prompt = rng.integers(0, vocab, rng.integers(4, 33))
        work.append((rid, prompt.astype(np.int64),
                     int(rng.integers(4, 13))))
    return work


def soak_monkey(seed: int, spec_k: int) -> ChaosMonkey:
    """The soak's fault rates, the reference's."""
    return ChaosMonkey(ChaosConfig(
        seed=seed + 1, deny_rate=0.10, preempt_rate=0.15, nan_rate=0.02,
        garbage_draft_rate=0.5 if spec_k else 0.0))


def check_soak(label: str, reqs: list[Request], oracle: dict,
               engine: Engine, done) -> dict[str, int]:
    """The soak's assertions: the run drained, every request terminal,
    every ``done`` stream bitwise its oracle, every faulted stream a
    prefix of it, the preemption bound kept and (paged) no block leaked.
    Returns the outcome counts."""
    assert done.drained, (
        f"{label}: soak did not drain (truncated={done.truncated} "
        f"stalled={done.stalled} in_flight={done.in_flight})")
    engine.audit()
    outcomes: dict[str, int] = {}
    for r in reqs:
        assert r.done and r.status in ("done", "error"), (
            f"{label}: rid {r.rid} not terminal: {r.status}")
        outcomes[r.status] = outcomes.get(r.status, 0) + 1
        ref = oracle[r.rid]
        if r.status == "done":
            assert r.output == ref, (
                f"{label}: rid {r.rid} (preempted {r.preemptions}x) "
                f"diverged from oracle:\n  got {r.output}\n  ref {ref}")
        else:
            assert r.output == ref[:len(r.output)], (
                f"{label}: faulted rid {r.rid} corrupted before its fault")
        assert r.preemptions <= engine.max_preemptions, (
            f"{label}: preemption bound violated")
    if engine.paged:
        assert engine.alloc.n_free == engine.pool_blocks - (
            len(engine.prefix.blocks()) if engine.prefix is not None else 0), (
            f"{label}: leaked blocks after drain")
    return outcomes


def run_soak_cell(label: str, kv_layout: str, kv_quant: str, spec_k: int,
                  prefix_cache: bool, *, seed: int = 0, n_requests: int = 10,
                  params: Any = None, device="cuda") -> dict[str, Any]:
    """One soak cell: a faulted engine against the unfaulted oracle.

    ``params`` default to random weights from ``torch.Generator`` seeded
    with ``seed`` on ``device``.  Asserts ``check_soak``'s contract, with
    ``audit()`` run on every tick (it raises on a broken invariant).
    Returns the cell's outcome and resilience counters."""
    cfg = soak_config(kv_layout, kv_quant, device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = api.init_params(cfg, gen)
    work = soak_requests(cfg.vocab_size, prefix_cache, seed=seed,
                         n_requests=n_requests)
    reqs, oracle = [], {}
    for rid, prompt, n in work:
        # the oracle runs on the ORIGINAL prompt, before preemption folds
        # output into it
        oracle[rid] = reference_decode(cfg, params, prompt, n,
                                       max_len=SOAK_MAX_LEN, device=device)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    engine = Engine(cfg, params, batch_size=4, max_len=SOAK_MAX_LEN,
                    chunk_size=16, prefill_token_budget=32, spec_k=spec_k,
                    prefix_cache=prefix_cache, max_preemptions=2,
                    audit_every=1, chaos=soak_monkey(seed, spec_k),
                    device=device)
    for r in reqs:
        engine.submit(r)
    done = engine.run(max_steps=4000)
    outcomes = check_soak(label, reqs, oracle, engine, done)
    return {"cell": label, "outcomes": outcomes, "n_homes": 1,
            **engine.resilience_stats()}


def run_soak(seed: int = 0, n_requests: int = 10,
             device="cuda") -> list[dict[str, Any]]:
    """Every cell of ``SOAK_CELLS``."""
    return [run_soak_cell(*cell, seed=seed, n_requests=n_requests,
                          device=device)
            for cell in SOAK_CELLS]


# -- kill/restore soak ------------------------------------------------------

def restart_monkey(seed: int, spec_k: int, life: int,
                   max_lives: int) -> ChaosMonkey:
    """The kill/restore soak's monkey of one life, the reference's: life 0
    dies at tick 7, one tick past the first periodic snapshot (every 6),
    so recovery always replays a journal tail; later lives die at
    ``kill_rate=0.08`` until ``max_lives``, so the soak always drains."""
    return ChaosMonkey(ChaosConfig(
        seed=seed + 100 + life, deny_rate=0.05, preempt_rate=0.10,
        nan_rate=0.02, garbage_draft_rate=0.5 if spec_k else 0.0,
        kill_after=7 if life == 0 else None,
        kill_rate=0.08 if 0 < life < max_lives else 0.0))


def release(device) -> None:
    """After a kill: the abandoned engine's graphs, graph pool and pinned
    buffers belong to it alone, so they go before the next restore."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check_durable(label: str, root: str, oracle: dict,
                  n_requests: int) -> dict[str, int]:
    """The durable record's contract (``snapshot.journaled_streams``
    across every journal epoch): each rid terminal exactly once, a
    ``done`` stream bitwise its oracle, a faulted one a prefix of it.
    Returns the outcome counts."""
    from repro_torch.serving import snapshot as snaplib
    streams, status = snaplib.journaled_streams(root)
    terminals: dict[int, int] = {}
    for path in sorted(os.path.join(root, d) for d in os.listdir(root)
                       if d.startswith("journal_")):
        for ev in snaplib.read_journal(path):
            if ev["ev"] == "terminal":
                terminals[ev["rid"]] = terminals.get(ev["rid"], 0) + 1
    outcomes: dict[str, int] = {}
    for rid in range(n_requests):
        st = status.get(rid)
        assert st in ("done", "error"), (
            f"{label}: rid {rid} durable status {st!r} not terminal")
        assert terminals.get(rid) == 1, (
            f"{label}: rid {rid} journaled {terminals.get(rid)} terminals")
        outcomes[st] = outcomes.get(st, 0) + 1
        ref, got = oracle[rid], streams.get(rid, [])
        if st == "done":
            assert got == ref, (
                f"{label}: rid {rid} durable stream diverged:\n  got {got}"
                f"\n  ref {ref}")
        else:
            assert got == ref[:len(got)], (
                f"{label}: faulted rid {rid} corrupted before its fault")
    return outcomes


def run_restart_cell(label: str, kv_layout: str, kv_quant: str,
                     spec_k: int, prefix_cache: bool, *, seed: int = 0,
                     n_requests: int = 10, max_lives: int = 12,
                     params: Any = None, device="cuda") -> dict[str, Any]:
    """One kill/restore cell: the soak's fault mix plus seeded process
    kills (``restart_monkey``), on an engine with snapshots every 6 ticks
    and the journal.  Each ``EngineKilled`` abandons the engine (and, on
    the card, frees it) and ``Engine.restore`` resumes from disk.  Asserts
    ``check_durable``'s contract, ``audit()`` green on every tick and on
    the last engine, and no block leaked across any restart.  On the CPU
    the lives share one compile cache, as in the reference; on the card
    each life captures its own graphs."""
    cfg = soak_config(kv_layout, kv_quant, device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = api.init_params(cfg, gen)
    oracle = {rid: reference_decode(cfg, params, prompt, n,
                                    max_len=SOAK_MAX_LEN, device=device)
              for rid, prompt, n in soak_requests(
                  cfg.vocab_size, prefix_cache, seed=seed,
                  n_requests=n_requests)}
    on_card = torch.device(device).type == "cuda"
    cc = None if on_card else CompileCache()
    workdir = tempfile.mkdtemp(prefix=f"restart_{label}_")
    try:
        engine = Engine(cfg, params, batch_size=4, max_len=SOAK_MAX_LEN,
                        chunk_size=16, prefill_token_budget=32,
                        spec_k=spec_k, prefix_cache=prefix_cache,
                        max_preemptions=2, audit_every=1,
                        chaos=restart_monkey(seed, spec_k, 0, max_lives),
                        compile_cache=cc, snapshot_dir=workdir,
                        snapshot_every=6, device=device)
        for rid, prompt, n in soak_requests(cfg.vocab_size, prefix_cache,
                                            seed=seed,
                                            n_requests=n_requests):
            engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
        lives = 1
        while True:
            killed = False
            try:
                res = engine.run(max_steps=4000)
            except EngineKilled:
                killed = True
            if not killed:
                break
            # outside the handler: its traceback holds the dead engine
            engine = None
            release(device)
            engine = Engine.restore(
                workdir, params, compile_cache=cc, device=device,
                chaos=restart_monkey(seed, spec_k, lives, max_lives))
            lives += 1
        assert res.drained, (
            f"{label}: restart soak did not drain (truncated="
            f"{res.truncated} stalled={res.stalled} "
            f"in_flight={res.in_flight})")
        engine.audit()
        kills = lives - 1
        assert kills >= 1, f"{label}: no kill fired"
        outcomes = check_durable(label, workdir, oracle, n_requests)
        if engine.paged:
            assert engine.alloc.n_free == engine.pool_blocks - (
                len(engine.prefix.blocks())
                if engine.prefix is not None else 0), (
                f"{label}: leaked blocks across the restart boundary")
        return {"cell": label, "lives": lives, "kills": kills,
                "snapshots_taken": engine.snapshots_taken,
                "outcomes": outcomes, "n_homes": 1,
                **engine.resilience_stats()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_restart_soak(seed: int = 0, n_requests: int = 10,
                     device="cuda") -> list[dict[str, Any]]:
    """The kill/restore soak over every cell of ``SOAK_CELLS``."""
    return [run_restart_cell(*cell, seed=seed, n_requests=n_requests,
                             device=device)
            for cell in SOAK_CELLS]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-requests", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--restart", action="store_true",
                   help="run the kill/restore soak (snapshots, journal and "
                        "seeded process kills) instead of the in-process "
                        "one")
    p.add_argument("--out", default=None,
                   help="write per-cell stats JSON here")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path")
    soak = run_restart_soak if args.restart else run_soak
    stats = soak(seed=args.seed, n_requests=args.n_requests,
                 device=args.device)
    for s in stats:
        print(json.dumps(s))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seed": args.seed, "cells": stats}, f, indent=2)
        print(f"wrote {args.out}")
    kind = "kill/restore" if args.restart else "chaos"
    print(f"{kind} soak OK: {len(stats)} cells green")


if __name__ == "__main__":
    main()
