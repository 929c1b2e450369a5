"""Serving engine: chunked-prefill continuous batching over one resident
KV cache, slot or paged.

Port of the core of ``repro/serving/engine.py`` (EdgeLLM §IV-B):

* **One resident cache.**  ``api.init_cache(cfg, B, max_len)`` allocates a
  single cache on the device for the engine's lifetime; requests lease a
  slot.  With ``kv_layout="paged"`` the cache is one shared block pool per
  layer, and the engine keeps the host side of it (below).
* **One dispatch per tick.**  ``api.mixed_step`` advances every slot in one
  call (row ``b`` by ``q_lens[b]`` tokens: 1 for a decoding row, up to the
  chunk width for a row mid-prefill); a tick with no prompt chunk in flight
  runs ``api.decode_step``.  Prompts stream in chunk-width pieces
  (Sarathi-style) beside the decode rows, so admission costs no extra
  dispatch.  Chunk widths are bucketed by ``TokenBuckets``; which rows
  advance is ``_schedule_chunks``'s choice (``prefill_token_budget``,
  ``prefill_policy``), as in the reference.
* **Bounded executables.**  Each tick runs the executable of its key,
  ``("mixed", W)`` or ``("decode", B)``, memoized in a ``CompileCache``
  (``cache_compiles``); ``("insert", B)`` is the admission copy.  Misses
  are bounded by ``compile_budget`` = chunk buckets + 2, whatever the
  traffic.  On the card a mixed or decode key is ONE captured CUDA graph
  (``_CapturedTick``): captured on its first miss, after a warm-up dispatch
  in which every row is dead (so it writes no cache leaf), and replayed on
  every hit.  A tick copies its host arrays into pinned staging buffers
  and from there, without blocking, into the graph's static inputs; the
  only copy back is the token ids (and the logits for a ``sample`` hook).
  An engine's graphs share one memory pool.  A capture that fails raises:
  the engine never serves a tick eagerly on the card.  On the CPU the same
  functions run eagerly, memoized under the same keys, so keys, hits,
  misses and the budget mean the same on both devices.
* **True-length accounting.**  Slots track the request's real token count;
  K/V land at real positions and a prompt is admissible whenever
  ``len(prompt) <= max_len``.
* **Greedy on the device.**  The argmax runs on the device; only the token
  ids come back, unless a ``sample`` hook asks for the logits.
* **Recurrent families** (``api.needs_admission_insert``: the xLSTM's
  ``ssm``) get a fresh ``api.request_cache`` row copied into the slot at
  admission, so the previous occupant's state (the mLSTM stabilizer ``m``)
  never leaks into the next request.  A decode tick's ``write_mask`` keeps
  the rows that do not advance (dead ones) untouched, on every family and
  layout.  Their mixed tick steps the chunk one
  position at a time (``api.mixed_step``), so ``dispatched_columns``
  counts the token columns each tick dispatched: the chunk bucket of a
  mixed tick, one for a decode tick.

The engine ≡ oracle contract holds: every token stream equals
``reference_decode`` (batch-1 sequential decode), because the kernels reduce
every row in an order independent of the batch and the chunk width.

Paged KV bookkeeping (host only; the device sees a page table):

* **Geometry.**  ``block_size`` tokens per page, ``n_pages`` pages per slot,
  ``pool_blocks`` usable blocks (``kv_pool_blocks``, or ``B * n_pages``);
  the null block is ``pool_blocks``, the pool's last row.  The page table
  ``(B, n_pages)`` starts all-null and goes into every dispatch as a device
  tensor.
* **Reservation admission.**  A request's worst case is
  ``ceil(min(prompt + max_new_tokens, max_len) / block_size)`` blocks
  (``submit`` refuses one larger than the pool).  The queue head is
  admitted only when the free blocks not yet reserved cover its worst case
  (strict FIFO); otherwise the tick counts an ``admission_stalls`` and
  admits nothing more.  ``sum(reserve) <= free`` therefore always holds, so
  an admitted row can always lease its next block: pressure shows up as
  stalls, never as a stuck batch.
* **Leasing on demand.**  Before each dispatch every advancing row leases
  the blocks its new length crosses into (``BlockAllocator``, LIFO).
* **Release.**  Retirement drops the row's block references and points its
  page-table row back at the null block.
* ``pool_stats``, ``peak_resident_tokens`` and ``audit`` (every
  ``audit_every`` ticks) expose and check these invariants.

One card means one block home: the reference's per-home reservation split
is the total check here.  Left for later slices, and not accepted as
arguments: speculation, prefix sharing and copy-on-write (the ``("cow",
0)`` key), the request lifecycle and preemption, quarantine, chaos and
snapshots.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compiler import CompileCache, TokenBuckets
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.models.attention import (
    check_supported, paged_geometry, paged_pool_blocks)
from repro_torch.serving.prefix import BlockAllocator


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 32
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None
    token_times: list = dataclasses.field(default_factory=list)


class RunResult(list):
    """``Engine.run``'s return value: the requests finished during the call,
    plus ``truncated`` (``max_steps`` ran out with work left) and the
    ``in_flight`` / ``queued`` counts at return."""

    def __init__(self, reqs=(), *, truncated: bool = False,
                 in_flight: int = 0, queued: int = 0):
        super().__init__(reqs)
        self.truncated = truncated
        self.in_flight = in_flight
        self.queued = queued

    @property
    def drained(self) -> bool:
        return not (self.truncated or self.in_flight or self.queued)


@dataclasses.dataclass
class _Slot:
    """Host-side mirror of one row of the resident cache."""
    req: Request | None = None
    length: int = 0                  # TRUE tokens resident in this row
    pos: int = 0                     # prompt tokens consumed (chunk cursor)
    last_token: int = 0              # input token for the next decode step

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.pos < len(self.req.prompt)


def _mixed_executable(cfg):
    # page_table: the paged layout's operand, absent for the slot cache
    def fn(p, c, tokens, lengths, q_lens, page_table=None):
        logits, _ = api.mixed_step(cfg, p, c, tokens, lengths, q_lens,
                                   page_table=page_table)
        return torch.argmax(logits, dim=-1), logits
    return fn


def _decode_executable(cfg):
    # write_mask keeps the rows that do not advance untouched, so a tick
    # with every row dead writes nothing (the warm-up before a capture)
    def fn(p, c, tokens, lengths, write_mask, page_table=None):
        logits, _ = api.decode_step(cfg, p, c, tokens, lengths,
                                    page_table=page_table,
                                    write_mask=write_mask)
        return torch.argmax(logits, dim=-1), logits
    return fn


def _insert_executable(cfg):
    def fn(c, row, slot):
        return api.insert_request(cfg, c, row, slot)
    return fn


class _EagerTick:
    """A key's executable run eagerly (the CPU): host arrays in, device
    tensors ``(next_tok, logits)`` out, the cache updated in place."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device

    def __call__(self, params, cache, **host):
        args = {k: torch.from_numpy(a).to(self.device)
                for k, a in host.items()}
        return self.fn(params, cache, **args)


class _CapturedTick:
    """A key's executable as one captured CUDA graph.

    ``inputs`` are the static device buffers the graph reads (their
    values: a dispatch with every row dead); ``pinned`` the host staging
    buffers a tick writes first.  Before the capture the graph's function
    runs once on those dead inputs (lazy initialisation stays out of the
    graph; no cache leaf changes).  The capture records each kernel
    wrapper's launch; that count (``launches``) is added to
    ``_build.launches`` on every replay instead, so the counts read as if
    every tick had run eagerly (the warm-up serves no tick and is not
    counted).  The graph belongs to the params and cache it was captured
    with."""

    def __init__(self, fn, params, cache, inputs: dict, pool):
        self.fn, self.params, self.cache = fn, params, cache
        self.inputs = inputs
        self.pinned = {k: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                       for k, t in inputs.items()}
        before = collections.Counter(_build.launches)
        side = torch.cuda.Stream(inputs["tokens"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(params, cache, **inputs)
        torch.cuda.current_stream().wait_stream(side)
        warm = collections.Counter(_build.launches)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = fn(params, cache, **inputs)
        self.capture_s = time.perf_counter() - t0
        self.launches = collections.Counter(_build.launches) - warm
        _build.launches.clear()
        _build.launches.update(before)

    def __call__(self, params, cache, **host):
        if params is not self.params or cache is not self.cache:
            raise ValueError("a captured tick replays only on the params "
                             "and cache it was captured with")
        for k, a in host.items():
            self.pinned[k].numpy()[...] = a
            self.inputs[k].copy_(self.pinned[k], non_blocking=True)
        self.graph.replay()
        _build.launches.update(self.launches)
        return self.outputs


class Engine:
    """Continuous-batching engine: one mixed-batch dispatch per tick."""

    def __init__(self, cfg, params: Any, *, batch_size: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 chunk_size: int = 64,
                 prefill_token_budget: int | None = None,
                 prefill_policy: str = "mixed", audit_every: int = 0,
                 compile_cache: CompileCache | None = None, device="cuda"):
        if prefill_policy not in ("mixed", "stall"):
            raise ValueError(f"unknown prefill_policy {prefill_policy!r}")
        self.device = torch.device(device)
        check_supported(cfg, self.device)
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        # >= 2 so a mixed tick never takes mixed_step's C == 1 delegation
        self.chunk_size = max(2, min(chunk_size, max_len))
        self.prefill_token_budget = prefill_token_budget
        self.prefill_policy = prefill_policy
        self.chunk_buckets = TokenBuckets(
            max_tokens=self.chunk_size, min_bucket=min(16, self.chunk_size))
        # `is not None`, not `or`: an EMPTY CompileCache is falsy (__len__).
        # On the card an entry is a graph bound to this engine's params and
        # cache, so a cache shared with another engine fails at its replay;
        # on the CPU a shared cache serves engines of the same (cfg,
        # max_len, batch, chunk_size), as in the reference
        self.cache_compiles = (compile_cache if compile_cache is not None
                               else CompileCache())
        self.capture_seconds: dict[tuple, float] = {}   # key -> capture
        self._graph_pool = None
        self._queue: "collections.deque[Request]" = collections.deque()
        self.cache = api.init_cache(cfg, batch_size, max_len, self.device)
        self._slots = [_Slot() for _ in range(batch_size)]
        self.paged = api.has_paged_kv(cfg)
        # the pristine row an admission copies into its slot
        self._fresh_row = (api.request_cache(cfg, params, {}, max_len,
                                             self.device)
                           if api.needs_admission_insert(cfg) else None)
        if self.paged:
            self.block_size, self.n_pages = paged_geometry(cfg, max_len)
            self.pool_blocks = paged_pool_blocks(cfg, batch_size, max_len)
            self._null_block = self.pool_blocks      # last pool row
            self.alloc = BlockAllocator(self.pool_blocks)
            self._page_table = np.full((batch_size, self.n_pages),
                                       self._null_block, np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in
                                                  range(batch_size)]
            self._slot_reserve = [0] * batch_size    # worst-case not-yet-leased
        self.admission_stalls = 0    # admissions held back by the block pool
        self.peak_resident_tokens = 0
        self.audit_every = audit_every
        self.audits = 0              # audit() passes run (all green)
        self.steps = 0
        self.dispatches = 0          # must equal steps: one dispatch per tick
        self.mixed_ticks = 0
        self.dispatched_columns = 0  # chunk width of each tick, summed
        self._occupancy_sum = 0.0

    # -- client API ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} exceeds "
                f"engine max_len {self.max_len} — raise max_len or truncate")
        if self.paged and self._worst_case_blocks(req) > self.pool_blocks:
            raise ValueError(
                f"request {req.rid}: worst case needs "
                f"{self._worst_case_blocks(req)} KV blocks but the pool has "
                f"{self.pool_blocks} — raise kv_pool_blocks")
        req.submitted_at = time.monotonic()
        self._queue.append(req)

    # -- paged-KV block accounting -------------------------------------------

    def _worst_case_blocks(self, req: Request) -> int:
        """Blocks the request can ever hold: its prompt plus its generation,
        capped by the cache's addressable span (the ``_emit`` stop rules)."""
        toks = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return -(-toks // self.block_size)

    def _can_reserve(self, req: Request) -> bool:
        """Admission gate: the free blocks nobody has reserved yet must
        cover the request's worst case."""
        return (self.alloc.n_free - sum(self._slot_reserve)
                >= self._worst_case_blocks(req))

    def _admit_head(self, idx: int) -> bool:
        """Admit the queue head into free slot ``idx``, or count an
        admission stall when the pool cannot cover its reservation."""
        head = self._queue[0]
        if self.paged:
            if not self._can_reserve(head):
                self.admission_stalls += 1
                return False
            self._slot_reserve[idx] = self._worst_case_blocks(head)
        if self._fresh_row is not None:
            insert = self.cache_compiles.get(
                "insert", self.batch, lambda: _insert_executable(self.cfg))
            self.cache = insert(self.cache, self._fresh_row, idx)
        self._slots[idx] = _Slot(req=self._queue.popleft())
        return True

    def _lease_to(self, idx: int, new_len: int) -> None:
        """Grow slot ``idx`` to cover ``new_len`` tokens, leasing blocks as
        the length crosses page boundaries, against its reservation."""
        owned = self._slot_blocks[idx]
        while len(owned) < -(-new_len // self.block_size):
            if self._slot_reserve[idx] <= 0:
                raise RuntimeError(
                    f"slot {idx} leased past its reservation — worst-case "
                    "accounting is wrong")
            blk = self.alloc.lease()
            self._slot_reserve[idx] -= 1
            self._page_table[idx, len(owned)] = blk
            owned.append(blk)

    def pool_stats(self) -> dict[str, int]:
        """Free-list invariants, exposed for leak/double-free checks:
        ``free + leased == total`` always."""
        return {
            "total": self.pool_blocks,
            "free": self.alloc.n_free,
            "leased": self.alloc.n_live,
            "n_homes": self.alloc.n_homes,
            "reserved_outstanding": sum(self._slot_reserve),
        }

    def audit(self) -> None:
        """One-shot invariant audit (``audit_every`` runs it each N ticks).
        Raises AssertionError on the first violation: the allocator's
        partition, deadlock freedom (``sum(reserve) <= free``), page-table
        rows mirroring exactly the blocks each slot owns with a null tail,
        dead slots owning nothing, and no slot past ``max_len``."""
        self.audits += 1
        if self.paged:
            self.alloc.check()
            reserved = sum(self._slot_reserve)
            assert reserved <= self.alloc.n_free, (
                f"reservation invariant broken: {reserved} reserved > "
                f"{self.alloc.n_free} free")
            for i, s in enumerate(self._slots):
                owned = self._slot_blocks[i]
                if s.req is None:
                    assert not owned and not self._slot_reserve[i], (
                        f"dead slot {i} owns blocks/reservation")
                row = self._page_table[i]
                assert list(row[:len(owned)]) == owned, (
                    f"slot {i} page table != owned blocks")
                assert all(b == self._null_block for b in row[len(owned):]), (
                    f"slot {i} page table has stale tail entries")
                for blk in owned:
                    assert 0 <= blk < self.pool_blocks, (
                        f"slot {i} maps out-of-pool block {blk}")
                    assert self.alloc.ref(blk) >= 1, (
                        f"slot {i} maps freed block {blk}")
        for i, s in enumerate(self._slots):
            if s.req is not None:
                assert s.length <= self.max_len, f"slot {i} overran max_len"

    @property
    def compile_budget(self) -> int:
        """Upper bound on compile-cache misses (captured graphs and the
        insert entry) this engine can cause: n_chunk_buckets (mixed
        widths) + decode + insert."""
        return len(self.chunk_buckets.all_buckets()) + 2

    # -- executables (memoized: misses bounded by compile_budget) -----------

    def _dead_inputs(self, width: int | None) -> dict[str, np.ndarray]:
        """Inputs of a dispatch in which every row is dead: a mixed tick of
        ``width`` columns with ``q_lens == 0``, or (``width`` None) a
        decode tick with an all-False ``write_mask`` (lengths as the
        engine gives a dead row)."""
        b = self.batch
        if width is None:
            dead = {"tokens": np.zeros((b, 1), np.int64),
                    "lengths": np.full(b, 0 if self.paged else 1, np.int32),
                    "write_mask": np.zeros(b, bool)}
        else:
            dead = {"tokens": np.zeros((b, width), np.int64),
                    "lengths": np.zeros(b, np.int32),
                    "q_lens": np.zeros(b, np.int32)}
        if self.paged:
            dead["page_table"] = np.full((b, self.n_pages), self._null_block,
                                         np.int32)
        return dead

    def _executable(self, name: str, width: int | None):
        """The memoized entry of a ``("mixed", width)`` or (``width``
        None) ``("decode", B)`` tick."""
        bucket = self.batch if width is None else width
        return self.cache_compiles.get(
            name, bucket, lambda: self._build_tick(name, bucket, width))

    def _build_tick(self, name: str, bucket: int, width: int | None):
        """On the card the key's function captured as a graph over static
        inputs holding a dispatch with every row dead; on the CPU the
        function run eagerly."""
        fn = (_mixed_executable if name == "mixed"
              else _decode_executable)(self.cfg)
        if self.device.type != "cuda":
            return _EagerTick(fn, self.device)
        if self._graph_pool is None:
            _build.prepare()
            self._graph_pool = torch.cuda.graph_pool_handle()
        inputs = {k: torch.from_numpy(a).to(self.device)
                  for k, a in self._dead_inputs(width).items()}
        tick = _CapturedTick(fn, self.params, self.cache, inputs,
                             self._graph_pool)
        self.capture_seconds[(name, bucket)] = tick.capture_s
        return tick

    # -- internals -----------------------------------------------------------

    def _free_slot(self, idx: int) -> None:
        """Retire a row: a host-side release only.  The dead row's stale KV
        hides behind true-length masking until the next occupant writes.
        Paged: the row's block references are dropped and its page-table
        row points at the null block again, so a stale entry can never
        alias a block the next occupant is handed."""
        if self.paged:
            for blk in self._slot_blocks[idx]:
                try:
                    self.alloc.decref(blk)
                except RuntimeError as e:
                    raise RuntimeError(f"{e} (slot {idx})") from None
            self._slot_blocks[idx] = []
            self._slot_reserve[idx] = 0
            self._page_table[idx, :] = self._null_block
        self._slots[idx] = _Slot()

    def _schedule_chunks(self) -> list[int]:
        """Pick this tick's per-slot prompt-chunk sizes (Sarathi-style).

        Returns q_lens for mid-prefill rows only (0 elsewhere).  The
        "mixed" policy advances every mid-prefill row, subject to the
        token budget (FIFO by slot, at least one row always advances);
        the "stall" policy advances only the oldest mid-prefill row —
        head-of-line-blocking admission, the reference's serving_bench
        baseline (its decode rows wait that tick).
        """
        chunks = [0] * self.batch
        budget = self.prefill_token_budget
        picked = 0
        for i, s in enumerate(self._slots):
            if not s.prefilling:
                continue
            want = min(self.chunk_size, len(s.req.prompt) - s.pos)
            if picked and budget is not None:
                want = min(want, max(budget, 0))
            if picked and self.prefill_policy == "stall":
                want = 0
            if want <= 0:
                continue
            chunks[i] = want
            picked += 1
            if budget is not None:
                budget -= want
        return chunks

    def _emit(self, idx: int, token: int, completed: list[Request],
              first: bool) -> None:
        """Record one generated token; finish and free the slot when done."""
        slot = self._slots[idx]
        req = slot.req
        now = time.monotonic()
        if first:
            req.first_token_at = now
        req.output.append(token)
        req.token_times.append(now)
        slot.last_token = token
        if (len(req.output) >= req.max_new_tokens or
                slot.length >= self.max_len or   # no cache room to decode into
                (self.eos_id is not None and token == self.eos_id)):
            req.done = True
            req.finished_at = now
            completed.append(req)
            self._free_slot(idx)

    def run(self, *, max_steps: int = 10_000,
            sample: Callable | None = None) -> RunResult:
        """Drain the queue; returns the requests finished during the call.

        Each tick: (1) refill free slots from the queue (a host-side lease;
        paged: strict FIFO behind the block reservation), (2) co-schedule
        prompt chunks with decode rows and, paged, lease the blocks they
        grow into, (3) advance ALL slots with exactly one call — the
        ``("mixed", W)`` executable when any prompt chunk is in flight, the
        ``("decode", B)`` one otherwise (a graph replay on the card) — and
        consume the tokens.
        ``sample`` maps a logits row (V,) to a token id; greedy argmax on
        the device when None."""
        completed: list[Request] = []
        start_steps = self.steps
        while self.steps - start_steps < max_steps:
            for i in range(self.batch):
                if self._slots[i].req is None and self._queue:
                    if not self._admit_head(i):
                        break
            live = [i for i, s in enumerate(self._slots) if s.req is not None]
            if not live:
                break
            chunks = self._schedule_chunks()
            stall = self.prefill_policy == "stall" and any(chunks)
            decoding = [i for i in live
                        if not self._slots[i].prefilling and not stall]
            host = {}
            if self.paged:
                for i, s in enumerate(self._slots):
                    if chunks[i]:
                        self._lease_to(i, s.length + chunks[i])
                    elif i in decoding:
                        self._lease_to(i, s.length + 1)
                host["page_table"] = self._page_table

            if any(chunks):
                # mixed tick: prompt chunks + decode rows, one dispatch
                w = self.chunk_buckets.bucket(max(max(chunks), 2))
                tokens = np.zeros((self.batch, w), np.int64)
                lengths = np.zeros(self.batch, np.int32)
                q_lens = np.zeros(self.batch, np.int32)
                for i, s in enumerate(self._slots):
                    lengths[i] = s.length
                    if chunks[i]:
                        q_lens[i] = chunks[i]
                        tokens[i, :chunks[i]] = \
                            s.req.prompt[s.pos:s.pos + chunks[i]]
                    elif i in decoding:
                        q_lens[i] = 1
                        tokens[i, 0] = s.last_token
                fn = self._executable("mixed", w)
                next_tok, logits = fn(self.params, self.cache, tokens=tokens,
                                      lengths=lengths, q_lens=q_lens, **host)
                self.mixed_ticks += 1
                self.dispatched_columns += w
            else:
                # pure-decode tick: rows outside write_mask (dead ones) ride
                # along, their output ignored and their cache untouched
                # (paged: at length 0 they read no block of the pool)
                tokens = np.fromiter((s.last_token for s in self._slots),
                                     np.int64, self.batch).reshape(-1, 1)
                lengths = np.fromiter(
                    (s.length + 1 if i in decoding else
                     0 if self.paged else max(s.length, 1)
                     for i, s in enumerate(self._slots)),
                    np.int32, self.batch)
                adv = np.zeros(self.batch, bool)
                adv[decoding] = True
                fn = self._executable("decode", None)
                next_tok, logits = fn(self.params, self.cache, tokens=tokens,
                                      lengths=lengths, write_mask=adv,
                                      **host)
                self.dispatched_columns += 1
            next_np = next_tok.cpu().numpy()
            logits_np = (logits.float().cpu().numpy() if sample is not None
                         else None)
            self.steps += 1
            self.dispatches += 1
            self._occupancy_sum += len(live) / self.batch
            self.peak_resident_tokens = max(
                self.peak_resident_tokens,
                sum(self._slots[i].length + chunks[i] + (i in decoding)
                    for i in live))

            for i in live:
                slot = self._slots[i]
                if chunks[i]:
                    slot.pos += chunks[i]
                    slot.length += chunks[i]
                    if slot.pos == len(slot.req.prompt):
                        # final chunk: this row's logits are its first token
                        tok = (int(next_np[i]) if sample is None
                               else int(sample(logits_np[i])))
                        self._emit(i, tok, completed, first=True)
                elif i in decoding:
                    slot.length += 1
                    tok = (int(next_np[i]) if sample is None
                           else int(sample(logits_np[i])))
                    self._emit(i, tok, completed, first=False)
            if self.audit_every and self.steps % self.audit_every == 0:
                self.audit()
        in_flight = sum(s.req is not None for s in self._slots)
        truncated = (self.steps - start_steps >= max_steps and
                     bool(in_flight or self._queue))
        return RunResult(completed, truncated=truncated,
                         in_flight=in_flight, queued=len(self._queue))

    # -- metrics ---------------------------------------------------------------

    @property
    def slot_occupancy(self) -> float:
        """Mean fraction of slots live per tick (1.0 = saturated)."""
        return self._occupancy_sum / self.steps if self.steps else 0.0

    @staticmethod
    def summarize(reqs: list[Request]) -> dict[str, float]:
        if not reqs:
            return {}
        ttft = [r.first_token_at - r.submitted_at for r in reqs
                if r.first_token_at is not None]
        tps = [(len(r.output) - 1) /
               max(r.finished_at - r.first_token_at, 1e-9)
               for r in reqs
               if r.finished_at and r.first_token_at and len(r.output) > 1]
        itl = [dt for r in reqs for dt in np.diff(r.token_times).tolist()]
        out = {"n": len(reqs),
               "total_tokens": float(sum(len(r.output) for r in reqs)),
               "completed": sum(r.done for r in reqs)}
        if ttft:
            out["mean_ttft_s"] = float(np.mean(ttft))
            out["ttft_p50_s"] = float(np.percentile(ttft, 50))
            out["ttft_p99_s"] = float(np.percentile(ttft, 99))
        if tps:
            out["mean_tokens_per_s"] = float(np.mean(tps))
        if itl:
            out["itl_p50_s"] = float(np.percentile(itl, 50))
            out["itl_p99_s"] = float(np.percentile(itl, 99))
        return out


def reference_decode(cfg, params: Any, prompt: np.ndarray,
                     max_new_tokens: int, *, max_len: int = 512,
                     eos_id: int | None = None, device="cuda") -> list[int]:
    """Per-request batch-1 greedy decode — the exact numerics oracle.

    Teacher-forces the prompt through ``api.decode_step`` one token at a
    time (true positions and lengths), then decodes greedily.  A paged or
    int8 configuration runs through its own batch-1 cache (paged: a pool
    under the default linear page table).  The engine must match it token
    for token."""
    if len(prompt) > max_len:
        raise ValueError(f"prompt length {len(prompt)} exceeds {max_len}")
    dev = torch.device(device)
    cache = api.init_cache(cfg, 1, max_len, dev)
    logits = None
    n_cached = 0
    for t in np.asarray(prompt).tolist():
        n_cached += 1
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[t]], device=dev),
            torch.tensor([n_cached], dtype=torch.int32, device=dev))
    out = [int(torch.argmax(logits[0]))]
    while (len(out) < max_new_tokens and n_cached < max_len and
           (eos_id is None or out[-1] != eos_id)):
        n_cached += 1
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[out[-1]]], device=dev),
            torch.tensor([n_cached], dtype=torch.int32, device=dev))
        out.append(int(torch.argmax(logits[0])))
    return out
