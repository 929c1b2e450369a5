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
  (``cache_compiles``); ``("insert", B)`` is the admission copy and
  ``("cow", 0)`` prefix sharing's block copy.  Misses are bounded by
  ``compile_budget`` = chunk buckets + 2 (+ 1 when sharing), whatever the
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
* **Speculative decoding (``spec_k > 0``).**  A prompt-lookup drafter
  (``serving/draft.py``) proposes up to K continuation tokens per decode
  row from the row's own history; the row rides the SAME ``("mixed", W)``
  dispatch as a ``1 + len(draft)``-token chunk, and the speculating
  engine's mixed executable (``_mixed_executable_spec``) runs
  ``mixed_step(all_logits=True)`` and returns every position's greedy
  token (B, W), the only copy back of the tick.  Acceptance is the longest
  draft prefix equal to the model's greedy tokens; the row emits ``a + 1``
  tokens and ``_rewind_slot`` rolls the rejected tail back on the host
  (its K/V hides past the row's length; paged, wholly dead tail blocks go
  back to the pool and into the row's reservation).  Outputs stay the
  oracle's token for token.  Chunk buckets go down to 4 so a verify tick
  is narrow; a slot whose drafts keep missing backs off exponentially.
  Families that cannot rewind (``api.supports_speculation``: the xLSTM)
  fall back to plain decode, and a ``sample`` hook disables drafting.
* **Prefix sharing (``prefix_cache=True``, paged transformer families).**
  A ``RadixPrefixCache`` maps block-aligned prompt prefixes to the blocks
  holding their K/V.  Admission of a prompt that walks a cached path maps
  the shared blocks into its page table (one reference each) and streams
  only the suffix; when the suffix starts mid-block, a fresh block is
  leased and the cached one copied into it on the device (the ``("cow",
  0)`` key: one captured graph whose block ids are device inputs) before
  the chunk writer overwrites its tail.  A finished prompt donates its
  full blocks to the cache; under pool pressure admission evicts cold
  cache leaves LRU-first (only blocks the cache alone holds).  Sharing is
  exact because ``mixed_step`` is bitwise sequential decode.
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
* **The audio family** (Whisper): a request brings its frames (F, d).
  Admission runs the ``("admit", F)`` executable (on the card one captured
  graph: the encoder and every decoder layer's cross K/V, from a static
  frames input into a static batch-1 row, staged through a pinned buffer
  like a tick's inputs; its warm-up writes only that row), then the
  ``("insert", B)`` copy of the row into the slot, so a reused slot never
  attends the previous request's audio; nothing is read back.  Every
  request's F is the config's ``encoder_frames``, so there is one admit
  key, and ``compile_budget`` counts it.  Mixed ticks step the chunk one position at a time, as the
  xLSTM's; speculation works, prefix sharing falls back (a block's K/V
  depends on the request's audio).  Durable serving of audio (frames in
  the snapshot and journal) is a later slice: an audio engine with a
  ``snapshot_dir`` raises ``NotImplementedError``.

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
* **Sharing.**  Blocks are refcounted; a prefix hit's shared blocks
  shrink the request's reservation, and the copy-on-write block leases
  inside it.
* ``pool_stats``, ``peak_resident_tokens`` and ``audit`` (every
  ``audit_every`` ticks) expose and check these invariants; ``audit``
  also counts every block a slot or the radix cache holds against the
  allocator's refcounts.

Resilience (the reference's lifecycle, preemption and quarantine, all on
the host; the compile keys do not change):

* **Lifecycle.**  A request walks ``queued -> running -> {done, error,
  cancelled, deadline_missed}`` (``TERMINAL_STATES``); preemption loops a
  running request back to ``queued``.  ``_terminal`` is the one exit:
  it stamps ``finished_at`` from the engine's ``clock`` (injectable, as
  every timestamp) and frees the rid.  ``cancel(rid)`` retires a request
  wherever it is, a ``sample`` hook's own row included; ``deadline_s``
  requests are swept at the top of every tick (``enforce_deadlines``).
* **Bounded preemption (``max_preemptions > 0``).**  A queue head whose
  reservation falls short after LRU eviction preempts the lowest-priority,
  youngest running row that does not outrank it, and a head that outranks
  a running row preempts it when the batch is full.  ``_fold_slot``
  donates the victim's full blocks (prompt and accepted output) to the
  radix cache when sharing, and folds its output into its prompt; it
  requeues behind the head and re-admits through the ordinary chunk path
  (a hit on its own blocks copies on write through ``("cow", 0)``; the
  xLSTM re-admits through its ``("insert", B)`` fresh row).  A request at
  its bound is immune, so progress is guaranteed.
* **Quarantine (``check_finite``).**  Every tick executable also reduces
  each row's logits (the last live position's) to their least and
  greatest value (``torch.aminmax``: NaN propagates into both, an
  infinity into one), inside the same captured graph, packed into the one
  int64 tensor that carries the token ids back (``_pack_tick``).  A row
  whose two are not both finite, or whose ``sample`` hook raises, ends
  ``status="error"`` alone: its slot and blocks are freed and never
  donated to the radix cache.  ``serving/chaos.py``'s faults (reservation
  denials, forced preemptions, NaN rows, garbage drafts) act at the
  reference's seams and draw from its generator in the reference's order;
  a chaos NaN row clears the row's flag on the host (and, for a hook, its
  host logits).

One card means one block home: the reference's per-home reservation split
is the total check here.  A rid already queued or running is refused at
``submit``.

Durability (``snapshot_dir=``, ``serving/snapshot.py``): an edge device
loses power and has its process killed as a matter of course, so serving
state persists.  Atomic point-in-time snapshots hold the device cache
(bitwise) and the whole host control plane (slots, page tables, allocator
refcounts, radix cache, each live request's lifecycle fields with its
deadline as REMAINING budget, drafter histories, counters, compile keys);
a write-ahead journal of submit / emit / terminal events is fsync'd once a
tick.  ``Engine.restore(dir, params)`` captures its graphs (the saved
keys; on the card the rest of the key set too), loads the latest
complete snapshot IN PLACE into the tensors those graphs read,
replays the journal (output grown past the snapshot folds into its prompt
through ``_fold_slot``) and resumes with streams BITWISE equal to the
never-killed engine's.  An emitted token is never lost and never
journaled twice; a snapshot cut short is never seen.  Without
``snapshot_dir`` the engine opens no file and does no fsync.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compiler import CompileCache, TokenBuckets
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.models.attention import (
    check_supported, paged_blocks_for, paged_geometry, paged_pool_blocks)
from repro_torch.serving.draft import make_drafter
from repro_torch.serving.prefix import BlockAllocator, RadixPrefixCache


@dataclasses.dataclass
class _PrefixPlan:
    """Host-side admission plan from a radix-cache hit: ``shared`` blocks
    map read-only into the slot's page table (one incref each); ``cow`` is
    the cached block whose matched head is reused through copy-on-write
    (None when the suffix starts block-aligned); ``consumed`` prompt tokens
    are covered without recompute, always < len(prompt), so the last
    prompt token runs and gives the first token's logits."""
    shared: list[int]
    cow: int | None
    consumed: int


# request lifecycle: queued -> running -> one terminal state (preemption
# loops running back to queued; ``done`` is True exactly on terminals)
TERMINAL_STATES = ("done", "error", "cancelled", "deadline_missed")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 32
    frames: np.ndarray | None = None  # (F, d) audio family only
    priority: int = 0                # higher = admitted/kept first
    deadline_s: float | None = None  # seconds after submit; None = none
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "queued"           # queued|running|done|error|cancelled|
    #                                  deadline_missed
    error: str | None = None         # quarantine reason when status=="error"
    preemptions: int = 0             # times evicted and requeued (bounded)
    folded: int = 0                  # output tokens already folded into the
    #                                  prompt by earlier preemptions
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None
    token_times: list = dataclasses.field(default_factory=list)


class RunResult(list):
    """``Engine.run``'s return value: the requests that reached a terminal
    state during the call, plus ``truncated`` (``max_steps`` ran out with
    work left), ``stalled`` (work queued, nothing admissible and no row
    live) and the ``in_flight`` / ``queued`` counts at return."""

    def __init__(self, reqs=(), *, truncated: bool = False,
                 in_flight: int = 0, queued: int = 0, stalled: bool = False):
        super().__init__(reqs)
        self.truncated = truncated
        self.in_flight = in_flight
        self.queued = queued
        self.stalled = stalled

    @property
    def drained(self) -> bool:
        return not (self.truncated or self.stalled or
                    self.in_flight or self.queued)


@dataclasses.dataclass
class _Slot:
    """Host-side mirror of one row of the resident cache."""
    req: Request | None = None
    length: int = 0                  # TRUE tokens resident in this row
    pos: int = 0                     # prompt tokens consumed (chunk cursor)
    last_token: int = 0              # input token for the next decode step
    seq: int = 0                     # admission order (preemption picks the
    #                                  youngest = largest seq first)

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.pos < len(self.req.prompt)


def _pack_tick(logits, last):
    """The greedy ids of ``logits`` (argmax over its last axis) and each
    row's least and greatest logit of ``last`` (B, V), in ONE int64 tensor,
    so that one copy brings both to the host: the ids first, then the
    minima and the maxima in ``last``'s dtype.  Two reductions write
    straight into it (no copy); ``torch.aminmax`` propagates NaN into
    both, so a row is finite exactly when its two are."""
    lead = logits.shape[:-1]
    n, b = math.prod(lead), last.shape[0]
    out = torch.empty(n + -(-2 * b * last.element_size() // 8),
                      dtype=torch.int64, device=last.device)
    torch.argmax(logits, dim=-1, out=out[:n].view(lead))
    span = out[n:].view(last.dtype)
    torch.aminmax(last, dim=-1, out=(span[:b], span[b:2 * b]))
    return out


_HOST_FLOAT = {torch.float32: np.float32, torch.float16: np.float16}


def _unpack_tick(host: np.ndarray, rows: int, dtype):
    """``_pack_tick``'s tensor, on the host: (ids, finite), the ids flat
    (B or B * W) and ``finite[b]`` True when row b's logits are."""
    nbytes = 2 * rows * dtype.itemsize
    n = host.size - -(-nbytes // 8)
    raw = host[n:].view(np.uint8)[:nbytes]
    if dtype == torch.bfloat16:     # numpy has no bf16: widen the bits
        vals = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    else:
        vals = raw.view(_HOST_FLOAT[dtype])
    finite = np.isfinite(vals[:rows]) & np.isfinite(vals[rows:])
    return host[:n], finite


def _mixed_executable(cfg):
    # page_table: the paged layout's operand, absent for the slot cache
    def fn(p, c, tokens, lengths, q_lens, page_table=None):
        logits, _ = api.mixed_step(cfg, p, c, tokens, lengths, q_lens,
                                   page_table=page_table)
        return _pack_tick(logits, logits), logits
    return fn


# adaptive speculation: a slot whose drafts keep fully rejecting sits out
# 1, 2, 4, ... up to this many ticks before drafting again
_DRAFT_BACKOFF_MAX = 8


def _mixed_executable_spec(cfg):
    """The speculating engine's mixed tick (all of its mixed ticks, so the
    keys stay ``("mixed", W)``): ``all_logits=True`` scores every chunk
    position; returns the per-position greedy tokens (B, W), for draft
    acceptance and, at ``q_lens - 1``, each row's next token, with the
    finiteness of the last live position's logits (B, V), which it also
    returns for a ``sample`` hook."""
    def fn(p, c, tokens, lengths, q_lens, page_table=None):
        logits, _ = api.mixed_step(cfg, p, c, tokens, lengths, q_lens,
                                   page_table=page_table, all_logits=True)
        idx = torch.clamp(q_lens.long() - 1, 0, tokens.shape[1] - 1)
        last = torch.gather(logits, 1, idx[:, None, None].expand(
            -1, 1, logits.shape[-1]))[:, 0]
        return _pack_tick(logits, last), last
    return fn


def _decode_executable(cfg):
    # write_mask keeps the rows that do not advance untouched, so a tick
    # with every row dead writes nothing (the warm-up before a capture)
    def fn(p, c, tokens, lengths, write_mask, page_table=None):
        logits, _ = api.decode_step(cfg, p, c, tokens, lengths,
                                    page_table=page_table,
                                    write_mask=write_mask)
        return _pack_tick(logits, logits), logits
    return fn


def _insert_executable(cfg):
    def fn(c, row, slot):
        return api.insert_request(cfg, c, row, slot)
    return fn


def _admit_executable(cfg):
    # the encoder and every layer's cross K/V written into ``c``, the
    # engine's static batch-1 row of this frame count (never a live cache)
    def fn(p, c, frames):
        api.admit_into(cfg, p, c, {"frames": frames})
        return ()
    return fn


def _cow_executable(cfg):
    # one function for every copy-on-write: block ids are device tensors
    def fn(p, c, src, dst):
        api.copy_pool_block(cfg, c, src, dst)
        return ()
    return fn


class _EagerTick:
    """A key's executable run eagerly (the CPU): host arrays in, device
    tensors out (``(_pack_tick(...), logits)`` for a tick), the cache
    updated in place."""

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
    values: a dispatch with every row dead, or a copy of the null block
    onto itself).  Before the capture the graph's function runs once on
    those dead inputs (lazy initialisation stays out of the graph; no live
    cache leaf changes).  A replay stages its host arrays in pinned
    buffers from PyTorch's caching host allocator, which recycles a buffer
    only after its copy to the device has run, so replays may follow each
    other without a host wait (two copy-on-writes in one admission pass).
    The capture records each kernel wrapper's launch; that count
    (``launches``) is added to ``_build.launches`` on every replay instead,
    so the counts read as if every tick had run eagerly (the warm-up serves
    no tick and is not counted).  The graph belongs to the params and cache
    it was captured with."""

    def __init__(self, fn, params, cache, inputs: dict, pool):
        self.fn, self.params, self.cache = fn, params, cache
        self.inputs = inputs
        before = collections.Counter(_build.launches)
        side = torch.cuda.Stream(next(iter(inputs.values())).device)
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
            staged = torch.empty(self.inputs[k].shape,
                                 dtype=self.inputs[k].dtype, pin_memory=True)
            staged.numpy()[...] = a
            self.inputs[k].copy_(staged, non_blocking=True)
        self.graph.replay()
        _build.launches.update(self.launches)
        return self.outputs


class Engine:
    """Continuous-batching engine: one mixed-batch dispatch per tick."""

    def __init__(self, cfg, params: Any, *, batch_size: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 chunk_size: int = 64,
                 prefill_token_budget: int | None = None,
                 prefill_policy: str = "mixed",
                 spec_k: int = 0, drafter: Any = "plookup",
                 prefix_cache: bool = False,
                 max_preemptions: int = 0,
                 enforce_deadlines: bool = True,
                 check_finite: bool = True,
                 audit_every: int = 0,
                 chaos: Any = None,
                 compile_cache: CompileCache | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 snapshot_dir: str | None = None,
                 snapshot_every: int = 0,
                 snapshot_keep: int = 2,
                 journal: bool = True,
                 device="cuda"):
        if prefill_policy not in ("mixed", "stall"):
            raise ValueError(f"unknown prefill_policy {prefill_policy!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if max_preemptions < 0:
            raise ValueError(
                f"max_preemptions must be >= 0, got {max_preemptions}")
        self.device = torch.device(device)
        check_supported(cfg, self.device)
        if cfg.family == "audio" and snapshot_dir is not None:
            raise NotImplementedError(
                "durable serving of the audio family (frames in the snapshot "
                "and journal, the admit key at restore) comes in a later "
                "slice of the port: no snapshot_dir for an audio engine")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        # >= 2 so a mixed tick never takes mixed_step's C == 1 delegation
        self.chunk_size = max(2, min(chunk_size, max_len))
        self.prefill_token_budget = prefill_token_budget
        self.prefill_policy = prefill_policy
        # drafts ride the mixed dispatch as K+1-token chunks, so K is capped
        # by the chunk width; a family that cannot rewind falls back to
        # plain decode (spec_requested / spec_supported record the gate)
        self.spec_requested = spec_k
        self.spec_supported = api.supports_speculation(cfg)
        self.spec_k = (min(spec_k, self.chunk_size - 1)
                       if spec_k and self.spec_supported else 0)
        # a speculating engine keeps finer buckets: a verify tick is only
        # K+1 wide (compile_budget counts all_buckets())
        self.chunk_buckets = TokenBuckets(
            max_tokens=self.chunk_size,
            min_bucket=min(4 if self.spec_k else 16, self.chunk_size))
        self.drafter = ((make_drafter(drafter) if isinstance(drafter, str)
                         else drafter) if self.spec_k else None)
        self.spec_ticks = 0        # dispatches carrying >= 1 verify row
        self.spec_rows = 0         # verify rows dispatched
        self.spec_drafted = 0      # draft tokens scored
        self.spec_accepted = 0     # draft tokens accepted
        self.spec_rewinds = 0      # partial/full rejections rolled back
        self._draft_wait = [0] * batch_size      # ticks left to sit out
        self._draft_penalty = [0] * batch_size   # current backoff length
        # `is not None`, not `or`: an EMPTY CompileCache is falsy (__len__).
        # On the card an entry is a graph bound to this engine's params and
        # cache, so a cache shared with another engine fails at its replay;
        # on the CPU a shared cache serves engines of the same (cfg,
        # max_len, batch, chunk_size, spec on/off), as in the reference
        self.cache_compiles = (compile_cache if compile_cache is not None
                               else CompileCache())
        self.capture_seconds: dict[tuple, float] = {}   # key -> capture
        self._graph_pool = None
        self._queue: "collections.deque[Request]" = collections.deque()
        self.cache = api.init_cache(cfg, batch_size, max_len, self.device)
        self._slots = [_Slot() for _ in range(batch_size)]
        self.paged = api.has_paged_kv(cfg)
        # the pristine row an admission copies into its slot; the audio
        # family's comes from its ("admit", F) executable, into one static
        # batch-1 row (a paged row's pool is a stub: inserts skip it)
        self._audio = cfg.family == "audio"
        self._fresh_row = (api.request_cache(cfg, params, {}, max_len,
                                             self.device)
                           if api.needs_admission_insert(cfg)
                           and not self._audio else None)
        self._admit_row = (api.init_cache(
            dataclasses.replace(cfg, kv_pool_blocks=1) if self.paged else cfg,
            1, max_len, self.device) if self._audio else None)
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
        # prefix sharing: paged transformer families only (a recurrent
        # state has no per-token block chain)
        self.prefix_requested = prefix_cache
        self.prefix_sharing = bool(prefix_cache and self.paged and
                                   api.supports_prefix_cache(cfg))
        self.prefix = (RadixPrefixCache(self.block_size)
                       if self.prefix_sharing else None)
        self.prefix_hits = 0         # admissions that reused >= 1 block
        self.prefix_hit_tokens = 0   # prompt tokens covered without recompute
        self.cow_copies = 0          # copy-on-write block duplications
        self.prefix_evictions = 0    # cache leaves dropped under pool pressure
        self.peak_pool_blocks = 0    # high-water physical blocks in use
        self._live_rids: set = set()  # queued + running rids (duplicate gate)
        self.admission_stalls = 0    # admissions held back by the block pool
        self.peak_resident_tokens = 0
        self.steps = 0
        self.dispatches = 0          # must equal steps: one dispatch per tick
        self.mixed_ticks = 0
        self.dispatched_columns = 0  # chunk width of each tick, summed
        self._occupancy_sum = 0.0
        # resilience: max_preemptions bounds how often ONE request may be
        # evicted and requeued (0: stall-only admission); enforce_deadlines
        # sweeps deadline_s requests every tick; check_finite quarantines a
        # row whose logits are not finite; audit_every=N self-checks the
        # pool every N ticks; chaos (serving/chaos.py's ChaosMonkey)
        # injects faults at these seams
        self.max_preemptions = max_preemptions
        self.enforce_deadlines = enforce_deadlines
        self.check_finite = check_finite
        self.audit_every = audit_every
        self.chaos = chaos
        self.clock = clock
        self.preemptions = 0         # total preempt-and-requeue events
        self.deadline_misses = 0     # requests retired past their deadline
        self.row_faults = 0          # rows quarantined (non-finite / hook)
        self.cancels = 0             # cancel() calls that found their target
        self.audits = 0              # audit() passes run (all green)
        self._admit_seq = 0          # admission counter (a slot's age)
        # durability: snapshots every snapshot_every ticks (0: the baseline
        # one only) under snapshot_dir, the newest snapshot_keep kept, and a
        # journal (journal=False: snapshots alone)
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.snapshot_keep = snapshot_keep
        self.journal_enabled = journal
        self.snapshots_taken = 0
        # terminal events replayed from the journal at restore (requests
        # that finished after the last snapshot in the killed process,
        # whose request objects are gone)
        self.restored_terminal: list[Request] = []
        self._journal: Any = None
        self._snap_epoch = -1
        # what durability costs: per snapshot its bytes and seconds, the
        # journal's fsyncs, the phases of the restore that built this engine
        self.snapshot_log: list[dict] = []
        self.journal_commits = 0
        self.journal_fsync_s = 0.0
        self.restore_seconds: dict[str, float] = {}
        if snapshot_dir is not None:
            # the baseline snapshot: restore always has a complete one to
            # start from, and its epoch's journal records what follows
            from repro_torch.serving import snapshot as _snaplib
            _snaplib.attach(self, snapshot_dir)

    # -- client API ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if self._audio:
            want = (self.cfg.encoder_frames, self.cfg.d_model)
            got = None if req.frames is None else np.shape(req.frames)
            if got != want:
                raise ValueError(f"request {req.rid}: the audio family takes "
                                 f"frames of shape {want}, got {got}")
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
        if req.rid in self._live_rids:
            raise ValueError(
                f"request {req.rid}: rid already queued or in flight — "
                "rids must be unique among live requests")
        req.status = "queued"
        self._live_rids.add(req.rid)
        req.submitted_at = self.clock()
        self._queue.append(req)
        if self._journal is not None:
            self._journal.append({
                "ev": "submit", "rid": req.rid,
                "prompt": np.asarray(req.prompt).tolist(),
                "max_new": req.max_new_tokens, "priority": req.priority,
                "deadline": req.deadline_s, "frames": None})
            # durable at once: a submit outside run() must survive a kill
            # before the next tick's fsync
            self._commit()

    def cancel(self, rid: int) -> bool:
        """Retire request ``rid`` wherever it is: dequeued if waiting, or
        freed mid-flight (slot and blocks released, the partial output
        kept).  Its status becomes ``"cancelled"`` and it is retired HERE,
        not echoed through a later ``run()`` result.  False when no live
        request has that rid (cancel is idempotent)."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                self.cancels += 1
                self._terminal(r, "cancelled")
                self._commit()
                return True
        for i, s in enumerate(self._slots):
            if s.req is not None and s.req.rid == rid:
                self.cancels += 1
                self._terminal(s.req, "cancelled")
                self._free_slot(i)
                self._commit()
                return True
        return False

    def snapshot(self) -> str:
        """Write a point-in-time snapshot to ``snapshot_dir`` (atomic: a
        temp dir and ``os.replace``) and rotate the journal to a fresh
        epoch.  Returns the snapshot's directory.  ``serving/snapshot.py``
        states the contract."""
        if self.snapshot_dir is None:
            raise RuntimeError("engine has no snapshot_dir")
        from repro_torch.serving import snapshot as _snaplib
        return _snaplib.save(self)

    @classmethod
    def restore(cls, snapshot_dir: str, params: Any,
                **overrides) -> "Engine":
        """Rebuild a process-equivalent engine from the latest complete
        snapshot under ``snapshot_dir``, replaying the journal of what
        happened after it; restored streams are bitwise the never-killed
        engine's.  ``overrides`` replace constructor arguments: a fresh
        ``chaos`` monkey, a ``compile_cache`` (on the card never one of
        another engine: its graphs are bound to that engine's cache), a
        ``clock``, the ``device`` (the card by default)."""
        from repro_torch.serving import snapshot as _snaplib
        return _snaplib.restore_engine(snapshot_dir, params, **overrides)

    def durability_stats(self) -> dict[str, Any]:
        """Snapshot and journal counters (the reference's), with the
        bytes and seconds of each snapshot, the journal's fsync count and
        seconds, and the phases of the restore that built this engine."""
        return {
            "snapshot_dir": self.snapshot_dir,
            "snapshot_every": self.snapshot_every,
            "snapshots_taken": self.snapshots_taken,
            "epoch": self._snap_epoch,
            "journal": self._journal is not None,
            "restored_terminal": len(self.restored_terminal),
            "snapshot_log": list(self.snapshot_log),
            "journal_commits": self.journal_commits,
            "journal_fsync_s": self.journal_fsync_s,
            "restore_seconds": dict(self.restore_seconds),
        }

    def _commit(self) -> None:
        """The journal's durability point (flush + fsync), timed; nothing
        without a journal."""
        if self._journal is None:
            return
        t0 = time.perf_counter()
        self._journal.commit()
        self.journal_fsync_s += time.perf_counter() - t0
        self.journal_commits += 1

    # -- paged-KV block accounting -------------------------------------------

    def _worst_case_blocks(self, req: Request) -> int:
        """Blocks the request can ever hold: its prompt plus its REMAINING
        generation (a preempted request's output is folded into its prompt,
        so ``max_new_tokens - len(output)`` are owed, at least one), capped
        by the cache's addressable span (the ``_emit`` stop rules)."""
        owed = max(req.max_new_tokens - len(req.output), 1)
        toks = min(len(req.prompt) + owed, self.max_len)
        return -(-toks // self.block_size)

    def _prefix_plan(self, req: Request) -> _PrefixPlan | None:
        """Match the prompt against the radix cache and plan the admission.
        ``consumed`` stops at ``len(prompt) - 1``: the last prompt token
        runs through a chunk to give the first token's logits.  When the
        cache covers the WHOLE prompt, the last matched block is demoted
        from shared to copy-on-write source so that token has a writable
        page."""
        if self.prefix is None or len(req.prompt) < 2:
            return None
        full, partial = self.prefix.match(req.prompt)
        consumed = len(full) * self.block_size
        cow = None
        if partial is not None:
            blk, n = partial
            n = min(n, len(req.prompt) - 1 - consumed)
            if n > 0:
                cow = blk
                consumed += n
        elif consumed >= len(req.prompt):
            cow = full.pop()
            consumed = len(req.prompt) - 1
        if not full and cow is None:
            return None
        return _PrefixPlan(shared=full, cow=cow, consumed=consumed)

    def _evict_for(self, n: int, plan: _PrefixPlan | None) -> int:
        """Free up to ``n`` blocks by dropping cold radix-cache leaves,
        LRU-first.  Only blocks the cache alone holds free: shared ones
        (refcount >= 2) and the plan's blocks are skipped, so eviction never
        invalidates a live mapping or the admission just planned.  Returns
        the blocks freed."""
        protect = set()
        if plan is not None:
            protect.update(plan.shared)
            if plan.cow is not None:
                protect.add(plan.cow)
        freed = 0
        while freed < n:
            blk = self.prefix.evict_lru(
                keep=lambda b: b in protect or self.alloc.ref(b) > 1)
            if blk is None:
                break                       # nothing evictable left
            self.prefix_evictions += 1
            if not self.alloc.decref(blk):  # cache was sole holder: frees
                raise RuntimeError(
                    f"evicted cache block {blk} still live — keep() gate "
                    "is wrong")
            freed += 1
        return freed

    def _can_reserve(self, req: Request,
                     plan: _PrefixPlan | None = None) -> bool:
        """Admission gate: the free blocks nobody has reserved yet must
        cover the request's worst case, less a prefix hit's shared blocks
        (the copy-on-write block leases inside the reservation).  On a
        shortfall, cold cache leaves are evicted one at a time until it
        closes or nothing is evictable."""
        need = self._worst_case_blocks(req)
        if plan is not None:
            need -= len(plan.shared)
        while self.alloc.n_free - sum(self._slot_reserve) < need:
            if self.prefix is None or self._evict_for(1, plan) == 0:
                return False
        return True

    def _admit_head(self, idx: int) -> bool:
        """Admit the queue head into free slot ``idx``.  On a paged
        reservation shortfall (after ``_can_reserve``'s LRU eviction),
        preempt victims one at a time (lowest priority, youngest, never
        outranking the head), planning again after each, until the head
        fits; with no victim left, count an admission stall.  A chaos
        denial is a shortfall with no victim."""
        head = self._queue[0]
        plan = self._prefix_plan(head)
        if self.paged:
            if self.chaos is not None and self.chaos.deny_reservation():
                self.admission_stalls += 1
                return False
            while not self._can_reserve(head, plan):
                v = self._pick_victim(head.priority, strict=False)
                if v is None:
                    self.admission_stalls += 1
                    return False
                self._preempt(v)
                plan = self._prefix_plan(head)
        self._admit(self._queue.popleft(), idx, plan)
        return True

    def _admit(self, req: Request, idx: int,
               plan: _PrefixPlan | None) -> None:
        """Lease slot ``idx`` to ``req`` (no dispatch: the prompt streams
        through the next mixed ticks).  Recurrent families copy a fresh row
        into the slot first.  A prefix ``plan`` maps the shared blocks into
        the page table (one incref each), copies the one partial block on
        write, and starts the chunk cursor at the first uncovered token."""
        if self.paged:
            shared = list(plan.shared) if plan is not None else []
            self._slot_reserve[idx] = (self._worst_case_blocks(req)
                                       - len(shared))
            for page, blk in enumerate(shared):
                self.alloc.incref(blk)
                self._page_table[idx, page] = blk
            self._slot_blocks[idx] = shared
        row = self._fresh_row
        if self._audio:
            row = self._admit_row
            admit = self._entry("admit", self.cfg.encoder_frames)
            admit(self.params, row,
                  frames=np.asarray(req.frames, np.float32)[None])
        if row is not None:
            insert = self._entry("insert", self.batch)
            self.cache = insert(self.cache, row, idx)
        self._admit_seq += 1
        req.status = "running"
        self._slots[idx] = _Slot(req=req, seq=self._admit_seq)
        if plan is not None:
            if plan.cow is not None:
                self._cow_block(idx, plan.cow)
            s = self._slots[idx]
            s.length = s.pos = plan.consumed
            self.prefix_hits += 1
            self.prefix_hit_tokens += plan.consumed
        self._draft_wait[idx] = self._draft_penalty[idx] = 0
        if self.drafter is not None:
            # prompt lookup proper: drafts may copy prompt spans before the
            # prompt has streamed through the cache (acceptance keeps it
            # lossless)
            self.drafter.reset(idx)
            self.drafter.observe(idx, req.prompt)

    def _lease_one(self, idx: int) -> int:
        """Lease one block against slot ``idx``'s reservation."""
        if self._slot_reserve[idx] <= 0:
            raise RuntimeError(
                f"slot {idx} leased past its reservation — worst-case "
                "accounting is wrong")
        self._slot_reserve[idx] -= 1
        return self.alloc.lease()

    def _lease_to(self, idx: int, new_len: int) -> None:
        """Grow slot ``idx`` to cover ``new_len`` tokens, leasing blocks as
        the length crosses page boundaries, against its reservation."""
        owned = self._slot_blocks[idx]
        while len(owned) < -(-new_len // self.block_size):
            blk = self._lease_one(idx)
            self._page_table[idx, len(owned)] = blk
            owned.append(blk)

    def _cow_block(self, idx: int, src: int) -> None:
        """Copy-on-write: lease a private block for slot ``idx``'s next page
        and copy shared block ``src`` into it on the device (the ``("cow",
        0)`` executable).  The copy's matched head is live; its tail sits
        past the slot's length until the chunk writer overwrites it."""
        dst = self._lease_one(idx)
        self._page_table[idx, len(self._slot_blocks[idx])] = dst
        self._slot_blocks[idx].append(dst)
        fn = self._entry("cow", 0)
        fn(self.params, self.cache, src=np.array([src], np.int64),
           dst=np.array([dst], np.int64))
        self.cow_copies += 1

    def _cache_prompt(self, idx: int) -> None:
        """Prefill just finished for slot ``idx``: donate the prompt's fully
        written blocks to the radix cache, which holds ONE reference per
        node it newly created (a duplicate prompt keeps the first author's
        block; the duplicate stays private)."""
        prompt = self._slots[idx].req.prompt
        nfull = len(prompt) // self.block_size
        if nfull == 0:
            return
        fresh = self.prefix.insert(
            np.asarray(prompt)[:nfull * self.block_size],
            self._slot_blocks[idx][:nfull])
        for blk in fresh:
            self.alloc.incref(blk)

    def pool_stats(self) -> dict[str, int]:
        """Free-list invariants, exposed for leak/double-free checks:
        ``free + leased == total`` always (``leased`` counts live blocks, so
        a block mapped by three slots and the cache is one block)."""
        return {
            "total": self.pool_blocks,
            "free": self.alloc.n_free,
            "leased": self.alloc.n_live,
            "n_homes": self.alloc.n_homes,
            "reserved_outstanding": sum(self._slot_reserve),
            "shared_blocks": self.alloc.n_shared(),
            "cached_blocks": (len(self.prefix)
                              if self.prefix is not None else 0),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
        }

    def prefix_stats(self) -> dict[str, int]:
        """Prefix-cache counters (a subset of ``pool_stats`` plus the
        gate)."""
        return {
            "enabled": self.prefix_sharing,
            "requested": self.prefix_requested,
            "hits": self.prefix_hits,
            "hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "evictions": self.prefix_evictions,
            "cached_blocks": (len(self.prefix)
                              if self.prefix is not None else 0),
            "shared_blocks": self.alloc.n_shared() if self.paged else 0,
        }

    def drop_prefix_cache(self) -> int:
        """Flush the radix cache, dropping every cache-held block reference
        (so a drained engine's pool is whole again).  Returns the nodes
        dropped."""
        if self.prefix is None:
            return 0
        blocks = self.prefix.clear()
        for blk in blocks:
            self.alloc.decref(blk)
        return len(blocks)

    def audit(self) -> None:
        """One-shot invariant audit (``audit_every`` runs it each N ticks).
        Raises AssertionError on the first violation: the allocator's
        partition, deadlock freedom (``sum(reserve) <= free``), page-table
        rows mirroring exactly the blocks each slot owns with a null tail,
        dead slots owning nothing, every block's refcount equal to the
        slots and the radix cache that hold it, and no slot past
        ``max_len``."""
        self.audits += 1
        if self.paged:
            self.alloc.check()
            reserved = sum(self._slot_reserve)
            assert reserved <= self.alloc.n_free, (
                f"reservation invariant broken: {reserved} reserved > "
                f"{self.alloc.n_free} free")
            holders = collections.Counter(
                self.prefix.blocks() if self.prefix is not None else ())
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
                holders.update(owned)
            for blk in range(self.pool_blocks):
                assert self.alloc.ref(blk) == holders[blk], (
                    f"block {blk}: refcount {self.alloc.ref(blk)} but "
                    f"{holders[blk]} holders (slots and the radix cache)")
        for i, s in enumerate(self._slots):
            if s.req is not None:
                assert s.length <= self.max_len, f"slot {i} overran max_len"
                assert s.req.rid in self._live_rids, (
                    f"running rid {s.req.rid} untracked")

    def resilience_stats(self) -> dict[str, Any]:
        """Lifecycle and fault counters (with the chaos monkey's injection
        counts when one is attached)."""
        out: dict[str, Any] = {
            "preemptions": self.preemptions,
            "max_preemptions": self.max_preemptions,
            "deadline_misses": self.deadline_misses,
            "row_faults": self.row_faults,
            "cancels": self.cancels,
            "audits": self.audits,
            "enforce_deadlines": self.enforce_deadlines,
            "check_finite": self.check_finite,
        }
        if self.chaos is not None:
            out["chaos"] = self.chaos.stats()
        return out

    @property
    def compile_budget(self) -> int:
        """Upper bound on compile-cache misses (captured graphs and the
        insert entry) this engine can cause: n_chunk_buckets (mixed
        widths) + decode + insert, + the ``("cow", 0)`` copy when
        sharing, + the audio family's one ``("admit", F)`` encoder."""
        return (len(self.chunk_buckets.all_buckets()) + 2 +
                (1 if self._audio else 0) +
                (1 if self.prefix_sharing else 0))

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

    def _entry(self, name: str, bucket: int):
        """The memoized entry of any key: ``("mixed", W)``, ``("decode",
        B)``, ``("insert", B)``, ``("cow", 0)`` or ``("admit", F)`` (a
        restore builds the saved keys through it)."""
        if name == "insert":
            return self.cache_compiles.get(
                "insert", bucket, lambda: _insert_executable(self.cfg))
        if name in ("cow", "admit"):
            return self.cache_compiles.get(
                name, bucket, lambda: self._build_tick(name, bucket, None))
        if name == "decode":
            if bucket != self.batch:
                raise ValueError(f"decode key ({name!r}, {bucket}) of "
                                 f"another batch than {self.batch}")
            return self._executable(name, None)
        return self._executable(name, bucket)

    def _key_space(self) -> list[tuple[str, int]]:
        """Every key this engine can build (``compile_budget`` bounds
        them): each chunk bucket's mixed tick, the decode tick, and the
        copy-on-write and fresh-row inserts where the engine has them."""
        keys = [("mixed", w) for w in self.chunk_buckets.all_buckets()]
        keys.append(("decode", self.batch))
        if self.prefix_sharing:
            keys.append(("cow", 0))
        if self._fresh_row is not None:
            keys.append(("insert", self.batch))
        return keys

    def _build_tick(self, name: str, bucket: int, width: int | None):
        """On the card the key's function captured as a graph over static
        inputs that write nothing live (a dispatch with every row dead;
        for ``cow`` the null block copied onto itself; for ``admit`` zero
        frames encoded into the static row ``_admit_row``); on the CPU
        the function run eagerly."""
        cache = self.cache
        if name == "cow":
            fn = _cow_executable(self.cfg)
            null = np.array([self._null_block], np.int64)
            dead = {"src": null, "dst": null}
        elif name == "admit":
            fn = _admit_executable(self.cfg)
            cache = self._admit_row
            dead = {"frames": np.zeros((1, bucket, self.cfg.d_model),
                                       np.float32)}
        else:
            fn = (_decode_executable(self.cfg) if name == "decode" else
                  _mixed_executable_spec(self.cfg) if self.spec_k else
                  _mixed_executable(self.cfg))
            dead = self._dead_inputs(width)
        if self.device.type != "cuda":
            return _EagerTick(fn, self.device)
        if self._graph_pool is None:
            _build.prepare()
            self._graph_pool = torch.cuda.graph_pool_handle()
        inputs = {k: torch.from_numpy(a).to(self.device)
                  for k, a in dead.items()}
        tick = _CapturedTick(fn, self.params, cache, inputs,
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
        if self.drafter is not None:
            self.drafter.reset(idx)
        self._slots[idx] = _Slot()

    def _rewind_slot(self, idx: int, new_len: int) -> None:
        """Rollback of rejected draft tokens: shrink slot ``idx``'s length
        to ``new_len``, on the host only (stale K/V past it hides behind
        true-length masking until the next writes land over it).  Paged:
        tail blocks wholly past the new length are re-nulled in the page
        table, dropped (a rewound tail block is private: shared blocks
        cover at most ``len(prompt) - 1`` tokens and speculation rewinds
        only past the prompt) and put back into the slot's reservation,
        which may lease them again."""
        slot = self._slots[idx]
        if new_len > self.max_len:
            raise ValueError(f"rewind to {new_len} exceeds max_len")
        slot.length = new_len
        if self.paged:
            keep = paged_blocks_for(new_len, self.block_size)
            owned = self._slot_blocks[idx]
            while len(owned) > keep:
                blk = owned.pop()
                self._page_table[idx, len(owned)] = self._null_block
                try:
                    self.alloc.decref(blk)
                except RuntimeError as e:
                    raise RuntimeError(f"{e} (rewind slot {idx})") from None
                self._slot_reserve[idx] += 1

    # -- resilience: lifecycle, quarantine, deadlines, preemption -----------

    def _terminal(self, req: Request, status: str,
                  completed: list[Request] | None = None) -> None:
        """Move ``req`` into terminal state ``status``: the one exit of the
        lifecycle, so every path stamps ``finished_at`` and frees the rid
        exactly once."""
        assert status in TERMINAL_STATES, status
        req.status = status
        req.done = True
        req.finished_at = self.clock()
        self._live_rids.discard(req.rid)
        if self._journal is not None:
            self._journal.append({"ev": "terminal", "rid": req.rid,
                                  "status": status, "error": req.error})
        if completed is not None:
            completed.append(req)

    def _fault_row(self, idx: int, msg: str,
                   completed: list[Request]) -> None:
        """Quarantine exactly one row: its request ends ``status="error"``
        (partial output kept, ``error`` says why), its slot and blocks are
        freed through ``_free_slot`` (never donated), and every other row
        of the tick proceeds untouched."""
        req = self._slots[idx].req
        req.error = msg
        self.row_faults += 1
        self._terminal(req, "error", completed)
        self._free_slot(idx)

    def _safe_sample(self, idx: int, sample: Callable,
                     logits_np: np.ndarray,
                     completed: list[Request]) -> int | None:
        """Run the ``sample`` hook for one row, quarantining the row (not
        the tick) if it raises.  None when the row faulted."""
        try:
            return int(sample(logits_np[idx]))
        except Exception as e:  # noqa: BLE001 — hook code is untrusted
            self._fault_row(idx, f"sample hook raised: {e!r}", completed)
            return None

    def _sweep_deadlines(self, completed: list[Request]) -> None:
        """Retire every live request whose deadline has passed, queued or
        mid-flight (slot freed, partial output kept).  ``deadline_s`` runs
        from ``submitted_at``; ``>=`` makes ``deadline_s=0.0`` miss at the
        first sweep."""
        if not self.enforce_deadlines:
            return
        now = self.clock()

        def missed(r: Request) -> bool:
            return (r.deadline_s is not None and
                    now - r.submitted_at >= r.deadline_s)

        for i, s in enumerate(self._slots):
            if s.req is not None and missed(s.req):
                self.deadline_misses += 1
                self._terminal(s.req, "deadline_missed", completed)
                self._free_slot(i)
        if any(missed(r) for r in self._queue):
            keep: collections.deque = collections.deque()
            for r in self._queue:
                if missed(r):
                    self.deadline_misses += 1
                    self._terminal(r, "deadline_missed", completed)
                else:
                    keep.append(r)
            self._queue = keep

    def _pick_victim(self, max_priority: int | None = None, *,
                     strict: bool = False) -> int | None:
        """The slot to preempt: lowest priority first, youngest (largest
        ``seq``) within a priority; a request at its preemption bound is
        immune.  ``strict``: the victim must rank BELOW ``max_priority``
        (priority preemption of a full batch); otherwise it may equal it
        (a shortfall: the head outranks a peer that has had its turn)."""
        best: int | None = None
        best_key: tuple[int, int] | None = None
        for i, s in enumerate(self._slots):
            r = s.req
            if r is None or r.preemptions >= self.max_preemptions:
                continue
            if max_priority is not None:
                if strict and r.priority >= max_priority:
                    continue
                if not strict and r.priority > max_priority:
                    continue
            key = (r.priority, -s.seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _fold_slot(self, idx: int) -> None:
        """The lossless fold preemption rests on: donate the slot's fully
        written blocks to the radix cache (prompt AND accepted output, so
        re-admission is mostly a page-table copy), then fold the output
        not folded yet into the prompt.  The folded stream is bitwise the
        unfolded one: emit-time lengths line up exactly."""
        slot = self._slots[idx]
        req = slot.req
        if self.prefix is not None and slot.length >= self.block_size:
            # the prompt already holds output[:folded]: the resident tokens
            # are the prompt and the output emitted since
            resident = np.concatenate([
                np.asarray(req.prompt, np.int64),
                np.asarray(req.output[req.folded:], np.int64)])[:slot.length]
            nfull = slot.length // self.block_size
            fresh = self.prefix.insert(resident[:nfull * self.block_size],
                                       self._slot_blocks[idx][:nfull])
            for blk in fresh:
                self.alloc.incref(blk)
        if len(req.output) > req.folded:
            req.prompt = np.concatenate([
                np.asarray(req.prompt, np.int64),
                np.asarray(req.output[req.folded:], np.int64)])
            req.folded = len(req.output)

    def _preempt(self, idx: int, *, requeue_front: bool = False) -> None:
        """Evict a running request, keeping its work (``_fold_slot``), and
        requeue it behind the head that evicted it and every waiter that
        outranks it, or at the front for a forced (chaos) preemption or
        an empty queue."""
        req = self._slots[idx].req
        self._fold_slot(idx)
        req.preemptions += 1
        req.status = "queued"
        self.preemptions += 1
        self._free_slot(idx)
        if requeue_front or not self._queue:
            self._queue.appendleft(req)
        else:
            pos = 1
            while (pos < len(self._queue) and
                   self._queue[pos].priority > req.priority):
                pos += 1
            self._queue.insert(pos, req)

    def _schedule_drafts(self, chunks: list[int], decoding: list[int],
                         sample) -> dict[int, list[int]]:
        """Pick this tick's verify rows: up to ``spec_k`` draft tokens per
        decode row from the drafter, each capped by (1) the cache room past
        the row's own next token, (2) the request's remaining need minus
        one (which keeps the tick's writes inside the paged worst-case
        reservation) and (3) what the prefill token budget leaves after
        the chunks.  A ``sample`` hook disables drafting (acceptance is
        defined against the model's greedy tokens)."""
        if not self.spec_k or sample is not None:
            return {}
        left = None
        if self.prefill_token_budget is not None:
            left = max(self.prefill_token_budget - sum(chunks), 0)
        drafts: dict[int, list[int]] = {}
        for i in decoding:
            if self._draft_wait[i] > 0:          # backing off after misses
                self._draft_wait[i] -= 1
                continue
            s = self._slots[i]
            k = min(self.spec_k,
                    self.max_len - s.length - 1,
                    s.req.max_new_tokens - len(s.req.output) - 1)
            if left is not None:
                k = min(k, left)
            if k <= 0:
                continue
            d = self.drafter.draft(i, k)
            if d:
                drafts[i] = d
                if left is not None:
                    left -= len(d)
        return drafts

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
        now = self.clock()
        if first and req.first_token_at is None:
            # a preempted request keeps its first token's time: its
            # re-prefill's "first" token is a later output token
            req.first_token_at = now
        req.output.append(token)
        req.token_times.append(now)
        if self._journal is not None:
            self._journal.append({"ev": "emit", "rid": req.rid,
                                  "tok": int(token)})
        slot.last_token = token
        if self.drafter is not None:
            self.drafter.observe(idx, (token,))
        if (len(req.output) >= req.max_new_tokens or
                slot.length >= self.max_len or   # no cache room to decode into
                (self.eos_id is not None and token == self.eos_id)):
            self._terminal(req, "done", completed)
            self._free_slot(idx)

    def _fetch(self, out, logits, want_logits: bool):
        """A tick's outputs on the host, through ONE copy of ``out``
        (``_pack_tick``'s): (ids, finite, the logits as float32 or None);
        the logits come back only when ``want_logits`` (a ``sample``
        hook)."""
        ids, finite = _unpack_tick(out.cpu().numpy(), self.batch,
                                   logits.dtype)
        logits_np = (logits.float().cpu().numpy().copy() if want_logits
                     else None)
        return ids, finite, logits_np

    def run(self, *, max_steps: int = 10_000,
            sample: Callable | None = None) -> RunResult:
        """Drain the queue; returns a ``RunResult``: the requests that
        reached a terminal state during the call (done, error, cancelled,
        deadline_missed) and the truncation and stall flags.

        Each tick: (0) chaos's kill seam, expired deadlines retire, chaos
        may force a preemption; (1) refill free slots from the queue (a
        host-side lease; paged: strict FIFO behind the block reservation,
        a prefix hit mapping cached blocks, a shortfall preempting a
        bounded victim) and let a head that outranks a running row preempt
        it when the batch is full; (2) co-schedule prompt chunks, decode
        rows and verify rows (a decode row with a draft) and, paged, lease
        the blocks they grow into; (3) advance ALL slots with exactly one
        call — the ``("mixed", W)`` executable when any prompt chunk or
        draft is in flight, the ``("decode", B)`` one otherwise (a graph
        replay on the card) — whose ids and finiteness come back in one
        copy; quarantine every advancing row whose logits are not finite,
        then consume the rest, accepting and rolling back drafts.
        ``sample`` maps a logits row (V,) to a token id; greedy argmax on
        the device when None.  With work queued and nothing live the run
        ends ``stalled``, unless chaos made the denial transient (then it
        idles, at most ``max_steps`` ticks)."""
        completed: list[Request] = []
        start_steps = self.steps
        stalled = False
        idle = 0                   # consecutive no-row no-admission ticks
        while self.steps - start_steps < max_steps:
            if self.chaos is not None:
                # process death fires at the top of the tick, after the
                # previous tick's journal fsync: a kill can lose work not
                # dispatched yet, never an emitted token
                self.chaos.maybe_kill()
            self._sweep_deadlines(completed)
            if self.chaos is not None and self.max_preemptions:
                eligible = [i for i, s in enumerate(self._slots)
                            if s.req is not None and
                            s.req.preemptions < self.max_preemptions]
                v = self.chaos.forced_preempt(eligible)
                if v is not None:
                    self._preempt(v, requeue_front=True)
            for i in range(self.batch):
                if self._slots[i].req is None and self._queue:
                    if not self._admit_head(i):
                        break
            # priority preemption: a head that OUTRANKS a running request
            # does not wait behind it because the batch is full
            while (self._queue and self.max_preemptions and
                   all(s.req is not None for s in self._slots)):
                v = self._pick_victim(self._queue[0].priority, strict=True)
                if v is None:
                    break
                self._preempt(v)
                if not self._admit_head(v):
                    break
            live = [i for i, s in enumerate(self._slots) if s.req is not None]
            if not live:
                stalled = bool(self._queue)
                if not stalled:
                    break          # queue drained and no row in flight
                # queued work and nothing runs: permanent without chaos,
                # transient under an injected denial
                idle += 1
                if self.chaos is None or idle >= max_steps:
                    break
                continue
            idle = 0
            chunks = self._schedule_chunks()
            stall = self.prefill_policy == "stall" and any(chunks)
            decoding = [i for i in live
                        if not self._slots[i].prefilling and not stall]
            drafts = self._schedule_drafts(chunks, decoding, sample)
            if self.chaos is not None and drafts:
                # same length (the leases are sized by it), maybe junk:
                # verification must reject it losslessly
                drafts = {i: self.chaos.garble_draft(d, self.cfg.vocab_size)
                          for i, d in drafts.items()}
            host = {}
            if self.paged:
                for i, s in enumerate(self._slots):
                    if chunks[i]:
                        self._lease_to(i, s.length + chunks[i])
                    elif i in decoding:
                        self._lease_to(
                            i, s.length + 1 + len(drafts.get(i, ())))
                host["page_table"] = self._page_table

            greedy_np = None
            if any(chunks) or drafts:
                # mixed tick: prompt chunks + decode and verify rows, one
                # dispatch
                w = self.chunk_buckets.bucket(max(
                    [max(chunks), 2] + [1 + len(d) for d in drafts.values()]))
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
                        d = drafts.get(i, ())
                        q_lens[i] = 1 + len(d)
                        tokens[i, 0] = s.last_token
                        tokens[i, 1:1 + len(d)] = d
                fn = self._executable("mixed", w)
                out, logits = fn(self.params, self.cache, tokens=tokens,
                                 lengths=lengths, q_lens=q_lens, **host)
                ids, finite, logits_np = self._fetch(out, logits,
                                                     sample is not None)
                if self.spec_k:
                    # (B, W) greedy tokens: a row's next token sits at its
                    # last live position
                    greedy_np = ids.reshape(self.batch, w)
                    next_np = greedy_np[np.arange(self.batch),
                                        np.clip(q_lens - 1, 0, w - 1)]
                else:
                    next_np = ids
                if drafts:
                    self.spec_ticks += 1
                    self.spec_rows += len(drafts)
                    self.spec_drafted += sum(len(d) for d in drafts.values())
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
                out, logits = fn(self.params, self.cache, tokens=tokens,
                                 lengths=lengths, write_mask=adv, **host)
                next_np, finite, logits_np = self._fetch(out, logits,
                                                         sample is not None)
                self.dispatched_columns += 1
            self.steps += 1
            self.dispatches += 1
            self._occupancy_sum += len(live) / self.batch
            if self.paged:
                self.peak_pool_blocks = max(
                    self.peak_pool_blocks,
                    self.pool_blocks - self.alloc.n_free)
            self.peak_resident_tokens = max(
                self.peak_resident_tokens,
                sum(self._slots[i].length + chunks[i] + (i in decoding) +
                    len(drafts.get(i, ())) for i in live))
            advancing = [i for i in live if chunks[i] or i in decoding]
            if self.chaos is not None:
                # a chaos NaN row, where the reference overwrites its host
                # logits: the flag cleared, the hook's row NaN
                for i in self.chaos.corrupt_rows(advancing):
                    finite[i] = False
                    if logits_np is not None:
                        logits_np[i] = np.nan
            bad = ({i for i in advancing if not finite[i]}
                   if self.check_finite else set())

            # consume: advance cursors, emit tokens, retire finished rows;
            # a faulted row quarantines here, the rest are untouched
            for i in live:
                slot = self._slots[i]
                if slot.req is None:
                    continue        # freed earlier this tick
                if i in bad:
                    self._fault_row(i, "non-finite logits", completed)
                    continue
                if chunks[i]:
                    slot.pos += chunks[i]
                    slot.length += chunks[i]
                    if slot.pos == len(slot.req.prompt):
                        if self.prefix is not None:
                            # the prompt's full blocks join the cache
                            self._cache_prompt(i)
                        # final chunk: this row's logits are its first token
                        if sample is None:
                            tok = int(next_np[i])
                        else:
                            tok = self._safe_sample(i, sample, logits_np,
                                                    completed)
                            if tok is None or self._slots[i].req is None:
                                # the hook raised (row quarantined) or
                                # cancelled this very row
                                continue
                        self._emit(i, tok, completed, first=True)
                elif i in drafts:
                    self._verify(i, drafts[i], greedy_np[i], completed)
                elif i in decoding:
                    slot.length += 1
                    if sample is None:
                        tok = int(next_np[i])
                    else:
                        tok = self._safe_sample(i, sample, logits_np,
                                                completed)
                        if tok is None or self._slots[i].req is None:
                            continue
                    self._emit(i, tok, completed, first=False)
            if self.audit_every and self.steps % self.audit_every == 0:
                self.audit()
            # durability: one fsync a tick, then maybe a snapshot, which
            # sees every event the journal committed
            self._commit()
            if (self.snapshot_dir is not None and self.snapshot_every and
                    self.steps % self.snapshot_every == 0):
                self.snapshot()
        self._commit()
        in_flight = sum(s.req is not None for s in self._slots)
        truncated = (self.steps - start_steps >= max_steps and
                     bool(in_flight or self._queue))
        if truncated:
            warnings.warn(
                f"Engine.run hit max_steps={max_steps} with {in_flight} "
                f"request(s) in flight and {len(self._queue)} queued — "
                "work is NOT drained; call run() again to continue",
                RuntimeWarning, stacklevel=2)
        return RunResult(completed, truncated=truncated,
                         in_flight=in_flight, queued=len(self._queue),
                         stalled=stalled)

    def _verify(self, idx: int, draft: list[int], greedy: np.ndarray,
                completed: list[Request]) -> None:
        """Score verify row ``idx``: accept the longest draft prefix equal
        to the model's greedy tokens, emit the model's token at each
        accepted position plus the first disagreement (a verify row never
        emits less than a decode row), then roll back the rejected tail.
        Token j is emitted at cache length ``base + 1 + j``, so the stop
        rules fire at exactly the oracle's token."""
        slot = self._slots[idx]
        a = 0
        while a < len(draft) and draft[a] == int(greedy[a]):
            a += 1
        self.spec_accepted += a
        if a:                   # productive row: speculate freely
            self._draft_wait[idx] = self._draft_penalty[idx] = 0
        else:                   # full miss: back off exponentially
            self._draft_penalty[idx] = min(
                max(self._draft_penalty[idx] * 2, 1), _DRAFT_BACKOFF_MAX)
            self._draft_wait[idx] = self._draft_penalty[idx]
        base = slot.length
        for j in range(a + 1):
            slot.length = base + 1 + j
            self._emit(idx, int(greedy[j]), completed, first=False)
            if self._slots[idx].req is None:
                return          # finished: _free_slot released the row
        if a < len(draft):
            self.spec_rewinds += 1
            self._rewind_slot(idx, base + 1 + a)

    # -- metrics ---------------------------------------------------------------

    @property
    def slot_occupancy(self) -> float:
        """Mean fraction of slots live per tick (1.0 = saturated)."""
        return self._occupancy_sum / self.steps if self.steps else 0.0

    def spec_stats(self) -> dict[str, float]:
        """Speculation counters.  ``accepted_per_dispatch`` is the extra
        tokens a verify dispatch gave beyond the one plain decode would
        have."""
        return {
            "spec_k": self.spec_k,
            "spec_requested": self.spec_requested,
            "spec_supported": self.spec_supported,
            "spec_ticks": self.spec_ticks,
            "verify_rows": self.spec_rows,
            "draft_tokens": self.spec_drafted,
            "accepted_tokens": self.spec_accepted,
            "rewinds": self.spec_rewinds,
            "acceptance_rate": (self.spec_accepted /
                                max(self.spec_drafted, 1)),
            "accepted_per_dispatch": (self.spec_accepted /
                                      max(self.spec_ticks, 1)),
        }

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
        # outcome counts; an empty timing bucket omits its keys (no nan)
        out = {"n": len(reqs),
               "total_tokens": float(sum(len(r.output) for r in reqs)),
               "completed": sum(r.status == "done" for r in reqs),
               "errors": sum(r.status == "error" for r in reqs),
               "cancelled": sum(r.status == "cancelled" for r in reqs),
               "deadline_missed": sum(r.status == "deadline_missed"
                                      for r in reqs),
               "preempted": sum(r.preemptions > 0 for r in reqs),
               "preemptions": sum(r.preemptions for r in reqs)}
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
                     eos_id: int | None = None,
                     frames: np.ndarray | None = None,
                     device="cuda") -> list[int]:
    """Per-request batch-1 greedy decode — the exact numerics oracle.

    Teacher-forces the prompt through ``api.decode_step`` one token at a
    time (true positions and lengths), then decodes greedily.  A paged or
    int8 configuration runs through its own batch-1 cache (paged: a pool
    under the default linear page table); the audio family's starts from
    ``api.request_cache`` of the request's ``frames`` (F, d).  The engine
    must match it token for token."""
    if len(prompt) > max_len:
        raise ValueError(f"prompt length {len(prompt)} exceeds {max_len}")
    dev = torch.device(device)
    if cfg.family == "audio":
        f = torch.from_numpy(np.asarray(frames, np.float32).reshape(
            1, -1, cfg.d_model)).to(dev)
        cache = api.request_cache(cfg, params, {"frames": f}, max_len, dev)
    else:
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
