"""Block allocator and radix prefix cache of the paged KV pool (port of
``BlockAllocator``, ``_Node`` and ``RadixPrefixCache`` in
``repro/serving/prefix.py``, the cache's snapshot ``dump``/``load`` pair
included).

Pure host bookkeeping, no device state.  ``BlockAllocator`` is the free
list with per-block refcounts.  A freshly leased block has refcount 1
(its slot); mapping it into another holder ``incref``s it; retiring a slot
``decref``s, and a block returns to the free list only at refcount 0.
Every block is either free with refcount 0 or live with refcount >= 1: a
decref at 0 is a double free, and ``check()`` asserts the partition.  The
free list is LIFO, so lease order (and the block recycling that scrambles
page tables) is the reference's.

Topology (``n_homes > 1``, the reference's sharded paged path): the pool's
``n_blocks + 1`` rows (the null row last) split into ``n_homes`` contiguous
runs; block ``b`` is home to shard ``b // rows_per_home``.  ``lease(home=h)``
takes from home ``h``; ``lease()`` rotates over non-empty homes.  The port
serves one card, so its engine uses ``n_homes = 1``.

``RadixPrefixCache`` maps block-aligned prompt prefixes to the physical
blocks that hold their K/V, so a request whose prompt walks a cached path
maps those blocks into its page table instead of recomputing them (the
engine's prefix sharing with copy-on-write).
"""

from __future__ import annotations

from typing import Callable, Iterable


class BlockAllocator:
    """Refcounted free-list allocator over ``n_blocks`` physical KV blocks."""

    def __init__(self, n_blocks: int, n_homes: int = 1):
        if n_blocks < 1:
            raise ValueError(f"need >= 1 block, got {n_blocks}")
        if n_homes < 1:
            raise ValueError(f"need >= 1 home, got {n_homes}")
        if (n_blocks + 1) % n_homes:
            raise ValueError(
                f"pool rows {n_blocks + 1} (incl. null) must split evenly "
                f"into {n_homes} block homes")
        self.n_blocks = n_blocks
        self.n_homes = n_homes
        self.rows_per_home = (n_blocks + 1) // n_homes
        self.free: list[int] = list(range(n_blocks))
        self.refs: list[int] = [0] * n_blocks
        self._next_home = 0

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_live(self) -> int:
        return sum(1 for r in self.refs if r > 0)

    def ref(self, blk: int) -> int:
        return self.refs[blk]

    def home(self, blk: int) -> int:
        """The shard block ``blk`` is home to (pure function of the id)."""
        return blk // self.rows_per_home

    def free_by_home(self) -> list[int]:
        """Free-block count per home."""
        counts = [0] * self.n_homes
        for blk in self.free:
            counts[self.home(blk)] += 1
        return counts

    def lease(self, home: int | None = None) -> int:
        """Take a free block (refcount 0 -> 1), from home ``home`` when
        given (LIFO within the home), else round-robin across homes."""
        if not self.free:
            raise RuntimeError("KV block pool exhausted")
        if home is None and self.n_homes > 1:
            by_home = self.free_by_home()
            for step in range(self.n_homes):
                h = (self._next_home + step) % self.n_homes
                if by_home[h]:
                    home = h
                    self._next_home = (h + 1) % self.n_homes
                    break
        if home is None:
            blk = self.free.pop()
        else:
            idx = next((i for i in range(len(self.free) - 1, -1, -1)
                        if self.home(self.free[i]) == home), None)
            if idx is None:
                raise RuntimeError(f"KV block pool exhausted in home {home}")
            blk = self.free.pop(idx)
        if self.refs[blk] != 0:
            raise RuntimeError(
                f"free list corrupt: block {blk} freed at refcount "
                f"{self.refs[blk]}")
        self.refs[blk] = 1
        return blk

    def incref(self, blk: int) -> None:
        """Add a holder to a LIVE block."""
        if self.refs[blk] < 1:
            raise RuntimeError(
                f"incref of dead KV block {blk}: a shared mapping must "
                "target a live block")
        self.refs[blk] += 1

    def decref(self, blk: int) -> bool:
        """Drop one holder; True when the block went back to the free list
        (refcount hit 0)."""
        if self.refs[blk] <= 0:
            raise RuntimeError(f"double free of KV block {blk}")
        self.refs[blk] -= 1
        if self.refs[blk] == 0:
            self.free.append(blk)
            return True
        return False

    def n_shared(self) -> int:
        """Blocks currently mapped by more than one holder."""
        return sum(1 for r in self.refs if r >= 2)

    def check(self) -> None:
        """The partition invariant: every block is either on the free list
        with refcount 0, or off it with refcount >= 1; homes tile the pool
        rows with the null row in the last home."""
        if len(set(self.free)) != len(self.free):
            raise AssertionError("free list holds duplicate block ids")
        free = set(self.free)
        if not free <= set(range(self.n_blocks)):
            raise AssertionError("free list holds foreign block ids")
        for blk, r in enumerate(self.refs):
            if (blk in free) == (r > 0):
                raise AssertionError(
                    f"block {blk}: refcount {r} vs free={blk in free}: "
                    "leak or double lease")
        if self.rows_per_home * self.n_homes != self.n_blocks + 1:
            raise AssertionError(
                f"homes {self.n_homes} x {self.rows_per_home} do not tile "
                f"the {self.n_blocks + 1} pool rows")
        if self.home(self.n_blocks) != self.n_homes - 1:
            raise AssertionError("null row must be home to the last shard")
        if sum(self.free_by_home()) != self.n_free:
            raise AssertionError("per-home free counts do not partition "
                                 "the free list")


class _Node:
    """One radix edge: ``tokens`` (exactly ``block_size`` ids) labels the
    edge from ``parent``; ``block`` is the physical block whose K/V was
    written from those tokens at this tree depth."""

    __slots__ = ("tokens", "block", "children", "parent", "last_used")

    def __init__(self, tokens: tuple, block: int, parent):
        self.tokens = tokens
        self.block = block
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Radix tree over prompt tokens at KV-block granularity.

    Edges are ``block_size``-token runs; a node maps its root-to-node token
    path to the physical block holding that run's K/V.  Matching returns the
    longest fully-cached block chain plus, at the divergence point, the
    longest PARTIAL head of any next cached block (the engine turns that
    into a copy-on-write admission).  Eviction removes least-recently-used
    LEAF nodes only, so every surviving node's path stays walkable.
    """

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.root: dict[tuple, _Node] = {}
        self._nodes: list[_Node] = []
        self._clock = 0          # LRU timestamps without wall-clock time

    def __len__(self) -> int:
        return len(self._nodes)

    def blocks(self) -> list[int]:
        """Every block the cache currently holds a reference on."""
        return [n.block for n in self._nodes]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens) -> tuple[list[int], tuple[int, int] | None]:
        """Longest cached prefix of ``tokens``.

        Returns ``(full_blocks, partial)``: ``full_blocks`` is the chain of
        physical blocks covering ``len(full_blocks) * block_size`` leading
        tokens exactly; ``partial`` is ``(block, n)`` when the next cached
        edge agrees with the following ``n`` (``0 < n < block_size``) tokens
        — reusable only via copy-on-write, since its tail differs.  Every
        node on the walk (and the partial node) is LRU-touched.
        """
        toks = [int(t) for t in tokens]
        bs = self.block_size
        now = self._tick()
        level, full, i = self.root, [], 0
        while True:
            chunk = tuple(toks[i:i + bs])
            if len(chunk) == bs and chunk in level:
                node = level[chunk]
                node.last_used = now
                full.append(node.block)
                i += bs
                level = node.children
                continue
            best: tuple[_Node, int] | None = None
            rest = toks[i:]
            for key, child in level.items():
                n = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    n += 1
                if n and (best is None or n > best[1]):
                    best = (child, n)
            if best is None:
                return full, None
            best[0].last_used = now
            return full, (best[0].block, best[1])

    def insert(self, tokens, blocks: Iterable[int]) -> list[int]:
        """Register ``blocks`` as the fully-written chain for ``tokens``
        (``len(tokens) == len(blocks) * block_size``).  Existing nodes win —
        concurrent identical prompts keep the FIRST author's block, and the
        duplicate block stays private to its slot.  Returns the blocks of
        newly created nodes; the caller holds the cache's reference on
        exactly those (one incref each).
        """
        toks = [int(t) for t in tokens]
        blocks = list(blocks)
        bs = self.block_size
        if len(toks) != len(blocks) * bs:
            raise ValueError(
                f"{len(toks)} tokens cannot map {len(blocks)} blocks of "
                f"{bs} — only whole fully-written blocks are cacheable")
        now = self._tick()
        level, parent, fresh = self.root, None, []
        for j, blk in enumerate(blocks):
            chunk = tuple(toks[j * bs:(j + 1) * bs])
            node = level.get(chunk)
            if node is None:
                node = _Node(chunk, int(blk), parent)
                level[chunk] = node
                self._nodes.append(node)
                fresh.append(int(blk))
            node.last_used = now
            parent, level = node, node.children
        return fresh

    def evict_lru(self, keep: Callable[[int], bool] | None = None
                  ) -> int | None:
        """Remove the least-recently-used LEAF node (skipping blocks for
        which ``keep(block)`` is True) and return its block — the caller
        drops the cache's reference on it.  Returns None when nothing is
        evictable.  Leaf-only eviction keeps every cached path reachable;
        repeated calls peel a cold chain back from its tip.
        """
        victim = None
        for node in self._nodes:
            if node.children:
                continue
            if keep is not None and keep(node.block):
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        level = victim.parent.children if victim.parent else self.root
        del level[victim.tokens]
        self._nodes.remove(victim)
        return victim.block

    def clear(self) -> list[int]:
        """Drop every node; returns their blocks for the caller to decref."""
        blocks = [n.block for n in self._nodes]
        self.root = {}
        self._nodes = []
        return blocks

    def dump(self) -> dict:
        """JSON-safe capture for serving snapshots.  Each node goes out
        with its FULL root-to-node token path (not just its edge), so
        ``load`` rebuilds the tree by inserting paths in depth order; the
        LRU timestamps and the clock survive, so eviction order after a
        restore is the never-killed engine's."""
        entries = []
        for n in self._nodes:
            path, cur = [], n
            while cur is not None:
                path.append(cur.tokens)
                cur = cur.parent
            toks = [int(t) for chunk in reversed(path) for t in chunk]
            entries.append({"tokens": toks, "block": int(n.block),
                            "last_used": int(n.last_used)})
        return {"block_size": self.block_size, "clock": self._clock,
                "nodes": entries}

    def load(self, state: dict) -> None:
        """Rebuild from a ``dump()`` capture into an EMPTY cache, parents
        before children.  Structure only: the cache's block references are
        already counted in the restored allocator's refcounts, so nothing
        is incref'd here."""
        if self._nodes:
            raise RuntimeError("load() requires an empty prefix cache")
        if state["block_size"] != self.block_size:
            raise ValueError(
                f"snapshot block_size {state['block_size']} != engine "
                f"block_size {self.block_size}")
        bs = self.block_size
        for e in sorted(state["nodes"], key=lambda e: len(e["tokens"])):
            toks = e["tokens"]
            level, parent = self.root, None
            for j in range(0, len(toks) - bs, bs):
                parent = level[tuple(toks[j:j + bs])]
                level = parent.children
            chunk = tuple(toks[-bs:])
            node = _Node(chunk, int(e["block"]), parent)
            node.last_used = int(e["last_used"])
            level[chunk] = node
            self._nodes.append(node)
        self._clock = int(state["clock"])
