"""Block allocator of the paged KV pool (port of ``BlockAllocator`` in
``repro/serving/prefix.py``; the radix prefix cache is a later slice).

Pure host bookkeeping, no device state: the engine's free list with
per-block refcounts.  A freshly leased block has refcount 1 (its slot);
mapping it into another holder ``incref``s it; retiring a slot ``decref``s,
and a block returns to the free list only at refcount 0.  Every block is
either free with refcount 0 or live with refcount >= 1: a decref at 0 is a
double free, and ``check()`` asserts the partition.  The free list is LIFO,
so lease order (and the block recycling that scrambles page tables) is the
reference's.

Topology (``n_homes > 1``, the reference's sharded paged path): the pool's
``n_blocks + 1`` rows (the null row last) split into ``n_homes`` contiguous
runs; block ``b`` is home to shard ``b // rows_per_home``.  ``lease(home=h)``
takes from home ``h``; ``lease()`` rotates over non-empty homes.  The port
serves one card, so its engine uses ``n_homes = 1``.
"""

from __future__ import annotations


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
