"""Model-free draft-token proposers for speculative decoding (port of
``repro/serving/draft.py``, host-only, with its snapshot ``dump``/``load``
pair).

Decode is bandwidth-bound: every tick streams the full weight set (and the
live KV) to advance each row by ONE token.  ``api.mixed_step`` already
scores ``q_lens[b]`` tokens per row in one dispatch, so if something cheap
can GUESS the next K tokens, the engine verifies all K+1 positions for one
weight stream — accepted tokens are free bandwidth-wise.  The guesser here
is prompt-lookup / n-gram drafting (no second model, no new params, no new
executables): LLM output is locally repetitive — copied spans, code
boilerplate, format scaffolding, greedy loops — so the continuation of the
row's CURRENT suffix n-gram has usually been seen before in the row's own
token history.

``PromptLookupDrafter`` keeps, per engine slot, the request's token history
(prompt + everything emitted) and an incremental suffix index: a hash map
from each n-gram (``ngram_min <= n <= ngram_max``) to the position where it
last occurred — the O(1)-per-token collapsed form of a suffix automaton's
last-occurrence endpoints, which is the only query drafting needs (match
the longest indexed suffix of the history, propose the tokens that followed
its previous occurrence).  Rejected drafts are never observed, so the
history always equals the accepted stream and rollback needs no drafter
bookkeeping.

Acceptance is decided by the target model (longest agreeing greedy prefix),
so draft quality affects THROUGHPUT only, never outputs — a drafter may
return garbage, fewer than ``k`` tokens, or nothing at all (the engine then
decodes that row plainly).
"""

from __future__ import annotations


class PromptLookupDrafter:
    """Per-slot n-gram / prompt-lookup draft proposer.

    ``observe(slot, tokens)`` appends accepted tokens to the slot's history
    and indexes the new suffix n-grams; ``draft(slot, k)`` proposes up to
    ``k`` continuation tokens by matching the longest current suffix n-gram
    against its LAST earlier occurrence; ``reset(slot)`` clears the slot for
    its next lease.  All host-side, O(ngram_max) per token.
    """

    def __init__(self, *, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"{ngram_min}..{ngram_max}")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._history: dict[int, list[int]] = {}
        # per slot, per n: n-gram tuple -> index AFTER its last occurrence
        self._index: dict[int, dict[int, dict[tuple, int]]] = {}

    def reset(self, slot: int) -> None:
        self._history.pop(slot, None)
        self._index.pop(slot, None)

    def observe(self, slot: int, tokens) -> None:
        """Append accepted tokens to ``slot``'s history (prompt at admission,
        then each emitted token) and index their suffix n-grams.  Each
        n-gram keeps its last TWO occurrence endpoints: the history's
        current suffix is always its own last occurrence, so drafting needs
        the one before it (a cycle like ``a b a b`` must still match)."""
        hist = self._history.setdefault(slot, [])
        idx = self._index.setdefault(
            slot, {n: {} for n in range(self.ngram_min, self.ngram_max + 1)})
        for t in tokens:
            hist.append(int(t))
            end = len(hist)
            for n in range(self.ngram_min, min(self.ngram_max, end) + 1):
                g = tuple(hist[end - n:end])
                cur = idx[n].get(g)
                idx[n][g] = (end, cur[0] if cur is not None else None)

    def draft(self, slot: int, k: int) -> list[int]:
        """Propose up to ``k`` tokens continuing ``slot``'s history.

        Matches the longest suffix n-gram with an earlier occurrence and
        copies the run that followed it.  When the match lies within ``k``
        of the end, the copy overlaps the current position — the tail IS a
        cycle of period ``end - pos`` (a constant run is the period-1 case)
        and the draft continues it periodically instead of truncating at
        the end of history.  Returns [] when nothing matches (the engine
        decodes the row plainly that tick).
        """
        hist = self._history.get(slot)
        if not hist or k <= 0:
            return []
        end = len(hist)
        for n in range(min(self.ngram_max, end - 1), self.ngram_min - 1, -1):
            rec = self._index[slot][n].get(tuple(hist[end - n:end]))
            if rec is None:
                continue
            # the suffix IS its own last occurrence — take the one before
            pos = rec[0] if rec[0] < end else rec[1]
            if pos is None:
                continue
            if pos + k <= end:
                return hist[pos:pos + k]
            period = end - pos
            return [hist[pos + (j % period)] for j in range(k)]
        return []

    def history_len(self, slot: int) -> int:
        return len(self._history.get(slot, ()))

    def dump(self) -> dict:
        """JSON-safe capture: histories only; the suffix index is a pure
        function of the history and ``load`` rebuilds it."""
        return {"ngram_max": self.ngram_max, "ngram_min": self.ngram_min,
                "history": {str(s): list(h)
                            for s, h in self._history.items()}}

    def load(self, state: dict) -> None:
        """Rebuild per-slot histories (and their indexes, through
        ``observe``) from ``dump()``."""
        self._history = {}
        self._index = {}
        for s, hist in state.get("history", {}).items():
            self.observe(int(s), hist)


DRAFTERS = {
    "plookup": PromptLookupDrafter,
}


def make_drafter(name: str, **kwargs) -> PromptLookupDrafter:
    """Build a drafter by registry name (the ``--drafter`` serving knob)."""
    if name not in DRAFTERS:
        raise ValueError(f"unknown drafter {name!r}; have {sorted(DRAFTERS)}")
    return DRAFTERS[name](**kwargs)
