"""Deterministic synthetic token pipeline (the port's own copy of
``repro/data/pipeline.py``, numpy only, so that the port imports nothing of
the reference).

No external datasets ship with the container, so the pipeline synthesizes
token streams from a seeded generator, with the plumbing a real loader
needs:

* deterministic resume: batches are a pure function of (seed, step), so a
  restored checkpoint replays the exact stream; they are bitwise the
  reference's for the same (seed, step);
* shard-awareness: each data-parallel host materializes only its slice
  (``host_slice``);
* double-buffered prefetch: the next batch is generated on a background
  thread while the device step runs;
* a mixture of Zipf-distributed "natural" tokens and repeated n-gram
  motifs, so language-model loss actually decreases during training runs
  (pure-uniform tokens give a flat loss).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


class SyntheticTokens:
    """Stateless batch generator: batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed motif table — shared structure the model can learn
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab_size, (256, cfg.motif_len), dtype=np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s = cfg.global_batch, cfg.seq_len
        # Zipf body
        z = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        tokens = (z % cfg.vocab_size).astype(np.int32)
        # splice motifs (learnable repeated structure)
        n_splices = int(cfg.motif_prob * b * (s // cfg.motif_len) / 2)
        if n_splices:
            rows = rng.integers(0, b, n_splices)
            cols = rng.integers(0, s + 1 - cfg.motif_len, n_splices)
            ids = rng.integers(0, len(self._motifs), n_splices)
            for r, c, i in zip(rows, cols, ids):
                tokens[r, c:c + cfg.motif_len] = self._motifs[i]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def host_slice(self, step: int, host_id: int, n_hosts: int) -> dict:
        full = self.batch(step)
        b = self.cfg.global_batch
        lo = host_id * b // n_hosts
        hi = (host_id + 1) * b // n_hosts
        return {k: v[lo:hi] for k, v in full.items()}


class Prefetcher:
    """Background-thread double buffering around any step->batch function."""

    def __init__(self, fetch, start_step: int = 0, depth: int = 2):
        self._fetch = fetch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._fetch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
