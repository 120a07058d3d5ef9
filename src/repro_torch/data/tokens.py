"""Deterministic synthetic token pipeline for LM training (a copy of the
reference's ``data/tokens.py``, which is numpy only: batch ``k`` is
byte-equal to the reference's).

Deterministic-by-step: batch ``k`` is a pure function of ``(seed, k)``, so a
restart-from-checkpoint replays the exact same stream (required for the
fault-tolerant loop in ``repro_torch.runtime``).  A background prefetch thread
keeps ``prefetch`` batches ready (host-side overlap with device compute).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np


def _batch_at(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Markov-ish stream so the loss actually decreases: next token depends on
    # the previous token through a fixed random permutation + noise.
    perm = np.random.default_rng(seed).permutation(vocab)
    toks = np.empty((batch, seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    noise = rng.random((batch, seq_len))
    rand_tok = rng.integers(0, vocab, size=(batch, seq_len))
    for t in range(seq_len):
        nxt = perm[toks[:, t]]
        toks[:, t + 1] = np.where(noise[:, t] < 0.85, nxt, rand_tok[:, t])
    return toks


def synthetic_token_batches(
    seed: int, batch: int, seq_len: int, vocab: int, start_step: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(tokens, labels)`` of shapes (batch, seq_len)."""
    step = start_step
    while True:
        toks = _batch_at(seed, step, batch, seq_len, vocab)
        yield toks[:, :-1], toks[:, 1:]
        step += 1


class TokenPipeline:
    """Prefetching wrapper with exact resume: ``TokenPipeline(..., start_step=k)``."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 start_step: int = 0, prefetch: int = 2):
        self._it = synthetic_token_batches(seed, batch, seq_len, vocab, start_step)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        for item in self._it:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        item = self._q.get()
        self.step += 1
        return item

    def __iter__(self) -> "TokenPipeline":
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
