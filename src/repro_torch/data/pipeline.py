"""Deterministic synthetic token pipeline with host-side prefetch:
``repro/data/pipeline.py`` restated (numpy only, so the batches are the
JAX package's bit for bit).

Tokens are a keyed hash of (stream, step, position) so any worker can
regenerate any batch — restart-safe without data-state checkpointing (the
checkpoint records only the step).  A background thread keeps a small
prefetch queue full, overlapping host batch construction with device steps.
The batches stay numpy arrays: the train step moves them to the device, not
the prefetch thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class SyntheticTokens:
    """Deterministic pseudo-text: next-token structure exists (affine hash)
    so the LM loss actually decreases — useful for convergence smoke tests."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq = seq
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 0, step]))
        base = rng.integers(0, self.vocab, (self.batch, 1), np.int64)
        pos = np.arange(self.seq + 1, dtype=np.int64)[None, :]
        # affine-progression "language": learnable transition structure
        toks = (base * 31 + pos * 127 + (pos * pos % 61)) % self.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(ds: SyntheticTokens, start_step: int = 0,
                        prefetch: int = 2,
                        extra: Optional[Dict[str, Any]] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator starting at ``start_step``."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            b = ds.batch_at(step)
            if extra:
                b = {**b, **extra}
            try:
                q.put((step, b), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _It()
