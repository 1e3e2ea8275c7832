"""Prefetching data loader with a real checkpointable position (the port's
copy of the single-process ``DataLoader`` of
``mllm_npu_tpu/data/dataloader.py``).

Resume: the pipeline itself is checkpointable (streams.SampleStream:
index-derived RNG, integer state), the producer snapshots the pipe state
at every batch boundary, and ``state_dict()`` returns the state of the last
batch actually yielded to the training loop — so restore reproduces the
exact upcoming batch sequence. Epoch reseed (``seed_for_epoch``, the
reference's formula) composes on top: each epoch is a fresh deterministic
stream. The multi-process loader is not ported yet: ``make_dataloader``
raises for ``num_workers > 0``.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterator, Optional

log = logging.getLogger(__name__)


class DataLoader:
    """Single-process loader: one producer thread, bounded prefetch."""

    def __init__(self, pipe_factory: Callable[[int], Any],
                 prefetch: int = 4, seed: int = 888):
        """pipe_factory(seed) -> checkpointable iterable of batches."""
        self.pipe_factory = pipe_factory
        self.prefetch = prefetch
        self.seed = seed
        self._steps = 0
        self._epoch = 0
        self._pipe_state: Optional[dict] = None

    def seed_for_epoch(self, epoch: int, resume_steps: int = 0) -> int:
        # reference semantics: seed = resume_steps + epoch + 42
        # (train/train.py:318-323)
        return resume_steps + epoch + 42

    def next_epoch(self, resume_steps: int = 0) -> None:
        """Advance to the next epoch: bump the counter, reseed the
        stream (reference reseed semantics) and clear the position."""
        self._epoch += 1
        self.seed = self.seed_for_epoch(self._epoch, resume_steps)
        self._pipe_state = None

    def __iter__(self) -> Iterator:
        pipe = self.pipe_factory(self.seed)
        if self._pipe_state is not None and hasattr(pipe, "load_state_dict"):
            pipe.load_state_dict(self._pipe_state)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []
        has_state = hasattr(pipe, "state_dict")

        def producer():
            try:
                for batch in pipe:
                    q.put((batch, pipe.state_dict() if has_state else None))
            except Exception as e:  # noqa: BLE001
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, state = item
            self._steps += 1
            if state is not None:
                self._pipe_state = state
            yield batch

    # ---- resume state ----------------------------------------------------

    def state_dict(self) -> dict:
        return {"steps": self._steps, "epoch": self._epoch,
                "seed": self.seed, "pipe": self._pipe_state}

    def load_state_dict(self, state: dict) -> None:
        if "workers" in state:
            log.warning(
                "checkpoint was written by MultiProcessDataLoader but is "
                "being restored into the threaded DataLoader — the saved "
                "per-worker positions cannot be applied; the stream "
                "restarts from the epoch beginning (resume with the same "
                "--dataloader_workers to keep the exact position)")
        self._steps = state.get("steps", 0)
        self._epoch = state.get("epoch", 0)
        self.seed = state.get("seed", self.seed)
        self._pipe_state = state.get("pipe")


def make_dataloader(pipe_factory, num_workers: int = 0, prefetch: int = 4,
                    seed: int = 888):
    """num_workers=0 → the threaded DataLoader; the process pool is not
    ported yet."""
    if num_workers and num_workers > 0:
        raise NotImplementedError(
            "multi-process data loading (--dataloader_workers > 0) is not "
            "ported yet; use 0")
    return DataLoader(pipe_factory, prefetch=prefetch, seed=seed)
