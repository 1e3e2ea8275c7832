"""Prefetching data loaders with a real checkpointable position (the port's
copy of ``mllm_npu_tpu/data/dataloader.py``): the single-process
``DataLoader`` (one producer thread) and ``MultiProcessDataLoader`` (a pool
of spawned worker processes, each over its own file shard).

Resume: the pipeline itself is checkpointable (streams.SampleStream:
index-derived RNG, integer state), the producer snapshots the pipe state
at every batch boundary, and ``state_dict()`` returns the state of the last
batch actually yielded to the training loop — so restore reproduces the
exact upcoming batch sequence. Epoch reseed (``seed_for_epoch``, the
reference's formula) composes on top: each epoch is a fresh deterministic
stream. The pool's state is each worker's pipe state and the round-robin
cursor, so it resumes exactly for the same worker count.
"""

from __future__ import annotations

import collections
import logging
import mmap
import multiprocessing as mp
import os
import pickle
import queue
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Callable, Iterator, Optional

import numpy as np

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

    def shutdown(self) -> None:
        """Nothing to stop: the producer thread is a daemon."""


_SHM_DIR = "/dev/shm"
_ALIGN = 64


class _Shared:
    """A batch whose numpy arrays wait in one POSIX shared-memory segment
    (a file under /dev/shm): a worker process writes them there and the
    queue carries this small record, so the parent maps the arrays instead
    of reading and unpickling them out of the queue's pipe."""

    def __init__(self, name, size, layout, rest):
        self.name, self.size = name, size
        self.layout = layout      # key → (offset, shape, dtype), or None
        self.rest = rest          # the values that are not arrays


def _share(batch):
    """Worker side: ``batch`` (a dict) as a ``_Shared``, or the batch
    itself when it holds no array. The segment stays registered with the
    resource tracker that the pool's processes share, which unlinks it if
    every process ends before the parent has taken it."""
    if not isinstance(batch, dict):
        return batch
    layout, size = {}, 0
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.nbytes and not v.dtype.hasobject:
            layout[k] = (size, v.shape, v.dtype.str)
            size += -(-v.nbytes // _ALIGN) * _ALIGN
        else:
            layout[k] = None
    if not size:
        return batch
    shm = shared_memory.SharedMemory(create=True, size=size)
    try:
        for k, spec in layout.items():
            if spec is not None:
                off, shape, dtype = spec
                np.ndarray(shape, dtype, buffer=shm.buf,
                           offset=off)[...] = batch[k]
    except BaseException:
        shm.close()
        _release(shm.name)
        raise
    shm.close()
    return _Shared(shm.name, size, layout,
                   {k: v for k, v in batch.items() if layout[k] is None})


def _release(name: str) -> bool:
    """Unlink the segment ``name`` and drop it from the resource tracker;
    False when it was already gone."""
    try:
        os.unlink(os.path.join(_SHM_DIR, name))
    except FileNotFoundError:
        return False
    resource_tracker.unregister("/" + name, "shared_memory")
    return True


def _unshare(item: _Shared) -> dict:
    """Parent side: the batch, its arrays views of the mapped segment,
    which is released at once (the mapping lives as long as the arrays
    do)."""
    fd = os.open(os.path.join(_SHM_DIR, item.name), os.O_RDWR)
    try:
        mm = mmap.mmap(fd, item.size)
    finally:
        os.close(fd)
    _release(item.name)
    batch = {}
    for k, spec in item.layout.items():
        if spec is None:
            batch[k] = item.rest[k]
        else:
            off, shape, dtype = spec
            batch[k] = np.frombuffer(mm, np.dtype(dtype), int(np.prod(shape)),
                                     off).reshape(shape)
    return batch


def _worker_main(pipe_factory, seed, worker_id, num_workers, host_shard,
                 init_state, out_q, stop_evt, shared=False, parent=None,
                 prefetch=0):
    """Runs in a worker process (spawn) or thread: build the pipe with this
    worker's file shard and stream (batch, state) pairs, a process's
    batches through shared memory (``shared``). The host shard is passed in
    from the parent, and nothing here touches CUDA. A process stops when
    the parent sets the stop or is gone (its pid no longer this process's
    parent), releasing the segments of the batches it made that the
    parent may not have taken: at most the queue's ``prefetch`` and the one
    being put."""
    from mllm_npu_tpu_torch.data import streams
    made = collections.deque(maxlen=prefetch + 1)

    def stopping():
        return stop_evt.is_set() or (parent is not None
                                     and os.getppid() != parent)
    try:
        streams.set_host_shard(*host_shard)
        streams.set_worker_shard(worker_id, num_workers)
        pipe = pipe_factory(seed)
        if init_state is not None and hasattr(pipe, "load_state_dict"):
            pipe.load_state_dict(init_state)
        has_state = hasattr(pipe, "state_dict")
        for batch in pipe:
            state = pipe.state_dict() if has_state else None
            item = _share(batch) if shared else batch
            if isinstance(item, _Shared):
                made.append(item.name)
            while not stopping():
                try:
                    out_q.put((item, state), timeout=0.5)
                    break
                except queue.Full:
                    continue
            if stopping():
                # the parent reads no more: release what it has not taken
                # and exit without writing out what the queue holds
                for name in made:
                    _release(name)
                if hasattr(out_q, "cancel_join_thread"):
                    out_q.cancel_join_thread()
                return
        out_q.put(None)  # exhausted
    except Exception as e:  # noqa: BLE001 — re-raised in the parent
        try:
            out_q.put(e)
        except Exception:  # noqa: BLE001
            pass


class MultiProcessDataLoader:
    """N worker processes, each running the SAME pipeline factory over a
    disjoint file shard (files[host::hosts][worker::workers]); the parent
    interleaves their batches round-robin (twin of the reference's
    ``MultiProcessDataLoader``).

    Deterministic and resumable FOR A FIXED WORKER COUNT: the batch order is
    a function of (seed, num_workers); the state is the per-worker pipe
    states and the round-robin cursor, each taken at the batch actually
    yielded.

    The start method is ``spawn``: a fork after CUDA is initialised breaks
    the child's CUDA, and a fork of a threaded parent can deadlock on copied
    locks. Spawn needs a picklable ``pipe_factory`` (the trainer's
    ``PipeFactory`` is); an unpicklable one falls back to THREAD workers with
    a warning (the same shard split and batch order, the GIL shared).
    ``worker_kind`` says which ran. A process's batch crosses through one
    shared-memory segment (the queue carries its layout; the parent maps
    the arrays and releases the segment): its values are the pipeline's
    bit for bit. Pickled through the queue, as in the reference, a 94.6
    MiB batch took the parent 1.5 s to take on an H100's host
    (``chip_smoke.py`` phase 16a), more than the step it fed.
    """

    def __init__(self, pipe_factory: Callable[[int], Any],
                 num_workers: int = 4, prefetch: int = 4, seed: int = 888,
                 mp_context: str = "spawn"):
        self.pipe_factory = pipe_factory
        self.num_workers = max(1, int(num_workers))
        self.prefetch = prefetch
        self.seed = seed
        self.mp_context = mp_context
        self.worker_kind: Optional[str] = None
        self._steps = 0
        self._epoch = 0
        self._rr = 0
        self._worker_states: list = [None] * self.num_workers
        self._procs: list = []
        self._queues: list = []
        self._stop = None

    seed_for_epoch = DataLoader.seed_for_epoch

    def next_epoch(self, resume_steps: int = 0) -> None:
        self.shutdown()
        self._epoch += 1
        self.seed = self.seed_for_epoch(self._epoch, resume_steps)
        self._rr = 0
        self._worker_states = [None] * self.num_workers

    def _start(self) -> None:
        from mllm_npu_tpu_torch.data.streams import process_index_count
        host_shard = process_index_count()
        try:
            self._start_ctx(self.mp_context, host_shard)
        except (TypeError, AttributeError, pickle.PicklingError) as e:
            if self.mp_context == "thread":
                raise
            log.warning("pipe_factory not picklable (%s) — falling back "
                        "to thread workers", e)
            self.shutdown()
            self._start_ctx("thread", host_shard)
        log.info("dataloader: %d %s workers", self.num_workers,
                 self.worker_kind)

    def _start_ctx(self, ctx_name: str, host_shard) -> None:
        if ctx_name == "thread":
            self._stop = threading.Event()
            self._queues = [queue.Queue(maxsize=self.prefetch)
                            for _ in range(self.num_workers)]
            make = threading.Thread
        else:
            ctx = mp.get_context(ctx_name)
            self._stop = ctx.Event()
            self._queues = [ctx.Queue(maxsize=self.prefetch)
                            for _ in range(self.num_workers)]
            make = ctx.Process
        self._procs = []
        for w in range(self.num_workers):
            p = make(target=_worker_main,
                     args=(self.pipe_factory, self.seed, w, self.num_workers,
                           host_shard, self._worker_states[w],
                           self._queues[w], self._stop,
                           ctx_name != "thread",
                           None if ctx_name == "thread" else os.getpid(),
                           self.prefetch),
                     daemon=True)
            p.start()
            self._procs.append(p)
        self.worker_kind = ctx_name

    def shutdown(self) -> None:
        """Stop the workers and join them (a worker that sees the stop
        releases the segments of the batches the parent has not taken and
        exits without writing out what its queue holds); one still alive
        after 5 s is terminated, and the resource tracker releases its
        segments when the program ends. No queue is read after the
        stop."""
        if self._stop is not None:
            self._stop.set()
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if hasattr(p, "terminate") and p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q_ in self._queues:
            if hasattr(q_, "close"):
                q_.close()
        self._procs, self._queues, self._stop = [], [], None

    def _get(self, w: int):
        # bounded waits + liveness checks: a worker that dies without
        # enqueueing (killed for memory, a crash in native decode) raises
        # here instead of hanging the training loop on a bare get()
        while True:
            try:
                return self._queues[w].get(timeout=5.0)
            except queue.Empty:
                if self._procs[w].is_alive():
                    continue
                try:  # drain a batch enqueued just before death
                    return self._queues[w].get_nowait()
                except queue.Empty:
                    pass
                code = getattr(self._procs[w], "exitcode", None)
                self.shutdown()
                raise RuntimeError(
                    f"dataloader worker {w} died (exit code {code}) without "
                    "yielding — see the worker's stderr for the crash")

    def __iter__(self) -> Iterator:
        if not self._procs:
            self._start()
        done = [False] * self.num_workers
        while not all(done):
            w = self._rr % self.num_workers
            if done[w]:
                self._rr += 1
                continue
            item = self._get(w)
            if item is None:
                done[w] = True
                self._rr += 1
                continue
            if isinstance(item, Exception):
                self.shutdown()
                raise item
            batch, state = item
            if isinstance(batch, _Shared):
                batch = _unshare(batch)
            # advance the cursor BEFORE yield so a state_dict() taken by
            # the trainer right after this batch resumes at the next one
            self._rr += 1
            self._steps += 1
            if state is not None:
                self._worker_states[w] = state
            yield batch
        self.shutdown()

    # ---- resume state ----------------------------------------------------

    def state_dict(self) -> dict:
        return {"steps": self._steps, "epoch": self._epoch,
                "seed": self.seed, "rr": self._rr,
                "num_workers": self.num_workers,
                "workers": list(self._worker_states)}

    def load_state_dict(self, state: dict) -> None:
        if "workers" not in state:
            log.warning(
                "checkpoint was written by the threaded DataLoader but is "
                "being restored into MultiProcessDataLoader — the saved "
                "single-stream position cannot be split across workers; "
                "the stream restarts from the epoch beginning (resume "
                "with --dataloader_workers 0 to keep the exact position)")
        self._steps = state.get("steps", 0)
        self._epoch = state.get("epoch", 0)
        self.seed = state.get("seed", self.seed)
        self._rr = state.get("rr", 0)
        saved_w = state.get("num_workers", self.num_workers)
        if saved_w != self.num_workers:
            log.warning(
                "resuming with num_workers=%d but checkpoint used %d — "
                "batch order will differ from an uninterrupted run",
                self.num_workers, saved_w)
        workers = state.get("workers") or []
        self._worker_states = [
            workers[w] if w < len(workers) else None
            for w in range(self.num_workers)]


def make_dataloader(pipe_factory, num_workers: int = 0, prefetch: int = 4,
                    seed: int = 888):
    """num_workers=0 → the threaded DataLoader; >0 → the process pool."""
    if num_workers and num_workers > 0:
        return MultiProcessDataLoader(pipe_factory,
                                      num_workers=num_workers,
                                      prefetch=prefetch, seed=seed)
    return DataLoader(pipe_factory, prefetch=prefetch, seed=seed)
