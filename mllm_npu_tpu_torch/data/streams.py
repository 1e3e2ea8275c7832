"""Stream primitives: the torchdata-free backbone of the data layer (the
port's copy of ``mllm_npu_tpu/data/streams.py``; tars are read with
``tarfile``, and the host shard comes from ``torch.distributed``).

Replaces the reference's datapipes graph (FileLister→cycle→shuffle→
sharding_filter→open→load_from_tar_wo_exception→webdataset grouping,
reference data/tasks/image_caption.py:600-611) with plain composable
generators. Robustness semantics are preserved: corrupt tar shards and
unreadable jsonl files are warned-and-skipped, never fatal (reference
data/datapipes.py:52-56,74-79).

Host sharding: shard_for_host() splits the *shard list* across the
``torch.distributed`` ranks (the DistributedReadingService equivalent).

Checkpointable streaming (what the reference lacks — it only reseeds on
resume, reference train/train.py:318-323): every randomness source is
*derived* from (seed, file-sequence-index, record-index) instead of a
serial RNG, so a stream's full position is the pair
``{"file_idx", "pos"}`` — tiny, JSON-safe, and resumable by skipping
``pos`` raw records of one file (no image decode on the skip path).
See FileCursor / SampleStream / BatchingStream / SampleMultiplexer.
"""

from __future__ import annotations

import logging
import random
import re
import tarfile
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Optional

log = logging.getLogger(__name__)


def brace_expand(pattern: str) -> list[str]:
    """Minimal {000..123} / {a,b} brace expansion (webdataset-style)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [
            x for i in range(int(lo), int(hi) + 1)
            for x in brace_expand(pattern[:m.start()]
                                  + str(i).zfill(width)
                                  + pattern[m.end():])
        ]
    m = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m:
        return [
            x for part in m.group(1).split(",")
            for x in brace_expand(pattern[:m.start()] + part
                                  + pattern[m.end():])
        ]
    return [pattern]


def list_files(roots, mask: str = "*.tar") -> list[str]:
    if isinstance(roots, (str, Path)):
        roots = [roots]
    out: list[str] = []
    for root in roots:
        root = str(root)
        expanded = brace_expand(root)
        for r in expanded:
            p = Path(r)
            if p.is_file():
                out.append(str(p))
            elif p.is_dir():
                out.extend(sorted(str(x) for x in p.rglob(mask)))
            else:
                log.warning("data path missing: %s", r)
    return sorted(out)


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_host(items: list, index: Optional[int] = None,
                   count: Optional[int] = None) -> list:
    if index is None:
        index, count = process_index_count()
    return items[index::count]


def derive_rng(seed, *keys) -> random.Random:
    """A Random seeded by a stable hash of (seed, *keys). Index-derived
    randomness (grain-style) instead of one serial RNG is what makes
    streams checkpointable with integer-only state: the coin flips for
    sample N never depend on how many draws preceded them."""
    import hashlib
    h = hashlib.sha256(repr((seed,) + keys).encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


class FileCursor:
    """Deterministic (finite or infinite) sequence of files where pass
    ``p`` visits a fresh permutation derived from (seed, p). Replaces
    cycle+buffer-shuffle over shard paths; full state is ONE integer, so
    resume just fast-forwards the index without replaying RNG draws."""

    def __init__(self, files: list, seed: int = 0,
                 cycle_count: Optional[int] = None):
        self.files = list(files)
        self.seed = seed
        self.cycle_count = cycle_count
        self.idx = 0

    def __iter__(self) -> Iterator[tuple[int, str]]:
        n = len(self.files)
        if n == 0:
            return
        while self.cycle_count is None or self.idx < n * self.cycle_count:
            pass_idx, off = divmod(self.idx, n)
            order = list(range(n))
            derive_rng(self.seed, "files", pass_idx).shuffle(order)
            for i in order[off:]:
                yield self.idx, self.files[i]
                self.idx += 1


def iter_tar_members(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (inner_path, bytes); swallow corrupt-shard errors
    (reference TarArchiveLoaderWoException semantics)."""
    try:
        with tarfile.open(path, mode="r") as tar:
            for info in tar:
                if not info.isfile():
                    continue
                f = tar.extractfile(info)
                if f is None:
                    log.warning("failed to extract %s from %s", info.name,
                                path)
                    continue
                yield f"{path}/{info.name}", f.read()
    except Exception as e:  # noqa: BLE001 — web-scale robustness
        log.warning("corrupt tar %s skipped: %s", path, e)


def permuted_lines(path: str, seed: int, file_idx: int
                   ) -> Iterator[bytes]:
    """Non-empty raw lines of a jsonl file in a deterministic per-file
    permutation derived from (seed, file_idx), read through an offset
    table (one pass to record each line's offset and length, one to seek
    in the permuted order), so the file never sits in memory. Unreadable
    files are warned-and-skipped (the reference's JsonlParser)."""
    offsets: list[tuple[int, int]] = []
    try:
        with open(path, "rb") as f:
            off = 0
            for ln in f:
                if ln.strip():
                    offsets.append((off, len(ln)))
                off += len(ln)
    except Exception as e:  # noqa: BLE001
        log.warning("unreadable jsonl %s skipped: %s", path, e)
        return
    order = list(range(len(offsets)))
    derive_rng(seed, "lines", file_idx).shuffle(order)
    try:
        with open(path, "rb") as f:
            for i in order:
                start, n = offsets[i]
                f.seek(start)
                yield f.read(n)
    except Exception as e:  # noqa: BLE001
        log.warning("unreadable jsonl %s skipped: %s", path, e)


def group_webdataset(members: Iterable[tuple[str, Any]]
                     ) -> Iterator[dict[str, Any]]:
    """Group consecutive tar members by sample key (basename without
    extension) — webdataset() semantics."""
    cur_key, cur = None, {}
    for path, value in members:
        base, dot, ext = path.rpartition(".")
        key = base if dot else path
        if cur_key is not None and key != cur_key:
            if cur:
                yield cur
            cur = {}
        cur_key = key
        cur["." + ext if dot else path] = value
    if cur:
        yield cur


class SampleStream:
    """Checkpointable sample stream: a deterministic file sequence
    (FileCursor), a per-file raw-record iterator, and a per-record decode
    with index-derived RNG. State is ``{"file_idx", "pos"}`` — raw-record
    granularity, so resume skips records WITHOUT decoding them (the
    expensive part: jpeg decode + anyres tiling).

    ``records_fn(path, file_idx)`` yields raw records (already in the
    final — possibly permuted — order for that file). ``decode_fn(raw,
    rng)`` returns a sample dict or None (filtered). Re-iterating a
    SampleStream RESUMES from its current position; it does not restart.
    """

    def __init__(self, list_files_fn: Callable[[], list],
                 records_fn: Callable[[str, int], Iterable],
                 decode_fn: Callable[[Any, random.Random], Optional[dict]],
                 seed: int = 0, cycle_count: Optional[int] = None):
        self.list_files_fn = list_files_fn
        self.records_fn = records_fn
        self.decode_fn = decode_fn
        self.seed = seed
        self.cycle_count = cycle_count
        self._file_idx = 0
        self._pos = 0

    def __iter__(self) -> Iterator[dict]:
        files = self.list_files_fn()
        cursor = FileCursor(files, seed=self.seed,
                            cycle_count=self.cycle_count)
        cursor.idx = self._file_idx
        skip = self._pos
        for fi, path in cursor:
            pos = 0
            for raw in self.records_fn(path, fi):
                if skip:
                    skip -= 1
                    pos += 1
                    continue
                rng = derive_rng(self.seed, "sample", fi, pos)
                pos += 1
                # state points at the NEXT raw record before we yield, so
                # a state_dict() taken downstream resumes after this one
                self._file_idx, self._pos = fi, pos
                try:
                    s = self.decode_fn(raw, rng)
                except Exception as e:  # noqa: BLE001 — web-scale robustness
                    log.warning("decode failed at %s[%d]: %s", path,
                                pos - 1, e)
                    continue
                if s is not None:
                    yield s
            self._file_idx, self._pos = fi + 1, 0
            skip = 0

    def state_dict(self) -> dict:
        return {"file_idx": self._file_idx, "pos": self._pos,
                "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self._file_idx = int(state.get("file_idx", 0))
        self._pos = int(state.get("pos", 0))
        if "seed" in state:
            self.seed = state["seed"]


class BatchingStream:
    """Collate a SampleStream into fixed batches. State = the source's
    state at the LAST BATCH BOUNDARY (the partial buffer is empty exactly
    when a batch has just been yielded, so no samples need serializing).
    """

    def __init__(self, source, collate_fn: Callable[[list], Any],
                 batch_size: int):
        self.source = source
        self.collate_fn = collate_fn
        self.batch_size = batch_size

    def __iter__(self) -> Iterator:
        buf = []
        for s in self.source:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []

    def state_dict(self) -> dict:
        return self.source.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.source.load_state_dict(state)


class SampleMultiplexer:
    """Weighted random interleave of N streams (reference uses torchdata
    SampleMultiplexer, data/datapipes.py:104). Exhausted streams drop
    out. Checkpointable: the pick RNG is derived from (seed, draw index)
    and children expose state_dict, so full state is {draws, children}.
    Re-iterating RESUMES (children are persistent iterators)."""

    def __init__(self, pipes_to_weights: dict, seed: int = 0):
        self.pipes_to_weights = pipes_to_weights
        self.seed = seed
        self._pipes = list(pipes_to_weights.keys())
        self._weights = [pipes_to_weights[p] for p in self._pipes]
        self._draws = 0
        self._done = [False] * len(self._pipes)

    def __iter__(self) -> Iterator:
        iters = [iter(p) for p in self._pipes]
        while not all(self._done):
            rng = derive_rng(self.seed, "mux", self._draws)
            self._draws += 1
            live = [i for i in range(len(iters)) if not self._done[i]]
            total = sum(self._weights[i] for i in live)
            r = rng.uniform(0, total)
            acc = 0.0
            for i in live:
                acc += self._weights[i]
                if r <= acc:
                    try:
                        yield next(iters[i])
                    except StopIteration:
                        self._done[i] = True
                    break

    def state_dict(self) -> dict:
        return {"draws": self._draws, "done": list(self._done),
                "pipes": [p.state_dict() if hasattr(p, "state_dict")
                          else None for p in self._pipes]}

    def load_state_dict(self, state: dict) -> None:
        self._draws = int(state.get("draws", 0))
        done = state.get("done")
        if done is not None:
            self._done = [bool(d) for d in done]
        for p, s in zip(self._pipes, state.get("pipes", [])):
            if s is not None and hasattr(p, "load_state_dict"):
                p.load_state_dict(s)
