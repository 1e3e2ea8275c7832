"""The port's multi-process data loader (``data/dataloader.py
MultiProcessDataLoader``) against the JAX package's.

Both read the same tiny caption tars (three shards, two workers, so the
workers' file shards differ in size and the round-robin meets an exhausted
worker) with the same tokenizer, processor and seed. The port's pool, in
spawned worker processes and in thread workers, must yield the reference's
batches bit for bit and in the same order, and the same resume state after
each batch; a state taken mid-epoch (through JSON) resumes to the rest of
the uninterrupted sequence. A worker that dies raises within 10 s, an
unpicklable factory falls back to threads with a warning and the same
batches, a spawned worker has loaded neither JAX nor a CUDA context, a
batch crosses from a worker through a shared-memory segment with every
value intact, and no segment is left behind by a shutdown with full
queues or by a killed parent.
The reference's pool runs thread workers here (its spawned workers would
import JAX); its own tests hold its threads equal to its processes.
"""

import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest

from loader_factories import (CAPTION_KW, EndlessFactory, ExitingFactory,
                              MixedBatchFactory, PortCaptionFactory,
                              ProbeFactory, make_caption_tars, mixed_batch)
from mllm_npu_tpu.data.dataloader import \
    MultiProcessDataLoader as JMultiProcessDataLoader
from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.data.tasks.image_caption import \
    build_caption_datapipes_with_pixels as j_caption
from mllm_npu_tpu.utils.testing import FakeTokenizer as JTok
from mllm_npu_tpu_torch.data.dataloader import (DataLoader,
                                                MultiProcessDataLoader,
                                                make_dataloader)

WORKERS = 2


class _RefCaptionFactory:
    def __init__(self, root):
        self.root = str(root)

    def __call__(self, seed):
        return j_caption(self.root, tokenizer=JTok(),
                         image_transform=JProc(height=56, width=56),
                         cycle_count=1, seed=seed, **CAPTION_KW)


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    return make_caption_tars(tmp_path_factory.mktemp("caption_tars"))


def _drain(loader, n=None):
    """(batches, state after each) of ``loader``, shut down after."""
    out = []
    try:
        for b in loader:
            out.append((b, loader.state_dict()))
            if n is not None and len(out) == n:
                break
    finally:
        loader.shutdown()
    return out


def _assert_same(a: dict, b: dict, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], (where, k)


@pytest.fixture(scope="module")
def reference_run(tars):
    return _drain(JMultiProcessDataLoader(
        _RefCaptionFactory(tars), num_workers=WORKERS, prefetch=2, seed=5,
        mp_context="thread"))


@pytest.mark.parametrize("ctx", ["spawn", "thread"])
def test_pool_matches_reference(tars, reference_run, ctx):
    loader = MultiProcessDataLoader(PortCaptionFactory(tars),
                                    num_workers=WORKERS, prefetch=2, seed=5,
                                    mp_context=ctx)
    got = _drain(loader)
    assert loader.worker_kind == ctx
    assert len(got) == len(reference_run) >= 5
    for i, ((b, state), (rb, rstate)) in enumerate(zip(got, reference_run)):
        _assert_same(b, rb, f"batch {i}")
        assert state == rstate, i
    # both workers contributed, and the images vary in their grids
    assert all(w is not None for w in got[-1][1]["workers"])
    assert len({int(b["embeds_cmp_mask"].sum() + b["embeds_gen_mask"].sum())
                for b, _ in got}) > 1


def test_pool_resumes_mid_epoch_exactly(tars, reference_run):
    """A state taken after three batches, through JSON, gives a fresh pool
    the rest of the uninterrupted run."""
    first = _drain(MultiProcessDataLoader(
        PortCaptionFactory(tars), num_workers=WORKERS, prefetch=2, seed=5),
        n=3)
    state = json.loads(json.dumps(first[-1][1]))
    assert set(state) == {"steps", "epoch", "seed", "rr", "num_workers",
                          "workers"}
    resumed = MultiProcessDataLoader(PortCaptionFactory(tars),
                                     num_workers=WORKERS, prefetch=2)
    resumed.load_state_dict(state)
    rest = _drain(resumed)
    assert len(rest) == len(reference_run) - 3
    for i, ((b, s), (rb, rs)) in enumerate(zip(rest, reference_run[3:])):
        _assert_same(b, rb, f"resumed batch {i}")
        assert s == rs


def test_dead_worker_raises_within_seconds():
    loader = MultiProcessDataLoader(ExitingFactory(), num_workers=1,
                                    prefetch=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        next(iter(loader))
    assert time.monotonic() - t0 < 10


def test_unpicklable_factory_warns_and_matches(tars, reference_run, caplog):
    factory = PortCaptionFactory(tars)

    def closure(seed):          # not picklable: spawn cannot start it
        return factory(seed)

    loader = MultiProcessDataLoader(closure, num_workers=WORKERS,
                                    prefetch=2, seed=5)
    with caplog.at_level(logging.WARNING):
        got = _drain(loader)
    assert loader.worker_kind == "thread"
    assert any("not picklable" in r.message for r in caplog.records)
    assert len(got) == len(reference_run)
    for i, ((b, _), (rb, _)) in enumerate(zip(got, reference_run)):
        _assert_same(b, rb, f"batch {i}")


def test_spawned_worker_loads_no_jax_and_no_cuda():
    got = _drain(MultiProcessDataLoader(ProbeFactory(), num_workers=WORKERS,
                                        prefetch=1))
    assert len(got) == WORKERS
    assert len({b["pid"] for b, _ in got}) == WORKERS
    for b, _ in got:
        assert not b["jax"] and not b["reference"] and not b["cuda"], b


def test_mismatched_states_warn(caplog):
    pool = make_dataloader(ProbeFactory(), num_workers=3)
    assert isinstance(pool, MultiProcessDataLoader)
    single = make_dataloader(ProbeFactory(), num_workers=0)
    assert isinstance(single, DataLoader)
    with caplog.at_level(logging.WARNING):
        pool.load_state_dict({"steps": 4, "num_workers": 2, "rr": 4,
                              "workers": [{"a": 1}, {"a": 2}]})
    assert any("num_workers=3 but checkpoint used 2" in r.message
               for r in caplog.records)
    assert pool.state_dict()["workers"] == [{"a": 1}, {"a": 2}, None]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        single.load_state_dict(pool.state_dict())
        pool.load_state_dict({"steps": 1, "pipe": None})
    messages = [r.message for r in caplog.records]
    assert any("threaded DataLoader" in m and "per-worker" in m
               for m in messages)
    assert any("single-stream position" in m for m in messages)


def test_pool_carries_every_kind_of_value():
    """A spawned worker's batch reaches the parent with its keys in order,
    its arrays bit for bit in dtype and shape, and its other values
    equal."""
    got = _drain(MultiProcessDataLoader(MixedBatchFactory(3), num_workers=1,
                                        prefetch=2))
    assert len(got) == 3
    for i, (b, _) in enumerate(got):
        want = mixed_batch(i)
        assert list(b) == list(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert b[k].dtype == v.dtype and b[k].shape == v.shape, k
                np.testing.assert_array_equal(b[k], v)
            else:
                assert b[k] == v


def _segments():
    return set(Path("/dev/shm").glob("psm_*"))


def test_shutdown_with_full_queues_is_prompt():
    """Workers whose queues hold large unread batches exit on their own at
    shutdown, without writing them out, none is left to terminate, and
    their batches' shared-memory segments are gone."""
    before = _segments()
    loader = MultiProcessDataLoader(EndlessFactory(8 << 20), num_workers=2,
                                    prefetch=2)
    it = iter(loader)
    next(it)
    time.sleep(1.0)                      # the queues fill
    pools = _segments() - before         # (another test's may be among them)
    assert pools
    procs = list(loader._procs)
    t0 = time.monotonic()
    loader.shutdown()
    assert time.monotonic() - t0 < 5
    assert [p.exitcode for p in procs] == [0, 0]
    assert loader._procs == [] and loader._queues == []
    assert not pools & _segments()


def test_shared_memory_round_trip():
    """A worker's batch crosses as one /dev/shm segment: the parent's
    arrays equal the worker's bit for bit, the other values and the key
    order are kept, and the segment's name is gone once the parent has
    mapped it (or released an untaken one)."""
    from mllm_npu_tpu_torch.data import dataloader as dl
    batch = mixed_batch(0)
    item = dl._share(batch)
    assert isinstance(item, dl._Shared)
    path = Path(dl._SHM_DIR) / item.name
    assert path.exists()
    got = dl._unshare(item)
    assert not path.exists()
    assert list(got) == list(batch)
    assert got["names"] is batch["names"]        # objects stay inline
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v
    assert got["images"].flags.writeable
    untaken = dl._share(batch)
    assert dl._release(untaken.name) and not dl._release(untaken.name)
    assert not (Path(dl._SHM_DIR) / untaken.name).exists()
    assert dl._share({"text": "no arrays"}) == {"text": "no arrays"}


def test_killed_parent_leaves_no_segment(tmp_path):
    """When the process that runs the pool is killed, its workers notice,
    release their batches' segments and exit, and nothing of the pool is
    left in /dev/shm."""
    import signal
    import subprocess
    import sys
    script = tmp_path / "pool.py"
    script.write_text(
        "import sys, time\n"
        f"sys.path[:0] = [{str(Path(__file__).parent)!r}, "
        f"{str(Path(__file__).parent.parent)!r}]\n"
        "from loader_factories import EndlessFactory\n"
        "from mllm_npu_tpu_torch.data.dataloader import "
        "MultiProcessDataLoader\n"
        "if __name__ == '__main__':\n"
        "    it = iter(MultiProcessDataLoader(EndlessFactory(4 << 20), "
        "num_workers=2, prefetch=2))\n"
        "    next(it)\n"
        "    time.sleep(1.0)\n"
        "    print('ready', flush=True)\n"
        "    time.sleep(60)\n")
    before = _segments()
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        pools = _segments() - before     # (another test's may be among them)
        assert pools
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    deadline = time.monotonic() + 10
    while pools & _segments() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not pools & _segments()
