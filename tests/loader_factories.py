"""Picklable pipe factories for ``tests/test_torch_dataloader.py``.

A spawned loader worker imports the module of the factory it runs, so this
module imports nothing of JAX, of the JAX package or of torch: what a
worker has loaded is what the port's data layer loads.
"""

import io
import json
import os
import sys
import tarfile
from pathlib import Path

import numpy as np
from PIL import Image

SIZES = [(500, 500), (900, 620), (620, 900), (700, 700), (1000, 680)]


def make_caption_tars(root: Path, n_tars: int = 3, n: int = 6) -> Path:
    """``n_tars`` webdataset tars of ``n`` seeded JPEGs each (sizes that
    give different anyres grids), a caption and a similarity above the
    threshold."""
    root.mkdir(parents=True, exist_ok=True)
    for t in range(n_tars):
        with tarfile.open(root / f"shard-{t:03d}.tar", "w") as tar:
            for i in range(t * n, (t + 1) * n):
                rs = np.random.RandomState(i)
                w, h = SIZES[i % len(SIZES)]
                buf = io.BytesIO()
                Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)
                                ).save(buf, format="JPEG")
                meta = {"similarity": 0.9}
                for ext, data in ((".txt", f"a photo of thing {i}".encode()),
                                  (".jpg", buf.getvalue()),
                                  (".json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(f"sample{i:04d}{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    return root


CAPTION_KW = dict(max_length=96, batch_size=2, similarity_thr=0.2,
                  min_resolution=100, num_img_in_tokens=4,
                  num_img_out_tokens=4, img_first_ratio=0.5,
                  multi_resolution=True, resolution_grids=["1x1", "1x2",
                                                           "2x1"],
                  base_resolution=448, dataset_name="caption")


class PortCaptionFactory:
    """seed → the port's caption pipeline over ``root``, sharded by file
    across hosts and workers."""

    def __init__(self, root, cycle_count=1):
        self.root = str(root)
        self.cycle_count = cycle_count

    def __call__(self, seed):
        from mllm_npu_tpu_torch.data.processor import ImageProcessor
        from mllm_npu_tpu_torch.data.tasks.image_caption import (
            build_caption_datapipes_with_pixels)
        from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
        return build_caption_datapipes_with_pixels(
            self.root, tokenizer=FakeTokenizer(),
            image_transform=ImageProcessor(height=56, width=56),
            cycle_count=self.cycle_count, seed=seed, **CAPTION_KW)


class ExitingFactory:
    """Kills its worker process mid-iteration with no exception (as a
    worker killed for memory does)."""

    def __call__(self, seed):
        def gen():
            os._exit(9)
            yield  # pragma: no cover
        return gen()


class ProbeFactory:
    """One batch that says what its worker process has loaded."""

    def __call__(self, seed):
        torch = sys.modules.get("torch")
        return [{
            "pid": os.getpid(),
            "jax": "jax" in sys.modules,
            "reference": any(m == "mllm_npu_tpu"
                             or m.startswith("mllm_npu_tpu.")
                             for m in sys.modules),
            "torch": torch is not None,
            "cuda": bool(torch is not None and torch.cuda.is_initialized()),
        }]


def mixed_batch(i: int) -> dict:
    """A batch with every kind of value the pipelines yield: integer, float
    and boolean arrays, an empty array, an object array and a string."""
    rs = np.random.RandomState(i)
    return {"input_ids": rs.randint(0, 9, (3, 7)).astype(np.int32),
            "dataset_name": "caption",
            "images": rs.randn(2, 5, 5, 3).astype(np.float32),
            "empty": np.zeros((0, 2), np.float32),
            "names": np.array(["a", None], object),
            "mask": rs.rand(3, 7) > 0.5}


class MixedBatchFactory:
    """``n`` batches of ``mixed_batch``."""

    def __init__(self, n):
        self.n = n

    def __call__(self, seed):
        return [mixed_batch(i) for i in range(self.n)]


class EndlessFactory:
    """Batches of ``nbytes`` each, without end: a worker always has one
    waiting in its queue."""

    def __init__(self, nbytes):
        self.nbytes = nbytes

    def __call__(self, seed):
        def gen():
            while True:
                yield {"images": np.ones(self.nbytes, np.uint8)}
        return gen()
