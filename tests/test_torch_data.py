"""The port's caption data pipeline against the JAX package's.

Both read the same synthetic webdataset tars (JPEGs of several sizes, so
the anyres tiling picks different grids, captions as ``.txt`` or in the
``.json`` metadata, a corrupt shard) with the same tokenizer, processor and
seed, and must yield array-for-array identical batches, the same resume
states, and the same batches after a resume
(``tests/test_data_pipeline.py:84``, ``tests/test_data_resume.py:102,165``).
"""

import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mllm_npu_tpu.data.dataloader import DataLoader as JLoader
from mllm_npu_tpu.data.datapipes import build_multi_datapipes as j_multi
from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.data.tasks.image_caption import (
    build_caption_datapipes_with_pixels as j_caption)
from mllm_npu_tpu.data.utils import collate_static as j_collate
from mllm_npu_tpu.data.utils import pack_samples as j_pack
from mllm_npu_tpu.utils.testing import FakeTokenizer as JTok
from mllm_npu_tpu_torch.data.dataloader import DataLoader, make_dataloader
from mllm_npu_tpu_torch.data.datapipes import build_multi_datapipes
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.data.tasks.image_caption import (
    build_caption_datapipes_with_pixels)
from mllm_npu_tpu_torch.data.utils import collate_static, pack_samples
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer

SIZES = [(500, 500), (900, 460), (460, 1000), (1400, 470), (700, 700)]


def _jpeg(i, size):
    rs = np.random.RandomState(i)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(size[1], size[0], 3) * 255).astype(np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def _make_tar(path: Path, start=0, n=6, caption_in_meta=False):
    with tarfile.open(path, "w") as tar:
        for i in range(start, start + n):
            meta = {"similarity": 0.9 if i % 5 else 0.05,
                    "caption": f"metadata caption {i}"}
            items = [(".jpg", _jpeg(i, SIZES[i % len(SIZES)])),
                     (".json", json.dumps(meta).encode())]
            if not caption_in_meta:
                items.insert(0, (".txt", f"a photo of thing {i}".encode()))
            for ext, data in items:
                info = tarfile.TarInfo(f"sample{i:04d}{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


def _kw(data_dir, **over):
    kw = dict(data_dir=str(data_dir), max_length=160, batch_size=2,
              similarity_thr=0.1, min_resolution=400, min_aspect_ratio=0.1,
              img_first_ratio=0.5, num_img_in_tokens=8, num_img_out_tokens=8,
              cycle_count=2, multi_resolution=True,
              resolution_grids=["1x1", "1x2", "2x1", "1x3", "2x2"],
              base_resolution=448, dataset_name="test", shard_for_host=False,
              seed=7)
    kw.update(over)
    return kw


def _pipes(data_dir, **over):
    kw = _kw(data_dir, **over)
    return (j_caption(tokenizer=JTok(), image_transform=JProc(56, 56), **kw),
            build_caption_datapipes_with_pixels(
                tokenizer=FakeTokenizer(),
                image_transform=ImageProcessor(56, 56), **kw))


def _assert_same(a: dict, b: dict, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], (where, k)


@pytest.fixture
def shards(tmp_path):
    _make_tar(tmp_path / "shard-000.tar", 0)
    _make_tar(tmp_path / "shard-001.tar", 6, caption_in_meta=True)
    (tmp_path / "shard-002.tar").write_bytes(b"not a tar")   # skipped
    return tmp_path


@pytest.mark.parametrize("over", [
    {}, {"use_caption_in_metadata": True, "caption_key_in_metadata":
         "caption"},
    {"img_first_ratio": 1.0, "packing": True, "batch_size": 4},
    {"add_gen_prompt": True, "img_first_ratio": 0.0},
], ids=["txt", "meta_caption", "packed", "gen_prompt"])
def test_caption_batches_identical(shards, over):
    jp, tp = _pipes(shards, **over)
    jb, tb = list(jp), list(tp)
    assert len(jb) == len(tb) and len(jb) >= 2
    for i, (a, b) in enumerate(zip(jb, tb)):
        _assert_same(a, b, f"batch {i}")
    assert jp.state_dict() == tp.state_dict()


def test_caption_resume_state_and_sequence(shards):
    """A state taken after three batches is the reference's, and a fresh
    pipe restored from it yields the rest of the sequence."""
    jp, tp = _pipes(shards)
    full = list(_pipes(shards)[1])
    jit, tit = iter(jp), iter(tp)
    for _ in range(3):
        _assert_same(next(jit), next(tit))
    state = tp.state_dict()
    assert state == jp.state_dict()
    rest_pipe = _pipes(shards)[1]
    rest_pipe.load_state_dict(json.loads(json.dumps(state)))
    rest = list(rest_pipe)
    assert len(rest) == len(full) - 3
    for i, (a, b) in enumerate(zip(rest, full[3:])):
        _assert_same(a, b, f"resumed batch {i}")


def test_mixture_and_loader_match_reference(shards):
    """``build_multi_datapipes`` → the threaded ``DataLoader``: the same
    batches and loader state as the reference's, and an exact resume
    through the prefetch queue."""
    node = {"_target_": None, **_kw(shards)}
    node.pop("seed")
    jnode = dict(node, _target_="mllm_npu_tpu.data.tasks.image_caption."
                 "build_caption_datapipes_with_pixels")
    tnode = dict(node, _target_="mllm_npu_tpu_torch.data.tasks."
                 "image_caption.build_caption_datapipes_with_pixels")

    def jf(seed):
        return j_multi([jnode], tokenizer=JTok(),
                       image_transform=JProc(56, 56), seed=seed)

    def tf(seed):
        return build_multi_datapipes([tnode], tokenizer=FakeTokenizer(),
                                     image_transform=ImageProcessor(56, 56),
                                     seed=seed)

    jl, tl = JLoader(jf, prefetch=2), make_dataloader(tf, prefetch=2)
    assert isinstance(tl, DataLoader)
    jit, tit = iter(jl), iter(tl)
    for i in range(3):
        _assert_same(next(jit), next(tit), f"batch {i}")
    state = tl.state_dict()
    assert state == jl.state_dict()
    expect = list(jit)
    resumed = DataLoader(tf, prefetch=2)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    got = list(iter(resumed))
    assert len(got) == len(expect)
    for i, (a, b) in enumerate(zip(got, expect)):
        _assert_same(b, a, f"resumed batch {i}")
    # the epoch reseed is the reference's (seed = resume_steps + epoch + 42)
    tl.next_epoch(resume_steps=5)
    jl.next_epoch(resume_steps=5)
    keys = ("epoch", "seed", "pipe")
    assert [tl.state_dict()[k] for k in keys] == \
        [jl.state_dict()[k] for k in keys]


def test_collates_match_reference():
    rs = np.random.RandomState(0)
    samples = []
    for i in range(5):
        L = int(rs.randint(10, 20))
        n = int(rs.randint(1, 3))
        samples.append({
            "input_ids": rs.randint(3, 100, (L,)).astype(np.int32),
            "attention_mask": np.ones((L,), np.int32),
            "labels": rs.randint(3, 100, (L,)).astype(np.int32),
            "ids_cmp_mask": rs.rand(L) < 0.3,
            "ids_gen_mask": np.zeros((L,), bool),
            "images": rs.randn(n, 8, 8, 3).astype(np.float32),
            "embeds_cmp_mask": np.ones((n,), bool),
            "embeds_gen_mask": np.zeros((n,), bool),
            "patch_position": rs.rand(n, 2).astype(np.float32)})
    kw = dict(max_length=24, max_images=12, image_size=8)
    _assert_same(j_collate(samples, pad_token_id=0, **kw),
                 collate_static(samples, pad_token_id=0, **kw))
    _assert_same(j_pack(samples, max_rows=3, **kw),
                 pack_samples(samples, max_rows=3, **kw))


def test_multiprocess_loader_is_refused():
    with pytest.raises(NotImplementedError):
        make_dataloader(lambda seed: [], num_workers=2)
