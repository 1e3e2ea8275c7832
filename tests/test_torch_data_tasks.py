"""The port's pure-text and interleaved image-text tasks
(``data/tasks/pure_text.py``, ``data/tasks/interleaved_image_text.py``)
against the JAX package's.

Both read the same synthetic data, built as ``tests/test_data_pipeline.py``
builds its (jsonl ``{"text"}`` lines with a bad line; tars of pickled
``{"images": [b64 | None], "texts": [str | None]}`` records), richer here:
several files, records of several images of several sizes, a record with
a mismatched slot and one with a corrupt image, so the filters, the
comprehension / generation coin flips, the anyres grids and the max-length
cut all take both branches. With the same tokenizer, processor and seed,
every batch array must be equal, with the same resume state after each
batch; and the three tasks mixed through ``build_multi_datapipes`` from a
dataset YAML's ``_target_`` nodes as the trainer builds them.
"""

import base64
import io
import json
import pickle
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mllm_npu_tpu.data.datapipes import build_multi_datapipes as j_multi
from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.data.tasks.interleaved_image_text import \
    build_interleave_datapipes_with_pixels as j_interleave
from mllm_npu_tpu.data.tasks.pure_text import build_text_datapipes as j_text
from mllm_npu_tpu.utils.testing import FakeTokenizer as JTok
from mllm_npu_tpu_torch.data.data_utils import base64_to_image
from mllm_npu_tpu_torch.data.datapipes import build_multi_datapipes
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.data.tasks.interleaved_image_text import \
    build_interleave_datapipes_with_pixels
from mllm_npu_tpu_torch.data.tasks.pure_text import build_text_datapipes
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer

SIZES = [(500, 500), (900, 460), (460, 900), (700, 700)]
WORDS = "the a cat dog sat on mat under blue sky river tree".split()


def _jpeg_b64(i: int) -> str:
    rs = np.random.RandomState(i)
    w, h = SIZES[i % len(SIZES)]
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def _text(rs, lo=3, hi=30) -> str:
    return " ".join(rs.choice(WORDS, int(rs.randint(lo, hi))))


def make_text_data(root: Path, files: int = 2, n: int = 10) -> Path:
    root.mkdir(parents=True)
    rs = np.random.RandomState(0)
    for f in range(files):
        lines = [json.dumps({"text": _text(rs, 2, 60)}) for _ in range(n)]
        lines += ["not json", json.dumps({"text": " ;,. "}),
                  json.dumps({"other": 1})]
        (root / f"part-{f}.jsonl").write_text("\n".join(lines) + "\n")
    return root


def make_interleaved_data(root: Path, tars: int = 2, n: int = 6) -> Path:
    root.mkdir(parents=True)
    rs = np.random.RandomState(1)
    k = 0
    for t in range(tars):
        with tarfile.open(root / f"inter-{t}.tar", "w") as tar:
            for i in range(n):
                images, texts = [], []
                for _ in range(int(rs.randint(1, 4))):
                    images += [_jpeg_b64(k), None]
                    texts += [None, _text(rs)]
                    k += 1
                if i == 2:           # an image and a text in one slot
                    images[0], texts[0] = images[0], "both"
                if i == 4:           # an image that does not decode
                    images[0] = base64.b64encode(b"not a jpeg").decode()
                data = pickle.dumps({"images": images, "texts": texts})
                info = tarfile.TarInfo(f"{t}_{i:03d}.pkl")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
                meta = b"{}"         # a member the task skips
                info = tarfile.TarInfo(f"{t}_{i:03d}.json")
                info.size = len(meta)
                tar.addfile(info, io.BytesIO(meta))
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tasks")
    return (make_text_data(root / "text"),
            make_interleaved_data(root / "interleaved"))


def _assert_same(a: dict, b: dict, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], (where, k)


def _run(pipe, limit=40):
    out = []
    for b in pipe:
        out.append((b, json.loads(json.dumps(pipe.state_dict()))))
        if len(out) == limit:
            break
    return out


def _same_runs(got, want):
    assert len(got) == len(want) > 0
    for i, ((b, s), (rb, rs)) in enumerate(zip(got, want)):
        _assert_same(b, rb, f"batch {i}")
        assert s == rs, i


@pytest.mark.parametrize("max_length", [32, 8])
def test_pure_text_batches_identical(data, max_length):
    text_dir, _ = data
    kw = dict(max_length=max_length, batch_size=3, cycle_count=2,
              dataset_name="text", seed=11, shard_for_host=False)
    got = _run(build_text_datapipes(str(text_dir), tokenizer=FakeTokenizer(),
                                    **kw))
    want = _run(j_text(str(text_dir), tokenizer=JTok(), **kw))
    _same_runs(got, want)
    b = got[0][0]
    assert b["input_ids"].shape == (3, max_length)
    assert not b["embeds_cmp_mask"].any() and not b["ids_cmp_mask"].any()


@pytest.mark.parametrize("over", [
    dict(img_first_ratio=0.5, multi_resolution=False,
         max_images_per_batch=6),
    dict(img_first_ratio=0.5, multi_resolution=True,
         resolution_grids=["1x1", "1x2", "2x1"], base_resolution=56),
    dict(img_first_ratio=1.0, multi_resolution=True,
         resolution_grids=["1x1", "2x2"], base_resolution=56,
         max_length=80),
], ids=["single", "anyres", "anyres_cut"])
def test_interleaved_batches_identical(data, over):
    _, inter_dir = data
    kw = dict(max_length=160, batch_size=2, num_img_in_tokens=4,
              num_img_out_tokens=4, cycle_count=2, dataset_name="inter",
              seed=3, shard_for_host=False)
    kw.update(over)
    got = _run(build_interleave_datapipes_with_pixels(
        str(inter_dir), tokenizer=FakeTokenizer(),
        image_transform=ImageProcessor(height=56, width=56), **kw))
    want = _run(j_interleave(
        str(inter_dir), tokenizer=JTok(),
        image_transform=JProc(height=56, width=56), **kw))
    _same_runs(got, want)
    masks = np.stack([b["embeds_cmp_mask"].sum() + b["embeds_gen_mask"].sum()
                      for b, _ in got])
    assert masks.min() > 0
    if over["img_first_ratio"] < 1:
        assert any(b["embeds_gen_mask"].any() for b, _ in got)


def test_base64_to_image():
    img = base64_to_image(_jpeg_b64(1))
    assert img.mode == "RGB" and img.size == SIZES[1]


def test_three_task_mixture_identical(data, tmp_path):
    """Caption, interleaved and pure text (1.0 : 0.5 : 0.5) from the
    ``_target_`` nodes of a dataset YAML, as the trainer's ``PipeFactory``
    builds them: the same batches, dataset names and states."""
    from loader_factories import make_caption_tars
    text_dir, inter_dir = data
    cap_dir = make_caption_tars(tmp_path / "caption", n_tars=2, n=4)
    common = dict(max_length=96, batch_size=2, cycle_count=3,
                  shard_for_host=False)
    nodes = [
        dict(_target_="{pkg}.data.tasks.image_caption."
                      "build_caption_datapipes_with_pixels",
             data_dir=str(cap_dir), similarity_thr=0.2, min_resolution=100,
             num_img_in_tokens=4, num_img_out_tokens=4, img_first_ratio=0.5,
             dataset_name="caption", **common),
        dict(_target_="{pkg}.data.tasks.interleaved_image_text."
                      "build_interleave_datapipes_with_pixels",
             data_dir=str(inter_dir), num_img_in_tokens=4,
             num_img_out_tokens=4, img_first_ratio=0.5,
             max_images_per_batch=6, dataset_name="interleaved", **common),
        dict(_target_="{pkg}.data.tasks.pure_text.build_text_datapipes",
             data_dir=str(text_dir), dataset_name="text", **common),
    ]

    def for_pkg(pkg):
        return [dict(n, _target_=n["_target_"].format(pkg=pkg))
                for n in nodes]
    weights = [1.0, 0.5, 0.5]
    got = _run(build_multi_datapipes(
        for_pkg("mllm_npu_tpu_torch"), tokenizer=FakeTokenizer(),
        image_transform=ImageProcessor(height=56, width=56),
        sample_weights=weights, seed=7), limit=30)
    want = _run(j_multi(
        for_pkg("mllm_npu_tpu"), tokenizer=JTok(),
        image_transform=JProc(height=56, width=56),
        sample_weights=weights, seed=7), limit=30)
    _same_runs(got, want)
    names = {b["dataset_name"] for b, _ in got}
    assert names == {"caption", "interleaved", "text"}
    for b, _ in got:
        if b["dataset_name"] == "text":
            assert not b["embeds_cmp_mask"].any()
            assert not b["embeds_gen_mask"].any()
