"""The port's OCR/conversation task (``data/tasks/ocr.py``) and its
``pretrain_data.yaml`` / ``sft_data.yaml`` mixtures against the JAX
package's.

Both read the same synthetic jsonl (records with one image of several
sizes, so the anyres tiling picks different grids; a text-only record; a
record without turns; one naming a missing image; a corrupt line) and
caption webdataset tars, with the same tokenizer, processor and seed, and
must yield array-for-array identical batches, the same resume states, and
the same batches after a resume (on the pattern of
``tests/test_torch_data.py``).
"""

import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mllm_npu_tpu.configs import load_config as j_load_config
from mllm_npu_tpu.data.datapipes import build_multi_datapipes as j_multi
from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.data.tasks.ocr import build_ocr_datapipes_caption as j_ocr
from mllm_npu_tpu.data.tasks.ocr import \
    decode_llava_data_caption as j_decode
from mllm_npu_tpu.utils.testing import FakeTokenizer as JTok
from mllm_npu_tpu_torch.configs import load_config
from mllm_npu_tpu_torch.data.datapipes import build_multi_datapipes
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.data.tasks.ocr import (build_ocr_datapipes_caption,
                                               decode_llava_data_caption)
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer

SIZES = [(500, 500), (900, 460), (460, 1000), (1400, 470), (700, 700)]


def _image(path: Path, i: int, size) -> None:
    rs = np.random.RandomState(i)
    Image.fromarray((rs.rand(size[1], size[0], 3) * 255).astype(np.uint8)
                    ).save(path, format="JPEG")


def make_ocr_data(root: Path, n: int = 9, files: int = 2) -> tuple:
    """``root/jsonl/*.jsonl`` over ``root/images/``: two- and four-turn
    conversations with an image, and in the first file a text-only record,
    a record without turns, one naming a missing image and a corrupt
    line. Returns (jsonl dir, image dir)."""
    jdir, idir = root / "jsonl", root / "images"
    jdir.mkdir(parents=True)
    idir.mkdir(parents=True)
    k = 0
    for f in range(files):
        lines = []
        for i in range(n):
            name = f"img{k:03d}.jpg"
            _image(idir / name, k, SIZES[k % len(SIZES)])
            turns = [f"what is written in picture {k}",
                     f"the sign says word{k} and more{k}"]
            if k % 3 == 0:
                turns += [f"and below {k}", f"a second line {k}"]
            lines.append(json.dumps({"image": name, "data": turns}))
            k += 1
        if f == 0:
            lines += [json.dumps({"data": ["hello there", "general text"]}),
                      json.dumps({"image": "img000.jpg"}),
                      json.dumps({"image": "missing.jpg",
                                  "data": ["q", "a"]}),
                      "{not json",
                      ""]
        (jdir / f"part-{f:03d}.jsonl").write_text("\n".join(lines) + "\n")
    return jdir, idir


def _jpeg_bytes(i, size):
    rs = np.random.RandomState(100 + i)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(size[1], size[0], 3) * 255).astype(np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def make_caption_tars(root: Path, n_tars: int = 2, n: int = 6) -> Path:
    """Caption tars: a ``.txt`` caption (the SFT entry's), a JPEG and a
    ``.json`` with a caption (the LAION-COCO entry's) and a similarity
    above both entries' thresholds."""
    root.mkdir(parents=True)
    for t in range(n_tars):
        with tarfile.open(root / f"shard-{t:03d}.tar", "w") as tar:
            for i in range(t * n, (t + 1) * n):
                meta = {"similarity": 0.9, "caption": f"a photo of {i}"}
                for ext, data in ((".txt", f"thing {i}".encode()),
                                  (".jpg", _jpeg_bytes(i, SIZES[i % 5])),
                                  (".json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(f"sample{i:04d}{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    return root


def _assert_same(a: dict, b: dict, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], (where, k)


@pytest.fixture
def ocr_data(tmp_path):
    return make_ocr_data(tmp_path)


def _kw(jdir, idir, **over):
    kw = dict(data_dir=str(jdir), image_dir=str(idir), max_length=300,
              batch_size=2, num_img_in_tokens=8, num_img_out_tokens=8,
              cycle_count=2, multi_resolution=True,
              resolution_grids=["1x1", "1x2", "1x3", "2x1", "3x1"],
              base_resolution=448, dataset_name="llavar-ocr",
              shard_for_host=False, seed=5)
    kw.update(over)
    return kw


def _pipes(ocr_data, **over):
    kw = _kw(*ocr_data, **over)
    return (j_ocr(tokenizer=JTok(), image_transform=JProc(56, 56), **kw),
            build_ocr_datapipes_caption(
                tokenizer=FakeTokenizer(),
                image_transform=ImageProcessor(56, 56), **kw))


@pytest.mark.parametrize("over", [
    {}, {"caption_prompt": "Read the text. "},
    {"multi_resolution": False, "batch_size": 3},
    {"max_length": 40},
], ids=["anyres", "prompt", "single_view", "cut"])
def test_ocr_batches_identical(ocr_data, over):
    jp, tp = _pipes(ocr_data, **over)
    jb, tb = list(jp), list(tp)
    assert len(jb) == len(tb) and len(jb) >= 2
    for i, (a, b) in enumerate(zip(jb, tb)):
        _assert_same(a, b, f"batch {i}")
    assert jp.state_dict() == tp.state_dict()


def test_ocr_samples_identical(ocr_data):
    """Per record (no batching), the text included: every record of the
    first file, the dropped ones too (both return ``{}``)."""
    jdir, idir = ocr_data
    grids = [[448, 448], [448, 896], [896, 448], [448, 1344], [1344, 448]]
    kw = dict(max_length=300, num_img_in_tokens=8, multi_resolution=True,
              grid_pinpoints=grids, base_resolution=448)
    n = 0
    for line in (jdir / "part-000.jsonl").read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        a = j_decode(rec, str(idir), JTok(), image_transform=JProc(56, 56),
                     **kw)
        b = decode_llava_data_caption(rec, str(idir), FakeTokenizer(),
                                      image_transform=ImageProcessor(56, 56),
                                      **kw)
        _assert_same(a, b, line[:40])
        n += bool(b)
    assert n == 10       # 9 image records and the text-only one


def test_ocr_resume_state_and_sequence(ocr_data):
    jp, tp = _pipes(ocr_data)
    full = list(_pipes(ocr_data)[1])
    jit, tit = iter(jp), iter(tp)
    for _ in range(3):
        _assert_same(next(jit), next(tit))
    state = tp.state_dict()
    assert state == jp.state_dict()
    rest_pipe = _pipes(ocr_data)[1]
    rest_pipe.load_state_dict(json.loads(json.dumps(state)))
    rest = list(rest_pipe)
    assert len(rest) == len(full) - 3
    for i, (a, b) in enumerate(zip(rest, full[3:])):
        _assert_same(a, b, f"resumed batch {i}")


def _mixture(cfg: dict, over: dict) -> dict:
    """The YAML's mixture with each entry's keys from ``over`` (by entry
    index) replaced."""
    out = dict(cfg)
    out["datapipes"] = [dict(node, **over.get(i, {}))
                        for i, node in enumerate(cfg["datapipes"])]
    return out


@pytest.mark.parametrize("name", ["pretrain_data.yaml", "sft_data.yaml"])
def test_mixture_yaml_matches_reference(tmp_path, name):
    """The port's YAML is the JAX package's with the port's builders: the
    same values, entry for entry; pointed at seeded data (its batch sizes
    and lengths cut), its mixture yields the reference mixture's batches
    and state."""
    jcfg = j_load_config(f"mllm_npu_tpu/configs/dataset/{name}")
    tcfg = load_config(f"mllm_npu_tpu_torch/configs/dataset/{name}")
    assert tcfg["sample_weights"] == jcfg["sample_weights"]
    assert len(tcfg["datapipes"]) == len(jcfg["datapipes"])
    for j, t in zip(jcfg["datapipes"], tcfg["datapipes"]):
        assert t["_target_"] == j["_target_"].replace(
            "mllm_npu_tpu.", "mllm_npu_tpu_torch.")
        assert {k: v for k, v in t.items() if k != "_target_"} == \
            {k: v for k, v in j.items() if k != "_target_"}

    jdir, idir = make_ocr_data(tmp_path / "ocr")
    tars = make_caption_tars(tmp_path / "tars")
    over = {}
    for i, node in enumerate(tcfg["datapipes"]):
        cut = dict(batch_size=2, max_length=300, num_img_in_tokens=8,
                   num_img_out_tokens=8, cycle_count=1,
                   shard_for_host=False)
        if node["_target_"].endswith("build_ocr_datapipes_caption"):
            cut.update(data_dir=str(jdir), image_dir=str(idir))
        else:
            cut.update(data_dir=[str(tars)], min_resolution=400)
        over[i] = cut
    jm = _mixture(jcfg, over)
    tm = _mixture(tcfg, over)
    jp = j_multi(jm["datapipes"], tokenizer=JTok(),
                 image_transform=JProc(56, 56),
                 sample_weights=jm["sample_weights"], seed=3)
    tp = build_multi_datapipes(tm["datapipes"], tokenizer=FakeTokenizer(),
                               image_transform=ImageProcessor(56, 56),
                               sample_weights=tm["sample_weights"], seed=3)
    jb, tb = list(jp), list(tp)
    assert len(jb) == len(tb) and len(tb) >= 4
    names = {str(b["dataset_name"]) for b in tb}
    assert len(names) == 2, names       # both entries ran
    for i, (a, b) in enumerate(zip(jb, tb)):
        _assert_same(a, b, f"batch {i}")
    assert jp.state_dict() == tp.state_dict()
