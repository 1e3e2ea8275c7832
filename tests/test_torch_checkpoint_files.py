"""The port's checkpoint files: its safetensors reader and writer against
the ``safetensors`` package, both ways, in every dtype the reference's
checkpoints hold; the memory-mapped read; the sharded writer; the
reference's directory rule (``_load_hf_dir_or_file``); the converter's
directory layout."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import safetensors.torch as st
import torch
from safetensors import safe_open

from mllm_npu_tpu_torch.utils import checkpoint_files as cf

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
          "I64": torch.int64}


def _tensors(dtype, seed=0):
    """Tensors of ``dtype`` of several shapes (a scalar, an empty one, odd
    lengths), beside tensors of other widths that shift the offsets."""
    g = torch.Generator().manual_seed(seed)

    def make(shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g).to(dtype)
        info = torch.iinfo(dtype)
        return torch.randint(max(info.min, -1000), min(info.max, 1000),
                             shape, generator=g, dtype=torch.int64).to(dtype)
    return {"w": make((5, 3)), "b": make((7,)), "s": make(()),
            "e": make((0, 4)), "x": make((2, 3, 4)),
            "odd_i8": torch.arange(3, dtype=torch.int8),
            "f32": torch.randn(3, generator=g)}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_writer_reads_in_safetensors(tmp_path, name):
    t = _tensors(DTYPES[name])
    cf.save_safetensors(t, tmp_path / "a.safetensors", {"format": "pt"})
    _assert_same(st.load_file(tmp_path / "a.safetensors"), t)
    with safe_open(str(tmp_path / "a.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_writer_reads_in_port(tmp_path, name):
    t = _tensors(DTYPES[name], seed=1)
    st.save_file(t, tmp_path / "b.safetensors", metadata={"k": "v"})
    _assert_same(cf.load_safetensors(tmp_path / "b.safetensors"), t)
    _, meta, _ = cf.read_safetensors_header(tmp_path / "b.safetensors")
    assert meta == {"k": "v"}


def test_reader_maps_the_file(tmp_path):
    """The tensors view one private mapping of the file: their addresses
    are the file's offsets apart, nothing is copied, and a write to a
    tensor never reaches the file."""
    t = {f"t{i}": torch.randn(1000 + i) for i in range(4)}
    path = tmp_path / "m.safetensors"
    cf.save_safetensors(t, path)
    header, _, start = cf.read_safetensors_header(path)
    got = cf.load_safetensors(path)
    base = got["t0"].data_ptr() - header["t0"]["data_offsets"][0]
    for k, v in got.items():
        assert v.data_ptr() - base == header[k]["data_offsets"][0]
    before = path.read_bytes()
    got["t1"].zero_()
    assert path.read_bytes() == before
    _assert_same(cf.load_safetensors(path), t)


def test_sharded_writer_and_the_reference_directory_rule(tmp_path):
    t = {f"layer{i}.weight": torch.randn(64, 64) for i in range(5)}
    index = cf.save_sharded(t, tmp_path / "d", max_shard_bytes=40_000)
    files = sorted(p.name for p in (tmp_path / "d").glob("*.safetensors"))
    assert files == [f"model-0000{i}-of-00003.safetensors"
                     for i in (1, 2, 3)]
    saved = json.loads((tmp_path / "d" / cf.INDEX_NAME).read_text())
    assert saved == index and index["metadata"]["total_size"] == 5 * 64 * 64 * 4
    assert set(index["weight_map"]) == set(t)
    _assert_same(cf.load_hf_dir_or_file(tmp_path / "d"), t)
    # a .bin (or .pt) beside the shards is read instead of them, as the
    # reference's _load_hf_dir_or_file does
    torch.save({"only": torch.ones(2)}, tmp_path / "d" / "pytorch_model.bin")
    assert list(cf.load_hf_dir_or_file(tmp_path / "d")) == ["only"]
    (tmp_path / "d" / "pytorch_model.bin").unlink()
    torch.save({"pt": torch.ones(1)}, tmp_path / "d" / "x.pt")
    assert list(cf.load_hf_dir_or_file(tmp_path / "d")) == ["pt"]
    # a file is read as it is; an empty directory raises
    assert list(cf.load_hf_dir_or_file(tmp_path / "d" / "x.pt")) == ["pt"]
    (tmp_path / "e").mkdir()
    with pytest.raises(FileNotFoundError, match="no weights found"):
        cf.load_hf_dir_or_file(tmp_path / "e")


def test_converted_directory_rules(tmp_path):
    for step in (3, 10):
        cf.save_sharded({"w": torch.full((2,), float(step))},
                        tmp_path / "c" / f"checkpoint-{step}")
    assert cf.converted_dir(tmp_path / "c").name == "checkpoint-10"
    assert cf.converted_state(tmp_path / "c", step=3)["w"][0] == 3.0
    assert cf.converted_dir(tmp_path / "c" / "checkpoint-3").name == \
        "checkpoint-3"
    with pytest.raises(FileNotFoundError, match="no converted checkpoint"):
        cf.converted_dir(tmp_path / "c", step=7)
    with pytest.raises(FileNotFoundError):
        cf.converted_dir(tmp_path / "missing")
    orbax = tmp_path / "o" / "checkpoint_0" / "default"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="item 16"):
        cf.converted_state(tmp_path / "o")


def test_legacy_torch_file_loads(tmp_path):
    t = {"a": torch.randn(3, 2), "b": torch.arange(4)}
    torch.save(t, tmp_path / "new.bin")
    torch.save(t, tmp_path / "old.bin", _use_new_zipfile_serialization=False)
    for name in ("new.bin", "old.bin"):
        _assert_same(cf.load_torch_file(tmp_path / name), t)


def test_new_modules_import_none_of_the_optional_packages():
    """The readers, the converters and the tool import neither
    ``safetensors`` nor ``transformers`` (the machine with the card has
    neither), nor JAX or the JAX package."""
    code = (
        "import sys\n"
        "import mllm_npu_tpu_torch.utils.checkpoint_files\n"
        "import mllm_npu_tpu_torch.utils.convert\n"
        "import mllm_npu_tpu_torch.tools.convert_checkpoint\n"
        "import mllm_npu_tpu_torch.models.factory\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'mllm_npu_tpu', 'safetensors', 'transformers'))\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
