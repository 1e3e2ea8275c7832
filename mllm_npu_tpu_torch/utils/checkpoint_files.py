"""Checkpoint files: the safetensors format, ``torch.load`` files and the
reference's directory rule (twins of ``mllm_npu_tpu/utils/weights.py:36
load_torch_file`` and ``mllm_npu_tpu/models/factory.py:99
_load_hf_dir_or_file``).

The safetensors reader and writer are the port's own (the format is an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw bytes), so the port needs no
``safetensors`` package. :func:`load_safetensors` maps the file into
memory and returns tensors that view the mapping: a 5 GB shard is read
from the page cache when its tensors are copied to the device, and never
copied whole on the host first.

:func:`save_sharded` writes a state dict as HF-style shards
(``model-00001-of-00004.safetensors`` and ``model.safetensors.index.json``)
of at most ``max_shard_bytes`` each, one tensor at a time, so tensors on
the GPU reach the disk without a second host copy of the model. The
converter (``utils/convert.py``) writes such shards under
``checkpoint-{step}/``, which :func:`converted_state` reads back.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
from pathlib import Path
from typing import Dict, Optional

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
          "F8_E5M2": torch.float8_e5m2}
NAMES = {v: k for k, v in DTYPES.items()}
MAX_SHARD_BYTES = 5 * 10 ** 9
INDEX_NAME = "model.safetensors.index.json"


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 CPU tensor (one copy off a GPU)."""
    t = t.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)


def save_safetensors(tensors: Dict[str, torch.Tensor], path,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` to ``path`` in the safetensors format; returns the
    bytes of tensor data written. Tensors go widest element first (as the
    ``safetensors`` package orders them), so each starts aligned to its
    element size after the 8-byte-aligned header."""
    names = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for n in names:
        t = tensors[n]
        if t.dtype not in NAMES:
            raise ValueError(f"{n}: dtype {t.dtype} has no safetensors name")
        size = t.numel() * t.element_size()
        header[n] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for n in names:
            f.write(memoryview(_raw(tensors[n]).numpy()))
    return offset


def read_safetensors_header(path) -> tuple:
    """→ (header dict without ``__metadata__``, metadata, data start)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors that view a
    private memory map of it (copy-on-write: nothing is read until a tensor
    is used, and writing to one never reaches the file)."""
    header, _, start = read_safetensors_header(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            raise ValueError(f"{path}: empty file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if start + end > size or end < begin:
            raise ValueError(f"{path}: {name} lies outside the file")
        count = end - begin
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=count,
                               offset=start + begin)
        if dtype == torch.bool:
            t = raw.view(torch.bool)
        elif (start + begin) % dtype.itemsize:
            t = raw.clone().view(dtype)      # a misaligned tensor is copied
        else:
            t = raw.view(dtype)
        out[name] = t.reshape(shape)
    return out


def load_torch_file(path) -> Dict[str, torch.Tensor]:
    """``torch.load`` on the CPU, tensors only (``weights_only``); a
    zip-format file is memory-mapped rather than read whole."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    except RuntimeError:
        # the legacy (non-zip) format cannot be mapped
        return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_files(path) -> list:
    """The files :func:`load_hf_dir_or_file` reads for ``path``, in order:
    the file itself; in a directory ``pytorch_model*.bin`` and ``*.pt``
    first, else ``*.safetensors``; raises when there is none."""
    p = Path(path)
    if p.is_file():
        return [p]
    bins = sorted(p.glob("pytorch_model*.bin")) + sorted(p.glob("*.pt"))
    if bins:
        return bins
    sts = sorted(p.glob("*.safetensors"))
    if sts:
        return sts
    raise FileNotFoundError(f"no weights found under {path}")


def load_hf_dir_or_file(path) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.pt`` / ``.bin`` / ``.safetensors`` file or a
    (sharded) HF directory, by :func:`checkpoint_files`' rule."""
    sd: Dict[str, torch.Tensor] = {}
    for f in checkpoint_files(path):
        sd.update(load_safetensors(f) if f.suffix == ".safetensors"
                  else load_torch_file(f))
    return sd


def save_sharded(tensors: Dict[str, torch.Tensor], directory,
                 max_shard_bytes: int = MAX_SHARD_BYTES,
                 prefix: str = "model") -> dict:
    """Write ``tensors`` into ``directory`` as shards of at most
    ``max_shard_bytes`` (a tensor larger than that gets a shard of its own)
    named as HF names them, and the index JSON beside them. Returns the
    index (``metadata.total_size`` and ``weight_map``)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    groups, size = [[]], 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if groups[-1] and size + n > max_shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    total, weight_map = 0, {}
    for i, names in enumerate(groups, 1):
        fname = (f"{prefix}.safetensors" if len(groups) == 1 else
                 f"{prefix}-{i:05d}-of-{len(groups):05d}.safetensors")
        total += save_safetensors({n: tensors[n] for n in names},
                                  directory / fname, {"format": "pt"})
        weight_map.update(dict.fromkeys(names, fname))
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    if len(groups) > 1:
        (directory / (INDEX_NAME if prefix == "model" else
                      f"{prefix}.safetensors.index.json")).write_text(
            json.dumps(index, indent=1))
    return index


_STEP = re.compile(r"^checkpoint-(\d+)$")
# files only an orbax checkpoint (the JAX package's) holds
_ORBAX = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
          "commit_success.txt")


def is_orbax(path) -> bool:
    return any(next(Path(path).rglob(name), None) is not None
               for name in _ORBAX)


def converted_dir(path, step: Optional[int] = None) -> Path:
    """The converter's ``checkpoint-{step}`` directory under ``path`` (the
    latest unless ``step`` is given), or ``path`` itself when it holds the
    shards. An orbax directory raises: cross-loading the JAX package's
    checkpoints is ROADMAP queue 1 item 16."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"params checkpoint {path!r} is not a "
                                "directory")
    if is_orbax(p):
        raise NotImplementedError(
            f"{path}: an orbax checkpoint (the JAX package's); loading those "
            "into the port is not ported yet (ROADMAP queue 1 item 16): "
            "convert the reference's torch checkpoints with python -m "
            "mllm_npu_tpu_torch.tools.convert_checkpoint")
    steps = {int(m.group(1)): c for c in p.iterdir()
             if c.is_dir() and (m := _STEP.match(c.name))}
    if step is not None and step in steps:
        return steps[step]
    if step is None and steps:
        return steps[max(steps)]
    if step is None and next(p.glob("*.safetensors"), None) is not None:
        return p
    raise FileNotFoundError(
        f"no converted checkpoint{'' if step is None else f' {step}'} under "
        f"{path}: write one with python -m "
        "mllm_npu_tpu_torch.tools.convert_checkpoint")


def converted_state(path, step: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """The whole state a converter directory holds (mapped, as
    :func:`load_safetensors`)."""
    state: Dict[str, torch.Tensor] = {}
    for f in sorted(converted_dir(path, step).glob("*.safetensors")):
        state.update(load_safetensors(f))
    return state
