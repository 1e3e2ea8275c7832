"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/lib<name>-<hash>.so``
at the repository root (git-ignored), and loaded with ``ctypes``. A hash
of the source, of every header under ``csrc/`` (``*.cuh``) and of the
flags names the library, so an edited source or header is rebuilt.
:func:`build_all` starts one nvcc per source, all at once.

``MLLM_NVCC_EXTRA`` adds flags to every build, e.g.
``MLLM_NVCC_EXTRA=-DMBAR_TRAP_CYCLES=4000000000`` makes a lost mbarrier
arrival trap (a fault) instead of hanging the card while a kernel is being
changed (``csrc/hopper.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: CUDA kernels are built on the GPU "
                       "machine (CUDA_HOME or /usr/local/cuda)")


def _flags():
    return NVCC_FLAGS + os.environ.get("MLLM_NVCC_EXTRA", "").split()


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> Dict[str, Tuple[float, str]]:
    """Compile each ``csrc/<name>.cu`` whose library is not current, one
    nvcc per source, all started together. Returns {name: (seconds,
    nvcc's report)} (0 and "" where nothing was built); raises if any nvcc
    fails, after all have ended."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    result = {name: (0.0, "") for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        result[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is current. Returns
    nvcc's report (empty when nothing was built); raises if nvcc fails."""
    return build_all([name])[name][1]


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
