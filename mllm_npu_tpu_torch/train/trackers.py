"""Experiment trackers (twin of ``mllm_npu_tpu/train/trackers.py``): an
offline JSONL run sink in wandb's on-disk shape (``wandb/config.json`` and
an append-only ``wandb/metrics.jsonl``), always on, and TensorBoard
(``torch.utils.tensorboard``, under ``tb/``) only where it imports."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Mapping, Optional

log = logging.getLogger(__name__)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class _JsonlRun:
    """Offline wandb-shaped sink: config.json + metrics.jsonl."""

    def __init__(self, run_dir: Path, config: Mapping[str, Any]):
        self.dir = run_dir
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "config.json").write_text(json.dumps(
            {k: _jsonable(v) for k, v in config.items()},
            indent=2, sort_keys=True))
        self._fh = open(self.dir / "metrics.jsonl", "a", encoding="utf-8")

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        rec = {"_step": step, "_timestamp": round(time.time(), 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class Trackers:
    """Fan-out scalar writer: the JSONL sink, and TensorBoard when
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, output_dir: str, config: Mapping[str, Any],
                 tb: bool = True):
        out = Path(output_dir)
        self._tb = None
        if tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(out / "tb"))
            except Exception as e:  # noqa: BLE001 — optional sink
                log.warning("tensorboard tracker unavailable: %s", e)
        self._jsonl = _JsonlRun(out / "wandb", config)

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        self._jsonl.log(metrics, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def build_trackers(output_dir: str, config: Mapping[str, Any]
                   ) -> Optional[Trackers]:
    """Trackers on rank 0 (``torch.distributed``), None elsewhere."""
    from mllm_npu_tpu_torch.data.streams import process_index_count
    if process_index_count()[0] != 0:
        return None
    return Trackers(output_dir, config)
