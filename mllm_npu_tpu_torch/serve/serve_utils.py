"""Serving helpers: a rotating file logger that can take over stdout and
stderr, the error text the worker sends, and a semaphore's description
(the port's own copy of ``mllm_npu_tpu/serve/serve_utils.py``)."""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from pathlib import Path

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE "
                    "REGENERATE OR REFRESH THIS PAGE.**")

handler = None


class StreamToLogger:
    """File-like shim routing bare print()/traceback output into the
    logger, so the rotating file captures everything a crashed worker
    said (reference serve/serve_utils.py:22-45 behavior)."""

    def __init__(self, logger: logging.Logger, level: int):
        self.logger = logger
        self.level = level
        self._buf = ""

    def write(self, text) -> int:
        if not isinstance(text, str):
            text = text.decode(errors="replace")
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line:
                self.logger.log(self.level, line)
        return len(text)

    def flush(self) -> None:
        if self._buf:
            self.logger.log(self.level, self._buf)
            self._buf = ""

    def isatty(self) -> bool:
        return False

    @property
    def encoding(self) -> str:
        return "utf-8"


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = "logs",
                 redirect_std: bool = True) -> logging.Logger:
    """Rotating-file logger attached to every logger; optionally hijacks
    sys.stdout/sys.stderr into it (disable via redirect_std=False or
    MLLM_LOG_REDIRECT=0 — tests do the latter so pytest capture keeps
    working)."""
    global handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    logging.basicConfig(level=logging.INFO, encoding="utf-8")
    for h in logging.getLogger().handlers:
        h.setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    if handler is None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        filename = os.path.join(log_dir, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True, encoding="utf-8")
        handler.setFormatter(formatter)
        # root covers every propagating logger (including ones created
        # after this call); non-propagating ones need the handler added
        # individually, and must NOT double up with the root copy
        logging.getLogger().addHandler(handler)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger) and not item.propagate:
                item.addHandler(handler)

    if redirect_std and os.environ.get("MLLM_LOG_REDIRECT", "1") == "1":
        # the root StreamHandler created by basicConfig above holds the
        # ORIGINAL stderr object, so console output survives the swap
        # and log records don't recurse through the shim
        # explicit levels: basicConfig above is a no-op when the host
        # process already configured root handlers, leaving root at
        # WARNING — which would silently drop the stdout INFO records
        if not isinstance(sys.stdout, StreamToLogger):
            out_log = logging.getLogger("stdout")
            out_log.setLevel(logging.INFO)
            sys.stdout = StreamToLogger(out_log, logging.INFO)
        if not isinstance(sys.stderr, StreamToLogger):
            err_log = logging.getLogger("stderr")
            err_log.setLevel(logging.ERROR)
            sys.stderr = StreamToLogger(err_log, logging.ERROR)
    return logger


def pretty_print_semaphore(semaphore) -> str:
    """``Semaphore(value=…, locked=…)`` for an asyncio or a threading
    semaphore (the worker's is a ``threading.Semaphore``), or "None"."""
    if semaphore is None:
        return "None"
    # _value is CPython's internal counter (no public accessor)
    value = getattr(semaphore, "_value", "?")
    locked = (semaphore.locked() if hasattr(semaphore, "locked")
              else value == 0)
    return f"Semaphore(value={value}, locked={locked})"
