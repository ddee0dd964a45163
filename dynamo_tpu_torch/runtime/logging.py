"""Structured logging: human-readable or JSONL, env-configured.

The port's copy of the reference package's runtime/logging.py, rooted at
the ``dynamo_tpu_torch`` logger. The reference's per-request id stamp
waits for a caller that sets it (the tracing of ROADMAP item 4b).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

from .config import ENV_LOG, ENV_LOG_JSONL, is_truthy

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        rec = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            rec["exception"] = self.formatException(record.exc_info)
        return json.dumps(rec, separators=(",", ":"))


ROOT = "dynamo_tpu_torch"
_initialized = False


def init_logging(level: Optional[str] = None, jsonl: Optional[bool] = None) -> None:
    """Idempotent root logger setup for the dynamo_tpu_torch.* hierarchy."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    lvl = _LEVELS.get((level or os.environ.get(ENV_LOG, "info")).lower(), logging.INFO)
    use_jsonl = jsonl if jsonl is not None else is_truthy(os.environ.get(ENV_LOG_JSONL))
    handler = logging.StreamHandler(sys.stderr)
    if use_jsonl:
        handler.setFormatter(_JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S")
        )
    root = logging.getLogger(ROOT)
    root.setLevel(lvl)
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
