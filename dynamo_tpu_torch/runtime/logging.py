"""Structured logging: human-readable or JSONL, env-configured.

The port's copy of the reference package's runtime/logging.py, rooted at
the ``dynamo_tpu_torch`` logger. The request id (``set_request_id``) and
the current span of runtime/tracing.py ride contextvars and are stamped on
every record: ``[<request id>]`` in the text format, ``request_id`` /
``trace_id`` / ``span_id`` keys in JSONL.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time
from typing import Optional

from .config import ENV_LOG, ENV_LOG_JSONL, is_truthy

_request_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dtpu_torch_request_id", default=None
)


def set_request_id(rid: Optional[str]) -> None:
    _request_id.set(rid)


def get_request_id() -> Optional[str]:
    return _request_id.get()


def _current_span():
    # runtime/tracing.py imports this module: look the span up lazily
    from .tracing import current_span

    return current_span()


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
        rid = _request_id.get()
        if rid:
            rec["request_id"] = rid
        span = _current_span()
        if span is not None:
            rec["trace_id"] = span.trace_id
            rec["span_id"] = span.span_id
        if record.exc_info and record.exc_info[0] is not None:
            rec["exception"] = self.formatException(record.exc_info)
        return json.dumps(rec, separators=(",", ":"))


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        rid = _request_id.get()
        prefix = f"[{rid[:8]}] " if rid else ""
        base = super().format(record)
        return base.replace(record.getMessage(), prefix + record.getMessage(), 1)


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
            _TextFormatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S")
        )
    root = logging.getLogger(ROOT)
    root.setLevel(lvl)
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
