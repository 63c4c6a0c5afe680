"""Structured logging: one stdlib logger tree under "tpuembed", plain text
on stderr by default, JSON lines with TPUEMBED_LOG_JSON=1 (for log
aggregation), at the level of TPUEMBED_LOG_LEVEL (default INFO)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER_NAME = "tpuembed"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {"ts": round(time.time(), 3), "level": record.levelname,
                 "logger": record.name, "msg": record.getMessage()}
        extra = getattr(record, "fields", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry)


def get_logger(name: str | None = None) -> logging.Logger:
    """The logger "tpuembed" or "tpuembed.<name>"; the first call sets up
    the tree's handler."""
    logger = logging.getLogger(f"{_LOGGER_NAME}.{name}" if name else _LOGGER_NAME)
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("TPUEMBED_LOG_JSON") == "1":
            handler.setFormatter(JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("TPUEMBED_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **fields) -> None:
    """An INFO record of a message and machine-readable fields (in the
    JSON lines, keys beside "msg")."""
    logger.info(msg, extra={"fields": fields})
