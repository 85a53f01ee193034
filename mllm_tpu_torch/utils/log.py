"""Logging — counterpart of the reference's compile-time fmt logger
(mllm/Log.h: MLLM_LOG_* with logcat sink).

Structured logging over stdlib `logging`: level from MLLM_LOG_LEVEL, optional
JSON-lines output (MLLM_LOG_JSON=1) for log pipelines, and the familiar
convenience functions. Copied from `mllm_tpu/utils/log.py`; the port logs
under the name "mllm_tpu_torch".
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER: logging.Logger | None = None


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def get_logger(name: str = "mllm_tpu_torch") -> logging.Logger:
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER if name == "mllm_tpu_torch" else logging.getLogger(name)
    logger = logging.getLogger("mllm_tpu_torch")
    level = os.environ.get("MLLM_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("MLLM_LOG_JSON") == "1":
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(handler)
    logger.propagate = False
    _LOGGER = logger
    return logger if name == "mllm_tpu_torch" else logging.getLogger(name)


def log_info(msg: str, **fields):
    get_logger().info(msg, extra={"fields": fields} if fields else None)


def log_warn(msg: str, **fields):
    get_logger().warning(msg, extra={"fields": fields} if fields else None)


def log_error(msg: str, **fields):
    get_logger().error(msg, extra={"fields": fields} if fields else None)


def log_debug(msg: str, **fields):
    get_logger().debug(msg, extra={"fields": fields} if fields else None)
