"""Structured logging: the port's own copy of the control plane's logger
setup (``gpumounter_tpu/utils/log.py``).

stdlib logging under the ``tpumounter`` logger tree, one line per record:
tab-separated key fields by default, one JSON object per line with
``LOG_FORMAT=json``; stdout, plus a rotating file when a log directory is
given. The tree is the control plane's, so one handler configuration
serves both packages in a process that runs both.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"
_DATEFMT = "%Y-%m-%dT%H:%M:%S%z"

_configured = False


class JsonFormatter(logging.Formatter):
    """One JSON object per line (``LOG_FORMAT=json``), for log pipelines
    that parse structured stdout."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, _DATEFMT),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def init_logger(log_dir: str | None = None, filename: str | None = None,
                level: int = logging.DEBUG) -> None:
    """Configure the root ``tpumounter`` logger: its level, a stdout
    handler and, with ``log_dir`` and ``filename``, a rotating file
    (64 MiB, 3 backups). Idempotent; an unwritable log directory leaves
    stdout only."""
    global _configured
    root = logging.getLogger("tpumounter")
    if _configured:
        return
    root.setLevel(level)
    if os.environ.get("LOG_FORMAT", "").lower() == "json":
        fmt: logging.Formatter = JsonFormatter()
    else:
        fmt = logging.Formatter(_FORMAT, datefmt=_DATEFMT)

    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    root.addHandler(stream)

    if log_dir and filename:
        try:
            os.makedirs(log_dir, exist_ok=True)
            fileh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, filename),
                maxBytes=64 * 1024 * 1024, backupCount=3)
            fileh.setFormatter(fmt)
            root.addHandler(fileh)
        except OSError:
            root.warning("log dir %s unwritable; logging to stdout only",
                         log_dir)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tpumounter.{name}")
