"""Logging: the port's own copy of ``get_logger`` (same logger tree as
the control plane, so one handler configuration serves both)."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tpumounter.{name}")
