"""Structured logging: the port of ``timed_design_tpu/utils/logging.py``.

One logger for the package; ``configure()`` installs a concise stderr
format, and ``log_event`` also appends machine-readable JSON lines to a file
when one is configured (for benchmarks and pipelines to tail).
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

LOGGER_NAME = "timed_design_tpu_torch"
_event_file = None


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def configure(level: int = logging.INFO, event_file: Path | None = None) -> logging.Logger:
    """The package's logger at ``level``, with one stderr handler; with
    ``event_file``, ``log_event`` appends its JSON lines there (a file
    configured before is closed)."""
    global _event_file
    logger = get_logger()
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                                         datefmt="%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(level)
    if event_file is not None:
        if _event_file is not None:
            _event_file.close()
        _event_file = open(event_file, "a")
    return logger


def close_event_file() -> None:
    """Close the JSON event file, if one is configured."""
    global _event_file
    if _event_file is not None:
        _event_file.close()
        _event_file = None


def log_event(event: str, **fields) -> None:
    """One INFO log line, and one JSON line in the event file if any."""
    record = {"ts": time.time(), "event": event, **fields}
    get_logger().info("%s %s", event, fields)
    if _event_file is not None:
        _event_file.write(json.dumps(record) + "\n")
        _event_file.flush()
