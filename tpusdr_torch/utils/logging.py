"""Leveled, pluggable logging.

TPU-native replacement for the reference's GSLog subsystem
(cuda-sdr src/GSLog.cpp:32-167: global pluggable ILogger, six levels,
level gate, fatal aborts). We use stdlib logging with the same level
vocabulary; ``set_log_level`` is the analog of gsLogSetVerbosity
(GSLog.cpp:77-82).
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_configured = False


def _configure_once() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
    )
    root = logging.getLogger("tpusdr")
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(os.environ.get("TPUSDR_LOG", "info").lower(), logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str = "tpusdr") -> logging.Logger:
    _configure_once()
    if name != "tpusdr" and not name.startswith("tpusdr."):
        name = f"tpusdr.{name}"
    return logging.getLogger(name)


def set_log_level(level: str) -> None:
    """Set the global tpusdr log verbosity ('trace'..'fatal')."""
    _configure_once()
    logging.getLogger("tpusdr").setLevel(_LEVELS[level.lower()])
