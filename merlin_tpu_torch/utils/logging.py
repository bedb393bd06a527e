"""Logging setup (a copy of ``merlin_tpu/utils/logging.py``): rank-0-only
stream and timestamped file handlers, and rate-limited helpers."""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional

_LOG_COUNTS: Dict[str, int] = {}
_LOG_TIMES: Dict[str, float] = {}


def setup_logger(output_dir: Optional[str] = None, rank: int = 0,
                 name: str = "merlin_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s", "%H:%M:%S")
    if rank == 0:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(
                output_dir, time.strftime("log-%Y%m%d-%H%M%S.txt")))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


def log_every_n(logger: logging.Logger, msg: str, n: int = 100,
                level: int = logging.INFO):
    key = msg[:80]
    _LOG_COUNTS[key] = _LOG_COUNTS.get(key, 0) + 1
    if (_LOG_COUNTS[key] - 1) % n == 0:
        logger.log(level, msg)


def log_every_n_seconds(logger: logging.Logger, msg: str, n: float = 10.0,
                        level: int = logging.INFO):
    key = msg[:80]
    now = time.time()
    if now - _LOG_TIMES.get(key, 0.0) >= n:
        _LOG_TIMES[key] = now
        logger.log(level, msg)
