"""File + stream logging setup (eval_utils.py:8-22 parity); a copy of the
JAX package's `utils/logging_utils.py`."""

from __future__ import annotations

import logging
import os
from typing import Optional


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.INFO,
                  name: str = "rtkv") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
