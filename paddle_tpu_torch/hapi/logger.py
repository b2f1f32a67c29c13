"""hapi.logger (port of paddle_tpu/hapi/logger.py): ``setup_logger``, the
shared logger setup."""
from __future__ import annotations

import logging
import sys

__all__ = ["setup_logger"]


def setup_logger(output=None, name="paddle", log_level=logging.INFO):
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler(stream=sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s: %(message)s"))
        logger.addHandler(h)
    if output is not None:
        path = (output if output.endswith((".txt", ".log"))
                else output + "/log.txt")
        # idempotent: repeated setup_logger calls must not stack
        # handlers (each would duplicate every log line)
        if not any(isinstance(h, logging.FileHandler)
                   and h.baseFilename == __import__("os").path.abspath(path)
                   for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(
                "%(asctime)s - %(levelname)s: %(message)s"))
            logger.addHandler(fh)
    return logger
