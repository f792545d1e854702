"""Logging shim: the reference's C++ ``BFLOG``/``BLUEFOG_LOG_LEVEL`` macros
(``bluefog/common/logging.h`` [U], SURVEY.md §5.5) mapped onto stdlib logging."""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logger = logging.getLogger("bluefog_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[%(asctime)s %(levelname)s bluefog_tpu_torch] %(message)s")
    )
    logger.addHandler(_h)
logger.setLevel(
    _LEVELS.get(os.environ.get("BLUEFOG_LOG_LEVEL", "warn").lower(), logging.WARNING)
)
