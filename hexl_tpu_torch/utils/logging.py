"""Levelled verbose logging: the port's copy of `hexl_tpu/utils/logging.py`.

The reference gates its VLOG levels 1-5 behind a debug build and a --v=N
flag (hexl/include/hexl/logging/logging.hpp:28-34). Here the level comes
from HEXL_TPU_VLOG (0 = off, the default), the JAX package's variable, and
the records go through the standard logging module under the logger
"hexl_tpu_torch".
"""

from __future__ import annotations

import logging
import os

_LOGGER = logging.getLogger("hexl_tpu_torch")


def get_logger() -> logging.Logger:
    return _LOGGER


def _vlog_level() -> int:
    try:
        return int(os.environ.get("HEXL_TPU_VLOG", "0"))
    except ValueError:
        return 0


def vlog(level: int, msg: str, *args) -> None:
    """Log msg when HEXL_TPU_VLOG >= level (levels 1-5, as the reference)."""
    if _vlog_level() >= level:
        if not _LOGGER.handlers and not logging.getLogger().handlers:
            logging.basicConfig(level=logging.INFO)
        _LOGGER.info(msg, *args)
