"""Utility subsystems: validation (debug-only), logging and profiling.

As in the JAX package, `from hexl_tpu_torch.utils import check` imports
the *module*; `check_bounds`/`debug_enabled`/`vlog`/`get_logger` are also
re-exported here. `profiling` (`trace`, `recording`, `summary` and the
spans) is imported on its own.
"""

from . import check
from .check import check_bounds, debug_enabled
from .logging import get_logger, vlog

__all__ = ["check", "check_bounds", "debug_enabled", "get_logger", "vlog"]
