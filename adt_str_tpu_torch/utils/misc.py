"""Host utilities: the one logging setup the port's CLIs share.

Port of `adt_str_tpu/utils/misc.py:setup_logging` (its own copy).
"""

from __future__ import annotations

import logging


def setup_logging(log_level: str = "INFO") -> None:
    """One format for every CLI's log lines, at `log_level`; replaces any
    handler installed before (a plain basicConfig would then do nothing)."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=getattr(logging, log_level.upper()),
        force=True,
    )
