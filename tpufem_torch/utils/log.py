"""Logging set-up of the command line (``-v``: INFO, ``-vv``: DEBUG).

The port runs on one GPU, so there is one stream: stdout, in the
reference's line format (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:108-132).
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s (%(relativeCreated)8.3fs) [%(name)s] %(levelname)s| %(message)s"


def init_logging(level: int = logging.INFO) -> logging.Logger:
    """Send the tpufem_torch logger to stdout at ``level``."""
    logger = logging.getLogger("tpufem_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(h)
    logger.propagate = False
    return logger


def get_logger(name: str = "tpufem_torch") -> logging.Logger:
    return logging.getLogger(name)
