"""Logger factory (counterpart of elasticdl_tpu/common/log_utils.py:get_logger).

ELASTICDL_LOG_LEVEL (DEBUG/INFO/WARNING/ERROR or a number, default INFO) sets
the level of the port's root logger, read at the first get_logger call.
"""

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"
_ROOT = "elasticdl_tpu_torch"


def _resolve_level():
    raw = os.environ.get("ELASTICDL_LOG_LEVEL", "").strip()
    if not raw:
        return logging.INFO
    if raw.isdigit():
        return int(raw)
    return getattr(logging, raw.upper(), logging.INFO)


def _configure():
    root = logging.getLogger(_ROOT)
    if root.handlers:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.propagate = False
    root.setLevel(_resolve_level())


def get_logger(name: str, level=None) -> logging.Logger:
    _configure()
    logger = logging.getLogger(f"{_ROOT}.{name}")
    if level is not None:
        logger.setLevel(level)
    return logger
