"""The port's logger: a copy of the part of ``dlrover_tpu.common.log``
that the port uses (one stderr handler, level from
``DLROVER_TPU_LOG_LEVEL``)."""

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d] %(message)s"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(os.getenv("DLROVER_TPU_LOG_LEVEL", "INFO").upper())
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()
