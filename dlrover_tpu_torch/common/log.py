"""The port's logger: a copy of ``dlrover_tpu.common.log`` (one stderr
handler, level from ``DLROVER_TPU_LOG_LEVEL``, a ``[proc N]`` tag once
the process index is known).

The process index comes from the agent's ``DLROVER_TPU_PROCESS_ID`` env
contract at first use, or from :func:`set_process_index` after
``trainer.distributed.init_from_env``; the journal and the span tracer
stamp it on every record too.
"""

import logging
import os
import sys
import threading
from typing import Optional

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d]%(proc_tag)s %(message)s"
)

_proc_lock = threading.Lock()
_process_index: Optional[int] = None


def current_process_index() -> Optional[int]:
    """This process's index in the distributed world, or None before it
    is known. The agent's env contract seeds it; ``set_process_index``
    updates it after the process group forms."""
    global _process_index
    with _proc_lock:
        if _process_index is None:
            raw = os.getenv("DLROVER_TPU_PROCESS_ID", "")
            if raw.strip().lstrip("-").isdigit():
                _process_index = int(raw)
        return _process_index


def set_process_index(index: int) -> None:
    """Record the distributed process index (called by
    ``trainer.distributed.init_from_env`` once the real value exists)."""
    global _process_index
    with _proc_lock:
        _process_index = int(index)


class _ProcTagFilter(logging.Filter):
    """Injects ``proc_tag`` (e.g. `` [proc 2]``) into every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        idx = current_process_index()
        record.proc_tag = "" if idx is None else f" [proc {idx}]"
        return True


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(os.getenv("DLROVER_TPU_LOG_LEVEL", "INFO").upper())
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler.addFilter(_ProcTagFilter())
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()
