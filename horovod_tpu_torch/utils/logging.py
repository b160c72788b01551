"""Logging in the reference's LOG(severity[, rank]) form: the port's own
copy of ``horovod_tpu.utils.logging``.

Levels trace..fatal are selected by HOROVOD_LOG_LEVEL (default warning);
HOROVOD_LOG_HIDE_TIME drops the timestamps. Lines go to stderr as
``[W 2026-01-01 12:00:00.000 rank 3] message``. The logger is named
``horovod_tpu_torch``, so a process that imports both packages keeps one
handler on each.
"""

from __future__ import annotations

import logging as _pylog
import os
import sys
import time

TRACE = 5
_pylog.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": _pylog.DEBUG,
    "info": _pylog.INFO,
    "warning": _pylog.WARNING,
    "error": _pylog.ERROR,
    "fatal": _pylog.CRITICAL,
}


class _HvdFormatter(_pylog.Formatter):
    def __init__(self, hide_time: bool):
        super().__init__()
        self.hide_time = hide_time

    def format(self, record: _pylog.LogRecord) -> str:
        rank = getattr(record, "hvd_rank", None)
        prefix = f"[{record.levelname[0]}"
        if not self.hide_time:
            t = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(record.created))
            prefix += f" {t}.{int(record.msecs):03d}"
        if rank is not None:
            prefix += f" rank {rank}"
        prefix += "]"
        return f"{prefix} {record.getMessage()}"


_logger: _pylog.Logger | None = None


def get_logger() -> _pylog.Logger:
    global _logger
    if _logger is None:
        _logger = _pylog.getLogger("horovod_tpu_torch")
        level = _LEVELS.get(os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower(),
                            _pylog.WARNING)
        _logger.setLevel(level)
        handler = _pylog.StreamHandler(sys.stderr)
        hide_time = (os.environ.get("HOROVOD_LOG_HIDE_TIME") or "").lower() \
            not in ("", "0", "false")
        handler.setFormatter(_HvdFormatter(hide_time))
        _logger.addHandler(handler)
        _logger.propagate = False
    return _logger


def log(level: str, msg: str, rank: int | None = None) -> None:
    lv = _LEVELS.get(level.lower(), _pylog.INFO)
    get_logger().log(lv, msg, extra={"hvd_rank": rank})
