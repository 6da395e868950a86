"""Console/file text logger with topic indentation.

Replacement for the reference singleton logger
(ref: framework/logger.py:7-75): ``[tag] HH:MM: message`` lines, nested
sub-topic indentation, every-N debug throttling, and an optional file handler
attached to a run directory.
"""

from __future__ import annotations

import logging
import os
import sys
import time


class Logger:
    """Singleton-style text logger.

    Usage::

        from satnerf_torch.logger import logger
        logger.info("Dataset", "loading images")
        logger.subtopic()          # indent following lines
        logger.reset_topic()
    """

    def __init__(self) -> None:
        self._logger = logging.getLogger("satnerf_torch")
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter("%(message)s"))
            self._logger.addHandler(handler)
        self._indent = 0
        self._debug_counters: dict[str, int] = {}
        self._file_handler: logging.Handler | None = None

    # -- topic indentation -------------------------------------------------
    def subtopic(self) -> None:
        self._indent += 1

    def reset_topic(self) -> None:
        self._indent = 0

    # -- handlers ----------------------------------------------------------
    def attach_file_handler(self, run_dp: str, name: str = "log.txt") -> None:
        """Additionally write all log lines into ``<run_dp>/<name>``."""
        os.makedirs(run_dp, exist_ok=True)
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
        self._file_handler = logging.FileHandler(os.path.join(run_dp, name))
        self._file_handler.setFormatter(logging.Formatter("%(message)s"))
        self._logger.addHandler(self._file_handler)

    # -- emit --------------------------------------------------------------
    def _format(self, tag: str, msg: str) -> str:
        stamp = time.strftime("%H:%M")
        pad = "  " * self._indent
        return f"{pad}[{tag}] {stamp}: {msg}"

    def info(self, tag: str, msg: str) -> None:
        self._logger.info(self._format(tag, msg))

    def warning(self, tag: str, msg: str) -> None:
        self._logger.warning(self._format(tag, f"WARNING: {msg}"))

    def error(self, tag: str, msg: str) -> None:
        self._logger.error(self._format(tag, f"ERROR: {msg}"))

    def debug_every_n(self, tag: str, msg: str, n: int = 100) -> None:
        """Log only every n-th call per tag (step-loop throttling)."""
        count = self._debug_counters.get(tag, 0)
        self._debug_counters[tag] = count + 1
        if count % n == 0:
            self._logger.debug(self._format(tag, msg))


logger = Logger()
