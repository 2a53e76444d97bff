"""Leveled ANSI console logging (Console.{h,cpp} equivalent).

The reference exposes debug/warning/error/fatal printf-style helpers
with ANSI colors (Console.cpp:18-24); this is the same surface on top
of Python logging so library users can silence/redirect it.
"""

from __future__ import annotations

import logging
import sys

_ANSI = {"debug": "\033[37m", "info": "\033[0m", "warning": "\033[33m",
         "error": "\033[31m", "fatal": "\033[1;31m"}
_RESET = "\033[0m"

logger = logging.getLogger("miro")
if not logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(h)
    logger.setLevel(logging.INFO)


def _emit(level: str, msg: str, *args) -> None:
    text = (msg % args) if args else msg
    color = _ANSI.get(level, "") if sys.stderr.isatty() else ""
    reset = _RESET if color else ""
    getattr(logger, "critical" if level == "fatal" else level)(
        f"{color}{text}{reset}")


def debug(msg, *args):
    _emit("debug", msg, *args)


def info(msg, *args):
    _emit("info", msg, *args)


def warning(msg, *args):
    _emit("warning", msg, *args)


def error(msg, *args):
    _emit("error", msg, *args)


def fatal(msg, *args):
    """Console.h fatal: log and raise (the reference exits)."""
    _emit("fatal", msg, *args)
    raise SystemExit(1)
