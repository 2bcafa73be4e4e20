"""Structured leveled logging (ref: libs/log/default.go — zerolog).

A Logger carries bound key=value fields; `with_fields` derives children
(ref: log.Logger.With). Two output formats: "console" (human-readable
single lines) and "json" (one JSON object per line, zerolog-style).
Level and format come from the env by default (TM_LOG_LEVEL,
TM_LOG_FORMAT) so nodes and tests can tune verbosity without config
plumbing; the node also wires config.base.log_level through here.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, TextIO

DEBUG = 10
INFO = 20
ERROR = 40
NONE = 100

_LEVELS = {"debug": DEBUG, "info": INFO, "error": ERROR, "none": NONE}
_NAMES = {DEBUG: "DBG", INFO: "INF", ERROR: "ERR"}

_write_lock = threading.Lock()


def parse_level(name: str) -> int:
    return _LEVELS.get(name.strip().lower(), INFO)


class Logger:
    """ref: libs/log/logger.go Logger interface (Debug/Info/Error/With)."""

    __slots__ = ("level", "fmt", "writer", "fields")

    def __init__(
        self,
        level: int | None = None,
        fmt: str | None = None,
        writer: TextIO | None = None,
        fields: dict[str, Any] | None = None,
    ):
        if level is None:
            level = parse_level(os.environ.get("TM_LOG_LEVEL", "info"))
        if fmt is None:
            fmt = os.environ.get("TM_LOG_FORMAT", "console")
        if fmt == "plain":  # the reference config's name for console
            fmt = "console"
        self.level = level
        self.fmt = fmt
        self.writer = writer or sys.stderr
        self.fields = fields or {}

    def with_fields(self, **kw: Any) -> "Logger":
        merged = dict(self.fields)
        merged.update(kw)
        return Logger(self.level, self.fmt, self.writer, merged)

    def debug(self, msg: str, **kw: Any) -> None:
        if self.level <= DEBUG:
            self._emit(DEBUG, msg, kw)

    def info(self, msg: str, **kw: Any) -> None:
        if self.level <= INFO:
            self._emit(INFO, msg, kw)

    def error(self, msg: str, **kw: Any) -> None:
        if self.level <= ERROR:
            self._emit(ERROR, msg, kw)

    def _emit(self, level: int, msg: str, kw: dict[str, Any]) -> None:
        record = dict(self.fields)
        record.update(kw)
        ts = time.time()
        try:
            if self.fmt == "json":
                record["level"] = _NAMES[level].lower()
                record["time"] = round(ts, 3)
                record["message"] = msg
                line = json.dumps(record, default=_json_val)
            else:
                t = time.strftime("%H:%M:%S", time.localtime(ts))
                pairs = " ".join(f"{k}={_fmt_val(v)}" for k, v in record.items())
                line = f"{t} {_NAMES[level]} {msg}" + (f" {pairs}" if pairs else "")
            with _write_lock:
                self.writer.write(line + "\n")
                self.writer.flush()
        except Exception:
            pass  # logging must never take the node down


def _json_val(v: Any) -> str:
    """json.dumps fallback: hex for bytes (zerolog emits hex, not a
    Python repr), str for everything else."""
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    return str(v)


def _fmt_val(v: Any) -> str:
    if isinstance(v, bytes):
        return v.hex()[:16]
    s = str(v)
    return f'"{s}"' if " " in s else s


_default: Logger | None = None


def default_logger() -> Logger:
    global _default
    if _default is None:
        _default = Logger()
    return _default


def new_logger(module: str, **fields: Any) -> Logger:
    return default_logger().with_fields(module=module, **fields)


class NopLogger(Logger):
    __slots__ = ()

    def __init__(self):
        super().__init__(level=NONE)

    def _emit(self, level, msg, kw):  # pragma: no cover
        pass
