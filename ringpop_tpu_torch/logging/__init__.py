"""Named-logger facility (parity: reference ``logging/facility.go:68-100``).

One underlying logger; per-name minimum levels settable at runtime.  Built on
the stdlib ``logging`` module rather than a bespoke backend — the reference's
``bark`` facade maps 1:1 onto stdlib levels.
"""

from __future__ import annotations

import logging as _stdlog
import threading
from typing import Optional

_LEVELS = {
    "debug": _stdlog.DEBUG,
    "info": _stdlog.INFO,
    "warn": _stdlog.WARNING,
    "warning": _stdlog.WARNING,
    "error": _stdlog.ERROR,
    "fatal": _stdlog.CRITICAL,
    "off": _stdlog.CRITICAL + 10,
}


def parse_level(name: str) -> int:
    """Parse a level name (parity: ``logging/level.go``)."""
    try:
        return _LEVELS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}")


class Facility:
    """Per-name min-level dispatch over one base logger
    (parity: ``logging/facility.go``)."""

    def __init__(self, base: Optional[_stdlog.Logger] = None):
        self._base = base or _stdlog.getLogger("ringpop")
        self._levels: dict[str, int] = {}
        self._lock = threading.RLock()

    def set_logger(self, base: _stdlog.Logger) -> None:
        with self._lock:
            self._base = base

    def set_level(self, name: str, level: int | str) -> None:
        if isinstance(level, str):
            level = parse_level(level)
        with self._lock:
            self._levels[name] = level

    def set_levels(self, levels: dict[str, int | str]) -> None:
        for k, v in levels.items():
            self.set_level(k, v)

    def min_level(self, name: str) -> int:
        with self._lock:
            return self._levels.get(name, _stdlog.ERROR)

    def logger(self, name: str) -> "NamedLogger":
        return NamedLogger(self, name)

    def log(self, name: str, level: int, msg: str, *args, **fields) -> None:
        if level < self.min_level(name):
            return
        extra = f" {fields}" if fields else ""
        self._base.log(level, f"[{name}] {msg}{extra}", *args)


class NamedLogger:
    """Logger bound to a facility name (parity: ``logging/named.go``)."""

    def __init__(self, facility: Facility, name: str, fields: Optional[dict] = None):
        self._facility = facility
        self.name = name
        self._fields = fields or {}

    def with_field(self, key, value) -> "NamedLogger":
        f = dict(self._fields)
        f[key] = value
        return NamedLogger(self._facility, self.name, f)

    def with_fields(self, **fields) -> "NamedLogger":
        f = dict(self._fields)
        f.update(fields)
        return NamedLogger(self._facility, self.name, f)

    def _log(self, level: int, msg: str, *args) -> None:
        self._facility.log(self.name, level, msg, *args, **self._fields)

    def debug(self, msg: str, *args) -> None:
        self._log(_stdlog.DEBUG, msg, *args)

    def info(self, msg: str, *args) -> None:
        self._log(_stdlog.INFO, msg, *args)

    def warn(self, msg: str, *args) -> None:
        self._log(_stdlog.WARNING, msg, *args)

    warning = warn

    def error(self, msg: str, *args) -> None:
        self._log(_stdlog.ERROR, msg, *args)


_default = Facility()


def logger(name: str) -> NamedLogger:
    """Package-global named logger (parity: ``logging/default.go``)."""
    return _default.logger(name)


def set_logger(base: _stdlog.Logger) -> None:
    _default.set_logger(base)


def set_level(name: str, level: int | str) -> None:
    _default.set_level(name, level)


def set_levels(levels: dict) -> None:
    _default.set_levels(levels)
