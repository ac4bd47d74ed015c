"""Leveled logging — the reference's core/logging.hpp re-expressed.

A copy of ``rcppml_tpu/utils/logging.py`` (that package's import loads
JAX); each package keeps its own level.

The reference gates ``FACTORNET_LOG_{NMF,IO,INFO}`` printf macros on an
int verbosity (core/logging.hpp:25-31): SILENT(0) / SUMMARY(1) /
DETAILED(2) / DEBUG(3).  Here the same four levels gate plain prints;
fits log SUMMARY lines at the gateway, per-iteration tolerances at
DETAILED (reproduced from the returned history, so the device loop never
pays a host sync for logging), and IO / kernel-dispatch
detail at DEBUG.

The process-wide level comes from ``RCPPML_TPU_VERBOSE`` (int or level
name) and can be changed at runtime with :func:`set_verbosity`.  A
boolean ``verbose=True`` on an API call maps to SUMMARY for that call,
matching ``options(RcppML.verbose)`` semantics (R/nmf_thin.R:19).
"""
from __future__ import annotations

import enum
import os
import sys


class LogLevel(enum.IntEnum):
    SILENT = 0
    SUMMARY = 1
    DETAILED = 2
    DEBUG = 3


def _parse(value) -> LogLevel:
    if isinstance(value, LogLevel):
        return value
    if isinstance(value, bool):
        return LogLevel.SUMMARY if value else LogLevel.SILENT
    if isinstance(value, int):
        return LogLevel(max(0, min(3, value)))
    s = str(value).strip().upper()
    if s.isdigit():
        return LogLevel(max(0, min(3, int(s))))
    try:
        return LogLevel[s]
    except KeyError:
        raise ValueError(
            f"invalid verbosity {value!r}; use 0-3 or one of "
            f"{[l.name for l in LogLevel]}")


_level: LogLevel = _parse(os.environ.get("RCPPML_TPU_VERBOSE", 0))


def set_verbosity(level) -> LogLevel:
    """Set the process-wide log level; returns the previous level."""
    global _level
    prev = _level
    _level = _parse(level)
    return prev


def get_verbosity() -> LogLevel:
    return _level


def effective_level(verbose=None) -> LogLevel:
    """Resolve a per-call ``verbose`` argument against the global level.

    ``None`` defers to the global level; a bool/int/name raises the
    effective level for this call only (never lowers the global one,
    mirroring how the reference threads ``verbose`` per entry point).
    """
    if verbose is None:
        return _level
    return max(_level, _parse(verbose))


def log(level, msg: str, *args, verbose=None) -> None:
    """Print ``msg % args`` when the effective level reaches ``level``."""
    if effective_level(verbose) >= level:
        print(msg % args if args else msg, file=sys.stdout, flush=True)


def warn(msg: str, *args) -> None:
    """Unconditional warning to stderr (FACTORNET_WARN_IMPL analog)."""
    print(msg % args if args else msg, file=sys.stderr, flush=True)


def log_summary(msg, *args, verbose=None):
    log(LogLevel.SUMMARY, msg, *args, verbose=verbose)


def log_detailed(msg, *args, verbose=None):
    log(LogLevel.DETAILED, msg, *args, verbose=verbose)


def log_debug(msg, *args, verbose=None):
    log(LogLevel.DEBUG, msg, *args, verbose=verbose)
