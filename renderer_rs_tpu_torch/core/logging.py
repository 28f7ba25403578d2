"""Logging init with env-filter semantics (≙ renderer_rs_tpu/core/logging.py,
crates/core/src/logging.rs:16-24): a ``RUST_LOG``-style filter, default
``info,renderer_rs_tpu_torch=debug``, target and thread id in each line.

The filter comes only from the argument (the app's ``--log``). Where none
is given, the JAX package reads it from its own log variable or
``RUST_LOG`` in the environment (logging.py:62-80); the port reads no
environment variable."""

from __future__ import annotations

import logging
import threading

_DEFAULT_FILTER = "info,renderer_rs_tpu_torch=debug"
_PACKAGE = "renderer_rs_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG,  # Python has no TRACE
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_initialized = False
_lock = threading.Lock()


class _ThreadTargetFormatter(logging.Formatter):
    """tracing-subscriber's target + thread-id layout (logging.rs:19-22)."""

    def format(self, record: logging.LogRecord) -> str:
        record.thread_id = threading.get_ident() % 100000
        return super().format(record)


def parse_env_filter(spec: str) -> tuple[int, dict[str, int]]:
    """Parse ``level[,target=level]...`` into (default_level, {target:
    level}); unknown levels are ignored."""
    default = logging.INFO
    per_target: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, lvl = part.partition("=")
            level = _LEVELS.get(lvl.strip().lower())
            if level is not None:
                per_target[target.strip()] = level
        else:
            level = _LEVELS.get(part.lower())
            if level is not None:
                default = level
    return default, per_target


def init_logging(filter_spec: str | None = None) -> None:
    """Initialize the package's logging (≙ core::init_logging). Idempotent.
    The filter is `filter_spec`, or ``info,renderer_rs_tpu_torch=debug``.
    The handler goes on the package logger, not the root logger."""
    global _initialized
    with _lock:
        if _initialized:
            return
        default, per_target = parse_env_filter(filter_spec or _DEFAULT_FILTER)
        handler = logging.StreamHandler()
        handler.setFormatter(_ThreadTargetFormatter(
            "%(asctime)s %(levelname)5s %(name)s [tid %(thread_id)s]: %(message)s",
            datefmt="%H:%M:%S",
        ))
        pkg = logging.getLogger(_PACKAGE)
        pkg.addHandler(handler)
        pkg.propagate = False
        pkg.setLevel(default)
        for target, level in per_target.items():
            logging.getLogger(target).setLevel(level)
        _initialized = True


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger (≙ a tracing target)."""
    return logging.getLogger(name)
