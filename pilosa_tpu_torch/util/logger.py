"""Leveled loggers (logger/logger.go): standard / verbose / nop.

A copy of ``pilosa_tpu/util/logger.py``."""

from __future__ import annotations

import sys
import time


class Logger:
    def printf(self, fmt: str, *args):
        raise NotImplementedError

    def debugf(self, fmt: str, *args):
        raise NotImplementedError


class NopLogger(Logger):
    def printf(self, fmt: str, *args):
        pass

    def debugf(self, fmt: str, *args):
        pass


class StandardLogger(Logger):
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def _emit(self, fmt: str, args):
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        msg = fmt % args if args else fmt
        self.stream.write(f"{ts} {msg}\n")

    def printf(self, fmt: str, *args):
        self._emit(fmt, args)

    def debugf(self, fmt: str, *args):
        pass


class VerboseLogger(StandardLogger):
    def debugf(self, fmt: str, *args):
        self._emit(fmt, args)
