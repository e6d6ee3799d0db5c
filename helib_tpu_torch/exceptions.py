"""Exception hierarchy + the typed assertion helper (helib_tpu.exceptions;
role of HElib's assertions.h / exceptions.h)."""

from __future__ import annotations


class HelibError(Exception):
    """Base (reference helib::Exception)."""


class LogicError(HelibError):
    pass


class InvalidArgument(HelibError, ValueError):
    pass


class OutOfRangeError(HelibError, IndexError):
    pass


class IOError_(HelibError, IOError):
    pass


def assert_true(cond, msg: str, exc=LogicError):
    if not cond:
        raise exc(msg)
