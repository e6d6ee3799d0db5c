"""Exception hierarchy + typed assertion helpers (helib_tpu.exceptions;
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


class RuntimeFailure(HelibError):
    """Reference RuntimeError (renamed to avoid shadowing the builtin)."""


class IOError_(HelibError, IOError):
    pass


def assert_true(cond, msg: str, exc=LogicError):
    if not cond:
        raise exc(msg)


def assert_eq(a, b, msg: str, exc=LogicError):
    if a != b:
        raise exc(f"{msg}: {a!r} != {b!r}")


def assert_neq(a, b, msg: str, exc=LogicError):
    if a == b:
        raise exc(f"{msg}: {a!r} == {b!r}")


def assert_in_range(v, lo, hi, msg: str, exc=OutOfRangeError):
    if not (lo <= v < hi):
        raise exc(f"{msg}: {v!r} not in [{lo!r}, {hi!r})")
