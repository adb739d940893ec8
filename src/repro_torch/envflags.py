"""Single shared truthy-parser for the port's environment flags.

The port's own copy of ``repro.envflags`` (the port imports nothing of
the JAX package). Every boolean-ish environment variable the port reads
(``REPRO_CONTRACTS``, ``REPRO_CHECKIFY``) routes its string-to-bool
decision through :func:`truthy`, so "0"/"false"/"no" mean the same thing
everywhere. Two wrappers differ only in how an *unset or empty* variable
is treated:

- :func:`parse_flag` — unset falls back to ``default``; an empty string
  is falsy.
- :func:`parse_tristate` — unset or empty means "no opinion" (``None``),
  letting the caller pick a default of its own.
"""
from __future__ import annotations

import os
from typing import Optional

# the single source of truth for string falsiness
FALSY = ("", "0", "false", "no")


def truthy(raw: str) -> bool:
    """True unless ``raw`` normalises to one of :data:`FALSY`."""
    return raw.strip().lower() not in FALSY


def parse_flag(raw: Optional[str], default: bool = False) -> bool:
    """Two-state parse: unset -> ``default``, else :func:`truthy`."""
    if raw is None:
        return default
    return truthy(raw)


def parse_tristate(raw: Optional[str]) -> Optional[bool]:
    """Three-state parse: unset/empty -> ``None``, else :func:`truthy`."""
    if raw is None or not raw.strip():
        return None
    return truthy(raw)


def env_flag(name: str, default: bool = False) -> bool:
    """:func:`parse_flag` over ``os.environ[name]``."""
    return parse_flag(os.environ.get(name), default)


def env_tristate(name: str) -> Optional[bool]:
    """:func:`parse_tristate` over ``os.environ[name]``."""
    return parse_tristate(os.environ.get(name))
