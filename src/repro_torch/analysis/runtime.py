"""The `REPRO_DEBUG` gate for the runtime validation head.

Structural ``validate()`` methods (monotone CSR pointers, nested level
ranges, sorted postings, shard partition exactness — see
:mod:`repro_torch.core.hier_index` / :mod:`repro_torch.core.device_engine`) cost real
time on large indexes, so production builds skip them.  They run when

* the ``REPRO_DEBUG`` environment variable is set to anything but
  ``""``/``"0"``/``"false"`` — the CI sanitize job sets ``REPRO_DEBUG=1``
  so every index/plan built during the gated test subset self-checks; or
* a test forces the flag locally with :func:`force_debug`.

Call sites gate through :func:`maybe_validate` so the fast path stays a
single dict lookup.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["debug_enabled", "force_debug", "maybe_validate"]

_FALSY = ("", "0", "false", "False", "no")

# tri-state override: None = follow the environment variable.
_forced: list = [None]


def debug_enabled() -> bool:
    """True when structural validation should run (env or forced)."""
    if _forced[0] is not None:
        return bool(_forced[0])
    return os.environ.get("REPRO_DEBUG", "") not in _FALSY


@contextlib.contextmanager
def force_debug(value: bool = True):
    """Override the ``REPRO_DEBUG`` environment gate within a block —
    how property tests turn validation on without mutating ``os.environ``
    (subprocess tests inherit the real environment, not this)."""
    prev = _forced[0]
    _forced[0] = value
    try:
        yield
    finally:
        _forced[0] = prev


def maybe_validate(obj):
    """Run ``obj.validate()`` when debugging is enabled; always returns
    ``obj`` so builders can gate in tail position."""
    if debug_enabled():
        obj.validate()
    return obj
