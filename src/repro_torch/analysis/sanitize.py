"""Runtime sanitizers: prove the warm device path never syncs implicitly.
The port of ``repro.analysis.sanitize``.

Two mechanisms compose, because each has a blind spot:

* ``torch.cuda.set_sync_debug_mode("error")`` — PyTorch's own guard.  It
  raises at every operation that makes the host wait for the card (a
  ``.item()``, a ``nonzero``, a blocking copy), including those deep
  inside C++ operators that no Python patch can reach.  It sees nothing
  on the CPU, where no operation waits for a device, and the tests run
  there; alone it would be a green light that tests nothing.

* a Python-level sentinel that patches the implicit conversions in both
  directions.  Device to host: ``np.asarray`` / ``np.array`` of a
  tensor, and ``Tensor.item``, ``.tolist``, ``bool()``, ``int()`` and
  ``float()`` of one.  Host to device: ``torch.as_tensor`` /
  ``torch.tensor`` / ``torch.asarray`` of an ``np.ndarray``.  The
  explicit transfer API — ``torch.from_numpy(a).to(device)`` for the
  upload, ``Tensor.cpu()`` (then ``.numpy()``) for the download — is
  wrapped to open an allowance window (on CUDA the sync guard is lifted
  for the call), because *explicit* transfers (the per-batch plan
  upload, the final counts download) are part of the engine's contract;
  only *implicit* ones are bugs.  The sentinel works everywhere, the CPU
  included; it cannot see a sync inside an operator, which the CUDA
  guard does.

``no_implicit_transfers()`` is the sanitize mode's wrapper: warm the
fold once, then run the same-shaped batch inside the guard — any
``.item()``, ``np.asarray(tensor)`` or stray upload that sneaks into the
hot path raises :class:`ImplicitTransferError` (or, for a sync inside an
operator on the card, PyTorch's ``RuntimeError``).

``jit_cache_size`` is the compile counter: the number of compiled
artefacts behind a callable.  The port compiles nothing per shape (each
kernel library is built once, at first use, and takes every shape as a
runtime argument), so it counts the callable's kernel libraries loaded
in this process: 0 on the CPU, where nothing is built, and on the card
1 for the fold from its first launch on — constant over the
quantization grid's mixed-size batches either way.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = [
    "ImplicitTransferError",
    "no_implicit_transfers",
    "jit_cache_size",
]


class ImplicitTransferError(RuntimeError):
    """An implicit host<->device transfer inside a sanitized region."""


_state = threading.local()


def _explicit_depth() -> int:
    return getattr(_state, "explicit", 0)


@contextlib.contextmanager
def _explicitly(cuda_guard: bool):
    _state.explicit = _explicit_depth() + 1
    mode = torch.cuda.get_sync_debug_mode() if cuda_guard else None
    if cuda_guard:
        torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        if cuda_guard:
            torch.cuda.set_sync_debug_mode(mode)
        _state.explicit -= 1


# (owner, attribute) of every patched entry point.
_D2H_FUNCS = ((np, "asarray"), (np, "array"))
_H2D_FUNCS = ((torch, "as_tensor"), (torch, "tensor"), (torch, "asarray"))
_D2H_METHODS = ("item", "tolist", "__bool__", "__int__", "__float__")
_EXPLICIT_METHODS = ("cpu", "to")


@contextlib.contextmanager
def no_implicit_transfers():
    """Forbid implicit host<->device transfers inside the block.

    Composes ``torch.cuda.set_sync_debug_mode("error")`` (where CUDA is
    available) with the sentinel patch (effective everywhere, the CPU
    included).  ``Tensor.cpu`` / ``.to`` (then ``.numpy()`` of the host
    copy) remain allowed — they are the explicit API the engine's
    per-batch upload/download contract is written against.
    """
    cuda_guard = torch.cuda.is_available()
    saved = {(owner, name): getattr(owner, name) for owner, name in _D2H_FUNCS + _H2D_FUNCS}
    saved.update({(torch.Tensor, name): getattr(torch.Tensor, name)
                  for name in _D2H_METHODS + _EXPLICIT_METHODS})

    def guard_d2h(orig, name):
        def wrapper(obj, *args, **kwargs):
            if _explicit_depth() == 0 and isinstance(obj, torch.Tensor):
                raise ImplicitTransferError(
                    f"implicit device->host transfer: {name}() on a tensor inside a "
                    "sanitized region — use .cpu() for the explicit download")
            return orig(obj, *args, **kwargs)

        return wrapper

    def guard_h2d(orig, name):
        def wrapper(obj, *args, **kwargs):
            if _explicit_depth() == 0 and isinstance(obj, np.ndarray):
                raise ImplicitTransferError(
                    f"implicit host->device transfer: {name}() on an np.ndarray inside a "
                    "sanitized region — use torch.from_numpy(a).to(device) for the "
                    "explicit upload")
            return orig(obj, *args, **kwargs)

        return wrapper

    def explicit(orig):
        def wrapper(self, *args, **kwargs):
            with _explicitly(cuda_guard):
                return orig(self, *args, **kwargs)

        return wrapper

    for owner, name in _D2H_FUNCS:
        setattr(owner, name, guard_d2h(saved[owner, name], f"np.{name}"))
    for owner, name in _H2D_FUNCS:
        setattr(owner, name, guard_h2d(saved[owner, name], f"torch.{name}"))
    for name in _D2H_METHODS:
        setattr(torch.Tensor, name, guard_d2h(saved[torch.Tensor, name], f"Tensor.{name}"))
    for name in _EXPLICIT_METHODS:
        setattr(torch.Tensor, name, explicit(saved[torch.Tensor, name]))
    mode = torch.cuda.get_sync_debug_mode() if cuda_guard else None
    try:
        if cuda_guard:
            torch.cuda.set_sync_debug_mode("error")
        yield
    finally:
        if cuda_guard:
            torch.cuda.set_sync_debug_mode(mode)
        for (owner, name), orig in saved.items():
            setattr(owner, name, orig)


def jit_cache_size(fn) -> int:
    """Compiled artefacts behind ``fn`` — the compile counter the
    quantization-grid bound is asserted against.  ``fn`` names its kernel
    sources in a ``kernel_sources`` attribute (``device_fold``:
    ``("fold",)``); the count is how many of their libraries this process
    has loaded.  Nothing is compiled per shape, so it stays constant over
    any sequence of batch shapes."""
    stems = getattr(fn, "kernel_sources", None)
    if stems is None:
        raise AttributeError(f"{fn!r} names no kernel_sources to count")
    return sum(1 for stem in stems if build.is_loaded(stem))
