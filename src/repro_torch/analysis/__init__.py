"""Runtime validation gate (``REPRO_DEBUG``) behind the ``validate()``
methods of ``HierIndex`` / ``SegmentPlan`` / ``DeviceIndex``; the
sanitizers of the warm device path live in
:mod:`repro_torch.analysis.sanitize`."""

from repro_torch.analysis.runtime import debug_enabled, force_debug, maybe_validate

__all__ = ["debug_enabled", "force_debug", "maybe_validate"]
