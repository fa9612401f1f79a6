"""Mesh construction, the port of ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no
device.  A mesh is a :class:`~repro_torch.dist.fault_tolerance.SlotMesh`.

* :func:`make_production_mesh` — the reference's 16 x 16 pod (256 slots,
  ``("data", "model")``) or 2 x 16 x 16 (512 slots, ``("pod", "data",
  "model")``), every slot on the ``meta`` device: for planning only
  (``launch/dryrun.py``), nothing can run on it.
* :func:`make_local_mesh` — every visible card as a 1 x N mesh; raises
  without a GPU unless the caller passes ``device="cpu"`` (one CPU slot).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.dist.fault_tolerance import ShardSlot, SlotMesh, visible_cuda_devices

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> SlotMesh:
    """16 x 16 = 256 slots a pod; 2 pods = 512 slots, on ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    meta = torch.device("meta")
    return SlotMesh([ShardSlot(id=i, device=meta) for i in range(math.prod(shape))], shape, axes)


def make_local_mesh(device: Optional[str] = None) -> SlotMesh:
    """Every visible CUDA device as a 1 x N ``("data", "model")`` mesh;
    ``device="cpu"`` gives one CPU slot (1 x 1).  Raises without a GPU
    otherwise."""
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    else:
        devices = visible_cuda_devices()
    slots = [ShardSlot(id=i, device=d) for i, d in enumerate(devices)]
    return SlotMesh(slots, (1, len(slots)), ("data", "model"))
