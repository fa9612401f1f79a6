"""Build, load and count the port's CUDA kernels.

Sources live in ``src/repro_torch/csrc/``: ``fold.cu`` (the multi-stage
fold of the device engine), ``intersect.cu`` (the intersect trio),
``cluster_score.cu`` (the δ⁺ scoring gather of the device K-means),
``flash_attention.cu`` (the general, the resident and the split-K decode
attention kernels, with the decode's combine) and
``flash_attention_sm90.cu`` (its bf16 tensor-core prefill kernel),
``flash_attention_bwd.cu`` (the attention's general backward: prep,
dK/dV, dQ), ``flash_attention_bwd_sm90.cu`` (the bf16 tensor-core
dK/dV and dQ), ``flash_attention_bwd_resident.cu`` (the fp32 backward
in one kernel at the resident forward's calls) and
``segment_aggregate.cu`` (PNA's aggregation, forward and backward, split
by edges); the two sm90 sources
share ``sm90_common.cuh``, the two resident ones ``resident_common.cuh``.  Each
source is compiled with ``nvcc`` for ``sm_90a`` on first use into its own
shared library under ``build/repro_torch/`` at the repository root, named
by a hash of the source, the headers and the compiler flags, so an edited
source rebuilds and an unchanged one loads at once.  All sources compile
in parallel, one ``nvcc`` each.  Without ``nvcc``, or when a build
fails, the build raises: there is no fallback.

Each library exports plain C launchers (bound with ``ctypes``) that
launch on the stream they are given and return ``cudaGetLastError()``.
The launchers of :mod:`repro_torch.kernels.intersect.kernel`,
:mod:`repro_torch.kernels.cluster_score.kernel`,
:mod:`repro_torch.kernels.flash_attention.kernel` and
:mod:`repro_torch.kernels.segment_aggregate.kernel` call them through
:func:`lib`, raise through :func:`check`, and add one to their entry of
:data:`LAUNCHES` per launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["LAUNCHES", "SOURCES", "build_libraries", "check", "is_loaded", "lib",
           "reset_launch_counts", "stream_of"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("fold", "intersect", "cluster_score", "flash_attention", "flash_attention_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90", "flash_attention_bwd_resident",
           "segment_aggregate")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "fold": {
        "segment_fold_launch": (
            _P, _L, _P, _L, _P, _L, _I, ctypes.POINTER(_I), _I, _I, _P, _P, _P, _P),
    },
    "intersect": {
        **{name: (_P, _P, _L, _L, _L, _P, _P)
           for name in (
               "intersect_members_launch",
               "intersect_members_count_launch",
               "intersect_count_launch",
           )},
        "intersect_count_split_launch": (_P, _P, _L, _L, _L, _L, _P, _P),
        "intersect_count_bins_launch": (_P, _P, _P, _L, _P, _L, _L, _L, _I, _P),
    },
    "cluster_score": {
        name: (_P, _L, _L, _P, _P, _L, _L, _P, _P)
        for name in ("cluster_scores_general_launch", "cluster_scores_staged_launch")
    },
    "flash_attention": {
        "flash_attention_launch": (
            _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, ctypes.POINTER(_L), _I, _I, _L, _F, _I, _P),
        "flash_decode_launch": (_P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F, _I, _P),
        "flash_combine_launch": (_P, _P, _P, ctypes.POINTER(_L), _P),
        "flash_resident_launch": (_P, _P, _P, _P, ctypes.POINTER(_L), _F, _P, _P),
    },
    "flash_attention_sm90": {
        "flash_attention_sm90_launch": (
            _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, ctypes.POINTER(_L), _I, _I, _L, _F, _P, _P),
    },
    "flash_attention_bwd": {
        "flash_bwd_prep_launch": (_P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F, _I, _P),
        "flash_bwd_dkdv_launch": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F, _P),
        "flash_bwd_dq_launch": (_P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F, _P),
    },
    "flash_attention_bwd_sm90": {
        "flash_bwd_dkdv_sm90_launch": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F,
                                       _P),
        "flash_bwd_dq_sm90_launch": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _F,
                                     _P),
    },
    "flash_attention_bwd_resident": {
        "flash_bwd_resident_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L),
                                      _F, _P),
    },
    "segment_aggregate": {
        **{name: (_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P, _P)
           for name in ("segment_aggregate_fwd_launch", "segment_aggregate_fwd_registers_launch")},
        **{name: (_P, _P, _P, _P, _P, _P, _L, _L, _I, _I,
                  _P, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P)
           for name in ("segment_aggregate_bwd_launch", "segment_aggregate_bwd_registers_launch")},
    },
}

# Launch counts of the kernels: one per launch, incremented only where a
# kernel is launched (never on the plain CPU path).  The two count
# launchers count each call as ``intersect_count_kernel`` or
# ``intersect_members_count_kernel`` and each launch of the form it took
# (``kernel.count_route``): ``intersect_count_row`` (one block a row) or
# ``intersect_count_split`` (one block a chunk of a row).  The
# non-clustered baseline's one launch over every bin of a batch counts as
# ``intersect_count_bins``.  The scoring launcher
# counts each call as ``cluster_scores_kernel`` and each launch of the
# variant it took (``cluster_scores_staged``: the weighted table in shared
# memory; ``cluster_scores_general``).  The attention
# launcher counts each call as ``flash_attention_kernel`` and each launch
# of the variant it took: ``flash_attention_sm90`` (bf16 tensor-core
# prefill), ``flash_attention_decode`` (split-K decode: one launch a call,
# its last blocks merge the splits), ``flash_attention_resident`` (K and
# V of a head in shared memory) or ``flash_attention_general``;
# ``flash_attention_combine`` counts the mesh decode's merges of its
# shards' partials (``ops.flash_decode_combine``).  The backward
# (``kernel.flash_attention_bwd_cuda``) launches the kernels
# ``kernel.bwd_launches`` lists, once each a call: by ``kernel.bwd_route``,
# ``flash_bwd_resident`` (fp32 at the resident forward's calls: one kernel,
# given the forward's log-sum-exp), ``flash_bwd_dq_sm90`` (computing delta)
# then ``flash_bwd_dkdv_sm90`` (bf16 tensor cores, given it), or
# ``flash_bwd_prep`` and then the general pair ``flash_bwd_dkdv`` and
# ``flash_bwd_dq``; without the forward's log-sum-exp, ``flash_bwd_prep``
# first on every route.  PNA's
# aggregation counts ``segment_aggregate_fwd`` and ``_bwd`` (the ring
# design, the main path) and ``segment_aggregate_fwd_registers`` and
# ``_bwd_registers`` (the register design, forced), one a call each.
LAUNCHES: Dict[str, int] = {
    "segment_fold": 0,
    "intersect_members_kernel": 0,
    "intersect_members_count_kernel": 0,
    "intersect_count_kernel": 0,
    "intersect_count_row": 0,
    "intersect_count_split": 0,
    "intersect_count_bins": 0,
    "cluster_scores_kernel": 0,
    "cluster_scores_staged": 0,
    "cluster_scores_general": 0,
    "flash_attention_kernel": 0,
    "flash_attention_sm90": 0,
    "flash_attention_decode": 0,
    "flash_attention_combine": 0,
    "flash_attention_resident": 0,
    "flash_attention_general": 0,
    "flash_bwd_prep": 0,
    "flash_bwd_dkdv": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkdv_sm90": 0,
    "flash_bwd_dq_sm90": 0,
    "flash_bwd_resident": 0,
    "segment_aggregate_fwd": 0,
    "segment_aggregate_bwd": 0,
    "segment_aggregate_fwd_registers": 0,
    "segment_aggregate_bwd_registers": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's lines for each kernel compiled by this process: its entry
# function, then its registers, stack and spills, and any warning that
# wgmma instructions were serialized ("Potential Performance Loss").
PTXAS: Dict[str, list] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "src/repro_torch/csrc at first use and need the CUDA toolkit"
    )


def _library_path(stem: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_libraries() -> Dict[str, Path]:
    """Compile every missing library (one ``nvcc`` per source, all started
    together) and load them.  Returns the library path of each source."""
    with _build_lock:
        paths = {stem: _library_path(stem) for stem in SOURCES}
        todo = [s for s in SOURCES if s not in _libs and not paths[s].exists()]
        if todo:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for stem in todo:
                tmp = paths[stem].with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
                procs.append((stem, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )))
            errors = []
            for stem, tmp, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, paths[stem])
                    PTXAS[stem] = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                                   if "entry function" in ln or "Used" in ln or "spill" in ln
                                   or "Performance Loss" in ln]
            if errors:
                raise RuntimeError("\n".join(errors))
        for stem in SOURCES:
            if stem in _libs:
                continue
            loaded = ctypes.CDLL(str(paths[stem]))
            for fn_name, argtypes in _SIGNATURES[stem].items():
                fn = getattr(loaded, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[stem] = loaded
        return paths


def is_loaded(stem: str) -> bool:
    """Whether this process has built (or found) and loaded the library
    of ``csrc/<stem>.cu``."""
    return stem in _libs


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    if stem not in _libs:
        build_libraries()
    return _libs[stem]


def check(status: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def stream_of(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
