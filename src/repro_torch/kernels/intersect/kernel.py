"""CUDA kernels of the search path, built with ``nvcc`` for ``sm_90a``
and bound with ``ctypes``.

Sources live in ``src/repro_torch/csrc/``: ``fold.cu`` (the multi-stage
fold of the device engine) and ``intersect.cu`` (the intersect trio).
Each source is compiled on first use into its own shared library under
``build/repro_torch/`` at the repository root, named by a hash of the
source and the compiler flags, so an edited source rebuilds and an
unchanged one loads at once.  Both sources compile in parallel.  Without
``nvcc``, or when a build fails, the build raises: there is no fallback.

Every launcher checks device, dtype, contiguity and shape, allocates its
outputs with ``torch.empty``/``torch.zeros``, launches on
``torch.cuda.current_stream()``, raises when the launch reports a CUDA
error, and adds one to its entry of :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "build_libraries",
    "segment_fold_cuda",
    "intersect_members_cuda",
    "intersect_members_count_cuda",
    "intersect_count_cuda",
]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("fold", "intersect")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "fold": {
        "segment_fold_launch": (_P, _L, _P, _L, _P, _L, _I, _P, _I, _I, _P, _P, _P, _P),
    },
    "intersect": {
        name: (_P, _P, _L, _L, _L, _P, _P)
        for name in (
            "intersect_members_launch",
            "intersect_members_count_launch",
            "intersect_count_launch",
        )
    },
}

# Launch counts of the four kernels: one per launch, incremented only
# where a kernel is launched (never on the plain CPU path).
LAUNCHES: Dict[str, int] = {
    "segment_fold": 0,
    "intersect_members_kernel": 0,
    "intersect_members_count_kernel": 0,
    "intersect_count_kernel": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
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
            if errors:
                raise RuntimeError("\n".join(errors))
        for stem in SOURCES:
            if stem in _libs:
                continue
            lib = ctypes.CDLL(str(paths[stem]))
            for fn_name, argtypes in _SIGNATURES[stem].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[stem] = lib
        return paths


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _libs:
        build_libraries()
    return _libs[stem]


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def _check_int32_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: inputs must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return device


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def segment_fold_cuda(
    post_docs: torch.Tensor,
    cells: torch.Tensor,
    stage_seg: torch.Tensor,
    group_width: int,
    stage_iters: Sequence[int],
    n_queries_pad: int,
    return_members: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The fold kernel (``csrc/fold.cu``): same contract as
    :func:`repro_torch.kernels.intersect.ref.segment_fold_ref`."""
    device = _check_int32_cuda("segment_fold", post_docs, cells, stage_seg)
    n_stages = len(stage_iters)
    if post_docs.dim() != 1 or cells.dim() != 2 or cells.shape[0] != 4:
        raise ValueError("segment_fold: post_docs (n,) and cells (4, N) expected")
    if stage_seg.dim() != 2 or stage_seg.shape[0] != 2:
        raise ValueError("segment_fold: stage_seg (2, n_stages * group_width) expected")
    if stage_seg.shape[1] != n_stages * group_width:
        raise ValueError("segment_fold: stage_seg width != n_stages * group_width")
    n_cells = cells.shape[1]
    counts = torch.zeros(n_queries_pad, dtype=torch.int32, device=device)
    entering = torch.zeros(n_stages, dtype=torch.int32, device=device)
    members = (
        torch.empty(n_cells, dtype=torch.int32, device=device)
        if return_members
        else None
    )
    iters = torch.tensor(list(stage_iters), dtype=torch.int32).to(device)
    status = _lib("fold").segment_fold_launch(
        post_docs.data_ptr(),
        post_docs.shape[0],
        cells.data_ptr(),
        n_cells,
        stage_seg.data_ptr(),
        stage_seg.shape[1],
        group_width,
        iters.data_ptr(),
        n_stages,
        n_queries_pad,
        counts.data_ptr(),
        entering.data_ptr(),
        members.data_ptr() if members is not None else None,
        _stream(device),
    )
    _check(status, "segment_fold")
    LAUNCHES["segment_fold"] += 1
    return counts, entering, members


def _rows_call(fn_name: str, counter: str, short, long, out):
    device = _check_int32_cuda(counter, short, long)
    if short.dim() != 2 or long.dim() != 2 or short.shape[0] != long.shape[0]:
        raise ValueError(f"{counter}: short (B, Ls) and long (B, Ll) expected")
    status = getattr(_lib("intersect"), fn_name)(
        short.data_ptr(),
        long.data_ptr(),
        short.shape[0],
        short.shape[1],
        long.shape[1],
        out.data_ptr(),
        _stream(device),
    )
    _check(status, counter)
    LAUNCHES[counter] += 1
    return out


def intersect_members_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B, Ls) ``short`` with misses replaced by PAD."""
    out = torch.empty(short.shape, dtype=torch.int32, device=short.device)
    return _rows_call("intersect_members_launch", "intersect_members_kernel", short, long, out)


def intersect_members_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 hit count of the members probe."""
    out = torch.empty(short.shape[0], dtype=torch.int32, device=short.device)
    return _rows_call(
        "intersect_members_count_launch", "intersect_members_count_kernel", short, long, out
    )


def intersect_count_cuda(short: torch.Tensor, long: torch.Tensor) -> torch.Tensor:
    """(B,) int32 |short ∩ long| per row."""
    out = torch.empty(short.shape[0], dtype=torch.int32, device=short.device)
    return _rows_call("intersect_count_launch", "intersect_count_kernel", short, long, out)
