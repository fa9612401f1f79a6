"""Time the search fold and the δ⁺ scoring kernel of this tree against
another tree's, and ablated copies of the other tree's, at the main
path's shapes on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent     # on the GPU

The other tree's ``src/repro_torch`` is copied to
``build/kernel_ab/src/repro_torch_ab`` with its imports renamed, so both
trees' launchers run in one process on one card.  The inputs are this
tree's: the search path of ``chip_smoke.py`` (``N_DOCS`` ``wiki``
documents, the first batch of each query log, lowered) and the top
TopDown split's scoring (the full frequent-term ELL, K = 8 tables of a
seeded random assignment).  Every launcher is timed in turns (other,
this, this, other):

* ``eager_ms``: CUDA events around back-to-back launcher calls (host
  launch cost and any sync the launcher makes included);
* ``graph_ms``: the same calls replayed from a CUDA graph (None where the
  launcher copies from pageable host memory, which a capture refuses);
* ``profile``: ``torch.profiler`` device time per call of the kernel and
  of the launcher's other device work (fills, copies), and the host time
  per call.

``ABLATIONS`` are copies of the other tree's sources with one part
taken out (a text substitution; a variant whose text is not in the
source is reported as not applicable), timed the same way to split the
kernel's time between its parts.  Each unablated fold is checked against
the plain version bit for bit, each unablated scoring within the scores
tolerance.  Results go to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "kernel_ab"
# (source stem, variant, [(text, replacement), ...])
ABLATIONS = [
    ("fold", "no_count_atomics", [("atomicAdd(&counts[query], 1);", "(void)query;")]),
    ("fold", "no_entering_atomics",
     [("if (lane == 0 && ballot) atomicAdd(&entering[s - 1], __popc(ballot));", "(void)ballot;")]),
    ("fold", "no_atomics", [("atomicAdd(&counts[query], 1);", "(void)query;"),
                            ("if (lane == 0 && ballot) atomicAdd(&entering[s - 1], __popc(ballot));",
                             "(void)ballot;")]),
    ("fold", "single_probe", [("for (int it = 0; it < iters; ++it) {",
                               "for (int it = 0; it < (iters > 0 ? 1 : 0); ++it) {")]),
    ("fold", "single_probe_no_atomics",
     [("for (int it = 0; it < iters; ++it) {", "for (int it = 0; it < (iters > 0 ? 1 : 0); ++it) {"),
      ("atomicAdd(&counts[query], 1);", "(void)query;"),
      ("if (lane == 0 && ballot) atomicAdd(&entering[s - 1], __popc(ballot));", "(void)ballot;")]),
    # the ELL stream alone: every valid slot adds p[r], no table row
    ("cluster_score", "ell_only", [("acc[c] += ws * trow[32 * c];", "acc[c] += ws;")]),
    # the gathers alone: every row reads the ranks of one of 256 rows (L2)
    ("cluster_score", "gathers_only", [("const int32_t* row = ell + d * l;",
                                        "const int32_t* row = ell + (d & 255) * l;")]),
]


def other_package(tree: Path) -> str:
    """Copy ``tree``'s package as ``repro_torch_ab`` and put it on the path."""
    dst = WORK / "src" / "repro_torch_ab"
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(tree / "src" / "repro_torch", dst)
    for py in dst.rglob("*.py"):
        py.write_text(re.sub(r"\brepro_torch\b", "repro_torch_ab", py.read_text()))
    sys.path.insert(0, str(WORK / "src"))
    return "repro_torch_ab"


def build_ablations(build_mod):
    """{(stem, variant): loaded library with the other tree's signatures}."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    out, procs = {}, []
    for stem, variant, subs in ABLATIONS:
        src = (build_mod.CSRC / f"{stem}.cu").read_text()
        if not all(old in src for old, _new in subs):
            out[(stem, variant)] = None
            continue
        for old, new in subs:
            src = src.replace(old, new)
        cu = WORK / f"{stem}_{variant}.cu"
        cu.write_text(src)
        so = WORK / f"lib{stem}_{variant}.so"
        procs.append((stem, variant, so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for stem, variant, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {stem}_{variant}.cu failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in build_mod._SIGNATURES[stem].items():
            getattr(lib, fn_name).argtypes = list(argtypes)
            getattr(lib, fn_name).restype = ctypes.c_int
        out[(stem, variant)] = lib
    return out


def profile_call(torch, fn, kernel_key: str, reps: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernel_us = other_us = 0.0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if kernel_key in e.key:
            kernel_us += us
        else:
            other_us += us
    return {"kernel_device_ms": kernel_us / 1e3 / reps, "other_device_ms": other_us / 1e3 / reps,
            "host_ms": host_ms}


def timings(torch, fn, kernel_key: str) -> dict:
    import chip_smoke as S

    prof = profile_call(torch, fn, kernel_key)
    try:
        device = S.graph_ms(fn)
    except RuntimeError:  # PyTorch refuses a host copy inside a capture before it runs
        torch.cuda.synchronize()
        device = None
    return {"eager_ms": S.time_ms(fn), "graph_ms": device, "profile": prof}


def main(argv) -> int:
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as S
    from repro_torch.core import torch_ops as T
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import lower_plan
    from repro_torch.core.queries import as_queries
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref
    from repro_torch.kernels.intersect.kernel import segment_fold_cuda
    from repro_torch.kernels.intersect.ref import segment_fold_ref
    from repro_torch.launch import search

    name = other_package(Path(argv[0]).resolve())
    other_build = __import__(f"{name}.kernels.build", fromlist=["x"])
    other_fold = __import__(f"{name}.kernels.intersect.kernel", fromlist=["x"]).segment_fold_cuda
    other_scores = __import__(f"{name}.kernels.cluster_score.kernel",
                              fromlist=["x"]).cluster_scores_cuda
    report = {"card": S.card_line(), "other_tree": argv[0]}
    print(report["card"], flush=True)
    other_build.build_libraries()
    base_libs = dict(other_build._libs)
    ablated = build_ablations(other_build)

    def with_lib(stem, lib, fn):
        other_build._libs[stem] = lib or base_libs[stem]
        return fn

    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(S.N_DOCS), "--k", str(S.K_CLUSTERS), "--tc", "3000",
        "--queries", str(S.N_QUERIES), "--device", "cuda"])
    svc, logs, _report = search.setup(args, log_fn=lambda *a: None)
    di, dev = svc.device_index, svc.device_index.device
    report["fold"] = {}
    for log_name, lg in logs.items():
        low = lower_plan(plan_segment_pairs(di.host, as_queries(lg.queries)[:search.SERVE_BATCH],
                                            track_work=False))
        fold_args = (di.post_docs, torch.from_numpy(low.cells).to(dev),
                     torch.from_numpy(low.stage_seg).to(dev), low.group_width, low.stage_iters,
                     low.n_queries_pad, True)
        want = segment_fold_ref(*fold_args)
        row = {"cells": int(low.n_cells), "stage_iters": list(low.stage_iters), "turns": []}
        for turn, fn in (("other", other_fold), ("this", segment_fold_cuda),
                         ("this", segment_fold_cuda), ("other", other_fold)):
            other_build._libs["fold"] = base_libs["fold"]
            for g, w in zip(fn(*fold_args), want, strict=True):
                if not torch.equal(g, w):
                    raise AssertionError(f"segment_fold ({turn} tree) disagrees with plain")
            row["turns"].append({"tree": turn, **timings(
                torch, lambda fn=fn: fn(*fold_args), "segment_fold")})
        for (stem, variant), lib in ablated.items():
            if stem == "fold":
                row[variant] = None if lib is None else timings(
                    torch, with_lib("fold", lib, lambda: other_fold(*fold_args)), "segment_fold")
        other_build._libs["fold"] = base_libs["fold"]
        report["fold"][log_name] = row
        print(f"fold {log_name}: " + json.dumps(row), flush=True)

    view = svc.res.view
    ell = torch.from_numpy(T.ell_pack(view)[0]).to(dev)
    p = torch.from_numpy(np.asarray(view.p_freq, np.float32)).to(dev)
    assign = torch.from_numpy(
        np.random.default_rng(0).integers(0, 8, view.n_docs).astype(np.int32)).to(dev)
    tables = T.delta_add_tables_torch(T.counts_from_ell(ell, assign, 8, view.tc), p).T.contiguous()
    want = cluster_scores_ref(ell, p, tables)
    row = {"shape": [*ell.shape, *tables.shape], "turns": []}
    this_variants = [("this", lambda v=v: cluster_scores_cuda(ell, p, tables, variant=v), v)
                     for v in ("staged", "general")]
    other = ("other", lambda: other_scores(ell, p, tables), "kernel")
    for turn, fn, variant in (other, *this_variants, *this_variants, other):
        other_build._libs["cluster_score"] = base_libs["cluster_score"]
        S.assert_close(f"cluster_scores ({turn} tree, {variant})", fn(), want)
        row["turns"].append({"tree": turn, "variant": variant,
                             **timings(torch, fn, "cluster_scores")})
    for (stem, variant), lib in ablated.items():
        if stem == "cluster_score":
            row[variant] = None if lib is None else timings(
                torch, with_lib("cluster_score", lib, lambda: other_scores(ell, p, tables)),
                "cluster_scores")
    other_build._libs["cluster_score"] = base_libs["cluster_score"]
    report["cluster_scores"] = row
    print("cluster_scores: " + json.dumps(row), flush=True)
    out = ROOT / "chiprun_out" / "kernel_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
