"""Time the search fold and the δ⁺ scoring kernel of this tree against
another tree's, and ablated copies of the other tree's, at the main
path's shapes on one GPU; and the resident attention variant against
ablated copies of itself at BERT4Rec's call.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent     # on the GPU
    python3 tools/kernel_ab.py                  # the attention alone

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
taken out (a text substitution in the source or a header it includes,
each built in its own directory with its own copy of the headers; a
variant whose text is in neither is reported as not applicable), timed the same way to split the
kernel's time between its parts.  Each unablated fold is checked against
the plain version bit for bit, each unablated scoring within the scores
tolerance.

    python3 tools/kernel_ab.py --bwd            # on the GPU

times the bf16 tensor-core backward's ``flash_bwd_dkdv_sm90`` and
``flash_bwd_dq_sm90`` at gemma3-4b's training shapes against ablated
copies of this tree's ``flash_attention_bwd_sm90.cu`` (``ABLATIONS``: no
operand loads, no tensor-core products, no P exchange between dkdv's
warpgroups, no per-row statistics), and the fp32 resident backward's
``flash_bwd_resident`` at BERT4Rec's training call against ablated copies
of ``flash_attention_bwd_resident.cu`` (no products, no exp, no operand
loads, phase 3 alone, the copies and delta alone), in turns, into
``chiprun_out/kernel_ab_bwd.json``.

The attention's ablations are of this tree's ``flash_attention.cu``
(``design`` is the unchanged source, built the same way).  The input is
BERT4Rec's call on a bulk slice: q, k, v (32768, 2, 200, 32) float32 in
the model's layout, not causal.  Each build's ``flash_resident_launch``
is held to ``FLASH_TOL`` of the plain version, then timed with CUDA
events in ``ATTENTION_TURNS`` turns, every build once a turn, the order
reversed every other turn; ptxas's registers and spills of its kernel
are kept.  Results go to ``chiprun_out/kernel_ab.json`` with the card's
name and power limit.

    python3 tools/kernel_ab.py --decode         # on the GPU

times the one-launch decode at the LM path's single-device decode shapes
split into its parts (the split kernel alone, the counter protocol alone,
the merge's weights without its outputs, the whole design) beside the
two-kernel call it replaced, as graph-replay device ms, in turns, into
``chiprun_out/kernel_ab_decode.json``.

    python3 tools/kernel_ab.py --train <tree>   # on the GPU

runs ``chip_smoke.py``'s first train phase (gemma3-4b, ``TRAIN_PHASES[0]``)
whole in the other tree and in this one, one process a turn (other, this,
this, other), each on an empty card, and writes the steps' host-clock s,
peak GiB, the traced step's stream ms by part and device ms, and the
losses to ``chiprun_out/kernel_ab_train.json``.
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
# The backward's ablations that take out every wgmma, and the loads of the
# per-row statistics.
NO_WGMMA = [("wgmma_ss_n64(acc, da + step, db + step, (c | kk) != 0);", "(void)step;"),
            ("for (int kk = 0; kk < 4; ++kk) wgmma_pv(acc, pf[kk], db + ((kk * 2048) >> 4));",
             "(void)db;")]
STAT_LOADS_OUT = [("stat[r] = in ? p.lse[row0 + r] * SM90_LOG2E : 0.0f;", "stat[r] = 0.0f * in;"),
                  ("stat[SM90_ROWS + r] = in ? p.delta[row0 + r] : 0.0f;",
                   "stat[SM90_ROWS + r] = 0.0f;"),
                  ("lse2[rh] = row < p.lq ? p.lse[at] * SM90_LOG2E : 0.0f;", "lse2[rh] = 0.0f;"),
                  ("dl[rh] = row < p.lq ? p.delta[at] : 0.0f;", "dl[rh] = 0.0f;")]
# The resident backward's ablations: every product out, the operand loads
# out, phase 2 skipped (phase 3 alone), and both phases skipped.
NO_MMA = [("""  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
           "  c[0] += __uint_as_float(a[0] ^ b0 ^ b1);")]
RESIDENT_LOADS_OUT = [("const bool full = c < dch && r < lk;", "const bool full = false;"),
                      ("const bool full = c < dch && r < lq;", "const bool full = false;"),
                      ("    if (live) {\n      const float* orow",
                       "    if (false) {\n      const float* orow")]
RESIDENT_PHASE2 = ("for (int kt = warp; kt < lk16 / FRB_TILE; kt += FRB_WARPS) {",
                   "for (int kt = warp; kt < 0; kt += FRB_WARPS) {")
RESIDENT_PHASE3 = ("tile < groups * q_tiles; tile += FRB_WARPS) {",
                   "tile < 0; tile += FRB_WARPS) {")
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
    # The resident attention kernel, one part of its design undone each.
    ("flash_attention", "design", []),
    # hi's TF32 rounding on the conversion unit (a quarter of the full rate)
    ("flash_attention", "cvt_rounding",
     [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
       "  uint32_t r;\n"
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
       "  return r;")]),
    # lo rounded to nearest as hi is (two more operations a split)
    ("flash_attention", "rounded_lo",
     [("  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;",
       "  lo = fr_tf32(x - __uint_as_float(hi));")]),
    # the keys past Lk masked in every chunk, not only the last
    ("flash_attention", "mask_every_chunk",
     [("  if (j0 + FR_KEYS > lk) {  // the last chunk: keys past Lk (uniform)",
       "  {  // every chunk")]),
    # the library's exp2f in place of one MUFU ex2.approx
    ("flash_attention", "precise_exp2",
     [("  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));", "  y = exp2f(x);")]),
    # the products kept in program order
    ("flash_attention", "volatile_mma",
     [("  asm(\n      \"mma.sync", "  asm volatile(\n      \"mma.sync")]),
    # 8 warps a block (2 blocks an SM) instead of 4 (4 blocks an SM)
    ("flash_attention", "eight_warps", [("#define FR_WARPS 4", "#define FR_WARPS 8")]),
    # The one-launch decode's tail (``--decode``): the counter protocol
    # alone (the last block resets its counter and merges nothing: no
    # output), and the merge's weights without its outputs.
    ("flash_attention", "decode_protocol_only",
     [("    if (!fd_last) return;\n    __threadfence();",
       "    if (!fd_last) return;\n    __threadfence();\n"
       "    if (threadIdx.x == 0) count[bh] = 0;\n    return;")]),
    ("flash_attention", "decode_weights_only",
     [("for (int base = first; base < units; base += K * step) {",
       "for (int base = first; base < 0; base += K * step) {")]),
    # The bf16 tensor-core backward (dkdv and dq), one part undone each.
    ("flash_attention_bwd_sm90", "design", []),
    # no operand tiles from device memory: the producer arrives on each
    # stage with no TMA load (dkdv: Q and dO; dq: K and V), the consumers
    # compute on what the shared memory holds
    ("flash_attention_bwd_sm90", "no_operand_loads",
     [("mbar_expect_tx(full + 8 * s, 2 * C::TILE);", "mbar_expect_tx(full + 8 * s, 0);"),
      ("tma_load_4d(st + c * SM90_CHUNK_BYTES,", "if (false) tma_load_4d(st + c * SM90_CHUNK_BYTES,"),
      ("tma_load_4d(st + C::TILE + c * SM90_CHUNK_BYTES,",
       "if (false) tma_load_4d(st + C::TILE + c * SM90_CHUNK_BYTES,"),
      ("mbar_expect_tx(k_full + 8 * sk, C::TILE);", "mbar_expect_tx(k_full + 8 * sk, 0);"),
      ("tma_load_4d(k_smem + sk * C::TILE", "if (false) tma_load_4d(k_smem + sk * C::TILE"),
      ("mbar_expect_tx(v_full + 8 * sv, C::TILE);", "mbar_expect_tx(v_full + 8 * sv, 0);"),
      ("tma_load_4d(v_smem + sv * C::TILE", "if (false) tma_load_4d(v_smem + sv * C::TILE")]),
    # no tensor-core products: every wgmma left out
    ("flash_attention_bwd_sm90", "no_tensor_cores", NO_WGMMA),
    # dkdv: warpgroup 1 does not wait for warpgroup 0's P (wrong dK)
    ("flash_attention_bwd_sm90", "no_p_exchange",
     [("if (it > 0) named_sync(BWD_BAR_P_FREE, 256);", ""),
      ("named_arrive(BWD_BAR_P_READY, 256);", ""),
      ("named_sync(BWD_BAR_P_READY, 256);", ""),
      ("if (it + 1 < n_tiles) named_arrive(BWD_BAR_P_FREE, 256);", "")]),
    # no per-row statistics loaded (lse and delta taken as 0)
    ("flash_attention_bwd_sm90", "no_stat_loads", STAT_LOADS_OUT),
    # the operand loads alone: no products, no statistics
    ("flash_attention_bwd_sm90", "operand_loads_only", NO_WGMMA + STAT_LOADS_OUT),
    # The fp32 resident backward, one part undone each.
    ("flash_attention_bwd_resident", "design", []),
    # no tensor-core products: each mma.sync of resident_common.cuh becomes
    # one xor and add on an accumulator, so its operands' loads and splits
    # stay live
    ("flash_attention_bwd_resident", "no_products", NO_MMA),
    # no exponentials: P = S - lse
    ("flash_attention_bwd_resident", "no_exp",
     [("  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));", "  y = x;")]),
    # no operand loads: the copies zero-fill shared memory, delta reads no O
    ("flash_attention_bwd_resident", "no_operand_loads", RESIDENT_LOADS_OUT),
    # phase 3 (dQ) alone, neither phase (the copies and delta)
    ("flash_attention_bwd_resident", "phase3_only", [RESIDENT_PHASE2]),
    ("flash_attention_bwd_resident", "copies_and_delta_only", [RESIDENT_PHASE2, RESIDENT_PHASE3]),
]
# BERT4Rec's attention call on a bulk slice: B, H, Hkv, Lq, Lk, D.
ATTENTION_SHAPE = (32768, 2, 2, 200, 200, 32)
ATTENTION_TURNS = 8


def other_package(tree: Path) -> str:
    """Copy ``tree``'s package as ``repro_torch_ab`` and put it on the path."""
    dst = WORK / "src" / "repro_torch_ab"
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(tree / "src" / "repro_torch", dst)
    for py in dst.rglob("*.py"):
        py.write_text(re.sub(r"\brepro_torch\b", "repro_torch_ab", py.read_text()))
    sys.path.insert(0, str(WORK / "src"))
    return "repro_torch_ab"


def build_ablations(build_mod, stems, logs=None):
    """{(stem, variant): loaded library with ``build_mod``'s signatures} for
    the ablations of ``stems``; each nvcc log goes to ``logs`` if given."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    out, procs = {}, []
    WORK.mkdir(parents=True, exist_ok=True)
    for stem, variant, subs in ABLATIONS:
        if stem not in stems:
            continue
        texts = {f"{stem}.cu": (build_mod.CSRC / f"{stem}.cu").read_text()}
        texts.update({h.name: h.read_text() for h in sorted(build_mod.CSRC.glob("*.cuh"))})
        if not all(any(old in text for text in texts.values()) for old, _new in subs):
            out[(stem, variant)] = None
            continue
        where = WORK / f"{stem}_{variant}"  # the source and its headers, as edited
        where.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():
            for old, new in subs:
                text = text.replace(old, new)
            (where / name).write_text(text)
        cu = where / f"{stem}.cu"
        so = WORK / f"lib{stem}_{variant}.so"
        procs.append((stem, variant, so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(build_mod.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for stem, variant, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {stem}_{variant}.cu failed:\n{log}")
        if logs is not None:
            logs[(stem, variant)] = log
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


def search_ab(torch, tree: Path, report: dict) -> None:
    """The fold and the scoring kernel of this tree against ``tree``'s and
    its ablated copies (``report["fold"]``, ``report["cluster_scores"]``)."""
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

    name = other_package(tree)
    other_build = __import__(f"{name}.kernels.build", fromlist=["x"])
    other_fold = __import__(f"{name}.kernels.intersect.kernel", fromlist=["x"]).segment_fold_cuda
    other_scores = __import__(f"{name}.kernels.cluster_score.kernel",
                              fromlist=["x"]).cluster_scores_cuda
    other_build.build_libraries()
    base_libs = dict(other_build._libs)
    ablated = build_ablations(other_build, ("fold", "cluster_score"))

    def with_lib(stem, lib, fn):
        other_build._libs[stem] = lib or base_libs[stem]
        return fn

    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(S.N_DOCS), "--k", str(S.K_CLUSTERS), "--tc", "3000",
        "--queries", str(S.N_QUERIES), "--device", "cuda"])
    svc, logs, _report, _corpus = search.setup(args, log_fn=lambda *a: None)
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


def attention_ab(torch) -> dict:
    """The resident attention kernel and its ablated copies at BERT4Rec's
    call: {variant: its row}, each held to ``FLASH_TOL`` and timed in turns."""
    import chip_smoke as S
    from _torch_parity import attention_ref_chunked, flash_close, flash_inputs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as FK

    logs = {}
    built = {variant: lib for (_stem, variant), lib in
             build_ablations(B, ("flash_attention",), logs).items()
             if not variant.startswith("decode_")}
    missing = [variant for variant, lib in built.items() if lib is None]
    if missing:
        raise RuntimeError(f"ablations whose text is not in flash_attention.cu: {missing}")
    dev = torch.device("cuda", 0)
    b, h, hkv, lq, lk, d = ATTENTION_SHAPE
    q, k, v = flash_inputs(dev, torch.float32, b, h, hkv, lq, lk, d, seed=4, model_layout=True)
    want = attention_ref_chunked(q.float(), k.float(), v.float(), False)
    launch = FK._launch_of(q, k, v, False, None, "kernel_ab")
    if launch.route != "resident":
        raise AssertionError(f"BERT4Rec's call takes the {launch.route} variant")
    out = torch.empty_like(q)

    def call(lib):  # on the current stream: a graph capture's, when there is one
        B.check(lib.flash_resident_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), launch.resident_args, launch.scale,
                                          None, B.stream_of(dev)), "flash_attention_resident")

    rows = {}
    for variant, lib in built.items():
        call(lib)
        err, share = flash_close(out, want)
        lines = logs[("flash_attention", variant)].splitlines()
        at = next(i for i, ln in enumerate(lines) if "flash_resident_kernelILi1" in ln)
        rows[variant] = {"ptxas": [ln.split(":", 1)[-1].strip() for ln in lines[at + 1:at + 4]
                                   if "Used" in ln or "spill" in ln],
                         "max_abs_err": err, "share_of_limit": share, "ms": []}
    for turn in range(ATTENTION_TURNS):
        for variant in (list(built) if turn % 2 == 0 else list(built)[::-1]):
            rows[variant]["ms"].append(S.time_ms(lambda lib=built[variant]: call(lib), reps=10))
    for variant, row in rows.items():
        row["median_ms"] = float(np.median(row["ms"]))
        row["min_ms"], row["max_ms"] = min(row["ms"]), max(row["ms"])
        row["graph_ms"] = S.graph_ms(lambda lib=built[variant]: call(lib), reps=10)
        print(f"{variant}: median {row['median_ms']:.4f} ms (min {row['min_ms']:.4f}, max "
              f"{row['max_ms']:.4f}, graph {row['graph_ms']:.4f}) {' | '.join(row['ptxas'])}; "
              f"max |err| {row['max_abs_err']:.3g} ({row['share_of_limit']:.3g} of FLASH_TOL)",
              flush=True)
    return {"shape": ATTENTION_SHAPE, "turns": ATTENTION_TURNS, "rows": rows}


def decode_ab(torch) -> dict:
    """The one-launch decode at the LM path's single-device decode shapes
    (``chip_smoke.FLASH_ROW_SHAPES``), split into its parts by graph-replay
    device ms: the split kernel alone (PartialsOnly), the counter protocol
    alone, the merge's weights without its outputs, the whole design, and
    the two-kernel call it replaced (``kernel._decode_two_kernels_forced``),
    in ``ATTENTION_TURNS`` turns (the order reversed every other turn); the
    design's output equal to the two-kernel call's bit for bit.  Each build
    counts on its own buffer, set back to 0 after the variants that leave
    counters set."""
    import chip_smoke as S
    from _torch_parity import flash_inputs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as FK

    built = {variant: lib for (_stem, variant), lib in
             build_ablations(B, ("flash_attention",)).items()
             if variant == "design" or variant.startswith("decode_")}
    missing = [variant for variant, lib in built.items() if lib is None]
    if missing:
        raise RuntimeError(f"ablations whose text is not in flash_attention.cu: {missing}")
    dev = torch.device("cuda", 0)
    report = {}
    for n, (label, b, h, hkv, lq, lk, d, window, _copies) in enumerate(S.FLASH_ROW_SHAPES):
        if FK.flash_route(torch.bfloat16, h, hkv, lq, lk, d, True, window) != "decode" \
                or "mesh" in label:
            continue
        q, k, v = flash_inputs(dev, torch.bfloat16, b, h, hkv, lq, lk, d, seed=100 + n,
                               model_layout=True)
        launch = FK._launch_of(q, k, v, True, window, "kernel_ab")
        ml_ptr, acc_ptr, scratch = FK._decode_scratch(launch, dev)
        counts = torch.zeros(b * hkv, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)

        def call(lib, mode):
            B.check(lib.flash_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ml_ptr, acc_ptr, out.data_ptr(),
                counts.data_ptr(), launch.decode_args, launch.scale, mode, B.stream_of(dev)),
                "flash_attention_decode")

        calls = {"partials only": lambda: call(built["design"], FK._PARTIALS_ONLY),
                 **{variant: (lambda lib=lib: call(lib, FK._FUSED))
                    for variant, lib in built.items()},
                 "two kernels": lambda: FK._decode_two_kernels_forced(q, k, v, True, window)}
        call(built["design"], FK._FUSED)
        if not torch.equal(out, FK._decode_two_kernels_forced(q, k, v, True, window)):
            raise AssertionError(f"the one-launch decode differs from the two kernels at {label}")
        rows = {name: [] for name in calls}
        for turn in range(ATTENTION_TURNS):
            for name in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
                rows[name].append(S.graph_ms(calls[name], reps=20))
                counts.zero_()  # the protocol-only build leaves its last counts set
        report[label] = {name: float(np.median(t)) for name, t in rows.items()}
        report[label]["plan"] = launch.plan
        print(f"decode {label} {launch.plan}: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in report[label].items() if name != "plan")
              + " (device ms, medians)", flush=True)
        del q, k, v, out, scratch, counts
    return {"turns": ATTENTION_TURNS, "shapes": report}


def attention_bwd_ab(torch) -> dict:
    """The bf16 tensor-core backward's two kernels and their ablated copies
    at gemma3-4b's training shapes (``chip_smoke.BWD_TRAIN_SHAPES``' bf16
    rows): per shape and variant the median of ``ATTENTION_TURNS`` turns of
    ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90`` (CUDA events, 5
    launches a turn), the design's outputs equal to this tree's build bit
    for bit (the build ``chip_smoke.py`` holds to the plain version)."""
    import chip_smoke as S
    from _torch_parity import flash_inputs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as FK

    stem = "flash_attention_bwd_sm90"
    built = {variant: lib for (_stem, variant), lib in build_ablations(B, (stem,)).items()}
    missing = [variant for variant, lib in built.items() if lib is None]
    if missing:
        raise RuntimeError(f"ablations whose text is not in {stem}.cu: {missing}")
    dev = torch.device("cuda", 0)
    report = {}
    for label, dt, b, h, hkv, lq, lk, d, causal, window in S.BWD_TRAIN_SHAPES:
        if dt != "bfloat16":
            continue
        q, k, v = flash_inputs(dev, torch.bfloat16, b, h, hkv, lq, lk, d, seed=5,
                               model_layout=True)
        dout = torch.randn(q.shape, device=dev).to(torch.bfloat16)
        out, lse = FK.flash_attention_lse_cuda(q, k, v, causal, window)
        lse, delta = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse)
        want_dq = FK.bwd_dq_sm90_cuda(q, k, v, dout, lse, delta, causal, window)
        want_dk, want_dv = FK.bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal, window)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        args_kv = FK._BwdLaunch(q, k, v, dout, dout, q, dk, dv, causal, window)
        args_q = FK._BwdLaunch(q, k, v, dout, dout, dq, k, v, causal, window)

        def dkdv(lib):
            B.check(lib.flash_bwd_dkdv_sm90_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), args_kv.args, args_kv.scale,
                B.stream_of(dev)), "flash_bwd_dkdv_sm90")

        def dq_call(lib):
            B.check(lib.flash_bwd_dq_sm90_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), args_q.args, args_q.scale, B.stream_of(dev)),
                "flash_bwd_dq_sm90")

        dkdv(built["design"])
        dq_call(built["design"])
        torch.cuda.synchronize()
        if not (torch.equal(dk, want_dk) and torch.equal(dv, want_dv) and torch.equal(dq, want_dq)):
            raise AssertionError(f"the design's copy differs from this tree's build at {label}")
        rows = {variant: {"dkdv_ms": [], "dq_ms": []} for variant in built}
        for turn in range(ATTENTION_TURNS):
            for variant in (list(built) if turn % 2 == 0 else list(built)[::-1]):
                lib = built[variant]
                rows[variant]["dkdv_ms"].append(S.time_ms(lambda lib=lib: dkdv(lib), reps=5))
                rows[variant]["dq_ms"].append(S.time_ms(lambda lib=lib: dq_call(lib), reps=5))
        for variant, row in rows.items():
            for key in ("dkdv_ms", "dq_ms"):
                row[f"median_{key}"] = float(np.median(row[key]))
            print(f"backward {label} {variant}: dkdv median {row['median_dkdv_ms']:.4f} ms, dq "
                  f"median {row['median_dq_ms']:.4f} ms", flush=True)
        report[label] = rows
        del q, k, v, out, dout, lse, delta, dq, dk, dv, want_dq, want_dk, want_dv
        torch.cuda.empty_cache()
    return {"turns": ATTENTION_TURNS, "shapes": report}


def resident_bwd_ab(torch) -> dict:
    """The fp32 resident backward and its ablated copies at BERT4Rec's
    training call (``chip_smoke.BWD_TRAIN_SHAPES``' fp32 row, given the
    resident forward's lse): per variant ptxas's registers and spills and
    the median of ``ATTENTION_TURNS`` turns (CUDA events, 5 launches a
    turn, every build once a turn, the order reversed every other turn);
    the design's outputs must equal this tree's build bit for bit (the
    build ``chip_smoke.py`` holds to the plain version)."""
    import chip_smoke as S
    from _torch_parity import flash_inputs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as FK

    stem = "flash_attention_bwd_resident"
    logs = {}
    built = {variant: lib for (_stem, variant), lib in build_ablations(B, (stem,), logs).items()}
    missing = [variant for variant, lib in built.items() if lib is None]
    if missing:
        raise RuntimeError(f"ablations whose text is not in {stem}.cu or its headers: {missing}")
    dev = torch.device("cuda", 0)
    (label, dt, b, h, hkv, lq, lk, d, causal, window), = [
        row for row in S.BWD_TRAIN_SHAPES if row[1] == "float32"]
    q, k, v = flash_inputs(dev, torch.float32, b, h, hkv, lq, lk, d, seed=5, model_layout=True)
    dout = torch.randn(q.shape, device=dev)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, causal, window)
    want = FK.bwd_resident_cuda(q, k, v, out, dout, lse, causal, window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = FK._resident_bwd_args(q, k, v, out, dout, lse, dq, dk, dv)

    def call(lib):  # on the stream of the call's arguments
        B.check(lib.flash_bwd_resident_launch(*args), "flash_bwd_resident")

    rows = {}
    for variant, lib in built.items():
        lines = logs[(stem, variant)].splitlines()
        at = next(i for i, ln in enumerate(lines) if "flash_bwd_resident_kernelILi1" in ln)
        rows[variant] = {"ptxas": [ln.split(":", 1)[-1].strip() for ln in lines[at + 1:at + 4]
                                   if "Used" in ln or "spill" in ln], "ms": []}
        if variant == "design":
            call(lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip((dq, dk, dv), want, strict=True)):
                raise AssertionError("the design's copy differs from this tree's build")
    for turn in range(ATTENTION_TURNS):
        for variant in (list(built) if turn % 2 == 0 else list(built)[::-1]):
            rows[variant]["ms"].append(S.time_ms(lambda lib=built[variant]: call(lib), reps=5))
    for variant, row in rows.items():
        row["median_ms"] = float(np.median(row["ms"]))
        row["min_ms"], row["max_ms"] = min(row["ms"]), max(row["ms"])
        print(f"resident backward {label} {variant}: median {row['median_ms']:.4f} ms (min "
              f"{row['min_ms']:.4f}, max {row['max_ms']:.4f}) {' | '.join(row['ptxas'])}",
              flush=True)
    return {"shape": [b, h, hkv, lq, lk, d], "turns": ATTENTION_TURNS, "rows": rows}


# What ``train_ab`` keeps of a train phase's report.
TRAIN_KEYS = ("step_s", "step_s_median", "peak_gib", "forward_ms", "backward_ms",
              "attention_backward_ms", "optimizer_ms", "device_ms", "idle_share", "losses")
# One train phase of the tree it runs in (the working directory).
TRAIN_CHILD = f"""
import json, sys
sys.path[:0] = ["src", ".", "tests"]
import torch
import chip_smoke as C
from repro_torch.kernels import build as B
torch.cuda.set_device(0)
B.build_libraries()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
report, _ = C.train_phase(torch, torch.device("cuda", 0), C.TRAIN_PHASES[0])
print("TRAIN_AB " + json.dumps({{k: report.get(k) for k in {TRAIN_KEYS!r}}}))
"""


def train_ab(tree: Path) -> list:
    """``chip_smoke.py``'s first train phase in ``tree`` and in this tree,
    one process a turn (other, this, this, other): each turn's report."""
    runs = []
    for name, where in (("other", tree), ("this", ROOT), ("this", ROOT), ("other", tree)):
        proc = subprocess.run([sys.executable, "-c", TRAIN_CHILD], cwd=where, capture_output=True,
                              text=True, timeout=600)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_AB ")), None)
        if proc.returncode or line is None:
            raise RuntimeError(f"the train phase in {where} failed:\n{proc.stderr[-4000:]}")
        runs.append({"tree": name, **json.loads(line.removeprefix("TRAIN_AB "))})
        print(f"train {name}: " + json.dumps(runs[-1]), flush=True)
    return runs


def main(argv) -> int:
    import torch

    if argv in (["--bwd"], ["--decode"]):
        if not torch.cuda.is_available():
            print(__doc__, file=sys.stderr)
            return 2
        sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]
        import chip_smoke as S

        report = {"card": S.card_line()}
        print(report["card"], flush=True)
        if argv == ["--decode"]:
            report["decode"] = decode_ab(torch)
        else:
            report["attention_bwd"] = attention_bwd_ab(torch)
            report["resident_bwd"] = resident_bwd_ab(torch)
        out = ROOT / "chiprun_out" / f"kernel_ab_{argv[0][2:]}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        return 0
    train = argv[:1] == ["--train"]
    if len(argv) > (2 if train else 1) or train and len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]
    import chip_smoke as S

    report = {"card": S.card_line()}
    print(report["card"], flush=True)
    if train:
        report["other_tree"] = argv[1]
        report["train"] = train_ab(Path(argv[1]).resolve())
    else:
        if argv:
            report["other_tree"] = argv[0]
            search_ab(torch, Path(argv[0]).resolve(), report)
        report["attention"] = attention_ab(torch)
    out = ROOT / "chiprun_out" / ("kernel_ab_train.json" if train else "kernel_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
