"""Time PNA's aggregation kernels (``csrc/segment_aggregate.cu``: the ring
design of the main path) against variants of their source, and against
the register design forced, at ogb_products' layer shapes on one GPU.

    python3 tools/aggregate_ab.py            # on the GPU

The graph is made on the card from a seed: 2,449,029 nodes and
61,225,725 edges (ogb_products as ``chip_smoke.py`` trains it), sources
uniform, destinations drawn from the power law of ``synth_graph``
(p ∝ i^-1.2, so node 0 takes ~11.5 M edges), every edge weighted 1;
hs and hd (N, 75) float32 normal, hd shifted by 0.3 so that about two
messages in three are positive.  ``VARIANTS`` are copies of this tree's
source with text substitutions, each a choice of the ring design: the
rows a warp's ring holds (``RING_SLOTS``), the edges it reads at once
(``RING_BATCH``; the ring keeps the difference in flight), the warps a
block and the blocks an SM each ring kernel is held to; and the design's
library at other run lengths.  ``design`` is the unchanged source and
``registers`` the register design forced from it
(``kernel._registers_forced_fwd`` and ``_bwd``).  Each is built in its
own directory with ``build.NVCC_FLAGS``; ptxas's registers and spills of
each kernel are kept.  Every variant's forward outputs and its d hd must
equal the design's bit for bit (both designs sum each destination's
edges in the same order), except the ablations' (``ABLATIONS``: a part of
the work taken out, to read what it costs) and, at other run lengths
(``RUN_EDGES_OF``: another order of the float64 sums), all but the exact
fields (max, min, deg, the tie counts).  Every backward is given the
design's forward.  The forward and the backward of each are
then timed with CUDA events in ``TURNS`` turns, every variant once a
turn, the order reversed every other turn.  d hs takes scalar atomics
in every variant: vector reductions need 16-byte aligned rows, and a
row of 75 floats is 300 bytes.  The design's and the register design's
kernels are also timed one by one under ``torch.profiler``
(``kernel_split``).  Results go to ``chiprun_out/aggregate_ab.json``
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "aggregate_ab"
N_NODES, N_EDGES, D = 2_449_029, 61_225_725, 75
TURNS, REPS = 4, 3
SEED = 0

# (name, what it tests, [(old text, new text), ...]) over segment_aggregate.cu;
# "registers" is the design's library with the register design forced.
SLOTS, BATCH, WARPS = "#define RING_SLOTS 8", "#define RING_BATCH 2", "#define RING_WARPS 4"
FWD_BLOCKS, BWD_BLOCKS = "#define RING_FWD_BLOCKS 5", "#define RING_BWD_BLOCKS 4"
VARIANTS = [
    ("design", "the source as it is", []),
    ("registers", "the register design, forced", []),
    ("ring_4", "4 rows a warp's ring (2 in flight)", [(SLOTS, "#define RING_SLOTS 4")]),
    ("ring_16", "16 rows a warp's ring (14 in flight)", [(SLOTS, "#define RING_SLOTS 16")]),
    ("batch_1", "one edge read at a time (7 in flight)", [(BATCH, "#define RING_BATCH 1")]),
    ("batch_4", "four edges read at a time (4 in flight)", [(BATCH, "#define RING_BATCH 4")]),
    ("warps_8", "blocks of 8 warps: the forward 2 an SM (16 warps), the backward 2",
     [(WARPS, "#define RING_WARPS 8"), (FWD_BLOCKS, "#define RING_FWD_BLOCKS 2"),
      (BWD_BLOCKS, "#define RING_BWD_BLOCKS 2")]),
    ("fwd_6_blocks", "the forward held to 6 blocks of 4 warps an SM (24 warps)",
     [(FWD_BLOCKS, "#define RING_FWD_BLOCKS 6")]),
    ("bwd_5_blocks", "the backward held to 5 blocks of 4 warps an SM (20 warps)",
     [(BWD_BLOCKS, "#define RING_BWD_BLOCKS 5")]),
    ("run_512", "runs of 512 edges (the design's library)", []),
    ("run_2048", "runs of 2,048 edges", []),
    ("run_4096", "runs of 4,096 edges", []),
    # Ablations (their outputs are not the function's, so not compared):
    ("gather_only", "ablation: the rows gathered and summed, no statistics or gradients",
     [("    for (int c = 0; c < NCH; ++c) add_edge_ring(a[c], message(x[c], y[c], wt), pos);",
       "    for (int c = 0; c < NCH; ++c) a[c].s1 += x[c] + pos;"),
      ("      const float pre = __fadd_rn(x[c], y[c]);\n",
       "      acc[c] += x[c];\n      continue;\n      const float pre = 0.f;\n")]),
    ("no_gather", "ablation: no source row copied (the ring read as it lies)",
     [("        if (act(c, d)) copy4_async(to + c * WARP, row + c * WARP);",
       "        (void)row, (void)to;")]),
    ("no_atomics", "ablation: the backward without its d hs atomics",
     [("      if (g0 + c * WARP + lane < d && dpre != 0.f) atomicAdd(d_row + c * WARP, dpre);",
       "      (void)d_row;")]),
]
ABLATIONS = ("gather_only", "no_gather", "no_atomics")
# Variants that run the design's library at another run length.
RUN_EDGES_OF = {"run_512": 512, "run_2048": 2048, "run_4096": 4096}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def build_variants(B) -> dict:
    """Compile each variant (one nvcc each, all started together); returns
    name -> (loaded library, ptxas lines)."""
    source = (B.CSRC / "segment_aggregate.cu").read_text()
    procs = {}
    for name, _, subs in VARIANTS:
        if name == "registers" or name in RUN_EDGES_OF:
            continue
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
        where = WORK / name
        where.mkdir(parents=True, exist_ok=True)
        (where / "segment_aggregate.cu").write_text(text)
        cmd = [B._nvcc(), *B.NVCC_FLAGS, "-o", str(where / "lib.so"),
               str(where / "segment_aggregate.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        loaded = ctypes.CDLL(str(WORK / name / "lib.so"))
        for fn_name, argtypes in B._SIGNATURES["segment_aggregate"].items():
            fn = getattr(loaded, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        out[name] = (loaded, [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                              if "entry function" in ln or "Used" in ln or "spill" in ln])
    return out


def make_graph(torch, dev):
    """hs, hd and the destination-sorted edges, made on the card."""
    from repro_torch.kernels.segment_aggregate.ref import edge_csr

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = torch.arange(1, N_NODES + 1, device=dev, dtype=torch.float64) ** -1.2
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(N_EDGES, generator=gen, device=dev, dtype=torch.float64)
    dst = torch.searchsorted(cdf, u).clamp_max(N_NODES - 1).to(torch.int32)
    src = torch.randint(0, N_NODES, (N_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    w = torch.ones(N_EDGES, device=dev)
    csr = edge_csr(src, dst, w, N_NODES)
    hs = torch.randn((N_NODES, D), generator=gen, device=dev)
    hd = torch.randn((N_NODES, D), generator=gen, device=dev) + 0.3
    grads = [torch.randn((N_NODES, D), generator=gen, device=dev) for _ in range(4)]
    return hs, hd, csr, grads


def ptxas_of(lines, kernel: str) -> list:
    """ptxas's register and spill lines of ``kernel`` (a part of its
    mangled name)."""
    at = [i for i, ln in enumerate(lines) if kernel in ln]
    return lines[at[0] + 1:at[0] + 3] if at else []


def kernel_split(torch, fns, B, hs, hd, csr, saved, grads) -> dict:
    """Device ms of each kernel a forward and a backward launch (one each
    under ``torch.profiler``), by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loaded, fwd, bwd = fns
    B._libs["segment_aggregate"] = loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd(hs, hd, csr)
        bwd(hs, hd, csr, saved, *grads)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"seg_agg_\w+|FillFunctor", e.name)
            key = found.group(0) if found else e.name[:40]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as B
    from repro_torch.kernels.segment_aggregate import kernel as K

    if not torch.cuda.is_available():
        print("aggregate_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    built = build_variants(B)
    hs, hd, csr, grads = make_graph(torch, dev)
    real_lib = B._libs.get("segment_aggregate")

    def launchers(name):
        """(library, forward, backward) of a variant."""
        if name == "registers":
            return built["design"][0], K._registers_forced_fwd, K._registers_forced_bwd
        if name in RUN_EDGES_OF:
            run = RUN_EDGES_OF[name]
            return (built["design"][0],
                    lambda *a: K.segment_aggregate_fwd_cuda(*a, run_edges=run),
                    lambda *a: K.segment_aggregate_bwd_cuda(*a, run_edges=run))
        return built[name][0], K.segment_aggregate_fwd_cuda, K.segment_aggregate_bwd_cuda

    names = [name for name, _, _ in VARIANTS]
    saved, d_hd = {}, {}
    for name in names:  # the design first: the others are held to it, then let go
        loaded, fwd, bwd = launchers(name)
        B._libs["segment_aggregate"] = loaded
        got = fwd(hs, hd, csr)
        got_hd = bwd(hs, hd, csr, saved.get("design", got), *grads)[1]
        if name == "design":
            saved["design"], d_hd["design"] = got, got_hd
            continue
        if name in ABLATIONS:
            continue
        # Another run length sums in another order: only the exact fields match.
        other_runs = name in RUN_EDGES_OF
        for field in (("mx", "mn", "deg", "n_max", "n_min") if other_runs
                      else K.FwdSaved._fields):
            if not torch.equal(getattr(got, field), getattr(saved["design"], field)):
                raise AssertionError(f"{name}: {field} differs from the design's")
        if not other_runs and not torch.equal(got_hd, d_hd["design"]):
            raise AssertionError(f"{name}: d hd differs from the design's")
        del got, got_hd
    del d_hd
    times = {name: {"fwd": [], "bwd": []} for name in names}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            loaded, fwd, bwd = launchers(name)
            B._libs["segment_aggregate"] = loaded
            for part, fn in (("fwd", lambda f=fwd: f(hs, hd, csr)),
                             ("bwd", lambda b=bwd: b(hs, hd, csr, saved["design"], *grads))):
                fn()
                torch.cuda.synchronize()
                start.record()
                for _ in range(REPS):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[name][part].append(start.elapsed_time(end) / REPS)
    kernels = {name: kernel_split(torch, launchers(name), B, hs, hd, csr, saved["design"], grads)
               for name in ("design", "registers")}
    if real_lib is not None:
        B._libs["segment_aggregate"] = real_lib
    report = {"kernels_ms": kernels, "card": card_line(), "nodes": N_NODES, "edges": N_EDGES,
              "d": D, "node0_edges": int(csr.indptr[1] - csr.indptr[0]), "variants": {}}
    print(report["card"])
    for name, split in kernels.items():
        print(f"{name} kernels (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)
    for name, what, _ in VARIANTS:
        fwd, bwd = sorted(times[name]["fwd"]), sorted(times[name]["bwd"])
        lines = built["design" if name == "registers" or name in RUN_EDGES_OF else name][1]
        kernels = (("seg_agg_fwd_runs", "seg_agg_bwd_runsILi3E") if name == "registers"
                   else ("seg_agg_fwd_ringILi3E", "seg_agg_bwd_ringILi3E"))
        row = {"what": what, "fwd_ms": fwd, "bwd_ms": bwd, "fwd_median_ms": fwd[len(fwd) // 2],
               "bwd_median_ms": bwd[len(bwd) // 2], "ptxas": lines,
               "ptxas_fwd": ptxas_of(lines, kernels[0]), "ptxas_bwd": ptxas_of(lines, kernels[1])}
        report["variants"][name] = row
        print(f"{name}: forward {row['fwd_median_ms']:.4f} ms, backward "
              f"{row['bwd_median_ms']:.4f} ms ({what}); forward kernel: "
              + " | ".join(row["ptxas_fwd"]) + "; backward kernel: "
              + " | ".join(row["ptxas_bwd"]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "aggregate_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
