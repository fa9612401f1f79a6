"""Time PNA's aggregation kernels (``csrc/segment_aggregate.cu``) against
variants of their source at ogb_products' layer shapes on one GPU.

    python3 tools/aggregate_ab.py            # on the GPU

The graph is made on the card from a seed: 2,449,029 nodes and
61,225,725 edges (ogb_products as ``chip_smoke.py`` trains it), sources
uniform, destinations drawn from the power law of ``synth_graph``
(p ∝ i^-1.2, so node 0 takes ~11.5 M edges), every edge weighted 1;
hs and hd (N, 75) float32 normal, hd shifted by 0.3 so that about two
messages in three are positive.  ``VARIANTS`` are copies of this tree's
source with text substitutions (``design`` is the unchanged source), each
built in its own directory with ``build.NVCC_FLAGS``; ptxas's registers
and spills of each kernel are kept.  Every variant's forward outputs
max, min, deg and the tie counts must equal the design's bit for bit.
The forward and the backward of each are then timed with CUDA events
in ``TURNS`` turns, every variant once a turn, the order reversed every
other turn.  Results go to ``chiprun_out/aggregate_ab.json`` with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "aggregate_ab"
N_NODES, N_EDGES, D = 2_449_029, 61_225_725, 75
TURNS, REPS = 4, 3
SEED = 0

RUNS_BOUNDS = "__global__ void __launch_bounds__(RUN_WARPS * WARP, 3)\nseg_agg_fwd_runs("
# (name, what it tests, [(old text, new text), ...]) over segment_aggregate.cu.
VARIANTS = [
    ("design", "the source as it is", []),
    ("fwd_free_registers", "the forward's run kernel without its 3 blocks an SM",
     [(RUNS_BOUNDS, RUNS_BOUNDS.replace("WARP, 3)", "WARP)"))]),
    ("fwd_4_blocks", "the forward's run kernel held to 4 blocks an SM (64 registers)",
     [(RUNS_BOUNDS, RUNS_BOUNDS.replace("WARP, 3)", "WARP, 4)"))]),
    ("square_in_fp32", "v^2 rounded in float32 before its float64 sum (no float64 multiply)",
     [("a.s2 = __dadd_rn(a.s2, __dmul_rn(x, x));",
       "a.s2 = __dadd_rn(a.s2, (double)__fmul_rn(v, v));")]),
    ("fp32_run_sums", "the run kernel's running sums in float32 (records and merge in float64)",
     [("  double s1, s2;  // float64 sums", "  float s1, s2;  // float32 sums"),
      ("  a.s1 = __dadd_rn(a.s1, x);\n  a.s2 = __dadd_rn(a.s2, __dmul_rn(x, x));",
       "  a.s1 = __fadd_rn(a.s1, v);\n  a.s2 = __fadd_rn(a.s2, __fmul_rn(v, v));\n  (void)x;")]),
]


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
    design = K.segment_aggregate_fwd_cuda(hs, hd, csr)
    real_lib = B._libs.get("segment_aggregate")
    saved = {}
    for name, (loaded, _) in built.items():
        B._libs["segment_aggregate"] = loaded
        saved[name] = K.segment_aggregate_fwd_cuda(hs, hd, csr)
        for field in ("mx", "mn", "deg", "n_max", "n_min"):
            if not torch.equal(getattr(saved[name], field), getattr(design, field)):
                raise AssertionError(f"{name}: {field} differs from the design's")
    times = {name: {"fwd": [], "bwd": []} for name in built}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for turn in range(TURNS):
        for name in (list(built) if turn % 2 == 0 else list(built)[::-1]):
            B._libs["segment_aggregate"] = built[name][0]
            for part, fn in (
                    ("fwd", lambda: K.segment_aggregate_fwd_cuda(hs, hd, csr)),
                    ("bwd", lambda s=saved[name]: K.segment_aggregate_bwd_cuda(hs, hd, csr, s,
                                                                               *grads))):
                fn()
                torch.cuda.synchronize()
                start.record()
                for _ in range(REPS):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[name][part].append(start.elapsed_time(end) / REPS)
    if real_lib is not None:
        B._libs["segment_aggregate"] = real_lib
    report = {"card": card_line(), "nodes": N_NODES, "edges": N_EDGES, "d": D,
              "node0_edges": int(csr.indptr[1] - csr.indptr[0]), "variants": {}}
    print(report["card"])
    for name, what, _ in VARIANTS:
        fwd, bwd = sorted(times[name]["fwd"]), sorted(times[name]["bwd"])
        row = {"what": what, "fwd_ms": fwd, "bwd_ms": bwd, "fwd_median_ms": fwd[len(fwd) // 2],
               "bwd_median_ms": bwd[len(bwd) // 2], "ptxas": built[name][1]}
        report["variants"][name] = row
        runs = [i for i, ln in enumerate(row["ptxas"]) if "seg_agg_fwd_runs" in ln]
        print(f"{name}: forward {row['fwd_median_ms']:.4f} ms, backward "
              f"{row['bwd_median_ms']:.4f} ms ({what}); the forward's run kernel: "
              + " | ".join(row["ptxas"][runs[0] + 1:runs[0] + 3] if runs else []))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "aggregate_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
