"""Dry run of every (architecture x cell) on the production meshes, the
port of ``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pna --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --out o.json

For each cell: ``build_cell`` against the 16 x 16 pod and the 2 x 16 x 16
multi-pod mesh (``launch.mesh.make_production_mesh``: slots on the
``meta`` device), then ``roofline.analyze_plan`` — FLOPs from a ``meta``
trace of the step at one data slot's rows, the placed bytes, the
collectives (``roofline/analysis.py`` states each rule) — and one row
with the reference's keys and statuses: ``OK``, ``SKIP`` with the cell's
reason, ``FAIL`` with the error (a step that cannot trace on ``meta`` — a
host sync, a data-dependent shape — fails; nothing is skipped for it).
It plans only: it never touches a card and needs none.  The rows keep
the reference's keys: ``lower_s`` holds the time to build the plan and
``compile_s`` the time of its trace, ``memory`` the placed argument,
output and aliased (donated) bytes of the slot that holds the most
(``temp_bytes`` None: no temporaries are counted), ``probe`` None (the
trace counts every loop iteration, so there is no scan-trip probe).
``--config smoke`` plans the archs' small configs instead (a quick check
of every cell's step).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Sequence

from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.roofline.analysis import H100, analyze_plan, placed_bytes, placed_memory

__all__ = ["run_cell", "main"]


def _memory(plan, mesh) -> dict:
    """The placed bytes of the slot that holds the most, as the
    reference's ``memory_analysis`` keys."""
    parts = placed_memory(plan, mesh)
    total = placed_bytes(plan, mesh)
    worst = max(range(len(total)), key=total.__getitem__)
    return {"argument_bytes": parts["argument"][worst], "output_bytes": parts["output"][worst],
            "temp_bytes": None, "alias_bytes": parts["alias"][worst]}


def run_cell(spec, shape_name: str, mesh, mesh_name: str, verbose: bool = True) -> dict:
    cell = spec.cells[shape_name]
    if cell.skip:
        return {"arch": spec.name, "shape": shape_name, "mesh": mesh_name, "status": "SKIP",
                "reason": cell.skip}
    t0 = time.perf_counter()
    plan = build_cell(spec, shape_name, mesh)
    t_plan = time.perf_counter() - t0
    report = analyze_plan(plan, mesh, H100, mesh_name, cell)
    t_trace = time.perf_counter() - t0 - t_plan
    out = {"status": "OK", "lower_s": round(t_plan, 1), "compile_s": round(t_trace, 1),
           "note": plan.note, "memory": _memory(plan, mesh), "probe": None,
           **report.to_dict()}
    if verbose:
        gib = lambda b: f"{(b or 0) / 2**30:.2f} GiB"  # noqa: E731
        fits = report.peak_memory_per_chip <= report.hw.hbm_bytes
        print(f"  [{mesh_name}] {spec.name}/{shape_name}: "
              f"args={gib(out['memory']['argument_bytes'])} "
              f"placed/chip={gib(report.peak_memory_per_chip)} "
              f"({'fits' if fits else 'OVER'} {report.hw.hbm_bytes / 2**30:.0f} GiB) | "
              f"flops/chip={report.flops_per_chip:.3e} "
              f"coll/chip={report.coll_bytes_per_chip['total'] / 2**20:.1f} MiB | "
              f"t(c={report.compute_s * 1e3:.1f} m={report.memory_s * 1e3:.1f} "
              f"x={report.collective_s * 1e3:.1f} ms) -> {report.dominant} | "
              f"useful={report.useful_flop_ratio:.2f} "
              f"roofline={report.roofline_fraction:.2f} | trace {t_trace:.0f}s", flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one cell name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--config", default="full", choices=["full", "smoke"],
                    help="the archs' published configs, or their small ones")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true", help="merge into --out")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = build_parser().parse_args(argv)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16", make_production_mesh(multi_pod=True)))
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name in archs:
        spec = get_arch(name)
        if args.config == "smoke":
            import dataclasses

            spec = dataclasses.replace(spec, cfg=spec.smoke_cfg)
        shapes = [args.shape] if args.shape else list(spec.cells)
        for shape_name in shapes:
            for mesh_name, mesh in meshes:
                key = (name, shape_name, mesh_name)
                if any((r.get("arch"), r.get("shape"), r.get("mesh")) == key for r in results):
                    continue
                try:
                    r = run_cell(spec, shape_name, mesh, mesh_name)
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    r = {"arch": name, "shape": shape_name, "mesh": mesh_name,
                         "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
                    print(f"  [{mesh_name}] {name}/{shape_name}: FAIL {e}", flush=True)
                r.setdefault("arch", name)
                r.setdefault("shape", shape_name)
                r.setdefault("mesh", mesh_name)
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "OK")
    skip = sum(1 for r in results if r["status"] == "SKIP")
    fail = sum(1 for r in results if r["status"] == "FAIL")
    print(f"\ndry-run: {ok} OK, {skip} SKIP (documented), {fail} FAIL -> {args.out}")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
