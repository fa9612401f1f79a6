"""The port's planning modules against the reference's: ``model_flops``
for every arch x cell, ``RooflineReport``'s terms (as
``tests/test_roofline.py`` checks them, on ``H100``), the production
meshes, and the dry-run CLI (``python -m repro_torch.launch.dryrun``) on
a few smoke cells: ``OK`` rows with the reference's keys, a skipped
cell's ``SKIP`` row, and the bytes a row reports equal to the sum of the
shards ``dist.sharding.place`` puts on the slot that holds the most."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.roofline import analysis as JR
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.layers import KVCache
from repro_torch.roofline import H100, RooflineReport, analyze_plan, model_flops, placed_bytes

# The reference's dry-run row keys (src/repro/launch/dryrun.py, run_cell).
ROW_KEYS = {"status", "lower_s", "compile_s", "note", "memory", "probe", "arch", "shape", "mesh",
            "chips", "flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip", "compute_s",
            "memory_s", "collective_s", "dominant", "model_flops_total", "useful_flop_ratio",
            "roofline_fraction", "peak_memory_per_chip"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
COLL_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
             "total"}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_flops_equal_the_reference(name):
    ref, port = ref_arch(name), get_arch(name)
    for cell_name, cell in port.cells.items():
        rcell = ref.cells[cell_name]
        if port.family == "lm":
            cfg = port.cfg.__class__(**{**port.cfg.__dict__, **cell.overrides})
            rcfg = ref.cfg.__class__(**{**ref.cfg.__dict__, **rcell.overrides})
        elif port.family == "gnn":
            ex = cell.extra
            cfg = port.cfg.__class__(**{**port.cfg.__dict__, "d_feat": ex.get(
                "d_feat", port.cfg.d_feat), "n_classes": ex.get("n_classes", port.cfg.n_classes)})
            rcfg = ref.cfg.__class__(**{**ref.cfg.__dict__, "d_feat": ex.get(
                "d_feat", ref.cfg.d_feat), "n_classes": ex.get("n_classes", ref.cfg.n_classes)})
        else:
            cfg, rcfg = port.cfg, ref.cfg
        got = model_flops(types.SimpleNamespace(kind=cell.kind, cfg=cfg, arch=name), cell)
        want = JR.model_flops(types.SimpleNamespace(kind=rcell.kind, cfg=rcfg, arch=name), rcell)
        assert got == want, (name, cell_name)
        assert got > 0 or cell.kind == "train_minibatch"


def test_roofline_report_terms():
    r = RooflineReport(
        arch="x", shape="y", mesh="m", chips=256,
        flops_per_chip=H100.peak_flops,  # exactly 1 second of compute
        bytes_per_chip=H100.hbm_bw,  # exactly 1 second of HBM
        coll_bytes_per_chip={"total": H100.link_bw / 2},  # 0.5 s of link
        compute_s=1.0, memory_s=1.0, collective_s=0.5,
        model_flops_total=H100.peak_flops * 256,  # all useful
        peak_memory_per_chip=8e9,
    )
    assert r.dominant in ("compute", "memory")
    assert np.isclose(r.useful_flop_ratio, 1.0)
    assert np.isclose(r.roofline_fraction, 1.0)
    d = r.to_dict()
    assert d["chips"] == 256 and "dominant" in d
    assert set(d) == set(JR.RooflineReport(
        arch="x", shape="y", mesh="m", chips=1, flops_per_chip=1.0, bytes_per_chip=1.0,
        coll_bytes_per_chip={"total": 0}, compute_s=1.0, memory_s=1.0, collective_s=0.0,
        model_flops_total=1.0, peak_memory_per_chip=1.0).to_dict())
    c = RooflineReport(
        arch="x", shape="y", mesh="m", chips=2, flops_per_chip=1.0, bytes_per_chip=1.0,
        coll_bytes_per_chip={"total": int(100e9)}, compute_s=1e-12, memory_s=1e-12,
        collective_s=2.0, model_flops_total=1.0, peak_memory_per_chip=1.0)
    assert c.dominant == "collective" and c.bound_time_s == 2.0
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80 * 2**30)


def test_production_and_local_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.dims == (16, 16) and single.axis_names == ("data", "model")
    assert multi.dims == (2, 16, 16) and multi.axis_names == ("pod", "data", "model")
    assert len(single) == 256 and len(multi) == 512
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert all(s.device.type == "meta" for s in multi)
    assert sh.data_spec(multi) == ("pod", "data") and sh.axes_size(multi, "model") == 16
    local = make_local_mesh("cpu")
    assert local.dims == (1, 1) and local[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh()


def _placed_by_place(plan, mesh) -> list:
    """Each slot's bytes summed from ``place``'s shards: the arguments,
    plus the outputs that are not donated arguments written in place."""
    total = [0] * len(mesh)
    seen = set()

    def tensors(struct, spec):
        if isinstance(struct, KVCache):
            return [(getattr(struct, f), spec[f]) for f in ("k", "v", "k_scale", "v_scale")
                    if getattr(struct, f) is not None]
        if isinstance(struct, dict):
            return [p for k in struct for p in tensors(struct[k], spec[k])]
        return [(struct, spec)]

    outs = plan.out_structs if isinstance(plan.out_structs, tuple) else (plan.out_structs,)
    out_specs = plan.out_specs if isinstance(plan.out_structs, tuple) else (plan.out_specs,)
    pairs = [p for s, sp in zip(plan.in_structs, plan.in_specs) for p in tensors(s, sp)]
    pairs += [p for s, sp in zip(outs, out_specs) for p in tensors(s, sp)]
    for t, spec in pairs:
        if id(t) in seen:
            continue
        seen.add(id(t))
        for slot, shard in enumerate(sh.place(t, spec, mesh)):
            if shard is not None:
                total[slot] += shard.numel() * shard.element_size()
    return total


@pytest.mark.parametrize("arch,cell", [("qwen3-moe-30b-a3b", "train_4k"),
                                       ("qwen1.5-32b", "decode_32k"), ("dcn-v2", "serve_p99"),
                                       ("mind", "retrieval_cand"), ("pna", "molecule")])
def test_dryrun_cli_rows(arch, cell, tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = dryrun.main(["--arch", arch, "--shape", cell, "--mesh", "single", "--config",
                        "smoke", "--out", str(out)])
    assert rows == json.loads(out.read_text()) and len(rows) == 1
    row = rows[0]
    assert row["status"] == "OK", row
    assert set(row) == ROW_KEYS and set(row["memory"]) == MEMORY_KEYS
    assert set(row["coll_bytes_per_chip"]) == COLL_KEYS
    assert row["chips"] == 256 and row["mesh"] == "single_pod_16x16"
    assert row["flops_per_chip"] > 0 and row["bytes_per_chip"] > 0
    assert "dry-run: 1 OK, 0 SKIP (documented), 0 FAIL" in capsys.readouterr().out
    spec = get_arch(arch)
    mesh = make_production_mesh()
    plan = build_cell(dataclasses.replace(spec, cfg=spec.smoke_cfg), cell, mesh)
    by_place = _placed_by_place(plan, mesh)
    assert by_place == placed_bytes(plan, mesh)
    assert row["bytes_per_chip"] == max(by_place) == row["peak_memory_per_chip"]
    mem = row["memory"]
    assert mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"] == max(by_place)
    report = analyze_plan(plan)
    assert report.flops_per_chip == row["flops_per_chip"]
    if spec.cells[cell].kind == "train":
        assert row["coll_bytes_per_chip"]["total"] > 0  # the gradients' reductions


def test_dryrun_skips_a_skipped_cell_and_appends(tmp_path):
    out = tmp_path / "rows.json"
    rows = dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k", "--mesh", "both",
                        "--config", "smoke", "--out", str(out)])
    assert [r["status"] for r in rows] == ["SKIP", "SKIP"]
    assert rows[0]["reason"] == get_arch("qwen1.5-4b").cells["long_500k"].skip
    again = dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k", "--mesh", "both",
                         "--config", "smoke", "--out", str(out), "--append"])
    assert again == rows  # nothing run twice
