"""The port's spec trees (``repro_torch.dist.sharding``) against the
reference's ``PartitionSpec`` trees, and ``place`` against
``NamedSharding``.

* For every arch at its full config, the port's parameter specs (keyed
  by its parameter names, from ``models/convert.py``'s leaf table) equal
  the reference's leaf by leaf, on the meshes (16, 16), (2, 16, 16),
  (1, 4) and (2, 2), with FSDP where the arch's ``fsdp`` is set: a
  layer's spec is the reference's stacked spec less its leading entry
  (``LayerSpec``), which keeps that entry as its layer placement.  The
  reference's trees are built with ``jax.eval_shape`` against
  ``jax.sharding.AbstractMesh``, so no device is needed.  The optimizer
  state's specs and every train cell's batch specs equal too.
* ``validate_spec`` on hand-picked cases, and ``cache_specs`` on the LM
  caches of the decode cells, against the reference's.
* ``place``'s shards against ``NamedSharding(mesh, P(*spec)).shard_shape``
  and the data of the reference's ``addressable_shards`` on the 8-device
  CPU mesh (``tests/conftest.py``), slot by slot; a layer placed by layer
  lies whole on the slots of its block and on no other.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_arch as ref_arch
from repro.dist import sharding as JS
from repro.launch import steps as JSt
from repro.models import pna as JP
from repro.models import transformer as JT
from repro_torch.configs.registry import ARCH_NAMES, get_arch
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault_tolerance import ElasticMesh, ShardSlot, SlotMesh
from repro_torch.launch import steps as S
from repro_torch.models.convert import _leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _keys(path) -> tuple:
    return tuple(p.key if hasattr(p, "key") else (p.idx if hasattr(p, "idx") else p.name)
                 for p in path)


def _flat(tree) -> dict:
    return {_keys(path): tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _reference_tree(name):
    spec = ref_arch(name)
    if spec.family == "lm":
        return jax.eval_shape(lambda: JT.init(spec.cfg, jax.random.key(0)))
    if spec.family == "gnn":
        return jax.eval_shape(lambda: JP.init(spec.cfg, jax.random.key(0)))
    return jax.eval_shape(lambda: JSt._recsys_module(name).init(spec.cfg, jax.random.key(0)))


def _reference_specs(name, tree, mesh):
    spec = ref_arch(name)
    if spec.family == "lm":
        return JS.lm_param_specs(tree, mesh, fsdp=spec.fsdp)
    if spec.family == "gnn":
        return JS.pna_param_specs(tree, mesh)
    return JS.recsys_param_specs(tree, mesh)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_opt_specs_equal_the_reference(name):
    tree = _reference_tree(name)
    plan_mesh = None
    for key, (dims, axes) in MESHES.items():
        mesh = AbstractMesh(dims, axes)
        want = _flat(_reference_specs(name, tree, mesh))
        plan_mesh = SlotMesh([ShardSlot(i, torch.device("meta")) for i in range(
            int(np.prod(dims)))], dims, axes)
        plan = S.build_cell(get_arch(name), next(c for c, cell in get_arch(name).cells.items()
                                                 if cell.kind.startswith("train")), plan_mesh)
        model = plan.model
        got = plan.in_specs[0]
        assert got == sh.param_specs(model, mesh, fsdp=get_arch(name).fsdp)
        names = {id(p): n for n, p in model.named_parameters()}
        layer_placed = 0
        for path, i, t in _leaves(model):
            ref = want[tuple(path)]
            port = got[names[id(t)]]
            if i is None:
                assert tuple(port) == ref, (key, path)
            else:
                assert tuple(port) == ref[1:], (key, path)
                assert port.layer == ((ref[0] if ref else None), i, tree_len(tree, path))
                layer_placed += port.layer[0] is not None
        assert len(got) == len(names)
        # the optimizer state: masters and moments follow the parameters, the step replicated
        ospecs = plan.in_specs[1]
        assert ospecs["mu"] == ospecs["nu"] == ospecs["params"] == got and ospecs["step"] == ()
        ref_o = JS.opt_state_specs(_reference_specs(name, tree, mesh))
        assert tuple(ref_o["step"]) == ()
        if name == "qwen1.5-32b" and key in ("16x16", "2x16x16", "2x2"):
            assert layer_placed == 192  # the q, k, v biases: FSDP picks their (L,) axis


def tree_len(tree, path) -> int:
    for k in path:
        tree = tree[k]
    return tree.shape[0]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_specs_of_every_cell_equal_the_reference(name):
    ref, port = ref_arch(name), get_arch(name)
    for key, (dims, axes) in MESHES.items():
        jmesh = AbstractMesh(dims, axes)
        mesh = SlotMesh([ShardSlot(i, torch.device("meta")) for i in range(
            int(np.prod(dims)))], dims, axes)
        for cell_name, cell in port.cells.items():
            if cell.skip:
                continue
            plan = S.build_cell(port, cell_name, mesh)
            want = JSt.build_cell(ref, cell_name, jmesh) if cell.kind.startswith("train") else None
            if want is None:
                continue
            assert {k: tuple(v) for k, v in want.in_specs[2].items()} == plan.in_specs[2], (
                key, cell_name)
            assert {k: tuple(v.shape) for k, v in want.in_structs[2].items()} == {
                k: tuple(v.shape) for k, v in plan.in_structs[2].items()}


def test_validate_spec_equals_the_reference():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    cases = [((), (8, 8)), (("data",), (8, 8)), (("data", "model"), (8, 8)),
             ((None, "model"), (8, 6)), (("model", None), (6, 8)), ((("data", "model"),), (16,)),
             ((("data", "model"),), (12,)), (("pod",), (8,)), (("data", None, None), (4, 2, 2)),
             ((None, None), (3, 3))]
    for spec, shape in cases:
        assert sh.validate_spec(mesh, spec, shape) == tuple(JS.validate_spec(mesh, P(*spec),
                                                                             shape))
    with pytest.raises(ValueError):
        sh.validate_spec(mesh, ("data", None, None), (4, 4))
    with pytest.raises(ValueError):
        JS.validate_spec(mesh, P("data", None, None), (4, 4))


@pytest.mark.parametrize("name", ["gemma3-4b", "qwen3-moe-30b-a3b"])
def test_cache_specs_equal_the_reference(name):
    ref, port = ref_arch(name), get_arch(name)
    for key, (dims, axes) in MESHES.items():
        jmesh = AbstractMesh(dims, axes)
        mesh = SlotMesh([ShardSlot(i, torch.device("meta")) for i in range(
            int(np.prod(dims)))], dims, axes)
        for cell_name, cell in port.cells.items():
            if cell.skip or cell.kind not in ("prefill", "decode"):
                continue
            got = S.build_cell(port, cell_name, mesh).in_specs[2]
            want = JSt.build_cell(ref, cell_name, jmesh).in_specs[2]
            for f in ("k", "v", "k_scale", "v_scale"):
                w = getattr(want, f)
                assert got[f] == (None if w is None else tuple(w)), (key, cell_name, f)


def test_place_equals_named_sharding_on_the_fake_devices():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 12, 4)).astype(np.float32)
    t = torch.from_numpy(x)
    for dims, axes in [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                       ((2, 2, 2), ("pod", "data", "model"))]:
        jmesh = jax.make_mesh(dims, axes, axis_types=(AxisType.Auto,) * len(dims))
        slots = SlotMesh([ShardSlot(i, torch.device("cpu")) for i in range(8)], dims, axes)
        flat_devices = list(np.asarray(jmesh.devices).reshape(-1))
        for spec in [(), ("data",), (None, "model"), ("model", "data"),
                     ((axes[0], axes[1]), None, None), (None, tuple(a for a in axes
                                                              if a != "model"))]:
            spec = sh.validate_spec(slots, spec, x.shape)
            sharding = NamedSharding(jmesh, P(*spec))
            arr = jax.device_put(x, sharding)
            by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
            shards = sh.place(t, spec, slots)
            assert len(shards) == 8
            for slot, shard in enumerate(shards):
                assert tuple(shard.shape) == sharding.shard_shape(x.shape)
                assert tuple(shard.shape) == sh.shard_shape(x.shape, spec, slots)
                np.testing.assert_array_equal(shard.numpy(), by_device[flat_devices[slot]])
            if spec == ():  # replicated: one tensor, no copy
                assert all(s is shards[0] for s in shards) and shards[0].data_ptr() == t.data_ptr()


def test_a_layer_placed_by_layer_lies_on_its_block():
    mesh = ElasticMesh(model_parallel=2).remesh(["cpu"] * 4)  # (2, 2)
    layers = [torch.full((6,), float(i)) for i in range(4)]
    for i, t in enumerate(layers):
        spec = sh.LayerSpec((), ("data", i, 4))
        assert spec == ()
        shards = sh.place(t, spec, mesh)
        block = i // 2  # 4 layers over 2 data slots: layers 0-1 on data slot 0
        for slot, shard in enumerate(shards):
            holds = slot // 2 == block
            assert (shard is not None) == holds
            if holds:
                assert shard.data_ptr() == t.data_ptr()
    # the reference's (L, d) leaf with P("data"): slot (d, m) holds layers [2d, 2d + 2)
    jmesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                          devices=jax.devices()[:4])
    stacked = jax.device_put(np.stack([t.numpy() for t in layers]), NamedSharding(jmesh,
                                                                                 P("data")))
    devices = list(np.asarray(jmesh.devices).reshape(-1))
    for s in stacked.addressable_shards:
        slot = devices.index(s.device)
        held = [i for i in range(4) if sh.layer_holders(sh.LayerSpec((), ("data", i, 4)),
                                                        mesh)[slot]]
        np.testing.assert_array_equal(np.asarray(s.data)[:, 0], np.asarray(held, np.float32))
