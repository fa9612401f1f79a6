"""The port's train step under a slot mesh against the reference's
``build_cell`` step, jitted with its plan's shardings on the 8 fake CPU
devices of ``tests/conftest.py`` (``AxisType.Auto`` axes, the mesh set as
the reference's module global as its dry run sets it), from the same
parameters (``models/convert.py``) and the same batch, at smoke configs
and small train cells:

* qwen3-moe under (2, 2) and (1, 4): the expert-parallel MoE trains
  through ``_moe_apply_sharded`` under the whole mesh (its tokens split
  over the data slots by rows); every MoE call's experts and keep set
  equal the reference's sharded capacity rule recomputed per data shard
  on the call's tokens (near-ties as ``test_torch_moe.py`` allows);
* a dense LM under (2, 2) with 2 microbatches (interleaved, so each
  microbatch's data block is that microbatch of a data slot's rows);
* dcn-v2 and mind under (4, 1): mind's (B, B) in-batch loss is kept whole
  (its step under the mesh equals its single-device step bit for bit,
  also under a config of another name, and per-slot negatives would not
  equal the reference);
* PNA's full graph under (2, 2): equal to its single-device step bit for
  bit, and to the reference's sharded step.

Compared: the loss within ``LOSS_RTOL``; AdamW's first moment after the
step (``(1 - b1)`` times the clipped gradient: the gradient the step
used) leaf by leaf as ``test_torch_train_lm.grads_close`` compares
gradients (a bf16 moment of an FSDP arch within one bf16 step; PNA's
segment sums within ``test_torch_pna.py``'s ``GRAD_RTOL``); the
parameters after the step within ``LR_SHARE`` of the step's learning rate
where the gradient is at least ``SETTLED`` of its leaf's largest, and
within the update's bound (2 learning rates) elsewhere: the first AdamW
update is about ``lr · g / (|g| + eps)``, so where ``|g|`` nears ``eps``
(1e-8) float32 noise in ``g`` moves it by a share of ``lr`` while the
moment above holds the gradient itself.  Also: the launcher's ``--mesh`` and its
refusals, and ``data_slot_grads``' per-slot trees summing to the mesh
step's gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from test_torch_moe import _compared_tokens
from test_torch_moe_sharded import _reference_sharded_routing
from test_torch_train_lm import grads_close

from repro.configs.base import Cell
from repro.configs.registry import get_arch as ref_arch
from repro.data.graphs import synth_graph
from repro.data.pipeline import PipelineState, RecsysPipeline, TokenPipeline
from repro.dist import sharding as JS
from repro.launch import steps as JSt
from repro.launch.steps import _recsys_module
from repro.models import layers as JL
from repro.models import pna as JP
from repro.models import transformer as JT
from repro.train import optimizer as ref_opt
from repro_torch.configs.registry import get_arch
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault_tolerance import ElasticMesh
from repro_torch.launch import steps as S
from repro_torch.launch import train as TL
from repro_torch.models import convert, pna
from repro_torch.models import layers as L

LOSS_RTOL = 1e-5
LR_SHARE = 2e-3
SETTLED = 1e-3
PNA_GRAD_RTOL = 1e-4
# The MoE smoke configs' capacity factor in these tests: the dense and the
# sharded capacity rules agree at it (per_shard_dense_moe).
MOE_CF = 1.0

# name: (arch, mesh, rows, sequence length or None, microbatches)
CASES = {
    "qwen3-moe-2x2": ("qwen3-moe-30b-a3b", (2, 2), 8, 16, 1),
    "qwen3-moe-1x4": ("qwen3-moe-30b-a3b", (1, 4), 8, 16, 1),
    "qwen1.5-4b-2x2-micro2": ("qwen1.5-4b", (2, 2), 8, 16, 2),
    "dcn-v2-4x1": ("dcn-v2", (4, 1), 16, None, 1),
    "mind-4x1": ("mind", (4, 1), 16, None, 1),
    "pna-2x2": ("pna", (2, 2), 1, None, 1),
}


@pytest.fixture(autouse=True)
def no_ambient_mesh():
    sh.set_mesh(None)
    yield
    sh.set_mesh(None)


def _slot_mesh(dims):
    return ElasticMesh(model_parallel=dims[1]).remesh(["cpu"] * (dims[0] * dims[1]))


def _specs(arch, cell):
    """The reference's and the port's ArchSpec at the smoke config with
    one train cell ``t``."""
    ref, port = ref_arch(arch), get_arch(arch)
    cfg, pcfg = ref.smoke_cfg, port.smoke_cfg
    if arch == "pna":
        extra = dict(d_feat=16, n_classes=5)
        cfg, pcfg = dataclasses.replace(cfg, **extra), dataclasses.replace(pcfg, **extra)
    if getattr(cfg, "moe", None) is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CF))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                                 capacity_factor=MOE_CF))
    return (dataclasses.replace(ref, cfg=cfg, cells={"t": cell}),
            dataclasses.replace(port, cfg=pcfg, cells={"t": cell}))


def _case(name):
    arch, dims, rows, seq, micro = CASES[name]
    if arch == "pna":
        cell = Cell(kind="train", batch=1, extra={"n_nodes": 64, "n_edges": 384, "d_feat": 16,
                                                  "n_classes": 5})
    elif seq is not None:
        cell = Cell(kind="train", batch=rows, extra={"seq_len": seq, "microbatches": micro})
    else:
        cell = Cell(kind="train", batch=rows)
    ref_spec, spec = _specs(arch, cell)
    cfg = ref_spec.cfg
    if ref_spec.family == "lm":
        params = JT.init(cfg, jax.random.key(1))
        batch = TokenPipeline(cfg.vocab, seq, rows, seed=3).batch(PipelineState(2))
        model = convert.params_from_numpy(jax.tree.map(np.asarray, params), spec.cfg, "cpu")
    elif arch == "pna":
        params = JP.init(cfg, jax.random.key(1))
        g = synth_graph(64, 6, 16, 5, seed=0)
        src, dst = g.edge_list()
        batch = {"feats": g.feats, "edges": np.stack([src, dst], 1),
                 "edge_mask": np.ones(g.n_edges, np.float32), "labels": g.labels,
                 "label_mask": (np.arange(g.n_nodes) % 3 != 0).astype(np.float32)}
        model = convert.pna_from_numpy(jax.tree.map(np.asarray, params), spec.cfg, "cpu")
    else:
        params = _recsys_module(arch).init(cfg, jax.random.key(1))
        if arch == "dcn-v2":
            pipe = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field, 4, rows, seed=2)
        else:
            pipe = RecsysPipeline(4, 4, cfg.vocab, cfg.hist_len, rows, seed=2)
        batch = pipe.batch(PipelineState(1))
        model = convert.recsys_from_numpy(jax.tree.map(np.asarray, params), arch, spec.cfg,
                                          "cpu")
    return ref_spec, spec, dims, params, batch, model.requires_grad_(True)


def per_shard_dense_moe(dp):
    """The reference's MoE function under a mesh of ``dp`` data slots,
    written without ``shard_map``: each data shard's tokens through the
    reference's ``_moe_apply_dense``, the aux losses averaged.  Where the
    dense capacity ``int(cf·t_loc·k/E)`` is a multiple of 8 and at least 8
    it is the sharded rule's, so this is ``_moe_apply_sharded``'s function
    (``MOE_CF`` makes it so at the smoke configs)."""
    def moe_apply(p, x, top_k, capacity_factor=1.25, act="silu"):
        t = x.shape[0] // dp
        outs, auxes = zip(*(JL._moe_apply_dense(p, x[i * t:(i + 1) * t], top_k,
                                                capacity_factor, act) for i in range(dp)))
        return jnp.concatenate(outs), sum(auxes) / dp
    return moe_apply


def _reference_step(ref_spec, dims, params, batch, monkeypatch):
    """The reference's ``build_cell`` step, jitted with its plan's
    shardings on a (data, model) mesh of the fake devices: ``(params,
    opt_state, loss)`` after it, the loss of the ``shard_map`` MoE
    dispatch, and the AdamW config.  For an MoE arch the returned step
    takes the MoE per data shard through :func:`per_shard_dense_moe` (the
    same function; the sharded step's loss must equal its loss): under
    jax 0.9 the gradient through the reference's ``shard_map`` dispatch
    is wrong for the router and the tokens
    (:func:`test_the_reference_shard_map_gradient_is_not_the_functions`)."""
    jmesh = jax.make_mesh(dims, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    plan = JSt.build_cell(ref_spec, "t", jmesh)
    opt_cfg = ref_opt.AdamWConfig(moment_dtype="bfloat16" if ref_spec.fsdp else "float32")
    if ref_spec.family == "gnn":
        opt_cfg = ref_opt.AdamWConfig()
    opt = ref_opt.adamw_init(opt_cfg, params)
    keys = plan.in_structs[2].keys()
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    ins, outs = plan.shardings(jmesh)
    step = jax.jit(plan.step, in_shardings=ins, out_shardings=outs)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", jmesh)
    p2, o2, loss = step(params, opt, jbatch)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", None)
    sharded_loss = float(loss)
    if getattr(ref_spec.cfg, "moe", None) is not None:
        with monkeypatch.context() as mp:
            mp.setattr(JL, "moe_apply", per_shard_dense_moe(dims[0]))
            # a new function: jit's cache would return the traced shard_map step
            p2, o2, loss = jax.jit(lambda *a: plan.step(*a), in_shardings=ins,
                                   out_shardings=outs)(params, opt, jbatch)
    return (jax.tree.map(np.asarray, p2), jax.tree.map(np.asarray, o2), float(loss),
            sharded_loss, opt_cfg)


def _port_step(spec, dims, model, batch, mesh=True):
    plan = S.build_cell(spec, "t", _slot_mesh(dims))
    state = S.train_state(model, plan.opt_cfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
          if k in plan.in_structs[2]}
    if spec.family == "gnn":
        tb = pna.with_csr(tb)
    if mesh:
        _, opt, loss = plan.bind(model)(dict(model.named_parameters()),
                                        {"params": state.params, **state.opt}, tb)
    else:
        loss = S.train_step(model, state, tb, plan.microbatches)
        opt = {"params": state.params, **state.opt}
    return float(loss), opt, plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_step_equals_the_reference_sharded_step(name, monkeypatch):
    ref_spec, spec, dims, params, batch, model = _case(name)
    want_params, want_opt, want_loss, sharded_loss, opt_cfg = _reference_step(
        ref_spec, dims, params, batch, monkeypatch)
    assert sharded_loss == pytest.approx(want_loss, rel=LOSS_RTOL)  # one function
    calls = []
    real = L._moe_apply_sharded

    def recorded(moe, x, top_k, cf, act, mesh):
        out = real(moe, x, top_k, cf, act, mesh)
        calls.append((moe, x.detach().numpy(), out[2], cf, mesh))
        return out

    monkeypatch.setattr(L, "_moe_apply_sharded", recorded)
    loss, opt, plan = _port_step(spec, dims, model, batch)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    mu = convert.params_to_numpy(model, {k: v.float() for k, v in opt["mu"].items()})
    if spec.family == "gnn":  # segment sums in another order: test_torch_pna.py's GRAD_RTOL
        scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want_opt["mu"]))
        for got, w in zip(jax.tree.leaves(mu), jax.tree.leaves(want_opt["mu"]), strict=True):
            assert float((np.abs(got - w) / (np.abs(w) + scale)).max()) <= PNA_GRAD_RTOL
    else:
        grads_close(mu, want_opt["mu"])
    lr = opt_cfg.lr / max(opt_cfg.warmup_steps, 1)  # the first step's, warming up
    for got, w, m in zip(jax.tree.leaves(convert.params_to_numpy(model)),
                         jax.tree.leaves(want_params), jax.tree.leaves(want_opt["mu"]),
                         strict=True):
        w, m = np.asarray(w, np.float32), np.abs(np.asarray(m, np.float32))
        settled = m >= SETTLED * m.max()  # the update's direction is settled there
        np.testing.assert_allclose(got[settled], w[settled], rtol=1e-5, atol=LR_SHARE * lr)
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=2 * lr)  # an update's bound
    moe = getattr(spec.cfg, "moe", None)
    assert bool(calls) == (moe is not None)
    if moe is None:
        return
    # Each call: a microbatch's tokens under the whole mesh, per layer and pass.
    assert len(calls) == plan.microbatches * spec.cfg.n_layers
    layer_of = {id(blk.moe): i for i, blk in enumerate(model.blocks)}
    for moe_mod, x, routing, cf, on in calls:
        assert on.dims == dims and x.shape[0] == 8 * 16 // plan.microbatches
        router = {"router": {"kernel": params["layers"]["moe"]["router"]["kernel"][
            layer_of[id(moe_mod)]]}}
        probs, want_idx, want_keep, _ = _reference_sharded_routing(router, x, moe.top_k, cf,
                                                                   dims[0])
        same = _compared_tokens(probs, want_idx, routing.experts.numpy(), want_keep,
                                routing.keep.numpy())
        assert same.sum() >= x.shape[0] - 2


@pytest.mark.parametrize("arch", ["mind", "mind-renamed", "pna", "qwen1.5-4b"])
def test_a_coupled_loss_stays_whole_and_slot_grads_add_up(arch):
    """mind and PNA: the mesh step equals the single-device step bit for
    bit (the coupled loss runs over the whole batch), also for a mind
    config of another name (nothing in the step reads the name).
    qwen1.5-4b: ``data_slot_grads``' per-slot trees (each slot's rows),
    summed in slot order, are the mesh step's gradient."""
    name = {"mind": "mind-4x1", "mind-renamed": "mind-4x1", "pna": "pna-2x2",
            "qwen1.5-4b": "qwen1.5-4b-2x2-micro2"}[arch]
    _, spec, dims, params, batch, model = _case(name)
    if arch == "mind-renamed":
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, name="mind-v2"))
        renamed = type(model)(spec.cfg, "cpu")
        renamed.load_state_dict(model.state_dict())
        model = renamed.requires_grad_(True)
    twin = type(model)(model.cfg, "cpu") if arch != "qwen1.5-4b" else None
    if twin is not None:
        twin.load_state_dict(model.state_dict())
        twin.requires_grad_(True)
        loss, opt, _ = _port_step(spec, dims, model, batch)
        loss1, opt1, _ = _port_step(spec, dims, twin, batch, mesh=False)
        assert loss == loss1
        for k in opt["mu"]:
            assert torch.equal(opt["mu"][k], opt1["mu"][k]), k
        for a, b in zip(model.parameters(), twin.parameters()):
            assert torch.equal(a, b)
        return
    mesh = _slot_mesh(dims)
    plan = S.build_cell(spec, "t", mesh)
    state = S.train_state(model, plan.opt_cfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    slots = S.data_slot_grads(model, params, tb, plan.microbatches, mesh)
    assert len(slots) == dims[0]
    total = {k: sum(s[k] for s in slots) for k in slots[0]}
    S.train_step(model, state, tb, plan.microbatches, mesh=mesh)
    b1 = plan.opt_cfg.b1
    # mu = (1 - b1) * clip * g; the clip scale is one number for every leaf
    ratios = [float((state.opt["mu"][k] / (1 - b1)).norm() / total[k].norm())
              for k in total if float(total[k].norm()) > 0]
    assert max(ratios) - min(ratios) < 1e-5


def test_a_mesh_that_does_not_divide_is_refused():
    base = ["--arch", "qwen3-moe-30b-a3b", "--steps", "1", "--device", "cpu"]
    TL.train_setup(TL.build_parser().parse_args(base + ["--mesh", "2x2"]))
    with pytest.raises(ValueError, match="data slots do not divide"):
        TL.train_setup(TL.build_parser().parse_args(base + ["--mesh", "8x1"]))
    with pytest.raises(ValueError, match="experts"):
        TL.train_setup(TL.build_parser().parse_args(base + ["--mesh", "1x3"]))
    with pytest.raises(ValueError, match="DATAxMODEL"):
        TL.train_setup(TL.build_parser().parse_args(base + ["--mesh", "2"]))


def test_launcher_trains_under_a_mesh(tmp_path, capsys):
    out = TL.main(["--arch", "qwen3-moe-30b-a3b", "--mesh", "2x2", "--steps", "5", "--device",
                   "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    losses = [loss for _, loss, _ in out["history"]]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert "under SlotMesh(data: 2, model: 2" in capsys.readouterr().out


@pytest.mark.parametrize("dims", [(2, 2)], ids=["2x2"])
def test_the_reference_shard_map_gradient_is_not_the_functions(dims, monkeypatch):
    """Why the MoE cases take the reference's gradient from
    :func:`per_shard_dense_moe`: under jax 0.9 (the reference pins
    ``jax<0.6``) the gradient through ``_moe_apply_sharded``'s
    ``shard_map`` misses the router's and the tokens' cotangents (the
    experts' are right), while its forward is the function's.  The
    router's error is reported, not asserted: another jax may give the
    function's gradient.  The port's sharded dispatch gives the function's
    gradient."""
    e, d, f, t, k = 8, 16, 32, 64, 2
    p = JL.moe_init(jax.random.key(0), d, f, e)
    x = jax.random.normal(jax.random.key(1), (t, d))
    r = jax.random.normal(jax.random.key(2), (t, d))

    def loss(p_, x_):
        out, aux = JL.moe_apply(p_, x_, k, MOE_CF, "silu")
        return jnp.sum(out * r) + aux

    with monkeypatch.context() as mp:
        mp.setattr(JL, "moe_apply", per_shard_dense_moe(dims[0]))
        want_loss, want = jax.value_and_grad(loss, argnums=(0, 1))(p, x)
    jmesh = jax.make_mesh(dims, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", jmesh)
    got_loss, got = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(p, x)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", None)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    np.testing.assert_allclose(np.asarray(got[0]["up"]), np.asarray(want[0]["up"]), atol=1e-5)
    router_err = float(jnp.abs(got[0]["router"]["kernel"] - want[0]["router"]["kernel"]).max())
    print(f"the reference's sharded router gradient: max error {router_err:.3g}, "
          f"{router_err / float(jnp.abs(want[0]['router']['kernel']).max()):.3g} of its largest")
    # the port's dispatch under the slot mesh: the function's gradient
    moe = L.MoE(d, f, e, k, MOE_CF, "silu", torch.float32, "cpu")
    with torch.no_grad():
        moe.router.kernel.copy_(torch.from_numpy(np.asarray(p["router"]["kernel"])))
        for name in ("up", "gate", "down"):
            getattr(moe, name).copy_(torch.from_numpy(np.asarray(p[name])))
    moe.requires_grad_(True)
    xt = torch.from_numpy(np.asarray(x)).requires_grad_(True)
    sh.set_mesh(_slot_mesh(dims))
    out, aux, _ = L.moe_apply(moe, xt, k, MOE_CF, "silu")
    (torch.sum(out * torch.from_numpy(np.asarray(r))) + aux).backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(moe.router.kernel.grad.numpy(),
                               np.asarray(want[0]["router"]["kernel"]), **tol)
    np.testing.assert_allclose(moe.up.grad.numpy(), np.asarray(want[0]["up"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]), **tol)
