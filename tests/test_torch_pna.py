"""PNA on the port against the JAX package, on the CPU: the graph data
(``data/graphs.py``) bit for bit; ``convert.pna_from_numpy`` and back;
the model's logits, loss and every gradient leaf (carried back with
``convert.params_to_numpy``) against ``jax.value_and_grad`` of the JAX
``loss_fn`` on the same parameters and batch, in the node readout over a
full graph (``label_mask``), over a sampled subgraph (``seed_pos``) and
in the graph readout over batched molecules; one ``train_step`` against
``_pna_cell``'s step; the launcher's smoke run (``--arch pna``) against
the JAX launcher's gnn branch over 10 steps; and the registry.  The
aggregation runs its plain version here (``tests/test_kernels_segment_
aggregate.py``; the kernels on the card).  Tolerances: the loss within
1e-5 relative, each logit and gradient element within 1e-4 of (its
magnitude + the largest of its tensor or tree), as
``test_torch_train_recsys.py`` measures them: float32 sums in other
orders, and where a node's messages are all equal, Σv²/denom − mean² is a
rounding of 0 whose sign the two packages may take apart, moving std
(≈ sqrt(1e-5)) by up to 0.5 % and its gradient by (v − mean)/std (the
aggregation tests hold that part to a derived limit); four layers carry
it on to logits up to 6e-5 apart (1.4e-5 of their scale)."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.data import graphs as ref_graphs
from repro.models import pna as JP
from repro.train import optimizer as ref_opt
from repro_torch.configs.registry import NOT_PORTED, get_arch
from repro_torch.data import graphs
from repro_torch.launch import train as launcher
from repro_torch.launch.steps import loss_fn_of, train_state, train_step
from repro_torch.models import convert, pna
from repro_torch.train.optimizer import AdamWConfig

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _graph_batch(g):
    src, dst = g.edge_list()
    return {"feats": g.feats, "edges": np.stack([src, dst], 1),
            "edge_mask": np.ones(g.n_edges, np.float32), "labels": g.labels,
            "label_mask": np.ones(g.n_nodes, np.float32)}


def _batch(kind):
    """A small batch of each readout, as numpy (the JAX package's data)."""
    if kind == "node":
        g = ref_graphs.synth_graph(300, 6, 16, 5, seed=0)
        batch = _graph_batch(g)
        batch["label_mask"][::3] = 0.0  # some nodes unlabelled
        return batch
    if kind == "seed_pos":
        g = ref_graphs.synth_graph(500, 8, 16, 5, seed=1)
        sub = ref_graphs.NeighborSampler(g, fanouts=(4, 3), seed=0).sample(np.arange(16))
        sub.pop("n_real_nodes")
        return sub
    return ref_graphs.batch_molecules(10, 12, 20, 16, 5, seed=0)


def _pair(kind):
    readout = "graph" if kind == "graph" else "node"
    cfg = dataclasses.replace(get_arch("pna").smoke_cfg, d_feat=16, n_classes=5, readout=readout)
    ref_cfg = dataclasses.replace(ref_arch("pna").smoke_cfg, d_feat=16, n_classes=5,
                                  readout=readout)
    params = JP.init(ref_cfg, jax.random.key(3))
    model = convert.pna_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, model.requires_grad_(True)


def _grads_close(got: dict, want: dict) -> None:
    leaves_w = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves_g = jax.tree.leaves(got)
    assert len(leaves_g) == len(leaves_w)
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in leaves_w)
    for g, (path, w) in zip(leaves_g, leaves_w, strict=True):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.abs(g - w) / (np.abs(w) + scale)
        assert float(err.max()) <= GRAD_RTOL, (jax.tree_util.keystr(path), float(err.max()))


# -- graph data --------------------------------------------------------------


@pytest.mark.parametrize("args", [(300, 6, 16, 5, 0, 1.2), (1000, 8, 4, 3, 7, 1.0)])
def test_synth_graph_equals_the_reference(args):
    n, deg, f, c, seed, power = args
    got = graphs.synth_graph(n, deg, f, c, seed=seed, power=power)
    want = ref_graphs.synth_graph(n, deg, f, c, seed=seed, power=power)
    for name in ("indptr", "indices", "feats", "labels"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.n_classes == want.n_classes and got.n_edges == n * deg
    for a, b in zip(got.edge_list(), want.edge_list(), strict=True):
        np.testing.assert_array_equal(a, b)


def test_neighbor_sampler_equals_the_reference():
    g, rg = graphs.synth_graph(500, 8, 6, 3, seed=2), ref_graphs.synth_graph(500, 8, 6, 3, seed=2)
    s, rs = graphs.NeighborSampler(g, (5, 3), seed=4), ref_graphs.NeighborSampler(rg, (5, 3), seed=4)
    assert s.budget(16) == rs.budget(16) == (16 + 80 + 240 + 1, 80 + 240)
    for seeds in (np.arange(16), np.array([3, 499, 250, 7])):  # the rng carries on
        got, want = s.sample(seeds), rs.sample(seeds)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_molecules_equals_the_reference():
    got = graphs.batch_molecules(7, 12, 20, 8, 4, seed=3)
    want = ref_graphs.batch_molecules(7, 12, 20, 8, 4, seed=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the model -----------------------------------------------------------------


def test_params_round_trip_through_numpy():
    _, _, params, model = _pair("node")
    back = convert.params_to_numpy(model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(back), strict=True):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
    assert len(model.layers) == 4 and model.layers[2].w_out.kernel.shape == (12 * 16, 16)
    with pytest.raises(ValueError, match="do not match"):
        convert.pna_from_numpy({"encode": {}}, model.cfg, device="cpu")


@pytest.mark.parametrize("kind", ["node", "seed_pos", "graph"])
def test_logits_loss_and_every_gradient_equal_the_reference(kind):
    cfg, ref_cfg, params, model = _pair(kind)
    batch = _batch(kind)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = pna.with_csr({k: torch.from_numpy(v) for k, v in batch.items()})
    with torch.no_grad():
        logits = model(tbatch)
    want_logits = jax.jit(lambda p, b: JP.forward(p, ref_cfg, b))(params, jbatch)
    assert logits.shape == want_logits.shape
    want_logits = np.asarray(want_logits)
    err = np.abs(logits.numpy() - want_logits) / (np.abs(want_logits) + np.abs(want_logits).max())
    assert float(err.max()) <= GRAD_RTOL
    want_loss, want = jax.jit(jax.value_and_grad(lambda p, b: JP.loss_fn(p, ref_cfg, b)))(
        params, jbatch)
    loss = loss_fn_of(model)(model, tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    grads = convert.params_to_numpy(model, {n: p.grad for n, p in model.named_parameters()})
    _grads_close(grads, jax.tree.map(np.asarray, want))


def test_layer_recompute_gives_the_same_gradients():
    """Under autograd each layer is checkpointed; the same step with the
    layers kept (no recompute) gives the same bits on the CPU."""
    _, _, _, model = _pair("node")
    batch = pna.with_csr({k: torch.from_numpy(v) for k, v in _batch("node").items()})
    pna.loss_fn(model, batch).backward()
    with_remat = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    csr = tuple(pna.csr_of(batch))
    h = torch.relu(model.encode(batch["feats"]))
    for layer in model.layers:
        h = layer(h, *csr)
    logits = model.decode(h)
    ce = torch.logsumexp(logits, -1) - logits.gather(1, batch["labels"].long()[:, None])[:, 0]
    mask = batch["label_mask"]
    ((ce * mask).sum() / mask.sum()).backward()
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, with_remat[n], rtol=0, atol=0)


def test_train_step_equals_the_reference_cell_step():
    _, ref_cfg, params, model = _pair("node")
    batch = _batch("node")
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rcfg = ref_opt.AdamWConfig(**ocfg)
    want, _ = jax.jit(lambda p, b: ref_opt.adamw_update(
        rcfg, jax.grad(lambda q: JP.loss_fn(q, ref_cfg, b))(p), ref_opt.adamw_init(rcfg, p), p))(
        params, jbatch)
    state = train_state(model, AdamWConfig(**ocfg))
    train_step(model, state, pna.with_csr({k: torch.from_numpy(v) for k, v in batch.items()}))
    # AdamW divides each gradient by its own magnitude: tolerance as in
    # test_torch_train_recsys.py.
    for got, w in zip(jax.tree.leaves(convert.params_to_numpy(model)), jax.tree.leaves(want),
                      strict=True):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=2e-3 * ocfg["lr"])


# -- launcher and registry -------------------------------------------------------


def _jax_launcher_losses(steps):
    """The JAX launcher's gnn branch (``repro.launch.train``), every step's loss."""
    cfg = dataclasses.replace(ref_arch("pna").smoke_cfg, d_feat=16, n_classes=5)
    g = ref_graphs.synth_graph(1000, 8, 16, 5, seed=0)
    batch = {k: jnp.asarray(v) for k, v in _graph_batch(g).items()}
    params = JP.init(cfg, jax.random.key(0))
    ocfg = ref_opt.AdamWConfig(lr=5e-3, total_steps=steps)
    opt = ref_opt.adamw_init(ocfg, params)
    step = jax.jit(lambda p, o, b: (lambda l, g_: ref_opt.adamw_update(ocfg, g_, o, p) + (l,))(
        *jax.value_and_grad(lambda p_: JP.loss_fn(p_, cfg, b))(p)))
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return params, losses


def test_launcher_losses_equal_the_reference_gnn_branch(capsys, monkeypatch):
    init, _ = _jax_launcher_losses(0)
    _, want = _jax_launcher_losses(10)
    setup = launcher.graph_setup(launcher.build_parser().parse_args(
        ["--arch", "pna", "--steps", "10", "--device", "cpu"]))
    assert setup.opt_cfg == AdamWConfig(lr=5e-3, total_steps=10)
    b = setup.batch(0)
    assert b["feats"].shape == (1000, 16) and b["edges"].shape == (8000, 2)
    model = convert.pna_from_numpy(jax.tree.map(np.asarray, init), setup.cfg, device="cpu")
    got = [loss for _, loss in launcher.train_graph(setup, model)["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[-1] < want[0]
    # The printed run, through main, in the JAX launcher's format.
    capsys.readouterr()
    out = launcher.main(["--arch", "pna", "--steps", "10", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert len(out["history"]) == 10 and out["ckpt_dir"] is None
    assert "step    5  loss" in printed and "step   10  loss" in printed
    from repro.launch import train as ref_launcher

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "pna", "--steps", "10"])
    ref_launcher.main()
    assert f"step   10  loss {want[-1]:.4f}" in capsys.readouterr().out


@pytest.mark.parametrize("cell", ["full_graph_sm", "ogb_products", "minibatch_lg", "molecule"])
def test_launcher_builds_each_cells_batch(cell):
    """Each cell at a cut graph (``--nodes``) or batch (``--batch``): the
    shapes ``_pna_cell`` gives it, the cell's optimizer, a few steps."""
    argv = ["--arch", "pna", "--config", "smoke", "--cell", cell, "--steps", "2", "--device",
            "cpu"]
    argv += {"full_graph_sm": [], "ogb_products": ["--nodes", "3000"],
             "minibatch_lg": ["--nodes", "2000", "--batch", "32"],
             "molecule": ["--batch", "8"]}[cell]
    setup = launcher.graph_setup(launcher.build_parser().parse_args(argv))
    ex = get_arch("pna").cells[cell].extra
    assert setup.opt_cfg == AdamWConfig() and setup.cfg.d_feat == ex["d_feat"]
    assert setup.cfg.n_classes == ex["n_classes"]
    b = setup.batch(0)
    n, e = b["feats"].shape[0], b["edges"].shape[0]
    if cell == "full_graph_sm":
        assert (n, e) == (2708, 10832) and setup.info["cell_edges"] == 10556
    elif cell == "ogb_products":
        assert (n, e) == (3000, 75000) and setup.info["degree"] == 25
    elif cell == "minibatch_lg":
        assert setup.info["degree"] == 492 and b["seed_pos"].shape == (32,)
        assert (n, e) == (32 + 32 * 15 + 32 * 150 + 1, 32 * 15 + 32 * 150)
        assert not torch.equal(setup.batch(1)["labels"], b["labels"])  # new seeds a step
    else:
        assert setup.cfg.readout == "graph" and (n, e) == (8 * 30, 8 * 64)
    out = launcher.train_graph(setup, log_fn=lambda *_: None)
    assert len(out["history"]) == 2 and all(np.isfinite([l for _, l in out["history"]]))


def test_registry_resolves_pna():
    assert NOT_PORTED == ()
    spec = get_arch("pna")
    ref = ref_arch("pna")
    assert spec.family == "gnn" and sorted(spec.cells) == sorted(ref.cells)
    for name, cell in ref.cells.items():
        assert spec.cells[name].kind == cell.kind and spec.cells[name].extra == cell.extra
    assert dataclasses.asdict(spec.cfg) == dataclasses.asdict(ref.cfg)
    assert spec.cfg.n_params() == ref.cfg.n_params()
    with pytest.raises(ValueError, match="microbatches"):
        launcher.graph_setup(launcher.build_parser().parse_args(
            ["--arch", "pna", "--microbatches", "2", "--device", "cpu"]))
    with pytest.raises(ValueError, match="--cell"):
        launcher.graph_setup(launcher.build_parser().parse_args(
            ["--arch", "pna", "--config", "full", "--device", "cpu"]))
