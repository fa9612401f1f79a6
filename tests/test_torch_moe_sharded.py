"""The port's expert-parallel MoE against the JAX package's.

``_moe_apply_sharded`` of the port (``moe_apply`` under a ``(data,
model)`` slot mesh of ``["cpu"] * n``) against the JAX function itself
under ``jax.jit`` on the 8 fake CPU devices of ``tests/conftest.py``, its
mesh built with ``AxisType.Auto`` axes; float32, inputs from a seeded
numpy generator, the JAX ``moe_init`` weights carried across.  Meshes
(2, 4), (1, 4) and (4, 2), capacity factors 8.0 (nothing drops) and 1.0
(the capacity ``max(8, ⌈int(cf·t_loc·k/E)/8⌉·8)`` binds): outputs and
the aux loss (each data shard's, averaged) within ``rtol=atol=1e-5``, the
experts of each token equal to the reference's, and the kept mask equal
to the reference's capacity rule recomputed in numpy from its choice
(per data shard, each expert's (token, k) pairs ranked in token order).
Near-ties as in ``test_torch_moe.py``.  Where capacity binds the outputs
differ from the dense dispatch's: that is the reference's behaviour.

Also: ``moe_apply`` takes the sharded path under the reference's
condition only; each slot's experts are views on one device and copies
placed on another; and whole qwen3-moe-30b-a3b ``SMOKE`` models, the
port's ``forward`` under a (2, 4) slot mesh against the JAX ``forward``
under its (2, 4) mesh (``jax.jit``, the mesh set as the module global).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import qwen3_moe_30b_a3b as jax_qwen3
from repro.dist import sharding as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import qwen3_moe_30b_a3b
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault_tolerance import ElasticMesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from test_torch_moe import MODEL_TOL, TOL, _compared_tokens, _moe_pair

T_TOKENS, D_MODEL, D_EXPERT, N_EXPERTS, TOP_K = 128, 32, 48, 8, 2
MESHES = {"2x4": (2, 4), "1x4": (1, 4), "4x2": (4, 2)}


@pytest.fixture(autouse=True)
def no_ambient_mesh():
    sh.set_mesh(None)
    yield
    sh.set_mesh(None)


def _jax_mesh(dims):
    return jax.make_mesh(dims, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _slot_mesh(dims):
    return ElasticMesh(model_parallel=dims[1]).remesh(["cpu"] * (dims[0] * dims[1]))


def _reference_sharded_routing(p, x, top_k, cf, dp):
    """The reference's experts per data shard (``jax.lax.top_k`` of
    ``x_loc @ router``'s softmax) and its keep flags from its sharded
    capacity rule, in numpy."""
    t, e = x.shape[0], p["router"]["kernel"].shape[1]
    t_loc = t // dp
    capacity = max(8, -(-int(cf * t_loc * top_k / e) // 8) * 8)
    probs, idx, keep = [], [], []
    for di in range(dp):
        x_loc = jnp.asarray(x[di * t_loc:(di + 1) * t_loc])
        pr = jax.nn.softmax((x_loc @ p["router"]["kernel"]).astype(jnp.float32), axis=-1)
        _, ix = jax.lax.top_k(pr, top_k)
        flat = np.asarray(ix).reshape(-1)
        order = np.argsort(flat, kind="stable")
        start = np.searchsorted(flat[order], np.arange(e), side="left")
        kp = np.empty(flat.shape, bool)
        kp[order] = np.arange(flat.size) - start[flat[order]] < capacity
        probs.append(np.asarray(pr))
        idx.append(np.asarray(ix))
        keep.append(kp.reshape(-1, top_k))
    return np.concatenate(probs), np.concatenate(idx), np.concatenate(keep), capacity


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["cf8_nothing_drops", "cf1_drops_bind"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_moe_matches_the_reference(mesh, cf):
    dims = MESHES[mesh]
    p, moe = _moe_pair(D_MODEL, D_EXPERT, N_EXPERTS, TOP_K, cf, False, seed=dims[0])
    x = np.random.default_rng(7).standard_normal((T_TOKENS, D_MODEL)).astype(np.float32)
    jmesh = _jax_mesh(dims)
    want, want_aux = jax.jit(lambda p_, x_: JL._moe_apply_sharded(
        p_, x_, TOP_K, cf, "silu", jmesh, ("data",)))(p, jnp.asarray(x))
    sh.set_mesh(_slot_mesh(dims))
    got, aux, routing = L.moe_apply(moe, torch.from_numpy(x), TOP_K, cf, "silu")
    probs, want_idx, want_keep, capacity = _reference_sharded_routing(p, x, TOP_K, cf, dims[0])
    got_idx, got_keep = routing.experts.numpy(), routing.keep.numpy()
    assert got_idx.shape == got_keep.shape == (T_TOKENS, TOP_K)
    same = _compared_tokens(probs, want_idx, got_idx, want_keep, got_keep)
    assert same.sum() >= T_TOKENS - 2  # near-ties are rare; most tokens are compared
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    dropped = int((~routing.keep).sum())
    if cf == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0 and capacity == 2 * T_TOKENS // (dims[0] * N_EXPERTS)
        # capacity binds: with data shards (capacity per shard) the dense
        # dispatch, whose capacity counts every token, keeps other slots
        dense, _, dense_routing = L._moe_apply_dense(moe, torch.from_numpy(x), TOP_K, cf)
        if dims[0] > 1:
            assert not torch.equal(dense_routing.keep, routing.keep)
            assert float((dense - got).abs().max()) > 1e-3


def test_sharded_dispatch_follows_the_reference_condition():
    p, moe = _moe_pair(D_MODEL, D_EXPERT, N_EXPERTS, TOP_K, 8.0, False)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((T_TOKENS, D_MODEL))
                         .astype(np.float32))
    calls = []
    real = L._moe_apply_sharded
    try:
        L._moe_apply_sharded = lambda *a: calls.append(a[-1].shape) or real(*a)
        for dims, tokens, sharded in (((2, 4), T_TOKENS, True), ((2, 4), T_TOKENS - 1, False),
                                      ((8, 1), T_TOKENS, False), ((1, 8), T_TOKENS, True),
                                      ((2, 3), T_TOKENS - 4, False), (None, T_TOKENS, False)):
            sh.set_mesh(None if dims is None else _slot_mesh(dims))
            calls.clear()
            out, _, _ = L.moe_apply(moe, x[:tokens], TOP_K, 8.0)
            assert bool(calls) == sharded, (dims, tokens)
            if not sharded:  # the dense dispatch
                want, _, _ = L._moe_apply_dense(moe, x[:tokens], TOP_K, 8.0)
                assert torch.equal(out, want)
    finally:
        L._moe_apply_sharded = real


def test_slot_experts_are_views_on_one_device_and_placed_copies_elsewhere():
    _, moe = _moe_pair(D_MODEL, D_EXPERT, N_EXPERTS, TOP_K, 1.0, False)
    here = moe.slot_experts(1, 4, torch.device("cpu"))
    assert here.up.data_ptr() == moe.up[2].data_ptr() and here.down.shape == (2, D_EXPERT,
                                                                              D_MODEL)
    there = moe.slot_experts(3, 4, torch.device("meta"))
    assert there.gate.device.type == "meta" and there.gate.shape == (2, D_MODEL, D_EXPERT)
    assert moe.slot_experts(3, 4, torch.device("meta")) is there  # placed once


def test_qwen3_moe_forward_under_a_mesh_matches_the_reference(monkeypatch):
    cfg = jax_qwen3.SMOKE
    params = JT.init(cfg, jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), qwen3_moe_30b_a3b.SMOKE, "cpu")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", _jax_mesh((2, 4)))
    want, want_aux = jax.jit(lambda p, t: JT.forward(p, cfg, t))(params, jnp.asarray(tokens))
    monkeypatch.setattr(JS, "_ACTIVE_MESH", None)
    sh.set_mesh(_slot_mesh((2, 4)))
    got, aux = T.forward(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    sh.set_mesh(None)
    dense, dense_aux = T.forward(model, torch.from_numpy(tokens))  # the dense rule's aux differs
    assert abs(float(dense_aux) - float(aux)) > 1e-4
