"""The port's recsys serving path against the JAX package's.

At each arch's ``SMOKE`` config (float32), the JAX parameters of
``init(cfg, key(0))`` are carried across with ``recsys_from_numpy`` and
both packages get the same numpy batch: one with full histories (mask all
ones, the JAX launcher's batch) and one left-padded (lengths uniform in
[1, T], row 0 with a single valid item; DCN-v2's sparse ids there run
below 0 and past the table, where both packages take the floor modulo).
``forward`` and ``score_candidates`` must agree within ``rtol=2e-5`` and
``atol=2e-6·max|want|``: float32 sums taken in another order (XLA's and
PyTorch's CPU kernels); the largest differences read at these sizes are
about 4e-7 of the largest output.  On the CPU the port's attention is the
plain version (``kernels/flash_attention/ref.py``).

Also: ``GQAAttention(causal=False)`` and the ungated ``MLP`` against
``gqa_attention_apply(causal=False)`` and ``mlp_apply`` without a gate;
``lookup``, ``bag_lookup`` and ``mlp_tower`` against the reference's;
a batch served in slices equal to one call; the launcher's recsys branch
and cells on ``--device cpu``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.steps import _recsys_module
from repro.models import layers as JL
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.convert import recsys_from_numpy
from repro_torch.models.recsys import recsys_module

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("dien", "mind", "dcn-v2", "bert4rec")
RTOL, ATOL_SHARE = 2e-5, 2e-6
ROWS, N_CANDIDATES = 9, 40


def assert_close(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SHARE * np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX module, JAX cfg, JAX params, port model with the same
    weights on the CPU)."""
    name = request.param
    cfg = jax_get_arch(name).smoke_cfg
    M = _recsys_module(name)
    params = M.init(cfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    model = recsys_from_numpy(tree, name, get_arch(name).smoke_cfg, "cpu")
    return name, M, cfg, params, model


def _batch(name, cfg, padded: bool):
    rng = np.random.default_rng(7 if padded else 3)
    batch = serve.recsys_batch(name, cfg, ROWS, rng, full_histories=not padded)
    if padded and name == "dcn-v2":
        v = cfg.vocab_per_field
        batch["sparse_ids"] = rng.integers(-v, 3 * v, batch["sparse_ids"].shape).astype(np.int32)
    elif padded:  # row 0 holds one valid item, at the last position
        batch["hist_mask"][0] = 0.0
        batch["hist_mask"][0, -1] = 1.0
        batch["hist_ids"][0, :-1] = 0
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_reference_configs(name):
    jspec, pspec = jax_get_arch(name), get_arch(name)
    assert pspec.family == jspec.family == "recsys"
    for jcfg, pcfg in ((jspec.cfg, pspec.cfg), (jspec.smoke_cfg, pspec.smoke_cfg)):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.n_params() == jcfg.n_params()
    assert {k: dataclasses.asdict(c) for k, c in pspec.cells.items()} == {
        k: dataclasses.asdict(c) for k, c in jspec.cells.items()}


@pytest.mark.parametrize("padded", [False, True], ids=["full", "left_padded"])
def test_forward_matches_reference(pair, padded):
    name, M, cfg, params, model = pair
    batch = _batch(name, cfg, padded)
    want = M.forward(params, cfg, _jax(batch))
    with torch.no_grad():
        got = model(_torch(batch))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "left_padded"])
def test_score_candidates_matches_reference(pair, padded):
    name, M, cfg, params, model = pair
    batch = _batch(name, cfg, padded)
    cands = np.random.default_rng(11).integers(
        0, serve.item_vocab(cfg), N_CANDIDATES).astype(np.int32)
    want = M.score_candidates(params, cfg, _jax(batch), jnp.asarray(cands))
    with torch.no_grad():
        got = model.score_candidates(_torch(batch), torch.from_numpy(cands))
    assert got.shape == (ROWS, N_CANDIDATES)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("n_heads,n_kv_heads,head_dim", [(2, 2, 32), (4, 2, 16)])
def test_non_causal_attention_matches_reference(n_heads, n_kv_heads, head_dim):
    d_model, b, t = 48, 3, 11
    p = JL.gqa_attention_init(jax.random.key(1), d_model, n_heads, n_kv_heads, head_dim)
    attn = L.GQAAttention(d_model, n_heads, n_kv_heads, head_dim, 10_000.0, False, False,
                          torch.float32, "cpu")
    for name in ("q", "k", "v", "o"):
        getattr(attn, name).kernel.copy_(torch.from_numpy(np.array(p[name]["kernel"])))
    x = np.random.default_rng(2).standard_normal((b, t, d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(t), (b, t))
    want, _ = JL.gqa_attention_apply(p, jnp.asarray(x), jnp.asarray(positions), n_heads,
                                     n_kv_heads, head_dim, causal=False, window=None)
    got = attn(torch.from_numpy(x), torch.arange(t)[None], None, causal=False)
    assert_close(got.numpy(), want)
    causal = attn(torch.from_numpy(x), torch.arange(t)[None], None)
    assert not np.allclose(causal.numpy(), np.asarray(want))  # the flag is read


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_ungated_mlp_matches_reference(act):
    p = JL.mlp_init(jax.random.key(4), 24, 40, gated=False)
    mlp = L.MLP(24, 40, act, torch.float32, "cpu", gated=False)
    assert mlp.gate is None
    mlp.up.kernel.copy_(torch.from_numpy(np.array(p["up"]["kernel"])))
    mlp.down.kernel.copy_(torch.from_numpy(np.array(p["down"]["kernel"])))
    x = np.random.default_rng(5).standard_normal((6, 24)).astype(np.float32)
    assert_close(mlp(torch.from_numpy(x)).numpy(), JL.mlp_apply(p, jnp.asarray(x), act=act))


@pytest.mark.parametrize("fn", ["lookup", "bag_lookup", "mlp_tower"])
def test_embedding_substrate_matches_reference(fn):
    from repro.models.recsys import embedding as JE
    from repro_torch.models.recsys import embedding as E

    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 7)).astype(np.int32)
    if fn == "lookup":
        got = E.lookup(torch.from_numpy(table), torch.from_numpy(ids))
        assert_close(got.numpy(), JE.lookup(jnp.asarray(table), jnp.asarray(ids)))
    elif fn == "bag_lookup":
        mask = (rng.random((4, 7)) < 0.6).astype(np.float32)
        got = E.bag_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask))
        assert_close(got.numpy(), JE.bag_lookup(jnp.asarray(table), jnp.asarray(ids),
                                                jnp.asarray(mask)))
    else:
        tree = JE.mlp_tower_init(jax.random.key(2), (8, 16, 3))
        tower = E.mlp_tower_init(torch.Generator().manual_seed(0), (8, 16, 3), "cpu")
        for dense, p in zip(tower.layers, tree):
            dense.kernel.copy_(torch.from_numpy(np.array(p["kernel"])))
            dense.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        x = table[:5]
        for final_act in (False, True):
            got = E.mlp_tower(tower, torch.from_numpy(x), final_act=final_act)
            assert_close(got.numpy(), JE.mlp_tower(tree, jnp.asarray(x), final_act=final_act))


@pytest.mark.parametrize("name", ARCHS)
def test_sliced_serving_equals_one_call(name):
    cfg = get_arch(name).smoke_cfg
    model = recsys_module(name).init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch(serve.recsys_batch(name, cfg, 10, np.random.default_rng(1)))
    with torch.no_grad():
        whole = model(batch)
        sliced = serve.forward_sliced(model, batch, slice_rows=3)
    assert sliced.shape == (10,)
    torch.testing.assert_close(sliced, whole, rtol=RTOL, atol=ATOL_SHARE * float(whole.abs().max()))


@pytest.mark.parametrize("name", ARCHS)
def test_init_draws_the_reference_distributions(name):
    cfg = dataclasses.replace(get_arch(name).smoke_cfg, **(
        {"vocab_per_field": 4000} if name == "dcn-v2" else {"vocab": 4000}))
    model = recsys_module(name).init(cfg, torch.Generator().manual_seed(0), "cpu")
    table = model.tables if name == "dcn-v2" else model.item_embed
    assert abs(table.std().item() - 0.05) < 0.002
    again = recsys_module(name).init(cfg, torch.Generator().manual_seed(0), "cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    for mod in model.modules():
        if isinstance(mod, L.Dense):
            d_in = mod.kernel.shape[0]
            if mod.kernel.numel() >= 256:
                assert abs(mod.kernel.std().item() - d_in**-0.5) < 0.2 * d_in**-0.5
            if mod.bias is not None:
                assert not mod.bias.any()


@pytest.mark.parametrize("name", ARCHS)
def test_recsys_batch_left_pads_histories(name):
    cfg = get_arch(name).cfg
    batch = serve.recsys_batch(name, cfg, 300, np.random.default_rng(0))
    if name == "dcn-v2":
        assert batch["dense"].shape == (300, 13) and batch["sparse_ids"].shape == (300, 26)
        assert 0 <= batch["sparse_ids"].min() and batch["sparse_ids"].max() < cfg.vocab_per_field
        return
    mask, ids = batch["hist_mask"], batch["hist_ids"]
    t = serve.history_len(cfg)
    assert mask.shape == ids.shape == (300, t)
    lengths = mask.sum(1).astype(int)
    assert lengths.min() >= 1 and lengths.max() <= t and len(set(lengths)) > 10
    # left-padded: the valid positions are the last ``length`` ones, pads are id 0
    assert np.array_equal(mask, (np.arange(t)[None] >= t - lengths[:, None]).astype(np.float32))
    assert not ids[mask == 0].any() and batch["target_id"].max() < cfg.vocab


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_serves_each_arch_on_the_cpu(name, capsys):
    report = serve.main(["--arch", name, "--device", "cpu", "--requests", "5"])
    assert report["device"] == "cpu" and report["rows"] == 5
    assert report["scores"].shape == (5,) and np.isfinite(report["scores"]).all()
    assert report["candidate_scores"].shape == (5, serve.SMOKE_CANDIDATES)
    assert "scored 5 requests" in capsys.readouterr().out


def test_launcher_cells_on_the_cpu():
    report = serve.main(["--arch", "dcn-v2", "--device", "cpu", "--cell", "serve_p99"])
    assert report["rows"] == 512 and report["scores"].shape == (512,)
    report = serve.main(["--arch", "mind", "--device", "cpu", "--cell", "retrieval_cand"])
    assert report["candidate_scores"].shape == (1, 1_000_000)
    for arch, cell in (("dien", "train_batch"), ("gemma3-4b", "serve_p99"),
                       ("bert4rec", "decode_32k")):
        with pytest.raises((ValueError, KeyError)):
            serve.main(["--arch", arch, "--device", "cpu", "--cell", cell])


def test_launcher_runs_as_a_program_and_prints():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "dien", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    assert "scored 8 requests" in out.stdout and "candidates" in out.stdout
