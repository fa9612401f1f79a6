"""The port's MoE against the JAX package's single-device dispatch.

``moe_apply`` against ``_moe_apply_dense`` (float32, inputs from a seeded
numpy generator, the JAX ``moe_init`` weights carried across): outputs
and aux loss within ``rtol=atol=1e-5`` (float32 sums in another order).
Each token's experts must equal the reference's ``jax.lax.top_k``
choice, in order, and each slot's keep flag the reference's capacity
rule, recomputed here in numpy from the reference's choice.  Near-ties:
the two packages' router probabilities differ by float32 rounding, so
where a token's experts differ, the reference's probabilities of the two
experts swapped must lie within ``ROUTER_TIE`` of each other; its
outputs, and those of any token whose keep flags then differ, are left
out of the comparison.  Cases: capacity factors 0.5 (slots dropped),
1.25 and 8.0 (no drops), one token (capacity 1), and a router built so
that pairs of experts tie exactly, where the lower index must win as in
``jax.lax.top_k``.

Whole models at qwen3-moe-30b-a3b's and arctic-480b's ``SMOKE``: hidden
states and aux loss of ``forward``, prefill and eight teacher-forced
decode steps (with the bf16 cache of ``SMOKE`` and the int8 cache of the
``decode_32k`` cell) and the greedy loop of the launcher against the JAX
launcher, by the rules (and with the helpers) of ``test_torch_lm_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arctic_480b as jax_arctic
from repro.configs import qwen3_moe_30b_a3b as jax_qwen3
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import arctic_480b, qwen3_moe_30b_a3b
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from test_torch_lm_serve import _jax_greedy_loop, assert_greedy_tokens_match

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# Router probabilities of the two packages differ by float32 rounding of
# the logits and the softmax: a few units in the last place of values
# below 1.
ROUTER_TIE = 1e-6
ARCHS = {"qwen3-moe-30b-a3b": (jax_qwen3, qwen3_moe_30b_a3b),
         "arctic-480b": (jax_arctic, arctic_480b)}
PROMPT_LEN = 24
DECODE_STEPS = 8
# (tokens, d_model, d_expert, experts, top_k, capacity factor, tied router)
MOE_CASES = {
    "cf0.5": (64, 32, 48, 8, 2, 0.5, False),
    "cf1.25": (64, 32, 48, 8, 2, 1.25, False),
    "cf8": (64, 32, 48, 8, 2, 8.0, False),
    "one_token": (1, 32, 48, 8, 3, 1.25, False),
    "top8_of_16": (40, 32, 24, 16, 8, 1.25, False),
    "tied_router": (64, 32, 48, 8, 2, 1.25, True),
}


def _moe_pair(d, f, e, top_k, cf, tied, seed=0):
    """The JAX MoE params and the port's ``MoE`` holding the same weights."""
    p = JL.moe_init(jax.random.key(seed), d, f, e)
    if tied:  # experts 2k+1 route exactly as 2k
        kernel = np.asarray(p["router"]["kernel"]).copy()
        kernel[:, 1::2] = kernel[:, 0::2]
        p["router"]["kernel"] = jnp.asarray(kernel)
    moe = L.MoE(d, f, e, top_k, cf, "silu", torch.float32, "cpu")
    moe.router.kernel.copy_(torch.from_numpy(np.array(p["router"]["kernel"])))
    for name in ("up", "gate", "down"):
        getattr(moe, name).copy_(torch.from_numpy(np.array(p[name])))
    return p, moe


def _reference_routing(p, x, top_k, cf):
    """The reference's experts (``jax.lax.top_k`` of its probabilities)
    and its keep flags, from its capacity rule in numpy."""
    probs = np.asarray(jax.nn.softmax(JL.dense(p["router"], jnp.asarray(x)).astype(jnp.float32)))
    _, idx = jax.lax.top_k(jnp.asarray(probs), top_k)
    idx = np.asarray(idx)
    t, e = probs.shape
    capacity = int(max(1, cf * t * top_k / e))
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    start = np.searchsorted(flat[order], np.arange(e), side="left")
    keep = np.empty(flat.shape, bool)
    keep[order] = np.arange(flat.size) - start[flat[order]] < capacity
    return probs, idx, keep.reshape(idx.shape), capacity


def _compared_tokens(probs, want_idx, got_idx, want_keep, got_keep):
    """Tokens whose routing agrees; every expert that differs must be a
    near-tie of the reference's probabilities (``ROUTER_TIE``)."""
    for t, j in zip(*np.nonzero(got_idx != want_idx)):
        a, b = probs[t, want_idx[t, j]], probs[t, got_idx[t, j]]
        assert abs(a - b) <= ROUTER_TIE, f"token {t} slot {j}: experts differ beyond a near-tie"
    return ((got_idx == want_idx) & (got_keep == want_keep)).all(axis=1)


def test_top_k_routing_breaks_ties_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.0, 0.0, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3):
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), k)
        gates, idx = L.top_k_routing(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        want = np.asarray(want_vals)
        np.testing.assert_allclose(gates.numpy(), want / np.maximum(want.sum(-1, keepdims=True),
                                                                    1e-9), rtol=1e-6)
    # a token whose top probabilities are all 0 keeps gates of 0 (sum held at 1e-9)
    gates, _ = L.top_k_routing(torch.zeros((1, 4)), 2)
    assert not gates.any()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_the_dense_dispatch(case):
    t, d, f, e, top_k, cf, tied = MOE_CASES[case]
    p, moe = _moe_pair(d, f, e, top_k, cf, tied)
    x = np.random.default_rng(3).standard_normal((t, d)).astype(np.float32)
    want, want_aux = JL._moe_apply_dense(p, jnp.asarray(x), top_k, cf, "silu")
    got, aux, routing = L.moe_apply(moe, torch.from_numpy(x), top_k, cf, "silu")
    probs, want_idx, want_keep, capacity = _reference_routing(p, x, top_k, cf)
    got_idx, got_keep = routing.experts.numpy(), routing.keep.numpy()
    assert got_idx.shape == got_keep.shape == (t, top_k)
    same = _compared_tokens(probs, want_idx, got_idx, want_keep, got_keep)
    assert same.sum() >= t - 2  # near-ties are rare; most tokens are compared
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    dropped = int((~routing.keep).sum())
    if case == "cf0.5":
        assert dropped > 0 and capacity == int(0.5 * t * top_k / e)
    if case in ("cf8", "one_token"):
        assert dropped == 0
    if case == "one_token":
        assert capacity == 1
    if tied:  # the tied pairs sit side by side in the choice, lower index first
        pairs = got_idx[got_idx % 2 == 0]
        assert pairs.size and (got_idx[:, 1:][got_idx[:, :-1] % 2 == 0]
                               == got_idx[:, :-1][got_idx[:, :-1] % 2 == 0] + 1).all()
        np.testing.assert_array_equal(got_idx, want_idx)
    # The dispatch repeated through the module stores the same routing.
    out, module_aux = moe(torch.from_numpy(x))
    assert torch.equal(out, got) and torch.equal(moe.routing.keep, routing.keep)


def test_kept_slots_follow_token_order_not_the_order_of_a_tokens_experts():
    """The capacity rule ranks an expert's slots by token: with capacity 1
    the first token that chose an expert keeps it, whatever place the
    expert has among that token's k."""
    _, moe = _moe_pair(16, 8, 4, 2, 0.5, False)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32))
    _, _, routing = L.moe_apply(moe, x, 2, 0.25)  # capacity int(max(1, 0.25·8·2/4)) = 1
    experts, keep = routing.experts.numpy(), routing.keep.numpy()
    seen = set()
    for t in range(8):
        for j in range(2):
            assert keep[t, j] == (experts[t, j] not in seen)
        seen.update(experts[t].tolist())


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(arch, JAX cfg, JAX params, port model with the same weights)."""
    jax_mod, port_mod = ARCHS[request.param]
    params = JT.init(jax_mod.SMOKE, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return request.param, jax_mod.SMOKE, params, params_from_numpy(tree, port_mod.SMOKE, "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_are_the_reference_configs(arch):
    jax_mod, port_mod = ARCHS[arch]
    for jcfg, pcfg in ((jax_mod.CFG, port_mod.CFG), (jax_mod.SMOKE, port_mod.SMOKE)):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.n_params() == jcfg.n_params()
        assert pcfg.n_active_params() == jcfg.n_active_params()
    spec, jspec = get_arch(arch), jax_mod.spec()
    assert spec.cfg == port_mod.CFG and spec.fsdp == jspec.fsdp
    assert {n: dataclasses.asdict(c) for n, c in spec.cells.items()} == {
        n: dataclasses.asdict(c) for n, c in jspec.cells.items()}
    assert port_mod.CFG.adtype == torch.bfloat16


def test_full_width_parameter_counts():
    assert round(qwen3_moe_30b_a3b.CFG.n_params() / 1e9, 2) == 30.53
    two_layers = dataclasses.replace(arctic_480b.CFG, n_layers=2)
    assert round(two_layers.n_params() / 1e9, 2) == 27.68
    assert round(arctic_480b.CFG.n_params() / 1e9, 1) == 476.9


def test_block_layout_follows_the_config():
    for arch, has_mlp in (("qwen3-moe-30b-a3b", False), ("arctic-480b", True)):
        cfg = ARCHS[arch][1].SMOKE
        model = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
        blk = model.blocks[0]
        assert blk.moe is not None and (blk.mlp is not None) == has_mlp
        assert blk.moe.up.shape == (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert)
        assert blk.moe.down.shape == (cfg.moe.n_experts, cfg.moe.d_expert, cfg.d_model)
        # moe_init's scales: up and gate d_model^-1/2, down d_expert^-1/2
        for w, fan_in in ((blk.moe.up, cfg.d_model), (blk.moe.gate, cfg.d_model),
                          (blk.moe.down, cfg.moe.d_expert)):
            assert abs(w.std().item() - fan_in**-0.5) < 0.1 * fan_in**-0.5
        assert not torch.equal(blk.moe.up[0], blk.moe.up[1])


def test_forward_hidden_states_and_aux_match(pair):
    _arch, jcfg, params, model = pair
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, PROMPT_LEN)).astype(np.int32)
    want, want_aux = JT.forward(params, jcfg, jnp.asarray(tokens))
    got, aux = T.forward(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_prefill_and_decode_match(pair, kv_quant):
    _arch, jcfg, params, model = pair
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    b, max_len = 2, PROMPT_LEN + DECODE_STEPS
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab, (b, PROMPT_LEN)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab, (b, DECODE_STEPS)).astype(np.int32)
    jcache = JT.init_cache(jcfg, b, max_len)
    cache = T.init_cache(dataclasses.replace(model.cfg, kv_quant=kv_quant), b, max_len, "cpu")
    jlogits, jcache = JT.prefill(params, jcfg, jnp.asarray(prompt), jcache)
    logits, cache = T.prefill(model, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    for s in range(DECODE_STEPS):
        jlogits, jcache = step(params, jnp.asarray(fed[:, s:s + 1]), jcache)
        logits, cache = T.decode_step(model, torch.from_numpy(fed[:, s:s + 1]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    assert cache.length == int(jcache.length) == max_len
    np.testing.assert_allclose(cache.k_scale.numpy() if kv_quant else cache.k.numpy(),
                               np.asarray(jcache.k_scale if kv_quant else jcache.k), **MODEL_TOL)


def test_greedy_loop_matches_the_jax_launcher(pair, capsys, monkeypatch):
    arch, jcfg, params, model = pair
    args = serve.build_parser().parse_args(["--arch", arch, "--device", "cpu"])
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)
    report = serve.serve(model, prompts, args.decode_steps, log_fn=lambda *_: None)
    got = report["tokens"]
    drops = report["dropped_slots"]
    assert len(drops) == 1 + args.decode_steps and all(0 <= n for n in drops)
    want, jlogits = _jax_greedy_loop(params, jcfg, prompts, args.decode_steps)
    from repro.launch import serve as jax_serve

    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
    jax_serve.main()
    first = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("first request:")]
    assert first and first[0] == f"first request: {want[0].tolist()}"
    assert_greedy_tokens_match(got, want, jlogits)
