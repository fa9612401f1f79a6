"""The port's LM serving path against the JAX package's.

At gemma3-4b's and qwen1.5-4b's ``SMOKE`` configs (float32), the JAX
parameters of ``init(cfg, key(0))`` are carried across with
``params_from_numpy`` and both packages get the same numpy tokens.
Hidden states, prefill logits (a prompt of 24 tokens, past gemma3's
window of 8), eight teacher-forced decode steps and the cache contents
must agree within ``rtol=atol=1e-4``: float32 sums taken in another order
(the port's attention keeps its scores in float32 as the Pallas kernel
does).  The greedy loop of the port's launcher must give the JAX
launcher's tokens, except at a near-tie: where a request's tokens first
differ, the JAX logits of the two tokens must lie within that tolerance
(the rule of ``ROADMAP.md`` Queue 3); after it the request is not
compared further.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as jax_gemma
from repro.configs import qwen1_5_4b as jax_qwen
from repro.models import transformer as JT
from repro_torch.configs import gemma3_4b, qwen1_5_4b
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {
    "gemma3-4b": (jax_gemma, gemma3_4b),
    "qwen1.5-4b": (jax_qwen, qwen1_5_4b),
}
PROMPT_LEN = 24
DECODE_STEPS = 8


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(arch, JAX cfg, JAX params, port model with the same weights)."""
    jax_mod, port_mod = ARCHS[request.param]
    params = JT.init(jax_mod.SMOKE, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return request.param, jax_mod.SMOKE, params, params_from_numpy(tree, port_mod.SMOKE, "cpu")


def _tokens(seed, cfg, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_are_the_reference_configs(arch):
    jax_mod, port_mod = ARCHS[arch]
    for jcfg, pcfg in ((jax_mod.CFG, port_mod.CFG), (jax_mod.SMOKE, port_mod.SMOKE)):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.n_params() == jcfg.n_params()
        assert pcfg.n_active_params() == jcfg.n_active_params()
        assert pcfg.layer_windows() == np.asarray(jcfg.layer_windows()).tolist()
    assert get_arch(arch).cfg == port_mod.CFG
    assert port_mod.CFG.adtype == torch.bfloat16 and port_mod.SMOKE.adtype == torch.float32


def test_gemma3_full_width_parameter_count():
    assert round(gemma3_4b.CFG.n_params() / 1e9, 2) == 3.88
    assert gemma3_4b.CFG.layer_windows().count(0) == 5  # every 6th of 34 is global


def test_forward_hidden_states_match(pair):
    _arch, jcfg, params, model = pair
    tokens = _tokens(1, jcfg, 2, PROMPT_LEN)
    want, want_aux = JT.forward(params, jcfg, jnp.asarray(tokens))
    got, aux = T.forward(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(want_aux) == 0.0  # no MoE, no aux loss


def test_prefill_decode_and_cache_match(pair):
    _arch, jcfg, params, model = pair
    b, max_len = 2, PROMPT_LEN + DECODE_STEPS
    prompt = _tokens(2, jcfg, b, PROMPT_LEN)
    fed = _tokens(3, jcfg, b, DECODE_STEPS)  # teacher forcing: both get these
    jcache = JT.init_cache(jcfg, b, max_len)
    jlogits, jcache = JT.prefill(params, jcfg, jnp.asarray(prompt), jcache)
    cache = T.init_cache(model.cfg, b, max_len, "cpu")
    logits, cache = T.prefill(model, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache.length == int(jcache.length) == PROMPT_LEN
    step = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    for s in range(DECODE_STEPS):
        jlogits, jcache = step(params, jnp.asarray(fed[:, s : s + 1]), jcache)
        logits, cache = T.decode_step(model, torch.from_numpy(fed[:, s : s + 1]), cache)
        assert logits.shape == (b, jcfg.vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache.length == int(jcache.length) == max_len
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)


def _jax_greedy_loop(params, cfg, prompts, steps):
    """The LM loop of ``repro.launch.serve`` (its lines 36-46), keeping
    each step's logits."""
    cache = JT.init_cache(cfg, prompts.shape[0], prompts.shape[1] + steps)
    logits, cache = JT.prefill(params, cfg, jnp.asarray(prompts), cache)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, cfg, t, c))
    toks, all_logits = [], []
    for _ in range(steps):
        all_logits.append(np.asarray(logits))
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(nxt)[:, 0])
        logits, cache = step(params, nxt, cache)
    return np.stack(toks, 1), np.stack(all_logits, 1)


def test_greedy_loop_matches_the_jax_launcher(pair, capsys, monkeypatch):
    arch, jcfg, params, model = pair
    args = serve.build_parser().parse_args(["--arch", arch, "--device", "cpu"])
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)
    report = serve.serve(model, prompts, args.decode_steps, log_fn=lambda *_: None)
    got = report["tokens"]
    assert got.shape == (args.requests, args.decode_steps)
    assert report["cache_len"] == args.prompt_len + args.decode_steps
    want, jlogits = _jax_greedy_loop(params, jcfg, prompts, args.decode_steps)
    # The JAX launcher itself, with the same arch and defaults (its
    # weights are init(SMOKE, key(0)), its prompts default_rng(0)).
    from repro.launch import serve as jax_serve

    capsys.readouterr()
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
    jax_serve.main()
    first = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("first request:")]
    assert first and first[0] == f"first request: {want[0].tolist()}"
    assert_greedy_tokens_match(got, want, jlogits)


def assert_greedy_tokens_match(got, want, jlogits):
    """Equal tokens, but where a request's first differ the JAX logits of
    the two tokens lie within ``TOL`` (a near-tie); the request is not
    compared after it."""
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size == 0:
            continue
        s = diff[0]
        a, b = jlogits[r, s, want[r, s]], jlogits[r, s, got[r, s]]
        assert abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(a), (r, s, a, b)


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(gemma3_4b.SMOKE, d_model=256, d_ff=512, vocab=2048)
    model = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert abs(model.embed.std().item() - cfg.d_model**-0.5) < 0.05 * cfg.d_model**-0.5
    up = model.blocks[0].mlp.up.kernel
    assert abs(up.std().item() - cfg.d_model**-0.5) < 0.05 * cfg.d_model**-0.5
    down = model.blocks[0].mlp.down.kernel
    assert abs(down.std().item() - cfg.d_ff**-0.5) < 0.05 * cfg.d_ff**-0.5
    for blk in model.blocks:
        assert not blk.attn_norm.any() and not blk.attn.q_norm.any()
    assert [blk.window for blk in model.blocks] == [8, 8, 2**30]
    again = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.blocks[2].attn.o.kernel, model.blocks[2].attn.o.kernel)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_arch("pna")
    assert get_arch("qwen1.5-32b").cfg.name == "qwen1.5-32b"  # ported with the model axis
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-2")
    model = T.init(gemma3_4b.SMOKE, torch.Generator().manual_seed(0), "cpu")
    cache = T.init_cache(gemma3_4b.SMOKE, 1, 4, "cpu")
    with pytest.raises(ValueError, match="full"):
        T.prefill(model, torch.zeros((1, 5), dtype=torch.int32), cache)
