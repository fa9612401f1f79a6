"""The port's int8 KV cache (``kv_quant``) against the JAX package's.

The quantizer is held bit for bit: ``_quantize``'s codes and scales and
``_dequantize``'s values equal the JAX functions' on float32 and bfloat16
inputs, an all-zero row and values at half steps (both round half to
even).  ``cache_update``/``cache_read`` of a quantized cache store the
same codes and scales and read the same values.

Whole models (gemma3-4b and qwen1.5-4b ``SMOKE`` with ``kv_quant=True``,
float32, the JAX parameters carried across by ``params_from_numpy``):
prefill of 24 tokens (past gemma3's window of 8, so its local layers
dequantize only their window at decode) and eight teacher-forced decode
steps, logits within ``rtol=atol=1e-4`` as in ``test_torch_lm_serve.py``.
The cache's scales must agree within the same tolerance and its codes
be equal, with one exception: the port's and the reference's keys and
values differ by float32 sums taken in another order, so a value that
lies at a half step of the int8 grid can round to the neighbouring code.
The reference's unquantized value is not visible (its cache holds codes),
so the rule reads the port's value ``x`` (recorded at ``cache_update``)
and allows codes one apart only where ``x`` lies within ``atol +
rtol·|x|`` of the half step ``(c + 1/2)·scale`` between them (``c`` the
lower code, ``scale`` the reference's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as jax_gemma
from repro.configs import qwen1_5_4b as jax_qwen
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import gemma3_4b, qwen1_5_4b
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"gemma3-4b": (jax_gemma, gemma3_4b), "qwen1.5-4b": (jax_qwen, qwen1_5_4b)}
PROMPT_LEN = 24
DECODE_STEPS = 8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _values(seed):
    """(2, 6, 3, 16) float32: normal values, one all-zero (B, L, H) row, and
    rows whose amax makes the scale 1 and 2 with values at half steps."""
    x = np.random.default_rng(seed).standard_normal((2, 6, 3, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    x[1, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 63.5, 0, 0, 0, 0, 0, 0]
    x[1, 0, 1] = [254.0, 1.0, 3.0, 5.0, -1.0, -3.0, -5.0, 7.0, 0, 0, 0, 0, 0, 0, 0, -9.0]
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_and_dequantize_are_bit_identical(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _values(0)
    jq, js = JL._quantize(jnp.asarray(x, jdt))
    q, s = L._quantize(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # half steps round to even, the zero row keeps the 1e-8 floor
    assert q[1, 0, 0, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 64]
    assert q[1, 0, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    assert not q[0, 1, 2].any() and float(s[0, 1, 2]) == np.float32(1e-8)
    want = JL._dequantize(jq, js, jdt)
    got = L._dequantize(q, s, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantized_cache_update_and_read_match(dtype):
    jdt, tdt = DTYPES[dtype]
    b, max_len, h, d = 2, 10, 3, 16
    first, second = _values(1), _values(2)[:, :1]
    jc = JL.init_kv_cache(b, max_len, h, d, dtype=jdt, quantized=True)
    cache = L.KVCache(k=torch.zeros((b, max_len, h, d), dtype=torch.int8),
                      v=torch.zeros((b, max_len, h, d), dtype=torch.int8),
                      k_scale=torch.ones((b, max_len, h)), v_scale=torch.ones((b, max_len, h)))
    for k_new in (first, second):
        v_new = -0.5 * k_new
        jc = JL.cache_update(jc, jnp.asarray(k_new, jdt), jnp.asarray(v_new, jdt))
        L.cache_update(cache, torch.from_numpy(k_new).to(tdt), torch.from_numpy(v_new).to(tdt))
    n = first.shape[1] + second.shape[1]
    assert cache.length == int(jc.length) == n
    for got, want in ((cache.k, jc.k), (cache.v, jc.v), (cache.k_scale, jc.k_scale),
                      (cache.v_scale, jc.v_scale)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jk, jv = JL.cache_read(jc, jdt)
    k, v = L.cache_read(cache, tdt)
    assert k.shape == (b, n, h, d) and k.dtype == tdt
    np.testing.assert_array_equal(k.float().numpy(), np.asarray(jk[:, :n].astype(jnp.float32)))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(jv[:, :n].astype(jnp.float32)))
    k3, _ = L.cache_read(cache, tdt, start=3)  # a local layer's window
    np.testing.assert_array_equal(k3.float().numpy(), k[:, 3:].float().numpy())
    with pytest.raises(ValueError, match="full"):
        L.cache_update(cache, torch.zeros((b, max_len, h, d), dtype=tdt),
                       torch.zeros((b, max_len, h, d), dtype=tdt))


def _check_codes(name, got, want, want_scale, values):
    """Codes equal, or one apart where the port's value lies within the
    tolerance of the half step between them (the module docstring's
    rule).  Returns how many codes the rule let pass."""
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    diff = np.nonzero(got != want)
    if not diff[0].size:
        return 0
    assert np.abs(got - want)[diff].max() == 1, f"{name}: codes more than one apart"
    x = values[diff]
    half = (np.minimum(got, want)[diff] + 0.5) * np.asarray(want_scale)[diff[:-1]]
    far = np.abs(x - half) > TOL["atol"] + TOL["rtol"] * np.abs(x)
    assert not far.any(), (f"{name}: codes one apart away from a half step at "
                           f"{[tuple(int(i[j]) for i in diff) for j in np.nonzero(far)[0]]}")
    return diff[0].size


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_int8_cache_prefill_and_decode_match(arch, monkeypatch):
    jax_mod, port_mod = ARCHS[arch]
    jcfg = dataclasses.replace(jax_mod.SMOKE, kv_quant=True)
    pcfg = dataclasses.replace(port_mod.SMOKE, kv_quant=True)
    params = JT.init(jcfg, jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), pcfg, "cpu")
    b, max_len = 2, PROMPT_LEN + DECODE_STEPS
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab, (b, PROMPT_LEN)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab, (b, DECODE_STEPS)).astype(np.int32)

    shape = (pcfg.n_layers, b, max_len, pcfg.n_kv_heads, pcfg.head_dim)
    values = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    writes, update = [], L.cache_update

    def recording_update(cache, k_new, v_new):
        layer = len(writes) % pcfg.n_layers
        pos = cache.length
        for name, x in (("k", k_new), ("v", v_new)):
            values[name][layer, :, pos:pos + x.shape[1]] = x.numpy()
        writes.append(layer)
        update(cache, k_new, v_new)

    monkeypatch.setattr(L, "cache_update", recording_update)
    jcache = JT.init_cache(jcfg, b, max_len)
    cache = T.init_cache(pcfg, b, max_len, "cpu")
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape == shape[:-1]
    assert bool((cache.k_scale == 1).all())
    jlogits, jcache = JT.prefill(params, jcfg, jnp.asarray(prompt), jcache)
    logits, cache = T.prefill(model, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    for s in range(DECODE_STEPS):
        jlogits, jcache = step(params, jnp.asarray(fed[:, s:s + 1]), jcache)
        logits, cache = T.decode_step(model, torch.from_numpy(fed[:, s:s + 1]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache.length == int(jcache.length) == max_len
    assert len(writes) == pcfg.n_layers * (1 + DECODE_STEPS)
    np.testing.assert_allclose(cache.k_scale.numpy(), np.asarray(jcache.k_scale), **TOL)
    np.testing.assert_allclose(cache.v_scale.numpy(), np.asarray(jcache.v_scale), **TOL)
    _check_codes("k", cache.k, jcache.k, jcache.k_scale, values["k"])
    _check_codes("v", cache.v, jcache.v, jcache.v_scale, values["v"])


def test_local_layers_dequantize_only_their_window(monkeypatch):
    """At gemma3's local layers a decode step dequantizes the last
    ``window`` positions, its global layer the whole prefix."""
    cfg = dataclasses.replace(gemma3_4b.SMOKE, kv_quant=True)
    model = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = T.init_cache(cfg, 1, 20, "cpu")
    T.prefill(model, torch.zeros((1, 16), dtype=torch.int32), cache)
    lengths, dequantize = [], L._dequantize
    monkeypatch.setattr(L, "_dequantize", lambda q, s, dt: lengths.append(q.shape[1])
                        or dequantize(q, s, dt))
    T.decode_step(model, torch.zeros((1, 1), dtype=torch.int32), cache)
    window = cfg.window
    assert lengths == [window] * 4 + [17] * 2  # k and v of layers 0, 1 (local), 2 (global)


def test_serving_cells_set_the_int8_cache():
    spec = get_arch("gemma3-4b")
    for cell in ("prefill_32k", "decode_32k", "long_500k"):
        cfg = serve.cell_config(spec, spec.cfg, cell)
        assert cfg.kv_quant and cfg == dataclasses.replace(spec.cfg, **spec.cells[cell].overrides)
    assert serve.cell_config(spec, spec.cfg, None) is spec.cfg
    with pytest.raises(ValueError, match="train cell"):
        serve.cell_config(spec, spec.cfg, "train_4k")
    with pytest.raises(KeyError, match="no cell"):
        serve.cell_config(spec, spec.cfg, "decode_1m")
    qwen = get_arch("qwen1.5-4b")
    with pytest.raises(ValueError, match="skips cell"):
        serve.cell_config(qwen, qwen.cfg, "long_500k")
    report = serve.main(["--arch", "gemma3-4b", "--cell", "decode_32k", "--device", "cpu",
                         "--requests", "2", "--decode-steps", "3"])
    assert report["kv_quant"] and report["tokens"].shape == (2, 3)
    assert report["dropped_slots"] is None
