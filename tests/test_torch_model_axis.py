"""The port's model axis against the JAX package's.

* ``plan_mesh_shape`` and ``ElasticMesh(model_parallel, prefer_pods)``:
  shapes, axes and the slots used equal the reference's over the 8 fake
  CPU devices of ``tests/conftest.py`` (the port over ``["cpu"] * n``
  slots), also after ``exclude_device`` and ``exclude_host``.
* ``decode_shards``: each slot's batch rows and positions equal what the
  cache's spec inside the reference's ``_flash_decode`` gives that device.
* ``_flash_decode``, the split-K mesh decode: the port against the JAX
  function itself, run with the reference's ambient mesh (``Auto`` axes)
  set as its module global (``repro.dist.sharding._ACTIVE_MESH``, by
  ``monkeypatch``), on meshes (2, 4) and (1, 4) and with batch 1 on
  (2, 4); float32 and int8 caches; no window and a window of 6 (whose
  first shard sees no key at length 9); ``length`` inside a shard and on
  a shard boundary, with the reference under ``jax.jit``.  Outputs within
  2e-5 of the largest (float32 sums in another order), the written caches
  bit for bit, but for one thing: under ``jax.jit`` XLA takes the
  quantizer's ``amax / 127`` as a multiply by the reciprocal, so an int8
  scale may lie one unit in the last place from the port's.  Run eagerly
  (seconds a call, so on one case a mesh), the reference divides as its
  ``_quantize`` and the port do, and there the int8 codes and scales are
  held bit for bit too.
* the port's mesh decode against its own single-device decode (whole
  models, both caches, a local layer's window): logits and caches
  within 1e-5 (the split-K partial sums round apart, and later layers'
  keys and values follow).
* qwen1.5-32b: its configs equal the reference's; at ``SMOKE`` the
  port's prefill and decode steps under a (1, 4) CPU mesh against the
  JAX single-device ``decode_step`` within ``rtol=atol=1e-4`` (the JAX
  mesh prefill does not run under the installed jax: its
  ``cache_update`` raises under the explicit-axis mesh; the int8 cache's
  whole-model rule, codes one apart at half steps, is
  ``test_torch_kv_quant.py``'s and the single-device decode's, which the
  mesh decode equals above), and the launcher's ``--mesh 1x4 --device
  cpu``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import qwen1_5_32b as jax_qwen32
from repro.dist import fault_tolerance as JF
from repro.dist import sharding as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import qwen1_5_32b
from repro_torch.configs.registry import get_arch
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault_tolerance import (ElasticMesh, NoDevicesError, ShardSlot, SlotMesh,
                                              plan_mesh_shape)
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_RTOL = 2e-5
B, S, HQ, HKV, D = 4, 16, 4, 2, 16


@pytest.fixture(autouse=True)
def no_ambient_mesh():
    """Every test starts and ends without a port mesh."""
    sh.set_mesh(None)
    yield
    sh.set_mesh(None)


def _slot_mesh(data, model):
    return ElasticMesh(model_parallel=model).remesh(["cpu"] * (data * model))


# ----------------------------------------------------------------------
# Mesh shapes
# ----------------------------------------------------------------------


def _plan_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("prefer_pods", [None, 2])
@pytest.mark.parametrize("model_parallel", [0, 1, 2, 4])
def test_plan_mesh_shape_is_the_reference(model_parallel, prefer_pods):
    for n in range(1, 9):
        assert (_plan_or_error(plan_mesh_shape, n, model_parallel, prefer_pods)
                == _plan_or_error(JF.plan_mesh_shape, n, model_parallel, prefer_pods))


def _same_mesh(got, want):
    assert isinstance(got, SlotMesh)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert [s.id for s in got.devices.flat] == [d.id for d in want.devices.flat]
    assert list(got) == list(got.devices.flat)  # the tuple is the slots, row-major


@pytest.mark.parametrize("prefer_pods", [None, 2])
@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_elastic_mesh_shapes_and_axes_are_the_reference(model_parallel, prefer_pods):
    devices = jax.devices()
    for n in range(model_parallel, 9):
        mine = ElasticMesh(model_parallel, prefer_pods)
        ref = JF.ElasticMesh(model_parallel, prefer_pods)
        _same_mesh(mine.remesh(["cpu"] * n), ref.remesh(devices[:n]))
        assert mine.epoch == ref.epoch == 1
        # one slot lost: the data axis shrinks (or the mesh cannot be built)
        mine.exclude_device(n - 1)
        ref.exclude_device(devices[n - 1].id)
        if n - 1 >= model_parallel:
            _same_mesh(mine.remesh(), ref.remesh())
            assert mine.epoch == ref.epoch == 2
        elif n > 1:
            for em in (mine, ref):
                with pytest.raises(ValueError, match="cannot hold one model-parallel group"):
                    em.remesh()
        # every slot of process 0 excluded: no mesh
        for em in (mine, ref):
            em.exclude_host(0)
            with pytest.raises(NoDevicesError if em is mine else JF.NoDevicesError,
                               match="no mesh can be built"):
                em.remesh()


def test_exclude_host_drops_one_process_and_the_search_mesh_stays_a_tuple():
    pool = [ShardSlot(i, torch.device("cpu"), process_index=i // 2) for i in range(8)]
    em = ElasticMesh(model_parallel=2)
    assert em.remesh(pool).shape == {"data": 4, "model": 2}
    em.exclude_host(1)
    mesh = em.remesh()
    assert [s.id for s in mesh] == [0, 1, 4, 5, 6, 7] and mesh.shape == {"data": 3, "model": 2}
    # the search path's ElasticMesh(): every live slot, one shard each
    flat = ElasticMesh().remesh(["cpu"] * 3)
    assert flat == tuple(ShardSlot(i, torch.device("cpu")) for i in range(3))
    assert flat.shape == {"data": 3, "model": 1} and sh.device_count(flat) == 3
    assert sh.shard_rows(7, flat) == sh.shard_rows(7, tuple(flat)) == 2
    assert sh.shard_rows(7, _slot_mesh(2, 4)) == 1  # the data axes only, as the reference
    assert flat != SlotMesh(list(flat), (1, 3), ("data", "model"))
    with pytest.raises(ValueError, match="last axis"):
        SlotMesh(list(flat), (3, 1), ("model", "data"))


@pytest.mark.parametrize("dims,axes,batch", [
    ((2, 4), ("data", "model"), 4),
    ((2, 4), ("data", "model"), 1),
    ((4, 2), ("data", "model"), 8),
    ((1, 4), ("data", "model"), 4),
    ((1, 4), ("data", "model"), 1),
    ((2, 2, 2), ("pod", "data", "model"), 4),
    ((2, 2, 2), ("pod", "data", "model"), 1),
])
def test_decode_shards_are_the_reference_flash_decode_layout(dims, axes, batch):
    # The cache's spec inside the reference's _flash_decode
    # (src/repro/models/layers.py:345-352): batch over the data axes and
    # sequence over model when the data axes divide the batch, else
    # (batch 1) the sequence over every axis; jax maps it to devices.
    jmesh = jax.make_mesh(dims, axes)
    dp = tuple(a for a in axes if a != "model")
    dp_spec = dp if len(dp) > 1 else dp[0]
    if batch % int(np.prod([jmesh.shape[a] for a in dp])) == 0:
        b_spec, seq_spec = dp_spec, "model"
    else:
        b_spec, seq_spec = None, axes
    shape = (batch, S, HKV, D)
    index = NamedSharding(jmesh, JP(b_spec, seq_spec, None, None)).devices_indices_map(shape)
    mesh = SlotMesh([ShardSlot(i, torch.device("cpu")) for i in range(int(np.prod(dims)))],
                    dims, axes)
    cache = L.KVCache(torch.zeros(shape), torch.zeros(shape))
    sh.set_mesh(mesh)
    try:
        assert L._flash_decode_applicable(cache, batch)
    finally:
        sh.set_mesh(None)
    got = L.decode_shards(mesh, batch, S)
    assert [p.slot for p in got] == list(mesh)
    for placed, dev in zip(got, jmesh.devices.flat, strict=True):
        rows, pos = index[dev][0].indices(batch), index[dev][1].indices(S)
        assert (placed.row0, placed.row1, placed.pos0, placed.pos1) == (
            rows[0], rows[1], pos[0], pos[1])


# ----------------------------------------------------------------------
# The mesh decode against the JAX _flash_decode
# ----------------------------------------------------------------------


def _decode_inputs(batch, length, quantized, seed):
    """q, k_new, v_new and a cache of S positions whose first ``length``
    hold keys and values (int8 codes and scales from the reference's
    quantizer when ``quantized``), as numpy."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((batch, 1, h, D)).astype(np.float32)
                 for h in (HQ, HKV, HKV))
    k, v = (np.zeros((batch, S, HKV, D), np.float32) for _ in range(2))
    k[:, :length], v[:, :length] = (rng.standard_normal((batch, length, HKV, D))
                                    for _ in range(2))
    if not quantized:
        return q, kn, vn, {"k": k, "v": v}
    (kq, ks), (vq, vs) = JL._quantize(jnp.asarray(k)), JL._quantize(jnp.asarray(v))
    ones = np.ones((batch, S, HKV), np.float32)
    ks, vs = np.where(np.arange(S)[None, :, None] < length, ks, ones), \
        np.where(np.arange(S)[None, :, None] < length, vs, ones)
    return q, kn, vn, {"k": np.asarray(kq), "v": np.asarray(vq), "k_scale": ks, "v_scale": vs}


def _jax_flash_decode(monkeypatch, dims, q, kn, vn, cache, length, window, jit=True):
    jmesh = jax.make_mesh(dims, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", jmesh)
    jcache = JL.KVCache(jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
                        None if "k_scale" not in cache else jnp.asarray(cache["k_scale"]),
                        None if "v_scale" not in cache else jnp.asarray(cache["v_scale"]),
                        jnp.asarray(length, jnp.int32))
    assert JL._flash_decode_applicable(jcache, q.shape[0])
    fn = lambda *a: JL._flash_decode(*a, window)  # noqa: E731
    out, new = (jax.jit(fn) if jit else fn)(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                           jcache)
    monkeypatch.setattr(JS, "_ACTIVE_MESH", None)
    fields = {"k": new.k, "v": new.v, "k_scale": new.k_scale, "v_scale": new.v_scale}
    return np.asarray(out), {n: np.asarray(a) for n, a in fields.items() if n in cache}


def _port_flash_decode(dims, q, kn, vn, cache, length, window):
    tcache = L.KVCache(**{n: torch.from_numpy(a.copy()) for n, a in cache.items()},
                       length=length)
    sh.set_mesh(_slot_mesh(*dims))
    assert L._flash_decode_applicable(tcache, q.shape[0])
    out = L._flash_decode(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                          tcache, window)
    sh.set_mesh(None)
    assert tcache.length == length + 1
    fields = {"k": tcache.k, "v": tcache.v, "k_scale": tcache.k_scale, "v_scale": tcache.v_scale}
    return out.numpy(), {n: t.numpy() for n, t in fields.items() if n in cache}


DECODE_MESHES = {"2x4": ((2, 4), B), "1x4": ((1, 4), B), "2x4_batch1": ((2, 4), 1)}


@pytest.mark.parametrize("length", [9, 8], ids=["inside_a_shard", "on_a_boundary"])
@pytest.mark.parametrize("window", [None, 6], ids=["global", "window6"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mesh", sorted(DECODE_MESHES))
def test_flash_decode_matches_the_reference(monkeypatch, mesh, quantized, window, length):
    dims, batch = DECODE_MESHES[mesh]
    q, kn, vn, cache = _decode_inputs(batch, length, quantized, seed=length)
    want, want_cache = _jax_flash_decode(monkeypatch, dims, q, kn, vn, cache, length, window)
    got, got_cache = _port_flash_decode(dims, q, kn, vn, cache, length, window)
    assert got.shape == want.shape == (batch, 1, HQ, D)
    assert np.abs(got - want).max() <= DECODE_RTOL * np.abs(want).max()
    for name in want_cache:  # the written cache, bit for bit (jit: scales to 1 ulp)
        if name.endswith("scale"):
            np.testing.assert_array_max_ulp(got_cache[name], want_cache[name], maxulp=1)
        else:
            np.testing.assert_array_equal(got_cache[name], want_cache[name], err_msg=name)


@pytest.mark.parametrize("mesh,length", [("2x4", 9), ("1x4", 8), ("2x4_batch1", 8)])
def test_flash_decode_writes_the_reference_int8_cache_bit_for_bit(monkeypatch, mesh, length):
    dims, batch = DECODE_MESHES[mesh]
    q, kn, vn, cache = _decode_inputs(batch, length, True, seed=length)
    want, want_cache = _jax_flash_decode(monkeypatch, dims, q, kn, vn, cache, length, 6,
                                         jit=False)
    got, got_cache = _port_flash_decode(dims, q, kn, vn, cache, length, 6)
    assert np.abs(got - want).max() <= DECODE_RTOL * np.abs(want).max()
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got_cache[name], want_cache[name], err_msg=name)


def test_decode_shards_split_as_the_reference_axis_index():
    mesh = _slot_mesh(2, 4)
    shards = L.decode_shards(mesh, 4, 16)
    assert [(s.row0, s.row1, s.pos0, s.pos1) for s in shards[:5]] == [
        (0, 2, 0, 4), (0, 2, 4, 8), (0, 2, 8, 12), (0, 2, 12, 16), (2, 4, 0, 4)]
    single = L.decode_shards(mesh, 1, 16)  # batch 1: positions over every axis, row-major
    assert [(s.pos0, s.pos1) for s in single] == [(2 * i, 2 * i + 2) for i in range(8)]
    assert [s.slot.id for s in single] == list(range(8))
    assert not L._flash_decode_applicable(L.KVCache(torch.zeros(3, 16, 2, 4),
                                                    torch.zeros(3, 16, 2, 4)), 3)


def test_flash_decode_refuses_slots_on_another_device_than_the_cache():
    mesh = SlotMesh([ShardSlot(i, torch.device("meta")) for i in range(4)], (1, 4),
                    ("data", "model"))
    cache = L.KVCache(torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4), length=3)
    sh.set_mesh(mesh)
    with pytest.raises(ValueError, match="keeps the cache on one device"):
        L._flash_decode(torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, 4),
                        torch.zeros(1, 1, 1, 4), cache, None)


# ----------------------------------------------------------------------
# The mesh decode against the port's single-device decode, whole models
# ----------------------------------------------------------------------


def _run(model, tokens, prompt, mesh=None):
    """Prefill ``tokens[:, :prompt]`` then teacher-forced decode steps
    under ``mesh``: the logits of every call and the cache."""
    sh.set_mesh(mesh)
    cache = T.init_cache(model.cfg, tokens.shape[0], tokens.shape[1], "cpu")
    out = [T.prefill(model, tokens[:, :prompt], cache)[0]]
    for s in range(prompt, tokens.shape[1]):
        out.append(T.decode_step(model, tokens[:, s:s + 1], cache)[0])
    sh.set_mesh(None)
    return torch.stack(out), cache


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_class", "int8"])
@pytest.mark.parametrize("arch,dims", [("qwen1.5-32b", (1, 4)), ("gemma3-4b", (2, 4))])
def test_mesh_decode_equals_the_single_device_decode(arch, dims, kv_quant):
    cfg = dataclasses.replace(get_arch(arch).smoke_cfg, kv_quant=kv_quant)
    model = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (4, 24)).astype(np.int32))
    calls = []
    real = L._flash_decode
    try:  # count the mesh decode's calls: every layer of every step
        L._flash_decode = lambda *a: calls.append(1) or real(*a)
        got, got_cache = _run(model, tokens, 12, _slot_mesh(*dims))
    finally:
        L._flash_decode = real
    want, want_cache = _run(model, tokens, 12)
    assert len(calls) == cfg.n_layers * 12
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(got_cache, name), getattr(want_cache, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5,
                                       atol=1e-5 if name != "k" or not kv_quant else 1,
                                       err_msg=name)


# ----------------------------------------------------------------------
# qwen1.5-32b
# ----------------------------------------------------------------------


def test_qwen1_5_32b_configs_are_the_reference_configs():
    for jcfg, pcfg in ((jax_qwen32.CFG, qwen1_5_32b.CFG), (jax_qwen32.SMOKE, qwen1_5_32b.SMOKE)):
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.n_params() == jcfg.n_params()
    spec, jspec = get_arch("qwen1.5-32b"), jax_qwen32.spec()
    assert spec.cfg == qwen1_5_32b.CFG and spec.fsdp == jspec.fsdp
    assert {n: dataclasses.asdict(c) for n, c in spec.cells.items()} == {
        n: dataclasses.asdict(c) for n, c in jspec.cells.items()}
    cfg = qwen1_5_32b.CFG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (64, 5120, 40, 40, 128, 27392, 152064)
    assert round(cfg.n_params() / 1e9, 1) == 35.2 and cfg.adtype == torch.bfloat16


def test_qwen1_5_32b_mesh_decode_matches_the_jax_single_device_decode():
    jcfg, pcfg = jax_qwen32.SMOKE, qwen1_5_32b.SMOKE
    params = JT.init(jcfg, jax.random.key(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), pcfg, "cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    jcache = JT.init_cache(jcfg, 4, 16)
    want, jcache = JT.prefill(params, jcfg, jnp.asarray(tokens[:, :12]), jcache)
    wants = [np.asarray(want)]
    for s in range(12, 16):
        want, jcache = JT.decode_step(params, jcfg, jnp.asarray(tokens[:, s:s + 1]), jcache)
        wants.append(np.asarray(want))
    got, cache = _run(model, torch.from_numpy(tokens), 12, _slot_mesh(1, 4))
    np.testing.assert_allclose(got.numpy(), np.stack(wants), **TOL)
    assert cache.length == int(jcache.length) == 16
    np.testing.assert_allclose(cache.k.float().numpy(), np.asarray(jcache.k, np.float32), **TOL)


def test_launcher_serves_under_a_mesh_on_the_cpu():
    report = serve.main(["--arch", "qwen1.5-32b", "--cell", "decode_32k", "--mesh", "1x4",
                         "--device", "cpu", "--requests", "4", "--decode-steps", "4"])
    assert report["mesh"] == {"data": 1, "model": 4} and report["tokens"].shape == (4, 4)
    # 4 x 12 + 4 positions: the mesh decode's shards, 4 positions a model slot
    assert report["decode_shards"] == [(i, (0, 4), (4 * i, 4 * i + 4)) for i in range(4)]
    plain = serve.main(["--arch", "qwen1.5-32b", "--cell", "decode_32k", "--device", "cpu",
                        "--requests", "4", "--decode-steps", "4"])
    np.testing.assert_array_equal(report["tokens"], plain["tokens"])
    assert sh.get_active_mesh() is None  # the launcher restores the ambient mesh
    with pytest.raises(ValueError, match="DATAxMODEL"):
        serve.main(["--arch", "qwen1.5-32b", "--mesh", "4", "--device", "cpu"])
    with pytest.raises(ValueError, match="recsys arch"):
        serve.main(["--arch", "dien", "--mesh", "1x4", "--device", "cpu"])
