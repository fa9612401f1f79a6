"""``repro_torch.dist.compression`` against ``repro.dist.compression``.

* The local round trip (``compress_decompress``) bit for bit against the
  reference's, over magnitudes from 1e-4 to 1e3, with error state.
* ``compressed_psum_tree`` over a data axis of 4 slots (one gradient tree
  a slot) against the reference's inside ``shard_map`` over 4 CPU
  devices.  Under ``jax.jit`` XLA computes the scale ``amax / 127`` as a
  multiply by the reciprocal and the error ``v - q·scale`` as one fused
  multiply-add; op by op, as the reference writes it and the port
  computes it, they are a division and two roundings.  So both are held
  bit for bit to a numpy emulation of the same arithmetic (``_emulated``:
  the ``shard_map`` result to XLA's, the port to the reference's op by
  op), and to each other within one ulp of the scale.
* The three invariant tests of ``tests/test_substrate.py`` on the port,
  and the bound the card check holds (``|compressed - plain sum| <=
  n_slots · scale / 2``, ``deq + err == v`` exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.dist import compression as JC
from repro_torch.dist import compression as C

N_SLOTS = 4


def _tree(rng, lead=()):
    mag = 10.0 ** rng.uniform(-4, 3)
    return {"a": (rng.standard_normal(lead + (37,)) * mag).astype(np.float32),
            "b": {"c": rng.standard_normal(lead + (5, 3)).astype(np.float32),
                  "d": np.zeros(lead + (4,), np.float32)}}


@pytest.mark.parametrize("seed", range(6))
def test_local_round_trip_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        x = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-4, 3)).astype(np.float32)
        e = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-6, -2)).astype(np.float32)
        want_deq, want_err = JC.compress_decompress(jnp.asarray(x), jnp.asarray(e))
        deq, err = C.compress_decompress(torch.from_numpy(x), torch.from_numpy(e))
        np.testing.assert_array_equal(deq.numpy(), np.asarray(want_deq))
        np.testing.assert_array_equal(err.numpy(), np.asarray(want_err))
    # one slot: the reduction is the local round trip
    g = _tree(rng)
    want, want_err = JC.compressed_psum_tree(jax.tree.map(jnp.asarray, g),
                                             JC.init_error_state(g), axis_name=None)
    tg = jax.tree.map(torch.from_numpy, g)
    got, got_err = C.compressed_psum_tree([tg], [C.init_error_state(tg)])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(got_err[0]), jax.tree.leaves(want_err), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _slot(tree, s):
    return jax.tree.map(lambda v: torch.from_numpy(np.ascontiguousarray(v[s:s + 1])), tree)


def _emulated(v, xla: bool):
    """The reference's reduction of one leaf (``v``: the slots' ``g + e``
    stacked) in numpy: the scale ``amax / 127`` by a division (op by op)
    or, as XLA computes it under ``jax.jit``, by a multiply with the
    reciprocal; the error ``v - q·scale`` rounded after each op, or once
    (XLA's fused multiply-add).  Returns (the sum, each slot's error)."""
    amax = np.float32(np.abs(v).max())
    if amax > 0:
        scale = amax * np.float32(1 / np.float32(127)) if xla else amax / np.float32(127)
    else:
        scale = np.float32(1)
    q = np.clip(np.round(v / scale), -127, 127).astype(np.float32)
    total = q.astype(np.int32).sum(0).astype(np.float32) * scale
    if xla:
        err = (v.astype(np.float64) - q.astype(np.float64) * np.float64(scale)).astype(np.float32)
    else:
        err = v - q * scale
    return total, err


@pytest.mark.parametrize("seed", range(4))
def test_compressed_psum_over_4_slots_equals_shard_map(seed):
    rng = np.random.default_rng(100 + seed)
    g = _tree(rng, (N_SLOTS,))
    e = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32), g)
    mesh = jax.make_mesh((N_SLOTS,), ("data",), devices=jax.devices()[:N_SLOTS])
    fn = jax.jit(jax.shard_map(lambda gg, ee: JC.compressed_psum_tree(gg, ee, "data"),
                               mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"))))
    want, want_err = jax.tree.map(np.asarray, fn(g, e))
    got, got_err = C.compressed_psum_tree([_slot(g, s) for s in range(N_SLOTS)],
                                          [_slot(e, s) for s in range(N_SLOTS)])
    leaves = zip(jax.tree.leaves(g), jax.tree.leaves(e), jax.tree.leaves(want),
                 jax.tree.leaves(want_err), jax.tree.leaves(got), strict=True)
    for j, (gl, el, w, w_err, a) in enumerate(leaves):
        v = gl + el
        total, err = _emulated(v, xla=True)  # the shard_map's arithmetic, bit for bit
        np.testing.assert_array_equal(w_err, err)
        for s in range(N_SLOTS):  # every slot receives the same sum
            np.testing.assert_array_equal(w[s], total)
        total, err = _emulated(v, xla=False)  # the port: the reference's op by op
        np.testing.assert_array_equal(a.numpy()[0], total)
        for s in range(N_SLOTS):
            np.testing.assert_array_equal(jax.tree.leaves(got_err[s])[j].numpy()[0], err[s])
        # the two scales differ by at most one ulp
        np.testing.assert_allclose(a.numpy()[0], w[0], rtol=2.0**-22, atol=0)


def test_error_feedback_invariant():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    deq, err2 = C.compress_decompress(x, torch.zeros_like(x))
    np.testing.assert_allclose((deq + err2).numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


def test_error_feedback_accumulates_to_truth():
    rng = np.random.default_rng(1)
    err, sent, true = torch.zeros(50), torch.zeros(50), torch.zeros(50)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(50).astype(np.float32)) * 1e-3
        deq, err = C.compress_decompress(g, err)
        sent, true = sent + deq, true + g
    np.testing.assert_allclose(sent.numpy(), true.numpy(), atol=1e-4)


def test_compressed_psum_tree_no_axis():
    grads = {"a": torch.ones(8), "b": {"c": torch.full((3,), 2.0)}}
    out, err2 = C.compressed_psum_tree([grads], [C.init_error_state(grads)])
    np.testing.assert_allclose(out["a"].numpy(), 1.0, rtol=1e-2)
    assert set(err2[0]) == set(grads) and set(err2[0]["b"]) == {"c"}


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_the_bound_and_the_invariant(n_slots):
    rng = np.random.default_rng(n_slots)
    slots = [{"w": torch.from_numpy((rng.standard_normal((64, 33)) * 0.1).astype(np.float32))}
             for _ in range(n_slots)]
    errs = [C.init_error_state(t) for t in slots]
    total, new_err = C.compressed_psum_tree(slots, errs)
    plain = sum(t["w"] for t in slots)
    scale = max(float(t["w"].abs().max()) for t in slots) / 127.0
    assert float((total["w"] - plain).abs().max()) <= n_slots * scale / 2
    for t, e in zip(slots, new_err):
        assert float(e["w"].abs().max()) <= scale / 2 * (1 + 1e-6)
        deq, err = C.compress_decompress(t["w"], torch.zeros_like(t["w"]))
        assert torch.equal(deq + err, t["w"])  # exactly, in float32
