"""PNA's aggregation on the port (``repro_torch.kernels.segment_aggregate``)
against the JAX package's ``_aggregate`` (``src/repro/models/pna.py:73``)
on the CPU: the plain version's forward, and its ``torch.autograd``
gradients against ``jax.vjp`` of the reference, on the graphs of
``_torch_parity.AGGREGATE_CASES`` (duplicate edges, so positive maxima and
minima tie; zero-degree nodes; masked edges; single-edge nodes, whose
variance is exactly 0; d = 75 and d = 16), on hand-built ties and on
graphs whose every node has degree 0.  Max, min and deg are equal bit for
bit (the same IEEE operations form each message); mean and std within
1e-5 and the gradients of both packages within the derived limit of
``_torch_parity.aggregate_reference`` (float32 sums in any order) of the
float64 reference.  Also: the destination sort, the wrapper's CPU route,
the float64 reference against autograd of the plain version in float64,
and the limits that ``chip_smoke.py`` and the card tests hold the kernels
to (float32 sums in two orders, and the kernels' float64 sums, stay
within theirs; faulty controls land beyond).  The kernels themselves run
only on the card (``tests/test_torch_cuda_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (AGGREGATE_CASES, aggregate_grads, aggregate_in_kernel_form,
                           aggregate_inputs, aggregate_reference, d_hs_limit,
                           dropped_edges_shares, share_of_limit)

from repro.models.pna import _aggregate
from repro_torch.kernels.segment_aggregate import kernel as K
from repro_torch.kernels.segment_aggregate.ops import edge_csr, segment_aggregate
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref

RTOL = ATOL = 1e-5


def _jax_aggregate(hs, hd, src, dst, w, n):
    return _aggregate(jax.nn.relu(hs[src] + hd[dst]), dst, n, w)


def _port(hs, hd, src, dst, w, n, grads=None):
    hs_t = torch.from_numpy(hs).requires_grad_(True)
    hd_t = torch.from_numpy(hd).requires_grad_(True)
    outs = segment_aggregate_ref(hs_t, hd_t, torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(w), n)
    if grads is not None:
        torch.autograd.backward(outs[:4], [torch.from_numpy(g) for g in grads])
    return outs, hs_t.grad, hd_t.grad


@pytest.mark.parametrize("case", AGGREGATE_CASES, ids=lambda c: f"seed{c[0]}_d{c[3]}")
def test_forward_equals_the_reference(case):
    seed, n, e, d, _ = case
    hs, hd, src, dst, w = aggregate_inputs(seed, n, e, d)
    want = _jax_aggregate(*map(jnp.asarray, (hs, hd, src, dst, w)), n)
    got, _, _ = _port(hs, hd, src, dst, w, n)
    names = ("mean", "max", "min", "std", "deg")
    for name, g, x in zip(names, got, want, strict=True):
        g, x = g.detach().numpy(), np.asarray(x)
        if name in ("max", "min", "deg"):
            np.testing.assert_array_equal(g, x, err_msg=name)
        else:
            np.testing.assert_allclose(g, x, rtol=RTOL, atol=ATOL, err_msg=name)
    deg = got[4].numpy()
    assert (deg == 0).any() and (deg == 1).any() and deg.max() >= min(20, e // 3)


@pytest.mark.parametrize("case", AGGREGATE_CASES, ids=lambda c: f"seed{c[0]}_d{c[3]}")
def test_gradients_equal_jax_vjp(case):
    seed, n, e, d, _ = case
    hs, hd, src, dst, w = aggregate_inputs(seed, n, e, d)
    grads = aggregate_grads(seed, n, d)
    _, vjp = jax.vjp(lambda a, b: _jax_aggregate(a, b, jnp.asarray(src), jnp.asarray(dst),
                                                 jnp.asarray(w), n)[:4],
                     jnp.asarray(hs), jnp.asarray(hd))
    want_hs, want_hd = vjp(tuple(jnp.asarray(g) for g in grads))
    outs, got_hs, got_hd = _port(hs, hd, src, dst, w, n, grads)
    # Where Σv²/denom − mean² is within rounding of 0 (a node whose messages
    # are all equal), the two packages may take different branches of the
    # maximum's gradient, and (v − mean), a rounding of mean, is divided by
    # std ≈ sqrt(1e-5) (1.2e-4 apart at one element of 22,500): so each is
    # held to the float64 reference within the derived limit of float32
    # sums, which covers that and the sum orders.
    t = [torch.from_numpy(x) for x in (hs, hd, src, dst, w)]
    ref = aggregate_reference(*t, n, [torch.from_numpy(g) for g in grads], mode="float32")
    lim_hs = d_hs_limit(ref["d_src"], ref["t_src"], ref["n_out"])
    for side, d_hs, d_hd in (("port", got_hs, got_hd),
                             ("jax", torch.from_numpy(np.array(want_hs)),
                              torch.from_numpy(np.array(want_hd)))):
        assert share_of_limit(d_hs, ref["d_hs"], lim_hs) <= 1.0, side
        assert share_of_limit(d_hd, ref["d_hd"], ref["limits"]["d_hd"]) <= 1.0, side
    # The case has tied positive maxima for the average to act on.
    assert ((ref["n_max"] > 1) & (ref["mx"] > 0)).any()


def test_hand_built_ties_zero_degree_and_relu_at_zero():
    # node 0: three edges, two tied at the max (2.0) and two at the min (0.5);
    # node 1: one masked edge only (deg 0); node 2: one edge whose pre is 0;
    # node 3: no edge.
    hs = np.array([[2.0], [0.5], [0.5], [-1.0]], np.float32)
    hd = np.array([[0.0], [0.0], [1.0], [0.0]], np.float32)
    src = np.array([0, 1, 0, 1, 2, 3], np.int32)
    dst = np.array([0, 0, 0, 0, 1, 2], np.int32)
    w = np.array([1, 1, 1, 1, 0, 1], np.float32)
    n = 4
    grads = [np.full((n, 1), g, np.float32) for g in (0.0, 6.0, 10.0, 0.0)]
    outs, got_hs, got_hd = _port(hs, hd, src, dst, w, n, grads)
    np.testing.assert_array_equal(outs[1].detach().numpy()[:, 0], [2.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(outs[2].detach().numpy()[:, 0], [0.5, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(outs[4].numpy(), [4.0, 0.0, 1.0, 0.0])
    # The max's 6 splits 3 + 3 over hs[0]'s two edges; the min's 10 splits 5 + 5
    # over hs[1]'s; the relu at pre == 0 (node 2) passes nothing.
    np.testing.assert_array_equal(got_hs.numpy()[:, 0], [6.0, 10.0, 0.0, 0.0])
    np.testing.assert_array_equal(got_hd.numpy()[:, 0], [16.0, 0.0, 0.0, 0.0])
    _, vjp = jax.vjp(lambda a, b: _jax_aggregate(a, b, jnp.asarray(src), jnp.asarray(dst),
                                                 jnp.asarray(w), n)[:4],
                     jnp.asarray(hs), jnp.asarray(hd))
    want_hs, want_hd = vjp(tuple(jnp.asarray(g) for g in grads))
    np.testing.assert_array_equal(got_hs.numpy(), np.asarray(want_hs))
    np.testing.assert_array_equal(got_hd.numpy(), np.asarray(want_hd))


@pytest.mark.parametrize("edges", [0, 50], ids=["no_edges", "all_masked"])
def test_every_node_with_degree_zero(edges):
    n, d = 20, 16
    hs, hd, src, dst, w = aggregate_inputs(5, n, max(edges, 1), d)
    src, dst, w = src[:edges], dst[:edges], np.zeros(edges, np.float32)
    grads = aggregate_grads(5, n, d)
    want = _jax_aggregate(*map(jnp.asarray, (hs, hd, src, dst, w)), n)
    got, got_hs, got_hd = _port(hs, hd, src, dst, w, n, grads)
    for g, x in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(x))
    np.testing.assert_array_equal(got[3].detach().numpy(), np.float32(np.sqrt(np.float32(1e-5))))
    assert not got_hs.any() and not got_hd.any()


def test_edge_csr_sorts_stably_and_builds_indptr():
    _, _, src, dst, w = aggregate_inputs(1, 300, 2500, 8)
    csr = edge_csr(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), 300)
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(csr.src.numpy(), src[order])
    np.testing.assert_array_equal(csr.dst.numpy(), dst[order])
    np.testing.assert_array_equal(csr.w.numpy(), w[order])
    want = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=300))])
    np.testing.assert_array_equal(csr.indptr.numpy(), want)
    assert csr.indptr.dtype == torch.int32 and csr.n_nodes == 300


def test_wrapper_on_cpu_is_the_plain_version_and_launchers_refuse_cpu_tensors():
    hs, hd, src, dst, w = aggregate_inputs(0, 60, 400, 16)
    csr = edge_csr(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), 60)
    hs_t, hd_t = torch.from_numpy(hs), torch.from_numpy(hd)
    got = segment_aggregate(hs_t, hd_t, csr)
    want = segment_aggregate_ref(hs_t, hd_t, csr.src, csr.dst, csr.w, 60)
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g, x)
    with pytest.raises(ValueError, match="CUDA"):
        K.segment_aggregate_fwd_cuda(hs_t, hd_t, csr)
    with pytest.raises(ValueError, match="run_edges"):
        K._check("x", hs_t, hd_t, csr, 16)
    assert K.n_runs(0) == 0 and K.n_runs(1024) == 1 and K.n_runs(1025, 1024) == 2


def _off_grid_case():
    """AGGREGATE_CASES' seed 3 scaled off the quarter grid, so that the
    sums round; the edges sorted by destination."""
    hs, hd, src, dst, w = aggregate_inputs(3, 500, 6000, 16)
    scale = np.random.default_rng(9).random(hs.shape, np.float32) + 0.5
    csr = edge_csr(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), 500)
    grads = [torch.from_numpy(g) for g in aggregate_grads(3, 500, 16)]
    return torch.from_numpy(hs * scale), torch.from_numpy(hd * scale), csr, grads


def _through(agg, hs, hd, csr, grads):
    a, b = hs.clone().requires_grad_(True), hd.clone().requires_grad_(True)
    outs = agg(a, b, csr)
    torch.autograd.backward(outs[:4], grads)
    return [o.detach() for o in outs], a.grad, b.grad


def _shares(ref, outs, d_hs, d_hd):
    lim = ref["limits"]
    return {"mean": share_of_limit(outs[0], ref["mean"], lim["mean"]),
            "std": share_of_limit(outs[3], ref["std"], lim["std"]),
            "d_hs": share_of_limit(d_hs, ref["d_hs"],
                                   d_hs_limit(ref["d_src"], ref["t_src"], ref["n_out"])),
            "d_hd": share_of_limit(d_hd, ref["d_hd"], lim["d_hd"])}


@pytest.mark.parametrize("case", AGGREGATE_CASES, ids=lambda c: f"seed{c[0]}_d{c[3]}")
@pytest.mark.parametrize("chunk", [None, 37], ids=["whole", "chunked"])
def test_float64_reference_equals_plain_autograd_in_float64(case, chunk):
    """On the quarter grid every message's add is exact, so the plain
    version in float64 forms the same messages: its outputs and autograd's
    gradients equal the reference's (explicit, in chunks of edges) to
    float64's rounding."""
    seed, n, e, d, _ = case
    hs, hd, src, dst, w = (torch.from_numpy(x) for x in aggregate_inputs(seed, n, e, d))
    grads = [torch.from_numpy(g) for g in aggregate_grads(seed, n, d)]
    ref = aggregate_reference(hs, hd, src, dst, w, n, grads, chunk=chunk)
    a, b = hs.double().requires_grad_(True), hd.double().requires_grad_(True)
    outs = segment_aggregate_ref(a, b, src, dst, w, n)
    torch.autograd.backward(outs[:4], [g.double() for g in grads])
    # float64 rounding, and the plain version's eps in float64 against the
    # reference's float32 1e-5 (4e-11 apart at std ≈ sqrt(1e-5)).
    tol = dict(rtol=1e-9, atol=1e-9)
    for name, got, want in (("mean", outs[0], ref["mean"]), ("std", outs[3], ref["std"]),
                            ("d_hs", a.grad, ref["d_hs"]), ("d_hd", b.grad, ref["d_hd"])):
        torch.testing.assert_close(got.detach(), want, **tol, msg=name)
    for got, key in ((outs[1], "mx"), (outs[2], "mn"), (outs[4], "deg")):
        assert torch.equal(got.detach().float(), ref[key]), key


def test_derived_limit_holds_across_orders_and_catches_faulty_controls():
    hs, hd, csr, grads = _off_grid_case()
    args = (hs, hd, csr.src, csr.dst, csr.w, 500, grads)
    ref32, ref64 = aggregate_reference(*args, mode="float32"), aggregate_reference(*args)
    # float32 sums in either order within float32's limit; the kernels'
    # float64 sums within theirs; the same tie sets everywhere.
    for order, ref in (("sorted", ref32), ("reversed", ref32), ("float64", ref64)):
        outs, d_hs, d_hd = _through(aggregate_in_kernel_form(order), hs, hd, csr, grads)
        assert max(_shares(ref, outs, d_hs, d_hd).values()) <= 1.0, order
        assert torch.equal(outs[1], ref["mx"]) and torch.equal(outs[2], ref["mn"])
    outs, d_hs, d_hd = _through(lambda a, b, c: segment_aggregate_ref(a, b, c.src, c.dst, c.w,
                                                                      500), hs, hd, csr, grads)
    assert max(_shares(ref32, outs, d_hs, d_hd).values()) <= 1.0
    # Controls, beyond both limits: ties given the whole gradient; one
    # stretch of node 0's edges dropped from its sums.
    for ref in (ref32, ref64):
        lim = ref["limits"]
        assert share_of_limit(d_hs, ref["ctrl_hs"],
                              d_hs_limit(ref["d_src"], ref["t_src"], ref["n_out"])) > 1.0
        assert share_of_limit(d_hd, ref["ctrl_hd"], lim["d_hd"]) > 1.0
        e0 = int(csr.indptr[0])
        shares = dropped_edges_shares(hs, hd, csr.src, csr.dst, csr.w, ref, 0, e0, e0 + 8,
                                      outs[0][0], d_hd[0])
        assert min(shares) > 1.0, shares
    # The float32 sums lie beyond the kernels' tighter limit (it is not loose).
    assert max(_shares(ref64, outs, d_hs, d_hd).values()) > 1.0


@pytest.mark.parametrize("order", ["sorted", "reversed", "float64"])
def test_kernel_form_of_the_backward_stays_within_the_limit(order):
    """The kernels' form of the backward (one product for the std's term),
    in plain PyTorch, against the float64 reference: within the derived
    limit of its sums (float32 in either order, or the kernels' float64),
    as the plain version's autograd is."""
    hs, hd, src, dst, w = aggregate_inputs(1, 300, 2500, 75)
    grads = [torch.from_numpy(g) for g in aggregate_grads(1, 300, 75)]
    csr = edge_csr(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), 300)
    t = (torch.from_numpy(hs), torch.from_numpy(hd))
    ref = aggregate_reference(*t, csr.src, csr.dst, csr.w, 300, grads,
                              mode="kernel" if order == "float64" else "float32")
    outs, d_hs, d_hd = _through(aggregate_in_kernel_form(order), *t, csr, grads)
    assert max(_shares(ref, outs, d_hs, d_hd).values()) <= 1.0
    assert torch.equal(outs[1], ref["mx"]) and torch.equal(outs[4], ref["deg"])
    if order != "float64":
        plain = _through(lambda a, b, c: segment_aggregate_ref(a, b, c.src, c.dst, c.w, 300),
                         *t, csr, grads)
        assert max(_shares(ref, *plain).values()) <= 1.0
