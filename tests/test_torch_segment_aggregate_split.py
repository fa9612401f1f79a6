"""The aggregation kernels' split by edges (``csrc/segment_aggregate.cu``),
emulated on the CPU: ``_torch_parity.aggregate_in_runs`` walks each run
of ``run_edges`` edges as a warp of either kernel design does (the ring
design and the register design sum each destination's edges in the same
order), finishes a destination inside its run, and merges the others from
head and tail records over 32 warps in a fixed order, all sums in float64.
Held to the float64 reference (``_torch_parity.AggregateCheck``, the
"kernel" limits): max, min, deg and the tie counts bit for bit, mean,
std, d hs and d hd within their limits, q's sign equal to the reference's
on the quarter grid (where the float64 sums are exact).  Cases: a node
spanning more records than the merge has warps, runs that start and end
at destination boundaries, nodes with no edges, a node and a graph whose
edges are all masked, ties.  The dropped-record controls: a merge that
leaves out a record lands beyond the limits, and exactly where
``dropped_edges_shares`` puts it for the edges ``record_edges`` names
(``chip_smoke.py`` plants its controls with them)."""

import numpy as np
import pytest
import torch
from _torch_parity import (MERGE_WARPS, AggregateCheck, aggregate_grads, aggregate_in_runs,
                           aggregate_inputs, aggregate_reference, dropped_edges_shares,
                           record_edges, share_of_limit)

from repro_torch.kernels.segment_aggregate.ref import edge_csr


def _graph(seed, degrees, d, masked=(), all_masked=False):
    """Features and weights as ``aggregate_inputs`` draws them (the quarter
    grid: ties), with node i receiving ``degrees[i]`` edges; the nodes in
    ``masked`` (or every node) have their edges masked."""
    n = len(degrees)
    e = int(sum(degrees))
    hs, hd, src, _, w = aggregate_inputs(seed, n, max(e, 1), d)
    rng = np.random.default_rng(seed + 50)
    dst = np.repeat(np.arange(n), degrees).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    src[e // 2:] = src[rng.integers(0, max(e // 2, 1), size=e - e // 2)]  # repeated pairs
    w = w[:e].copy()
    w[np.isin(dst, masked)] = 0.0
    if all_masked:
        w[:] = 0.0
    csr = edge_csr(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), n)
    return hs, hd, csr


RUN = 8
# (id, degrees, masked nodes, every edge masked): node 0 in the first case
# spans 50 records, past the merge's 32 warps; the second's degrees put
# destination boundaries on run boundaries (node 1 fills runs 3-5 exactly,
# node 3 one run) and beside them (one edge short and one past).
SPLIT_CASES = [
    ("past_32_records", [400, 3, 0, 17, 1, 0, 0, 9, 2, 30, 0, 1], (), False),
    ("on_run_boundaries", [24, 3 * RUN, 0, RUN, RUN - 1, 1, 2 * RUN + 1, 0, RUN, 5, 0, 0, 3],
     (5,), False),
    ("a_masked_node_across_runs", [5, 3 * RUN + 3, 2, 0, 11, 1], (1,), False),
    ("every_edge_masked", [3 * RUN, 5, 0, 2, RUN], (), True),
]


def _emulate(case, d=16, drop=None):
    _, degrees, masked, all_masked = case
    hs, hd, csr = _graph(len(degrees), degrees, d, masked, all_masked)
    grads = aggregate_grads(3, len(degrees), d)
    fwd, bwd = aggregate_in_runs(hs, hd, csr, grads, RUN, drop)
    return hs, hd, csr, grads, fwd, bwd


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("d", [16, 75])
def test_the_split_by_edges_holds_to_the_float64_reference(case, d):
    hs, hd, csr, grads, fwd, (d_hs, d_hd) = _emulate(case, d)
    t = torch.from_numpy
    check = AggregateCheck(t(hs), t(d_hs))
    ref = check.add(t(hd), csr.src, csr.dst, csr.w, [t(g) for g in grads],
                    tuple(t(x) for x in fwd[:7]), t(d_hd))
    assert check.within(), check.finish()["shares"]
    q = ref["q"].numpy()
    np.testing.assert_array_equal(fwd[7], np.where(q > 0, 2, np.where(q == 0, 1, 0)))
    deg = fwd[4]
    assert (deg == 0).any()
    if case[3]:
        assert not deg.any() and not d_hs.any() and not d_hd.any()
    if case[0] == "past_32_records":
        assert case[1][0] // RUN > MERGE_WARPS


@pytest.mark.parametrize("k", [1, MERGE_WARPS], ids=["dropped_run", "past_warp_32"])
def test_a_dropped_record_lands_beyond_the_limit_where_the_control_puts_it(k):
    case = SPLIT_CASES[0]
    hs, hd, csr, grads, fwd, (d_hs, d_hd) = _emulate(case, drop=(0, k))
    t = torch.from_numpy
    ref = aggregate_reference(t(hs), t(hd), csr.src, csr.dst, csr.w, csr.n_nodes,
                              [t(g) for g in grads])
    lim = ref["limits"]
    assert share_of_limit(t(fwd[0])[0], ref["mean"][0], lim["mean"][0]) > 1.0
    assert share_of_limit(t(d_hd)[0], ref["d_hd"][0], lim["d_hd"][0]) > 1.0
    e0, e1 = record_edges(csr.indptr.numpy(), 0, RUN, k)
    assert e1 - e0 == RUN
    mean_share, _ = dropped_edges_shares(t(hs), t(hd), csr.src, csr.dst, csr.w, ref, 0, e0, e1,
                                         t(fwd[0])[0], t(d_hd)[0])
    assert mean_share <= 1.0
    # The other nodes are untouched by the dropped record.
    _, _, _, _, whole, (_, d_hd_whole) = _emulate(case)
    for got, want in zip(fwd, whole, strict=True):
        np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(d_hd[1:], d_hd_whole[1:])


def test_record_edges_refuses_a_record_the_node_lacks():
    indptr = np.array([0, 20, 20, 23])
    assert record_edges(indptr, 0, RUN, 1) == (8, 16)
    assert record_edges(indptr, 0, RUN, 2) == (16, 20)
    with pytest.raises(ValueError, match="no record 3"):
        record_edges(indptr, 0, RUN, 3)
