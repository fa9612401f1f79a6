"""The port's device K-means against the JAX package's.

``repro_torch.core.torch_ops`` is held against ``repro.core.jax_ops`` and
``repro_torch.dist.cluster_dist`` against ``repro.dist.cluster_dist`` on
the CPU, with the same inputs made from the same seeds.  Counts are
integers and must be equal; ψ, the δ⁺ tables and the scores must lie
within the reference's own tolerances (``tests/test_jax_ops.py``).

Assignments are argmins of fp32 scores whose tables come from a cumsum
that XLA and torch sum in different orders, so two equal scores can round
apart.  Where a whole run diverges on such a near-tie, the test holds
each round to the per-round rule instead: the port's new assignment
equals the reference's except at documents whose reference scores for
the two clusters lie within the scores tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.cluster_dist as jax_dist
import repro_torch.data.corpus as tcorpus
from repro.core import jax_ops as J
from repro.core.objective import (
    assignment_scores,
    cluster_counts,
    delta_add_tables,
    frequent_term_view,
    psi_from_counts,
)
from repro.core.topdown import topdown_cluster as jax_topdown
from repro.data.corpus import CorpusSpec, synth_corpus
from repro.data.query_log import synth_query_log, term_probabilities
from repro_torch.core import torch_ops as T
from repro_torch.core.objective import frequent_term_view as torch_view
from repro_torch.core.topdown import topdown_cluster as torch_topdown
from repro_torch.data.query_log import synth_query_log as torch_log
from repro_torch.data.query_log import term_probabilities as torch_p
from repro_torch.dist import cluster_dist as torch_dist

SMALL_SPEC = dict(n_docs=1500, n_terms=3000, mean_doc_len=40, n_topics=8,
                  topicality=0.6, seed=7)
# The fixture of tests/test_cluster_dist.py.
DIST_SPEC = dict(n_docs=600, n_terms=800, mean_doc_len=25, n_topics=6, seed=0)
PSI_RTOL = 1e-4  # tests/test_jax_ops.py:55
TABLES_TOL = dict(rtol=2e-4, atol=1e-6)  # tests/test_jax_ops.py:67
SCORES_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_jax_ops.py:82


def _port_view(spec, n_queries, log_seed, tc):
    corpus = tcorpus.synth_corpus(tcorpus.CorpusSpec(**spec))
    log = torch_log(corpus, n_queries=n_queries, seed=log_seed)
    return torch_view(corpus, torch_p(corpus.n_terms, log=log), tc=tc)


@pytest.fixture(scope="module")
def port_small_view():
    return _port_view(SMALL_SPEC, 300, 11, 800)


@pytest.fixture(scope="module")
def packed(small_view, port_small_view):
    ids = np.arange(600)
    sub, port_sub = small_view.subset(ids), port_small_view.subset(ids)
    ell, _ = J.ell_pack(sub)
    return sub, port_sub, ell


@pytest.fixture(scope="module")
def dist_views():
    corpus = synth_corpus(CorpusSpec(**DIST_SPEC))
    log = synth_query_log(corpus, n_queries=300, seed=1)
    ref = frequent_term_view(corpus, term_probabilities(corpus.n_terms, log=log), tc=300)
    return ref, _port_view(DIST_SPEC, 300, 1, 300)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _near_tie_docs(ref_scores, ref_assign, port_assign):
    """Documents where the assignments differ; raises unless every one of
    them is a near-tie of the reference's scores for the two clusters."""
    diff = np.flatnonzero(ref_assign != port_assign)
    a = ref_scores[diff, ref_assign[diff]]
    b = ref_scores[diff, port_assign[diff]]
    tol = SCORES_TOL["atol"] + SCORES_TOL["rtol"] * np.abs(a)
    far = diff[np.abs(a - b) > tol]
    assert far.size == 0, f"assignments differ beyond a near-tie at docs {far[:10]}"
    return diff


def test_view_and_ell_equal_the_reference(small_view, port_small_view, packed):
    ref, port = small_view, port_small_view
    for field in ("edge_doc", "edge_rank", "p_freq", "rank_of_term", "term_of_rank"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field), err_msg=field)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port.mat, field), getattr(ref.mat, field))
    assert (port.n_docs, port.tc) == (ref.n_docs, ref.tc)
    sub, port_sub, ell = packed
    port_ell, l_pad = T.ell_pack(port_sub)
    np.testing.assert_array_equal(port_ell, ell)
    assert l_pad == ell.shape[1]
    port_cut, cut = T.ell_pack(port_sub, l_pad=7)[0], J.ell_pack(sub, l_pad=7)[0]
    np.testing.assert_array_equal(port_cut, cut)


@pytest.mark.parametrize("k", [1, 5, 13])
def test_counts_are_exact(packed, k):
    sub, _, ell = packed
    assign = (np.arange(sub.n_docs) * 7) % k
    got = T.counts_from_ell(_t(ell), _t(assign), k, sub.tc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), cluster_counts(sub, assign, k))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.counts_from_ell(jnp.asarray(ell), jnp.asarray(assign), k, sub.tc))
    )


def test_psi_and_tables_within_the_reference_tolerances(packed):
    sub, _, _ = packed
    k = 5
    counts = cluster_counts(sub, np.arange(sub.n_docs) % k, k)
    p32 = np.asarray(sub.p_freq, np.float32)
    psi = float(T.psi_torch(_t(counts.astype(np.int32)), _t(p32)))
    assert np.isclose(psi, psi_from_counts(counts, sub.p_freq), rtol=PSI_RTOL)
    assert np.isclose(psi, float(J.psi_jax(jnp.asarray(counts), jnp.asarray(p32))), rtol=PSI_RTOL)
    tables = T.delta_add_tables_torch(_t(counts.astype(np.int32)), _t(p32)).numpy()
    assert tables.shape == (k, sub.tc) and tables.dtype == np.float32
    np.testing.assert_allclose(tables, delta_add_tables(counts, sub.p_freq), **TABLES_TOL)
    np.testing.assert_allclose(
        tables, np.asarray(J.delta_add_tables_jax(jnp.asarray(counts), jnp.asarray(p32))),
        **TABLES_TOL,
    )


def test_scores_within_the_reference_tolerance(packed):
    sub, _, ell = packed
    k = 5
    tables = np.random.default_rng(0).random((k, sub.tc)).astype(np.float32)
    p32 = np.asarray(sub.p_freq, np.float32)
    got = T.scores_from_ell(_t(ell), _t(tables), _t(p32), block=128).numpy()
    np.testing.assert_allclose(got, assignment_scores(sub, tables), **SCORES_TOL)
    want = J.scores_from_ell(jnp.asarray(ell), jnp.asarray(tables), jnp.asarray(p32), block=128)
    np.testing.assert_allclose(got, np.asarray(want), **SCORES_TOL)


@pytest.mark.parametrize("k", [5, 8])
def test_kmeans_round_matches_the_reference_but_for_near_ties(packed, k):
    sub, _, ell = packed
    assign = np.random.default_rng(k).integers(0, k, sub.n_docs)
    p32 = np.asarray(sub.p_freq, np.float32)
    ref_assign, ref_psi = J.kmeans_round_jax(
        jnp.asarray(ell), jnp.asarray(assign), jnp.asarray(p32), k, sub.tc, block=128)
    got, psi = T.kmeans_round_torch(_t(ell), _t(assign), _t(p32), k, sub.tc, block=128)
    assert np.isclose(float(psi), float(ref_psi), rtol=PSI_RTOL)
    counts = J.counts_from_ell(jnp.asarray(ell), jnp.asarray(assign), k, sub.tc)
    ref_tables = J.delta_add_tables_jax(counts, jnp.asarray(p32))
    ref_scores = np.asarray(J.scores_from_ell(jnp.asarray(ell), ref_tables, jnp.asarray(p32),
                                              block=128))
    ties = _near_tie_docs(ref_scores, np.asarray(ref_assign), got.numpy())
    print(f"kmeans_round k={k}: {ties.size} near-tie documents differ")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_distributed_kmeans_equals_the_reference(dist_views, n_shards):
    ref_view, port_view = dist_views
    mesh = jax.make_mesh((n_shards, 8 // n_shards), ("data", "model"))
    ref_assign, ref_psi = jax_dist.distributed_kmeans(ref_view, k=6, mesh=mesh, max_iters=20)
    assign, psi = torch_dist.distributed_kmeans(
        port_view, k=6, devices=["cpu"] * n_shards, max_iters=20)
    np.testing.assert_array_equal(assign, ref_assign)
    assert assign.dtype == np.int64
    assert psi_from_counts(cluster_counts(ref_view, assign, 6), ref_view.p_freq) == \
        psi_from_counts(cluster_counts(ref_view, ref_assign, 6), ref_view.p_freq)
    assert np.isclose(psi, ref_psi, rtol=PSI_RTOL)
    rand = np.random.default_rng(0).integers(0, 6, ref_view.n_docs)
    assert psi_from_counts(cluster_counts(ref_view, assign, 6), ref_view.p_freq) < \
        psi_from_counts(cluster_counts(ref_view, rand, 6), ref_view.p_freq)


@pytest.mark.parametrize("n_shards", [3, 7])
def test_shard_count_and_row_padding_do_not_change_the_assignment(dist_views, n_shards):
    """From one initial assignment, the shard count (7 pads 600 rows to
    602) changes nothing.  Without ``init_assign`` the random start is
    drawn over the padded rows, as in the reference."""
    _, port_view = dist_views
    init = np.random.default_rng(3).integers(0, 6, port_view.n_docs)
    one, psi_one = torch_dist.distributed_kmeans(
        port_view, k=6, devices=["cpu"], init_assign=init, max_iters=20)
    many, psi_many = torch_dist.distributed_kmeans(
        port_view, k=6, devices=["cpu"] * n_shards, init_assign=init, max_iters=20)
    np.testing.assert_array_equal(many, one)
    assert psi_many == psi_one


def test_distributed_kmeans_fn_without_devices_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_dist.distributed_kmeans_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_dist.distributed_kmeans(None, k=2)
    with pytest.raises(ValueError, match="at least one device"):
        torch_dist.distributed_kmeans_fn([])


def _recorded_rounds(monkeypatch):
    """Wrap the reference's round so each call's inputs and outputs are
    kept as numpy arrays."""
    rounds = []
    make = jax_dist.make_round_fn

    def recording_make(mesh, k, tc, block=512):
        fn = make(mesh, k, tc, block=block)

        def round_fn(ell, assign, p):
            new_assign, psi = fn(ell, assign, p)
            rounds.append(dict(ell=np.array(ell), assign=np.array(assign), p=np.array(p),
                               k=k, tc=tc, new=np.array(new_assign), psi=float(psi)))
            return new_assign, psi

        return round_fn

    monkeypatch.setattr(jax_dist, "make_round_fn", recording_make)
    return rounds


def test_topdown_with_the_device_kmeans_fn(monkeypatch, small_view, port_small_view):
    """Both packages' TopDown with their device ``kmeans_fn``: the same
    k_actual and the same sequence of splits; every device round of the
    reference, replayed on the port, obeys the per-round rule.  The whole
    labelling differs: round 0 of the top split has a near-tie (recorded
    in ROADMAP.md, Queue 3)."""
    rounds = _recorded_rounds(monkeypatch)
    mesh = jax.make_mesh((1, 8), ("data", "model"))
    calls = {"ref": [], "port": []}

    def recorded(fn, key):
        def wrapped(view, k, **kw):
            calls[key].append((view.n_docs, k))
            return fn(view, k, **kw)
        return wrapped

    ref = jax_topdown(small_view, 8, doc_grained_below=256, kmeans_fn=recorded(
        jax_dist.distributed_kmeans_fn(mesh, doc_grained_below=256), "ref"))
    port = torch_topdown(port_small_view, 8, doc_grained_below=256, kmeans_fn=recorded(
        torch_dist.distributed_kmeans_fn(["cpu"], doc_grained_below=256), "port"))
    assert port.k_actual == ref.k_actual
    assert port.n_splits == ref.n_splits
    # The splits agree up to the first device call; after its near-tie
    # the subproblems differ by a few documents.
    first = next(i for i, (n, _) in enumerate(calls["ref"]) if n >= 256)
    assert calls["port"][: first + 1] == calls["ref"][: first + 1]
    assert port.assign.min() == 0 and port.assign.max() == port.k_actual - 1
    assert rounds, "the reference ran no device round"
    n_ties = 0
    for r in rounds:
        got, psi = T.kmeans_round_torch(_t(r["ell"]), _t(r["assign"]), _t(r["p"]),
                                        r["k"], r["tc"], block=512)
        assert np.isclose(float(psi), r["psi"], rtol=PSI_RTOL)
        counts = J.counts_from_ell(jnp.asarray(r["ell"]), jnp.asarray(r["assign"]),
                                   r["k"], r["tc"])
        tables = J.delta_add_tables_jax(counts, jnp.asarray(r["p"]))
        ref_scores = np.asarray(J.scores_from_ell(jnp.asarray(r["ell"]), tables,
                                                  jnp.asarray(r["p"]), block=512))
        n_ties += _near_tie_docs(ref_scores, r["new"], got.numpy()).size
    print(f"topdown: {len(rounds)} device rounds, {n_ties} near-tie documents differ; "
          f"{int((port.assign != ref.assign).sum())} final labels differ")
    psi_port = psi_from_counts(cluster_counts(small_view, port.assign, port.k_actual),
                               small_view.p_freq)
    psi_ref = psi_from_counts(cluster_counts(small_view, ref.assign, ref.k_actual),
                              small_view.p_freq)
    assert psi_port < 1.05 * psi_ref
