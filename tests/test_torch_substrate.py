"""The port's host substrate equals the JAX package's: the same spec and
seed give the same corpus, query log, clustering, reordered index and ψ
at every depth, and the batched planner and host engine return the same
plans, docs and work on arities 1-5 with empty, absent and duplicate
terms.

Integer outputs must be bit-identical.  ψ and the speedups of
``evaluate`` are computed by the same numpy code in both packages, so
they must be equal too (tolerance 0).
"""

import numpy as np
import pytest

import repro.core.cluster_index as jci
import repro.core.queries as jq
import repro.core.reorder as jre
import repro.data.corpus as jcorpus
import repro.index.build as jbuild
import repro_torch.core.cluster_index as tci
import repro_torch.core.queries as tq
import repro_torch.core.reorder as tre
import repro_torch.data.corpus as tcorpus
import repro_torch.index.build as tbuild
from _torch_parity import ragged_queries
from repro.core.batched_query import batched_query as jax_batched_query
from repro.core.batched_query import plan_segment_pairs as jax_plan
from repro.core.seclud import SecludPipeline as JaxPipeline
from repro.data.query_log import synth_query_log as jax_log
from repro_torch.core.batched_query import batched_query as torch_batched_query
from repro_torch.core.batched_query import plan_segment_pairs as torch_plan
from repro_torch.core.seclud import SecludPipeline as TorchPipeline
from repro_torch.data.query_log import synth_query_log as torch_log

SMALL_SPEC = dict(n_docs=1500, n_terms=3000, mean_doc_len=40, n_topics=8,
                  topicality=0.6, seed=7)
PIPE = dict(tc=800, doc_grained_below=256, seed=0)
PLAN_FIELDS = ("pair_query", "cluster", "base", "width", "arity", "seg_ptr",
               "seg_start", "seg_len", "cluster_work")


@pytest.fixture(scope="module")
def port_data():
    corpus = tcorpus.synth_corpus(tcorpus.CorpusSpec(**SMALL_SPEC))
    return corpus, torch_log(corpus, n_queries=300, seed=11)


def _assert_plans_equal(jp, tp):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    assert (tp.n_queries, tp.max_arity) == (jp.n_queries, jp.max_arity)
    assert len(tp.level_work) == len(jp.level_work)
    for a, b in zip(tp.level_work, jp.level_work, strict=True):
        np.testing.assert_array_equal(a, b)


def _assert_engines_equal(jidx, tidx, lists):
    jcq = jq.ConjunctiveQueries.from_lists(lists)
    tcq = tq.ConjunctiveQueries.from_lists(lists)
    _assert_plans_equal(
        jax_plan(jidx, jcq), torch_plan(tidx, tcq)
    )
    jptr, jdocs, jwork = jax_batched_query(jidx, jcq)
    tptr, tdocs, twork = torch_batched_query(tidx, tcq)
    np.testing.assert_array_equal(tptr, jptr)
    np.testing.assert_array_equal(tdocs, jdocs)
    assert twork == jwork


def test_corpus_and_log_are_identical(small_corpus, small_log, port_data):
    corpus, log = port_data
    np.testing.assert_array_equal(corpus.doc_ptr, small_corpus.doc_ptr)
    np.testing.assert_array_equal(corpus.doc_terms, small_corpus.doc_terms)
    assert corpus.n_terms == small_corpus.n_terms
    np.testing.assert_array_equal(log.queries, small_log.queries)
    mixed_j = jax_log(small_corpus, n_queries=80, seed=3, arity=[1, 2, 3, 4, 5],
                      arrival_qps=50.0)
    mixed_t = torch_log(corpus, n_queries=80, seed=3, arity=[1, 2, 3, 4, 5],
                        arrival_qps=50.0)
    np.testing.assert_array_equal(mixed_t.queries, mixed_j.queries)
    np.testing.assert_array_equal(mixed_t.arrivals, mixed_j.arrivals)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_fit_is_identical_at_every_depth(
    levels, small_corpus, small_log, small_seclud, port_data
):
    corpus, log = port_data
    if levels == 2:
        jres = small_seclud  # the session fit: same pipeline, same data
    else:
        jres = JaxPipeline(**PIPE).fit(small_corpus, k=8, log=small_log, levels=levels)
    tres = TorchPipeline(**PIPE).fit(corpus, k=8, log=log, levels=levels, device="cpu")

    assert tres.k == jres.k and tres.levels == jres.levels
    for f in ("assign", "perm", "ranges", "base_perm"):
        np.testing.assert_array_equal(getattr(tres, f), getattr(jres, f), err_msg=f)
    for f in ("level_ranges", "level_assigns"):
        got, want = getattr(tres, f), getattr(jres, f)
        assert len(got) == len(want)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        tres.reordered_index.post_docs, jres.reordered_index.post_docs
    )
    np.testing.assert_array_equal(
        tres.reordered_index.post_ptr, jres.reordered_index.post_ptr
    )
    assert tres.psi == jres.psi and tres.psi_single == jres.psi_single
    assert tres.psi_levels == jres.psi_levels
    for tl, jl in zip(tres.hier_index.levels, jres.hier_index.levels, strict=True):
        for f in ("cl_ptr", "cl_ids", "seg_start", "seg_end", "ranges"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f), err_msg=f)
    # fit uploaded the index to the device it was given
    assert tres.device_index.device.type == "cpu"

    # the planner and host engine over the fitted hierarchy: arities 1-5,
    # absent (zero-df) terms and duplicates
    rng = np.random.default_rng(levels)
    df = small_corpus.term_doc_freq()
    absent = int(np.flatnonzero(df == 0)[0]) if (df == 0).any() else small_corpus.n_terms - 1
    lists = [list(map(int, t)) for t in small_log.as_conjunctive()[:40]]
    lists += ragged_queries(rng, 40, small_corpus.n_terms)
    lists += [[absent], [absent, lists[0][0]], [lists[1][0], lists[1][0], lists[1][0]]]
    _assert_engines_equal(jres.hier_index, tres.hier_index, lists)

    if levels >= 2:
        jev = JaxPipeline(**PIPE).evaluate(small_corpus, jres, small_log, max_queries=40)
        tev = TorchPipeline(**PIPE).evaluate(corpus, tres, log, max_queries=40)
        assert tev == jev


def _random_pair(seed, n_docs, n_terms, k, mean_len=12):
    """The same random corpus and clustering as a JAX-package and a port
    ClusterIndex (empty posting lists included)."""
    rng = np.random.default_rng(seed)
    doc_lens = rng.integers(1, 2 * mean_len, n_docs)
    rows = [np.unique(rng.integers(0, n_terms, n)) for n in doc_lens]
    ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
    terms = np.concatenate(rows).astype(np.int32)
    assign = rng.integers(0, k, n_docs)
    out = []
    for corpus_mod, build_mod, reorder_mod, ci_mod in (
        (jcorpus, jbuild, jre, jci),
        (tcorpus, tbuild, tre, tci),
    ):
        corpus = corpus_mod.Corpus(doc_ptr=ptr, doc_terms=terms, n_terms=n_terms)
        index = build_mod.build_index(corpus)
        reordered = build_mod.permute_docs(index, reorder_mod.reorder_permutation(assign, k))
        out.append(ci_mod.build_cluster_index(reordered, reorder_mod.cluster_ranges(assign, k)))
    return rng, index, out[0], out[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_and_host_engine_on_random_corpora(seed):
    rng, index, jidx, tidx = _random_pair(seed, 150, 500, k=1 + 3 * seed)
    df = np.diff(index.post_ptr)
    empty = np.flatnonzero(df == 0)
    alive = np.flatnonzero(df > 0)
    lists = ragged_queries(rng, 60, index.n_terms)
    lists += [
        [int(empty[0])],
        [int(empty[0]), int(empty[1]), int(empty[2])],
        [int(alive[0]), int(empty[0]), int(alive[1])],
        [int(alive[2]), int(alive[2])],
        [int(alive[3]), int(alive[4]), int(alive[5]), int(alive[6]), int(alive[7])],
    ]
    _assert_engines_equal(jidx, tidx, lists)
