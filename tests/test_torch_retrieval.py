"""The port's SeCluD-filtered retrieval (``repro_torch.serve.retrieval``)
against the JAX package's ``repro.serve.retrieval``.

The reference's own checks (``tests/test_search_service.py``), ported:
``items_as_corpus`` builds the CSR, and the filter is exact against a
brute-force scan, its top-k the best of the exact set.  Then parity: 3,000
items over 200 attributes from the same rng, both packages fit their
retriever, and each 1-, 2- and 3-attribute filter must give the same item
ids in the same order, the same ``n_filtered`` and exactly the same
``filter_work`` and ``baseline_work`` (integers counted by the same
algorithm); ``retrieve`` with the same numpy ``score_fn`` the same ids
and scores.  The port runs on ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve.retrieval import FilteredRetriever as JaxRetriever
from repro.serve.retrieval import items_as_corpus as jax_items_as_corpus
from repro_torch.serve.retrieval import FilteredRetriever, items_as_corpus

N_ITEMS, N_ATTRS = 3000, 200
# 1-, 2- and 3-attribute filters; (17, 35, 145) and (55, 134, 163) hold 2 items each,
# (3, 7, 11) none; (5, 5) repeats an attribute (∩ is idempotent).
FILTERS = [(3,), (17,), (3, 7), (1, 4), (0, 2), (17, 35, 145), (55, 134, 163), (3, 7, 11),
           (5, 5)]


def _item_attrs(seed=0, n_items=N_ITEMS, n_attrs=N_ATTRS):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.choice(n_attrs, size=rng.integers(2, 10))) for _ in range(n_items)]


def test_items_as_corpus():
    attrs = [np.array([1, 5]), np.array([2]), np.array([1, 2, 9])]
    c = items_as_corpus(attrs, n_attrs=10)
    assert c.n_docs == 3
    assert np.array_equal(c.doc(2), [1, 2, 9])
    want = jax_items_as_corpus(attrs, n_attrs=10)
    assert np.array_equal(c.doc_ptr, want.doc_ptr) and np.array_equal(c.doc_terms, want.doc_terms)
    assert c.doc_terms.dtype == np.int32


@pytest.fixture(scope="module")
def retrievers():
    item_attrs = _item_attrs()
    port = FilteredRetriever(items_as_corpus(item_attrs, N_ATTRS), k=16, tc=200, device="cpu")
    ref = JaxRetriever(jax_items_as_corpus(item_attrs, N_ATTRS), k=16, tc=200)
    return item_attrs, port, ref


def test_filtered_retriever_exact(retrievers):
    item_attrs, r, _ = retrievers
    rng = np.random.default_rng(1)
    a, b = 3, 7
    got, report = r.filter(a, b)
    want = [i for i, s in enumerate(item_attrs) if a in s and b in s]
    assert sorted(got.tolist()) == want
    assert report.n_filtered == len(want) and report.n_candidates == N_ITEMS
    assert report.filter_work > 0 and report.baseline_work > 0

    emb = rng.standard_normal((N_ITEMS, 8)).astype(np.float32)
    user = rng.standard_normal((1, 8)).astype(np.float32)
    ids, scores, _ = r.retrieve(lambda c: user @ emb[c].T, a, b, top_k=3)
    # Top-3 by score among the exact filtered set.
    all_scores = (user @ emb[want].T)[0]
    want_top = np.asarray(want)[np.argsort(-all_scores)[:3]]
    np.testing.assert_array_equal(ids, want_top)


@pytest.mark.parametrize("attrs", FILTERS, ids=["-".join(map(str, f)) for f in FILTERS])
def test_filter_matches_reference(retrievers, attrs):
    item_attrs, port, ref = retrievers
    got, got_report = port.filter(*attrs)
    want, want_report = ref.filter(*attrs)
    np.testing.assert_array_equal(got, want)
    assert got_report.n_filtered == want_report.n_filtered
    assert got_report.filter_work == want_report.filter_work
    assert got_report.baseline_work == want_report.baseline_work
    assert got_report.speedup == want_report.speedup
    brute = [i for i, s in enumerate(item_attrs) if all(a in s for a in attrs)]
    assert sorted(got.tolist()) == brute


@pytest.mark.parametrize("attrs", [(3,), (3, 7), (17, 35, 145)], ids=["1", "2", "3"])
def test_retrieve_matches_reference(retrievers, attrs):
    _, port, ref = retrievers
    emb = np.random.default_rng(2).standard_normal((N_ITEMS, 8)).astype(np.float32)
    user = np.random.default_rng(3).standard_normal((1, 8)).astype(np.float32)
    ids, scores, report = port.retrieve(lambda c: user @ emb[c].T, *attrs, top_k=5)
    want_ids, want_scores, want_report = ref.retrieve(lambda c: user @ emb[c].T, *attrs, top_k=5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    assert dataclasses.asdict(report) == dataclasses.asdict(want_report)
    # a score_fn that answers with a tensor (a model head) gives the same
    t_ids, t_scores, _ = port.retrieve(
        lambda c: torch.from_numpy(user) @ torch.from_numpy(emb)[torch.from_numpy(c).long()].T,
        *attrs, top_k=5)
    np.testing.assert_array_equal(t_ids, ids)
    np.testing.assert_allclose(t_scores, scores, rtol=1e-6)


def test_an_empty_filter_scores_nothing(retrievers):
    _, port, _ = retrievers
    ids, scores, report = port.retrieve(lambda c: pytest.fail("scored an empty set"), 198, 199,
                                        5, top_k=5)
    assert len(ids) == len(scores) == report.n_filtered == 0
