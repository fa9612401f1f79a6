"""The port's ``SearchService`` against the JAX package's, on the CPU,
serving the session fit carried across with ``result_from_arrays``:
host counts and work, device-engine counts and docs, the block layout of
``pack`` (with and without ``pin_top``) and the block path's counts for
pairs-only and mixed-arity batches are all equal (integers, exact).
The launcher runs end to end with ``--device cpu``."""

import numpy as np
import pytest

from _torch_parity import port_result, ragged_queries
from repro.serve.search_service import SearchService as JaxService
from repro_torch.serve.search_service import SearchService


@pytest.fixture(scope="module")
def services(small_seclud):
    return JaxService(small_seclud), SearchService(port_result(small_seclud), device="cpu")


def _pairs(corpus, seed, n=24):
    rng = np.random.default_rng(seed)
    alive = np.flatnonzero(corpus.term_doc_freq() > 1)
    q = rng.choice(alive, (n, 2))
    return q[q[:, 0] != q[:, 1]]


def _mixed(corpus, seed, n=40):
    from repro_torch.core.queries import ConjunctiveQueries

    lists = ragged_queries(np.random.default_rng(seed), n, corpus.n_terms)
    lists.append([1, 2, 3, 4, 5])  # keep the batch's max arity at 5
    return ConjunctiveQueries.from_lists(lists).padded()


@pytest.mark.parametrize("kind", ["pairs", "mixed", "log"])
def test_serve_counts_and_device_engine_match(services, small_corpus, small_log, kind):
    jsvc, tsvc = services
    queries = {
        "pairs": lambda: _pairs(small_corpus, 0),
        "mixed": lambda: _mixed(small_corpus, 1),
        "log": lambda: small_log.queries[:100],
    }[kind]()
    jc, jwork = jsvc.serve_counts(queries)
    tc, twork = tsvc.serve_counts(queries)
    np.testing.assert_array_equal(tc, jc)
    assert twork == jwork
    jdc, jdocs, jinfo = jsvc.serve_counts_device(queries, return_docs=True)
    tdc, tdocs, tinfo = tsvc.serve_counts_device(queries, return_docs=True)
    np.testing.assert_array_equal(tdc, jdc)
    np.testing.assert_array_equal(tdocs, jdocs)
    np.testing.assert_array_equal(tdc, tc)
    for key in ("n_pairs", "padding_overhead", "occupancy", "stages"):
        assert tinfo[key] == jinfo[key], key


@pytest.mark.parametrize("pin_top", [False, True])
@pytest.mark.parametrize("kind", ["pairs", "mixed"])
def test_pack_and_block_counts_match(services, small_corpus, kind, pin_top):
    jsvc, tsvc = services
    queries = _pairs(small_corpus, 2) if kind == "pairs" else _mixed(small_corpus, 3)
    jp, tp = jsvc.pack(queries, pin_top=pin_top), tsvc.pack(queries, pin_top=pin_top)
    assert len(tp.segments) == len(jp.segments)
    for a, b in zip(tp.segments, jp.segments, strict=True):
        np.testing.assert_array_equal(a, b)
    for f in ("row_query", "row_arity", "row_top"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    assert tp.n_queries == jp.n_queries
    got = tsvc.device_counts(tp).numpy()
    np.testing.assert_array_equal(got, np.asarray(JaxService.device_counts(jp)))
    np.testing.assert_array_equal(got, tsvc.serve_counts(queries)[0])


def test_empty_pack(services, small_corpus):
    jsvc, tsvc = services
    df = small_corpus.term_doc_freq()
    if not (df == 0).any():
        pytest.skip("the session corpus uses every term")
    absent = int(np.flatnonzero(df == 0)[0])
    queries = np.array([[absent, absent]])
    tp = tsvc.pack(queries)
    assert tp.short.shape == jsvc.pack(queries).short.shape
    np.testing.assert_array_equal(tsvc.device_counts(tp).numpy(), [0])


def test_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import search

    report = search.run(search.build_parser().parse_args(
        ["--device", "cpu", "--docs", "600", "--k", "8", "--queries", "80", "--tc", "400"]))
    out = capsys.readouterr().out
    assert "agrees with host" in out
    assert report["device"] == "cpu" and report["n_docs"] == 600
    for name in ("arity2", "arity1to5"):
        assert report[f"engine_{name}"]["n_queries"] == 80
        assert report[f"blocks_{name}"]["n_queries"] == 64
