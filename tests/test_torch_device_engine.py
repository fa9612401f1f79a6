"""The port's device engine against the JAX package's, on the CPU.

Both engines serve the same fitted index (carried across with
``result_from_arrays``): ``lower_plan`` must give identical arrays, and
``device_counts(..., return_docs=True, device="cpu")`` identical counts,
docs, stage attribution, ``padding_overhead`` and ``occupancy`` — all
integers or ratios of integers, compared exactly.  Timing keys differ by
nature and are only checked to be present.
"""

import numpy as np
import pytest
import torch

from _torch_parity import port_result, ragged_queries
from repro.core.batched_query import plan_segment_pairs as jax_plan
from repro.core.device_engine import device_counts as jax_device_counts
from repro.core.device_engine import lower_plan as jax_lower_plan
from repro.core.queries import ConjunctiveQueries as JaxQueries
from repro_torch.core.batched_query import batched_query
from repro_torch.core.batched_query import plan_segment_pairs as torch_plan
from repro_torch.core.device_engine import device_counts, device_index, lower_plan
from repro_torch.core.queries import ConjunctiveQueries as TorchQueries

LOWERED_ARRAYS = ("cells", "stage_seg", "order", "cell_counts")
LOWERED_SCALARS = ("group_width", "cell_prefix", "group_prefix", "stage_iters",
                   "n_queries", "n_queries_pad", "n_cells_true")
INFO_EXACT = ("n_pairs", "n_kernel_calls", "padding_overhead", "occupancy", "stages")


def _fit_pair(seed, levels, n_docs=300, n_terms=700, k=8):
    from repro.core.seclud import SecludPipeline
    from repro.data.corpus import CorpusSpec, synth_corpus
    from repro.data.query_log import synth_query_log

    corpus = synth_corpus(CorpusSpec(n_docs=n_docs, n_terms=n_terms, mean_doc_len=16,
                                     n_topics=4, seed=seed))
    log = synth_query_log(corpus, n_queries=40, seed=seed, arity=[1, 2, 3, 4, 5])
    jres = SecludPipeline(tc=300, doc_grained_below=64, seed=0).fit(
        corpus, k=k, log=log, levels=levels)
    return corpus, log, jres, port_result(jres)


def _lists(corpus, log, seed):
    rng = np.random.default_rng(seed)
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    lists += ragged_queries(rng, 40, corpus.n_terms)
    df = corpus.term_doc_freq()
    absent = np.flatnonzero(df == 0)
    if len(absent):
        lists += [[int(absent[0])], [int(absent[0]), lists[0][0]]]
    return lists


def _assert_same_engine(jidx, tidx, lists):
    jcq, tcq = JaxQueries.from_lists(lists), TorchQueries.from_lists(lists)
    jlow = jax_lower_plan(jax_plan(jidx, jcq, track_work=False))
    tlow = lower_plan(torch_plan(tidx, tcq, track_work=False))
    for f in LOWERED_ARRAYS:
        np.testing.assert_array_equal(getattr(tlow, f), getattr(jlow, f), err_msg=f)
    for f in LOWERED_SCALARS:
        assert getattr(tlow, f) == getattr(jlow, f), f

    jc, jd, jinfo = jax_device_counts(jidx, jcq, return_docs=True)
    tc, td, tinfo = device_counts(tidx, tcq, return_docs=True, device="cpu")
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    for key in INFO_EXACT:
        assert tinfo[key] == jinfo[key], key
    assert set(tinfo) == set(jinfo)
    assert tinfo["jit_compiles"] == 0.0
    # and against the host engine
    ptr, docs, _ = batched_query(tidx, tcq)
    np.testing.assert_array_equal(tc, np.diff(ptr))
    np.testing.assert_array_equal(td, docs)
    return tinfo


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_device_counts_match_jax_engine_at_every_depth(levels):
    corpus, log, jres, tres = _fit_pair(levels, levels)
    info = _assert_same_engine(jres.hier_index, tres.hier_index, _lists(corpus, log, levels))
    assert info["n_kernel_calls"] == 1.0


def test_device_counts_match_jax_engine_on_the_session_fit(small_seclud, small_log):
    tres = port_result(small_seclud)
    lists = [list(map(int, t)) for t in small_log.as_conjunctive()[:120]]
    _assert_same_engine(small_seclud.hier_index, tres.hier_index, lists)


def test_counts_only_and_empty_plans(small_seclud, small_corpus):
    tres = port_result(small_seclud)
    df = small_corpus.term_doc_freq()
    absent = int(np.flatnonzero(df == 0)[0]) if (df == 0).any() else None
    lists = [[absent]] if absent is not None else [[0, 0]]
    counts, info = device_counts(tres.hier_index, TorchQueries.from_lists(lists), device="cpu")
    jc, jinfo = jax_device_counts(small_seclud.hier_index, JaxQueries.from_lists(lists))
    np.testing.assert_array_equal(counts, jc)
    for key in INFO_EXACT:
        assert info[key] == jinfo[key], key


def test_device_index_is_uploaded_once_per_device(small_seclud):
    tres = port_result(small_seclud)
    di = device_index(tres.hier_index, "cpu")
    assert device_index(tres.cluster_index, "cpu") is di  # the L = 2 facade shares it
    assert di.post_docs.dtype == torch.int32 and di.device.type == "cpu"
    assert di.nbytes == (
        di.post_docs.numel() * 4 + di.post_ptr.numel() * 8
        + sum(lev.cl_ptr.numel() * 8 + lev.cl_ids.numel() * 4 + lev.seg_start.numel() * 8
              + lev.seg_end.numel() * 8 + lev.ranges.numel() * 8 for lev in di.levels)
    )
    di.validate()
