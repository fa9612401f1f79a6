"""The port's search kernels against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions; they must
equal ``repro.kernels.intersect.ops`` (its jnp reference path on the
CPU) and a brute-force intersection on the shapes of the JAX package's
kernel tests, on PAD-holed short rows, and — for the fold — equal the
JAX engine's fused fold on the same lowered plans.  All outputs are
integers: tolerance 0.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from _torch_parity import make_rows, ragged_queries
from repro.core.batched_query import plan_segment_pairs as jax_plan
from repro.core.device_engine import device_fold as jax_device_fold
from repro.core.device_engine import device_index as jax_device_index
from repro.core.device_engine import lower_plan as jax_lower_plan
from repro.core.queries import ConjunctiveQueries
from repro.kernels.intersect import ops as jax_ops
from repro_torch.core.batched_query import plan_segment_pairs as torch_plan
from repro_torch.core.queries import ConjunctiveQueries as TorchQueries
from repro_torch.kernels.intersect import ops
from repro_torch.kernels.intersect.ref import PAD

SHAPES = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512), (3, 257, 1000)]


def _brute(short, long):
    return np.asarray(
        [len(np.intersect1d(s[s != PAD], l[l != PAD])) for s, l in zip(short, long, strict=True)],
        np.int32,
    )


@pytest.mark.parametrize("b,ls,ll", SHAPES)
def test_intersect_count_matches_reference(b, ls, ll):
    rng = np.random.default_rng(b * 1000 + ls + ll)
    short, long = make_rows(rng, b, ls, ll, universe=4 * ll)
    got = ops.intersect_count(short, long).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops.intersect_count(short, long)))
    np.testing.assert_array_equal(got, _brute(short, long))


@pytest.mark.parametrize("reduce", ["mask", "docs", "count"])
@pytest.mark.parametrize("holes", [False, True], ids=["sorted", "pad_holes"])
@pytest.mark.parametrize("b,ls,ll", SHAPES)
def test_intersect_members_matches_reference(b, ls, ll, holes, reduce):
    rng = np.random.default_rng(b * 7 + ls + ll)
    short, long = make_rows(rng, b, ls, ll, universe=4 * ll, holes=holes)
    got = ops.intersect_members(torch.from_numpy(short), torch.from_numpy(long), reduce=reduce)
    want = np.asarray(jax_ops.intersect_members(short, long, reduce=reduce))
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_pad_and_empty_rows():
    pad = np.full((8, 128), PAD, np.int32)
    np.testing.assert_array_equal(ops.intersect_count(pad, pad).numpy(), 0)
    np.testing.assert_array_equal(ops.intersect_members(pad, pad, reduce="mask").numpy(), pad)
    empty_long = np.zeros((3, 0), np.int32)
    short = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.testing.assert_array_equal(ops.intersect_members(short, empty_long, reduce="count"), 0)


def _jax_and_port_indexes(seed, n_docs=180, n_terms=400, k=6):
    from _torch_parity import port_result

    from repro.core.seclud import SecludPipeline
    from repro.data.corpus import CorpusSpec, synth_corpus
    from repro.data.query_log import synth_query_log

    corpus = synth_corpus(CorpusSpec(n_docs=n_docs, n_terms=n_terms, mean_doc_len=20,
                                     n_topics=4, seed=seed))
    log = synth_query_log(corpus, n_queries=60, seed=seed, arity=[1, 2, 3, 4, 5])
    res = SecludPipeline(tc=200, doc_grained_below=64, seed=0).fit(
        corpus, k=k, log=log, levels=3)
    return corpus, log, res, port_result(res)


@pytest.mark.parametrize("return_members", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_fold_matches_jax_fused_fold(seed, return_members):
    from repro_torch.core.device_engine import device_index, lower_plan

    corpus, log, jres, tres = _jax_and_port_indexes(seed)
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    lists += ragged_queries(np.random.default_rng(seed), 30, corpus.n_terms)
    cq = ConjunctiveQueries.from_lists(lists)
    jdi = jax_device_index(jres.hier_index)
    jlow = jax_lower_plan(jax_plan(jres.hier_index, cq, track_work=False))
    counts_j, entering_j, members_j = jax_device_fold(jdi, jlow, return_members=return_members)

    tdi = device_index(tres.hier_index, "cpu")
    tlow = lower_plan(torch_plan(tres.hier_index, TorchQueries.from_lists(lists),
                                 track_work=False))
    np.testing.assert_array_equal(tlow.cells, jlow.cells)
    counts_t, entering_t, members_t = ops.segment_fold(
        tdi.post_docs, torch.from_numpy(tlow.cells), torch.from_numpy(tlow.stage_seg),
        tlow.group_width, tlow.stage_iters, tlow.n_queries_pad, return_members)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(entering_t.numpy(), np.asarray(entering_j))
    if return_members:
        np.testing.assert_array_equal(members_t.numpy(), np.asarray(members_j))
    else:
        assert members_t is None
