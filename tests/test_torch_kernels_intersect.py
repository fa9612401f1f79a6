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

from _torch_parity import FOLD_CASES, FOLD_QUERY_TABLE, fold_emulation, make_rows, ragged_queries
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


# The redesigned fold (csrc/fold.cu) emulated on the CPU
# (``_torch_parity.fold_emulation``): the reference's search per live cell,
# stage totals per block, counts merged per warp by query and then per
# block in a table from the block's smallest query.  Tables of 2 and 64
# entries force queries beyond a block's table (added per warp) on the
# session fixture's plans; FOLD_QUERY_TABLE is the kernel's own.


def _fixture_fold_inputs(small_seclud, small_corpus, small_log, arities):
    from _torch_parity import port_result

    from repro.data.query_log import synth_query_log
    from repro_torch.core.device_engine import device_index, lower_plan

    log = small_log if arities == (2,) else synth_query_log(
        small_corpus, n_queries=300, seed=12, arity=list(arities))
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    tres = port_result(small_seclud)
    tdi = device_index(tres.hier_index, "cpu")
    tlow = lower_plan(torch_plan(tres.hier_index, TorchQueries.from_lists(lists),
                                 track_work=False))
    jdi = jax_device_index(small_seclud.hier_index)
    jlow = jax_lower_plan(jax_plan(small_seclud.hier_index, ConjunctiveQueries.from_lists(lists),
                                   track_work=False))
    np.testing.assert_array_equal(tlow.cells, jlow.cells)
    args = (tdi.post_docs, torch.from_numpy(tlow.cells), torch.from_numpy(tlow.stage_seg),
            tlow.group_width, tlow.stage_iters, tlow.n_queries_pad)
    return args, jdi, jlow


@pytest.mark.parametrize("query_table", [2, 64, FOLD_QUERY_TABLE])
@pytest.mark.parametrize("arities", [(2,), (1, 2, 3, 4, 5)], ids=["arity2", "arity1to5"])
def test_fold_emulation_matches_plain_and_jax(small_seclud, small_corpus, small_log, arities,
                                              query_table):
    from repro_torch.kernels.intersect.ref import segment_fold_ref

    args, jdi, jlow = _fixture_fold_inputs(small_seclud, small_corpus, small_log, arities)
    counts, entering, members, stats = fold_emulation(*args, True, query_table=query_table)
    want = segment_fold_ref(*args, True)
    for got, ref in zip((counts, entering, members), want, strict=True):
        assert torch.equal(got, ref)
    counts_j, entering_j, members_j = jax_device_fold(jdi, jlow, return_members=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(entering.numpy(), np.asarray(entering_j))
    np.testing.assert_array_equal(members.numpy(), np.asarray(members_j))
    # merged per warp and block: far fewer global atomics than survivors
    assert 0 < stats["count_atomics"] < int(counts.sum()) // 8
    if query_table == 2:
        assert stats["direct_atomics"] > 0  # queries beyond the table ran too


def test_fold_emulation_keeps_the_reference_misses_of_shallow_depths(small_seclud, small_corpus,
                                                                      small_log):
    """stage_iters too shallow for a segment: the plain version's answer
    (a miss where the doc may be present) is what the kernel must give."""
    from repro_torch.kernels.intersect.ref import segment_fold_ref

    args, _jdi, _jlow = _fixture_fold_inputs(small_seclud, small_corpus, small_log, (2,))
    deep = segment_fold_ref(*args, True)
    shallow = args[:4] + (tuple(max(it - 4, 1) for it in args[4]),) + args[5:]
    counts, entering, members, _stats = fold_emulation(*shallow, True)
    want = segment_fold_ref(*shallow, True)
    for got, ref in zip((counts, entering, members), want, strict=True):
        assert torch.equal(got, ref)
    assert int(counts.sum()) < int(deep[0].sum())  # the shallow search does miss


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_emulation_on_hand_built_layouts(name):
    """The hand-built layouts the card tests fold with the kernel: the
    emulation equals the plain version on each."""
    from _torch_parity import synthetic_fold_case

    from repro_torch.kernels.intersect.ref import segment_fold_ref

    case = synthetic_fold_case(**FOLD_CASES[name])
    args = (torch.from_numpy(case["post_docs"]), torch.from_numpy(case["cells"]),
            torch.from_numpy(case["stage_seg"]), case["group_width"], case["stage_iters"],
            case["n_queries_pad"])
    counts, entering, members, stats = fold_emulation(*args, True)
    want = segment_fold_ref(*args, True)
    for got, ref in zip((counts, entering, members), want, strict=True):
        assert torch.equal(got, ref)
    if name == "arity5_thins_out":
        assert int(counts.sum()) == 0 < int(entering[-1])  # the last stage drops all
    if name == "far_queries":  # beyond the block's table: one atomic per warp and query
        assert stats["direct_atomics"] > 0
