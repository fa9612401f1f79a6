"""The CUDA kernels of the port against their plain PyTorch versions.

The ``cuda`` tests need the card and skip without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The search kernels' outputs are integers: kernel and plain version must
be equal (the fold also on the hand-built layouts of
``_torch_parity.FOLD_CASES``, equal to the CPU emulation of its
algorithm, twice, and inside a CUDA graph).  The δ⁺ scores of
``cluster_scores`` are fp32 sums over at most L terms, taken in another
order than the plain version's, so they must agree within
``rtol=2e-5, atol=1e-5`` (the tolerance of the reference's
``tests/test_kernels_cluster_score.py``); each case asserts the variant
``kernel.score_route`` picked, a second launch gives the same bits, and
the staged variant equals the emulation of its summation order
(``_torch_parity.staged_scores_emulation``) bit for bit.  The tests without the marker
check, on any machine, that a launcher refuses what its kernel does not
take and that a missing compiler raises.

``flash_attention`` is held against its plain version computed in
float32 from the same inputs (TF32 off), at the cases and within the
tolerance of ``_torch_parity`` (``FLASH_CASES``, ``FLASH_TOL``, plus
``p_rounding_term`` for the sm90 variant, which rounds P to bf16) that
``chip_smoke.py`` uses too; each case asserts from the launch counters
which variant it took (``kernel.flash_route``).  The decode variant's two
kernels are also held one by one against their plain versions, and the
launcher must refuse a misaligned base or stride for the variants that
read with 16-byte loads, cp.async or TMA.  Each variant also runs past
gridDim.y's 65,535 (batch, head) rows (``BIG_BH_CASES``: B·H = 65,536 and
131,072, BERT4Rec's call among them), which its launcher cuts into
launches; at BERT4Rec's call the resident variant and the general kernel
forced on the same inputs are both held to ``FLASH_TOL``.

The attention's backward is held against ``attention_bwd_ref`` at
``FLASH_BWD_CASES`` through the autograd function of
``ops.flash_attention``, one launch of each kernel of the route
``kernel.bwd_route`` names a call: the fp32 resident kernel alone
(``csrc/flash_attention_bwd_resident.cu``, fp32, not causal, no window,
given the resident forward's lse; ``FLASH_BWD_TOL``), or prep
(``csrc/flash_attention_bwd.cu``), then the bf16 tensor-core dK/dV and dQ
(``csrc/flash_attention_bwd_sm90.cu``, bf16 with D in {64, 128, 256};
limit ``FLASH_BWD_TOL`` plus ``bwd_rounding_terms``, the rounding of P
and dS) or the general pair (``FLASH_BWD_TOL``).  The sm90 kernels are
also held one by one against their plain parts fed the same lse and
delta, the sm90 and resident kernels bit for bit across two runs and
past one launch chunk of B·H, and the sm90 and resident forwards'
log-sum-exp against ``bwd_prep_ref``'s within
``FLASH_BWD_TOL["float32"]``.

``moe_apply`` on the card is held against its CPU run, routing included
(near-ties apart).

PNA's aggregation (``csrc/segment_aggregate.cu``, forward and backward,
split by edges) is held against its plain version's formulas in float64
on the card (``_torch_parity.AggregateCheck``), through the autograd
function of ``ops.segment_aggregate`` (one launch of each a call), at
``_torch_parity.AGGREGATE_CASES`` (each at its own run length, E below one
run among them), a destination with more than 10⁶ incoming edges (hundreds
of runs merged), and graphs whose every node has degree 0: max, min, deg
and the tie counts bit for bit, mean, std and both gradients within the
limits of the kernels' float64 sums; a rerun of the forward gives the
same bits.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (AGGREGATE_CASES, FLASH_BWD_CASES, FLASH_BWD_TOL, FLASH_CASES,
                           FLASH_VARIANTS, AggregateCheck, aggregate_grads, aggregate_inputs,
                           FOLD_CASES, RESIDENT_BWD_CASES, VARIANT_LAUNCHES, attention_ref_chunked,
                           bwd_rounding_terms, flash_bwd_close, flash_close,
                           flash_inputs, fold_emulation,
                           make_rows, p_rounding_term, staged_scores_emulation,
                           synthetic_fold_case)
from repro_torch.kernels import build as B
from repro_torch.kernels.cluster_score import kernel as CK
from repro_torch.kernels.cluster_score import ops as cops
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_ref,
                                                     bwd_dkdv_ref, bwd_dq_ref, bwd_prep_ref,
                                                     combine_ref, decode_partials_ref)
from repro_torch.kernels.intersect import kernel as K
from repro_torch.kernels.intersect import ops, ref
from repro_torch.kernels.intersect.ref import PAD
from repro_torch.kernels.segment_aggregate import kernel as AK
from repro_torch.kernels.segment_aggregate.ops import edge_csr, segment_aggregate

SHAPES = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512), (3, 257, 1000),
          (4, 33, 0), (0, 8, 8), (6, 0, 5), (7, 1, 1)]
# (N, L, TC, K): the reference test's shapes, empty and narrow ones, a K
# above 256 (column chunks), and the path's L = 742, TC = 3000 at the top
# TopDown split's K = 8 and the flat algorithm's K = 256.
SCORE_SHAPES = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
                (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
                (300, 742, 3000, 8), (300, 742, 3000, 256),
                # the staged variant's edges: K in {1, 2, 7, 9} (padded to a power of
                # two), N in {0, 1, 3000}, L in {1, 3, 742} (rows 4-byte apart), and a
                # table just within and just beyond the shared-memory budget
                (3000, 742, 3000, 8), (1, 742, 3000, 8), (0, 742, 3000, 8), (3000, 1, 3000, 1),
                (3000, 3, 3000, 2), (500, 742, 3000, 7), (500, 742, 3000, 9),
                (200, 742, 6144, 8), (200, 742, 6145, 8), (200, 50, 3072, 16),
                (200, 50, 3073, 16), (50, 742, 3000, 33)]
SCORE_VARIANTS = ("cluster_scores_staged", "cluster_scores_general")
SCORE_TOL = dict(rtol=2e-5, atol=1e-5)
PAD_MAX = 2**31 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def test_launchers_refuse_cpu_and_wrong_dtype_tensors():
    s = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_count_cuda(s, s)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_members_cuda(s, s)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_members_count_cuda(s, s)
    cells = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.segment_fold_cuda(s.reshape(-1), cells, torch.zeros((2, 0), dtype=torch.int32),
                            8, (), 8, False)


def test_cluster_scores_launcher_refuses_cpu_and_wrong_dtype_tensors():
    ell = torch.zeros((2, 4), dtype=torch.int32)
    p = torch.ones(8, dtype=torch.float32)
    tables = torch.ones((8, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        CK.cluster_scores_cuda(ell, p, tables)
    with pytest.raises(ValueError, match="int32"):
        CK.cluster_scores_cuda(ell.long(), p, tables)
    with pytest.raises(ValueError, match="float32"):
        CK.cluster_scores_cuda(ell, p.double(), tables)
    with pytest.raises(ValueError, match="float32"):
        CK.cluster_scores_cuda(ell, p, tables.half())
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        with pytest.raises(ValueError, match="CUDA"):
            CK.cluster_scores_cuda(ell.to(dev), p, tables.to(dev))
        with pytest.raises(ValueError, match="contiguous"):
            CK.cluster_scores_cuda(ell.to(dev), p.to(dev), tables.to(dev).T)


def test_flash_attention_launcher_refuses_what_its_kernel_does_not_take():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.flash_attention_cuda(q.half(), q.half(), q.half())
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        qd = q.to(dev)
        with pytest.raises(ValueError, match="see a key"):
            FK.flash_attention_cuda(qd, qd[:, :, :2], qd[:, :, :2])
        with pytest.raises(ValueError, match="divide"):
            FK.flash_attention_cuda(qd, qd[:, :1].expand(1, 3, 4, 16), qd[:, :1].expand(1, 3, 4, 16))
        wide = torch.zeros((1, 1, 4, 512), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            FK.flash_attention_cuda(wide, wide, wide)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed here")
    monkeypatch.setattr(B.shutil, "which", lambda name: None)
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(B, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        B.build_libraries()


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True], ids=["sorted", "pad_holes"])
@pytest.mark.parametrize("b,ls,ll", SHAPES)
def test_intersect_trio_equals_plain(cuda_device, b, ls, ll, holes):
    rng = np.random.default_rng(b + ls + ll)
    short, long = make_rows(rng, b, ls, ll, universe=max(4 * ll, 4 * ls, 8), holes=holes)
    s, l = torch.from_numpy(short).to(cuda_device), torch.from_numpy(long).to(cuda_device)
    hit = ref.intersect_members_ref(s, l)
    before = dict(B.LAUNCHES)
    assert torch.equal(ops.intersect_members(s, l, reduce="mask"), torch.where(hit, s, int(PAD)))
    assert torch.equal(ops.intersect_members(s, l, reduce="docs"),
                       ref.intersect_members_docs_ref(s, l))
    assert torch.equal(ops.intersect_members(s, l, reduce="count"),
                       hit.sum(dim=1).to(torch.int32))
    s_sorted = torch.sort(s, dim=1).values
    assert torch.equal(ops.intersect_count(s_sorted, l), ref.intersect_count_ref(s_sorted, l))
    assert B.LAUNCHES["intersect_members_kernel"] == before["intersect_members_kernel"] + 2
    for name in ("intersect_members_count_kernel", "intersect_count_kernel"):
        assert B.LAUNCHES[name] == before[name] + 1


@pytest.fixture(scope="module")
def fitted():
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, synth_corpus
    from repro_torch.data.query_log import synth_query_log

    corpus = synth_corpus(CorpusSpec(n_docs=800, n_terms=1500, mean_doc_len=24,
                                     n_topics=6, seed=3))
    log = synth_query_log(corpus, n_queries=120, seed=4, arity=[1, 2, 3, 4, 5])
    res = SecludPipeline(tc=400, doc_grained_below=128, seed=0).fit(
        corpus, k=10, log=log, levels=3, device="cpu")
    return corpus, log, res


@pytest.mark.cuda
@pytest.mark.parametrize("arity_one_only", [False, True], ids=["arity1to5", "arity1"])
@pytest.mark.parametrize("return_members", [False, True])
def test_segment_fold_equals_plain(cuda_device, fitted, return_members, arity_one_only):
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import device_index, lower_plan
    from repro_torch.core.queries import ConjunctiveQueries

    _corpus, log, res = fitted
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    if arity_one_only:
        lists = [x[:1] for x in lists]
    di = device_index(res.hier_index, cuda_device)
    low = lower_plan(plan_segment_pairs(di.host, ConjunctiveQueries.from_lists(lists),
                                        track_work=False))
    args = (di.post_docs, torch.from_numpy(low.cells).to(cuda_device),
            torch.from_numpy(low.stage_seg).to(cuda_device), low.group_width,
            low.stage_iters, low.n_queries_pad, return_members)
    before = B.LAUNCHES["segment_fold"]
    got = ops.segment_fold(*args)
    assert B.LAUNCHES["segment_fold"] == before + 1
    want = ref.segment_fold_ref(*args)
    for g, w in zip(got, want, strict=True):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("return_members", [False, True])
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_segment_fold_hand_built_layouts_equal_plain(cuda_device, name, return_members):
    """Bit-identical counts, entering and members on the hand-built layouts
    of ``_torch_parity.FOLD_CASES``, equal to the CPU emulation of the
    kernel's algorithm too, and the same bits from a second launch."""
    case = synthetic_fold_case(**FOLD_CASES[name])
    host = (torch.from_numpy(case["post_docs"]), torch.from_numpy(case["cells"]),
            torch.from_numpy(case["stage_seg"]))
    rest = (case["group_width"], case["stage_iters"], case["n_queries_pad"], return_members)
    args = tuple(t.to(cuda_device) for t in host) + rest
    before = B.LAUNCHES["segment_fold"]
    got = ops.segment_fold(*args)
    again = ops.segment_fold(*args)
    torch.cuda.synchronize()
    # a plan past 64 stages runs as a chain of launches
    assert B.LAUNCHES["segment_fold"] == before + 2 * K.fold_launches(len(case["stage_iters"]))
    want = ref.segment_fold_ref(*args)
    *emulated, _stats = fold_emulation(*host, *rest)
    for g, a, w, e in zip(got, again, want, emulated, strict=True):
        assert (g is None and w is None and e is None) or (
            torch.equal(g, w) and torch.equal(a, g) and torch.equal(g.cpu(), e))


@pytest.mark.cuda
def test_segment_fold_launch_copies_nothing_from_the_host(cuda_device):
    """The search depths travel by value: the call can be captured in a
    CUDA graph (a host-to-device copy or a stream sync inside the capture
    would fail it), and a replay gives the eager result."""
    case = synthetic_fold_case(**FOLD_CASES["edges"])
    args = (torch.from_numpy(case["post_docs"]).to(cuda_device),
            torch.from_numpy(case["cells"]).to(cuda_device),
            torch.from_numpy(case["stage_seg"]).to(cuda_device), case["group_width"],
            case["stage_iters"], case["n_queries_pad"], True)
    want = ops.segment_fold(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.segment_fold(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.segment_fold(*args)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_segment_fold_chain_past_64_stages_captures_in_a_cuda_graph(cuda_device):
    """The chained launches of a 130-stage plan copy nothing from the host
    either: captured in a CUDA graph, a replay gives the eager result."""
    case = synthetic_fold_case(**FOLD_CASES["stages130"])
    args = (torch.from_numpy(case["post_docs"]).to(cuda_device),
            torch.from_numpy(case["cells"]).to(cuda_device),
            torch.from_numpy(case["stage_seg"]).to(cuda_device), case["group_width"],
            case["stage_iters"], case["n_queries_pad"], True)
    want = ops.segment_fold(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.segment_fold(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.segment_fold(*args)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, want, strict=True):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def long_docs():
    """A fit over documents long enough for queries of 70 and more terms."""
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, synth_corpus
    from repro_torch.data.query_log import synth_query_log

    corpus = synth_corpus(CorpusSpec(n_docs=600, n_terms=3000, mean_doc_len=120,
                                     n_topics=6, seed=5))
    log = synth_query_log(corpus, n_queries=60, seed=6)
    res = SecludPipeline(tc=600, doc_grained_below=128, seed=0).fit(
        corpus, k=6, log=log, levels=2, device="cpu")
    return corpus, res


def long_queries(corpus, lengths):
    """One query per entry of ``lengths``: that many terms of the longest
    documents (so each matches at least its document)."""
    lens = corpus.doc_lengths()
    lists = []
    for n, d in zip(lengths, np.argsort(-lens, kind="stable"), strict=False):
        terms = corpus.doc_terms[corpus.doc_ptr[d] : corpus.doc_ptr[d + 1]]
        assert len(terms) >= n, "the corpus has no document that long"
        lists.append([int(t) for t in terms[:n]])
    return lists


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(66,), (71, 70, 3), (131, 2)], ids=["65", "70", "130"])
def test_fold_past_64_stages_equals_plain_emulation_and_host(cuda_device, long_docs, lengths):
    """Queries of 66, 71 and 131 terms: the fold chains its launches and
    equals the plain version, the CPU emulation of its algorithm, and the
    host engine (counts and docs)."""
    from repro_torch.core.batched_query import batched_query, plan_segment_pairs
    from repro_torch.core.device_engine import device_counts, device_index, lower_plan
    from repro_torch.core.queries import ConjunctiveQueries

    corpus, res = long_docs
    cq = ConjunctiveQueries.from_lists(long_queries(corpus, lengths))
    di = device_index(res.hier_index, cuda_device)
    low = lower_plan(plan_segment_pairs(di.host, cq, track_work=False))
    assert low.n_stages == max(lengths) - 1 > 64
    host = (di.post_docs.cpu(), torch.from_numpy(low.cells), torch.from_numpy(low.stage_seg))
    rest = (low.group_width, low.stage_iters, low.n_queries_pad, True)
    before = B.LAUNCHES["segment_fold"]
    got = ops.segment_fold(di.post_docs, *(t.to(cuda_device) for t in host[1:]), *rest)
    assert B.LAUNCHES["segment_fold"] == before + K.fold_launches(low.n_stages) > before + 1
    want = ref.segment_fold_ref(*host, *rest)
    *emulated, _stats = fold_emulation(*host, *rest)
    for g, w, e in zip(got, want, emulated, strict=True):
        assert torch.equal(g.cpu(), w) and torch.equal(g.cpu(), e)
    counts, docs, _info = device_counts(res.hier_index, cq, return_docs=True, device=cuda_device)
    ptr, host_docs, _ = batched_query(res.hier_index, cq)
    np.testing.assert_array_equal(counts, np.diff(ptr))
    np.testing.assert_array_equal(docs, host_docs)
    assert counts[0] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_fold_on_slots_of_one_card_equals_single_device(cuda_device, fitted, n_shards):
    """Shards as slots of one card: one fold launch per shard and batch,
    counts and docs equal to the single-device fold and the host."""
    from repro_torch.serve.search_service import SearchService

    _corpus, log, res = fitted
    single = SearchService(res, device=cuda_device)
    sharded = SearchService(res, device=cuda_device)
    sidx = sharded.enable_sharded(devices=[cuda_device] * n_shards)
    assert sidx.n_shards == n_shards and all(t.is_cuda for t in sidx.post_docs)
    queries = log.queries
    want, want_docs, _ = single.serve_counts_device(queries, return_docs=True)
    before = B.LAUNCHES["segment_fold"]
    counts, docs, info = sharded.serve_counts_device(queries, return_docs=True)
    assert B.LAUNCHES["segment_fold"] == before + n_shards
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(docs, want_docs)
    np.testing.assert_array_equal(counts, single.serve_counts(queries)[0])
    assert info["n_shards"] == float(n_shards) and info["n_kernel_calls"] == float(n_shards)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("arity", ["pairs", "mixed"])
def test_block_path_split_over_slots_of_one_card(cuda_device, fitted, n_shards, arity):
    from repro_torch.serve.search_service import SearchService

    _corpus, log, res = fitted
    svc = SearchService(res, device=cuda_device)
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    if arity == "pairs":
        lists = [t[:2] for t in lists if len(t) >= 2 and t[0] != t[1]]
    queries = np.asarray(lists) if arity == "pairs" else log.queries
    packed = svc.pack(queries)
    before = dict(B.LAUNCHES)
    got = svc.device_counts(packed, devices=[cuda_device] * n_shards)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), svc.serve_counts(queries)[0])
    name = "intersect_count_kernel" if arity == "pairs" else "intersect_members_count_kernel"
    assert B.LAUNCHES[name] == before[name] + n_shards


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [0, 2], ids=["single", "sharded"])
def test_a_failed_fold_launch_raises_through_the_resilience_ladder(cuda_device, fitted, n_shards,
                                                                  monkeypatch):
    """On the card the ladder takes only the typed faults: a fold launch
    that reports a CUDA error propagates out of ``dispatch``, and the host
    rung never answers the batch."""
    from types import SimpleNamespace

    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.serve.resilience import ResilientDispatcher
    from repro_torch.serve.search_service import SearchService

    _corpus, log, res = fitted
    svc = SearchService(res, device=cuda_device)
    if n_shards:
        svc.enable_sharded(devices=[cuda_device] * n_shards)
    host_calls = []
    d = ResilientDispatcher(svc, host_engine=lambda q: host_calls.append(q) or svc.serve_counts(q))
    assert d.dispatch(log.queries)[2].level == "device"
    monkeypatch.setattr(K, "lib", lambda stem: SimpleNamespace(segment_fold_launch=lambda *a: 700))
    with pytest.raises(RuntimeError, match="segment_fold: CUDA launch failed with error 700"):
        d.dispatch(log.queries)
    assert host_calls == []


@pytest.mark.cuda
def test_warm_fold_counts_nothing_on_dead_cells(cuda_device, fitted):
    from repro_torch.core.device_engine import device_index, prewarm, warm_fold

    _corpus, log, res = fitted
    di = device_index(res.hier_index, cuda_device)
    keys = prewarm(res.hier_index, log.queries, batch_sizes=[1, 8, len(log.queries)])["keys"]
    before = B.LAUNCHES["segment_fold"]
    for key in keys:
        warm_fold(di, key, return_members=True)
    assert B.LAUNCHES["segment_fold"] == before + len(keys) and keys


@pytest.mark.cuda
def test_search_service_on_the_card_equals_host(cuda_device, fitted):
    from repro_torch.serve.search_service import SearchService

    _corpus, log, res = fitted
    svc = SearchService(res, device=cuda_device)
    queries = log.queries
    host, _ = svc.serve_counts(queries)
    B.reset_launch_counts()
    counts, docs, info = svc.serve_counts_device(queries, return_docs=True)
    np.testing.assert_array_equal(counts, host)
    assert info["n_kernel_calls"] == 1.0 and B.LAUNCHES["segment_fold"] == 1
    blocks = svc.device_counts(svc.pack(queries))
    assert blocks.is_cuda
    np.testing.assert_array_equal(blocks.cpu().numpy(), host)
    assert B.LAUNCHES["intersect_members_kernel"] > 0
    assert B.LAUNCHES["intersect_members_count_kernel"] == 1


def _score_inputs(rng, n, l, tc, k):
    """As chip_smoke.score_inputs: standard normal tables up to the
    reference test's L = 128, non-negative ones (as δ⁺ tables are) above,
    where mixed-sign fp32 sums cancel beyond what the tolerance bounds."""
    ell = rng.integers(0, tc, size=(n, l)).astype(np.int32)
    holes = rng.random((n, l))
    ell[holes < 0.2] = tc
    ell[(holes >= 0.2) & (holes < 0.3)] = PAD_MAX
    if n and l >= 3:
        ell[0, :] = PAD_MAX  # an all-pad row
        ell[n - 1, 1:3] = ell[n - 1, 0]  # duplicate ranks accumulate
    p = rng.random(tc).astype(np.float32)
    if l <= 128:
        tables = rng.standard_normal((tc, k)).astype(np.float32)
    else:
        tables = rng.random((tc, k)).astype(np.float32)
    return ell, p, tables


def _score_case(cuda_device, n, l, tc, k, offset_rows=0):
    """Inputs on the card; with ``offset_rows`` the ELL is a row slice of a
    larger one, so its base sits inside a 16-byte block when L is odd."""
    rng = np.random.default_rng(n + l + tc + k)
    ell, p, tables = _score_inputs(rng, n + offset_rows, l, tc, k)
    if n and l >= 3:
        ell[offset_rows, :] = PAD_MAX  # the slice's first row: all pads
    if n and l:
        ell[-1, -1] = -3  # a negative rank is a pad too
    ell_d = torch.from_numpy(ell).to(cuda_device)[offset_rows:]
    return ell_d, torch.from_numpy(p).to(cuda_device), torch.from_numpy(tables).to(cuda_device)


def _launched(before):
    return {name: B.LAUNCHES[name] - before[name] for name in SCORE_VARIANTS}


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,tc,k", SCORE_SHAPES)
def test_cluster_scores_equals_plain(cuda_device, n, l, tc, k):
    ell, p, tables = _score_case(cuda_device, n, l, tc, k, offset_rows=1 if l % 2 else 0)
    route = CK.score_route(tc, k)
    before = dict(B.LAUNCHES)
    got = cops.cluster_scores(ell, p, tables)
    torch.cuda.synchronize()
    assert B.LAUNCHES["cluster_scores_kernel"] == before["cluster_scores_kernel"] + (1 if n else 0)
    assert _launched(before) == {f"cluster_scores_{v}": int(bool(n) and v == route)
                                 for v in ("staged", "general")}
    assert got.is_cuda and got.shape == (n, k) and got.dtype == torch.float32
    want = cluster_scores_ref(ell, p, tables)
    torch.testing.assert_close(got, want, **SCORE_TOL)
    assert torch.equal(cops.cluster_scores(ell, p, tables), got)  # the same bits again
    if n and l >= 3:
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("offset_rows", [0, 1, 2, 3])
@pytest.mark.parametrize("n,l,tc,k", [c for c in SCORE_SHAPES
                                      if c[0] and CK.score_route(c[2], c[3]) == "staged"])
def test_staged_scores_are_the_emulated_sums_bit_for_bit(cuda_device, n, l, tc, k, offset_rows):
    """The staged variant adds the same fp32 values in the same order as
    ``_torch_parity.staged_scores_emulation`` (16-byte blocks to lanes,
    slot order in a lane, xor tree), whatever the ELL's base alignment."""
    ell, p, tables = _score_case(cuda_device, n, l, tc, k, offset_rows=offset_rows)
    got = CK.cluster_scores_cuda(ell, p, tables, variant="staged")
    mis = (ell.data_ptr() // 4) % 4
    want = staged_scores_emulation(ell.cpu(), p.cpu(), tables.cpu(), base_misalignment=mis)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cluster_scores_is_deterministic(cuda_device):
    rng = np.random.default_rng(9)
    ell, p, tables = (torch.from_numpy(a).to(cuda_device)
                      for a in _score_inputs(rng, 500, 200, 3000, 8))
    for variant in ("staged", "general"):
        assert torch.equal(CK.cluster_scores_cuda(ell, p, tables, variant=variant),
                           CK.cluster_scores_cuda(ell, p, tables, variant=variant))


BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_sm90",
               "flash_bwd_dq_sm90", "flash_bwd_resident")
BWD_ROUTE_KERNELS = {"sm90": ("flash_bwd_prep", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"),
                     "general": ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq"),
                     "resident": ("flash_bwd_resident",)}
SM90_BWD_CASES = [c for c in FLASH_BWD_CASES if c[5] in FK.SM90_HEAD_DIMS]


def _bwd_case(cuda_device, dtype, b, h, hkv, lq, lk, d, seed):
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=seed,
                           model_layout=lk % 2 == 0)
    gen = torch.Generator(device=cuda_device).manual_seed(seed + 1)
    return q, k, v, torch.randn(q.shape, generator=gen, device=cuda_device).to(dtype)


def _plain_terms(q, k, v, out, dout, causal, window):
    """The plain backward's lse and delta and the sm90 route's rounding term."""
    lse, delta = bwd_prep_ref(q.float(), k.float(), out.float(), dout.float(), causal, window)
    return lse, delta, bwd_rounding_terms(q, k, v, dout, lse, delta, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", FLASH_BWD_CASES)
def test_flash_attention_backward_equals_plain(cuda_device, dtype, b, h, hkv, lq, lk, d, causal,
                                               window):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _bwd_case(cuda_device, dtype, b, h, hkv, lq, lk, d, 3 * lq + lk + d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    route = FK.bwd_route(dtype, h, hkv, lq, lk, d, causal, window)
    out = flash_attention(q, k, v, causal=causal, window=window)
    before = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert {n: B.LAUNCHES[n] - before[n] for n in BWD_KERNELS} == {
        n: int(n in BWD_ROUTE_KERNELS[route]) for n in BWD_KERNELS}
    qf, kf, vf, of = (t.detach().float() for t in (q, k, v, out))
    want = attention_bwd_ref(qf, kf, vf, of, dout.float(), causal, window)
    terms = (_plain_terms(q.detach(), k.detach(), v.detach(), of, dout, causal, window)[2]
             if route == "sm90" else (None, None, None))
    for name, g, w, x, t in zip(("dq", "dk", "dv"), got, want, (q, k, v), terms, strict=True):
        assert g.dtype == dtype and g.shape == x.shape
        flash_bwd_close(name, g, w, t)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", SM90_BWD_CASES)
def test_sm90_backward_kernels_equal_their_plain_parts(cuda_device, b, h, hkv, lq, lk, d, causal,
                                                       window):
    """dkdv and dq alone against ``bwd_dkdv_ref`` and ``bwd_dq_ref`` fed the
    same lse and delta (prep's, recomputed); prep given the forward's lse
    computes delta alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _bwd_case(cuda_device, torch.bfloat16, b, h, hkv, lq, lk, d, lq + 7 * d)
    out, lse_fwd = FK.flash_attention_lse_cuda(q, k, v, causal, window)
    lse, delta = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v)
    _, _, terms = _plain_terms(q, k, v, out, dout, causal, window)
    before = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
    dk, dv = FK.bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal, window)
    dq = FK.bwd_dq_sm90_cuda(q, k, v, dout, lse, delta, causal, window)
    torch.cuda.synchronize()
    assert {n: B.LAUNCHES[n] - before[n] for n in BWD_KERNELS} == {
        n: int(n in ("flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")) for n in BWD_KERNELS}
    args = (q.float(), k.float(), v.float(), dout.float(), lse, delta, causal, window)
    want_dk, want_dv = bwd_dkdv_ref(*args)
    flash_bwd_close("dk", dk, want_dk.float(), terms[1])
    flash_bwd_close("dv", dv, want_dv.float(), terms[2])
    flash_bwd_close("dq", dq, bwd_dq_ref(*args).float(), terms[0])
    if lse_fwd is not None:
        same, delta2 = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse_fwd)
        assert same is lse_fwd
        torch.testing.assert_close(delta2, delta, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", SM90_BWD_CASES[:4])
def test_sm90_backward_is_deterministic(cuda_device, b, h, hkv, lq, lk, d, causal, window):
    q, k, v, dout = _bwd_case(cuda_device, torch.bfloat16, b, h, hkv, lq, lk, d, 11)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, causal, window)
    first = FK.flash_attention_bwd_cuda(q, k, v, out, dout, causal, window, lse=lse)
    second = FK.flash_attention_bwd_cuda(q, k, v, out, dout, causal, window, lse=lse)
    for a, b_ in zip(first, second, strict=True):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d", [(8193, 8, 4, 40, 40, 64), (70000, 2, 2, 16, 16, 128)])
def test_sm90_backward_past_one_launch_chunk(cuda_device, b, h, hkv, lq, lk, d):
    """B·H past the 65,535 pairs of one launch chunk of the general kernels:
    the sm90 kernels put the pairs on gridDim.x, which takes them all (the
    second case gives both kernels 140,000 blocks along it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _bwd_case(cuda_device, torch.bfloat16, b, h, hkv, lq, lk, d, 5)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, True, None)
    assert lse is not None
    before = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
    got = FK.flash_attention_bwd_cuda(q, k, v, out, dout, True, None, lse=lse)
    torch.cuda.synchronize()
    assert {n: B.LAUNCHES[n] - before[n] for n in BWD_KERNELS} == {
        n: int(n in BWD_ROUTE_KERNELS["sm90"]) for n in BWD_KERNELS}
    want = attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), dout.float(), True)
    terms = _plain_terms(q, k, v, out, dout, True, None)[2]
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, terms, strict=True):
        flash_bwd_close(name, g, w, t)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window",
                         [c for c in FLASH_CASES
                          if FK.flash_route(torch.bfloat16, *c[1:]) == "sm90"])
def test_sm90_forward_lse_equals_the_plain_lse(cuda_device, b, h, hkv, lq, lk, d, causal, window):
    q, k, v = flash_inputs(cuda_device, torch.bfloat16, b, h, hkv, lq, lk, d, seed=lq + d,
                           model_layout=lk % 2 == 0)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, causal, window)
    assert torch.equal(out, FK.flash_attention_cuda(q, k, v, causal, window))
    assert lse.dtype == torch.float32 and lse.shape == (b * h, lq) and lse.is_contiguous()
    rows = max(1, 2**30 // (4 * h * lq * lk))  # the plain scores in batch chunks
    want = torch.cat([bwd_prep_ref(q[c0:c0 + rows].float(), k[c0:c0 + rows].float(),
                                   out[c0:c0 + rows].float(), out[c0:c0 + rows].float(), causal,
                                   window)[0] for c0 in range(0, b, rows)])
    rtol, atol = FLASH_BWD_TOL["float32"]
    torch.testing.assert_close(lse, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_sm90_backward_refuses_misaligned_bases_and_strides(cuda_device):
    q, k, v, dout = _bwd_case(cuda_device, torch.bfloat16, 1, 4, 2, 64, 64, 64, 2)
    lse = torch.zeros((4, 64), device=cuda_device)
    wide = torch.zeros((1, 4, 64, 68), dtype=torch.bfloat16, device=cuda_device)[..., :64]
    flat = torch.zeros(4 * 64 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(1, 4, 64, 64)  # base 2 bytes past 16
    for fn in (FK.bwd_dkdv_sm90_cuda, FK.bwd_dq_sm90_cuda):
        with pytest.raises(ValueError, match="16-byte"):
            fn(wide, k, v, dout, lse, lse)
        with pytest.raises(ValueError, match="16-byte"):
            fn(shifted, k, v, dout, lse, lse)
        with pytest.raises(ValueError, match="lse and delta"):
            fn(q, k, v, dout, lse[:, :63], lse)


def _resident_bwd_call(q, k, v, dout):
    """The resident forward's output and lse, then the resident backward
    alone, its launches read from the counters."""
    out, lse = FK.flash_attention_lse_cuda(q, k, v, False, None)
    assert lse is not None
    before = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
    got = FK.flash_attention_bwd_cuda(q, k, v, out, dout, False, None, lse=lse)
    torch.cuda.synchronize()
    assert {n: B.LAUNCHES[n] - before[n] for n in BWD_KERNELS} == {
        n: int(n == "flash_bwd_resident") for n in BWD_KERNELS}
    return out, lse, got


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d", RESIDENT_BWD_CASES)
def test_resident_backward_equals_plain(cuda_device, b, h, hkv, lq, lk, d):
    """One launch of ``flash_bwd_resident`` a call, given the resident
    forward's lse, within ``FLASH_BWD_TOL``; a rerun gives the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _bwd_case(cuda_device, torch.float32, b, h, hkv, lq, lk, d, lq + 3 * d)
    assert FK.bwd_route(torch.float32, h, hkv, lq, lk, d, False, None) == "resident"
    out, lse, got = _resident_bwd_call(q, k, v, dout)
    want = attention_bwd_ref(q, k, v, out, dout, False, None)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v), strict=True):
        assert g.shape == x.shape and g.stride() == torch.empty_like(x).stride()
        flash_bwd_close(name, g, w)
    again = FK.bwd_resident_cuda(q, k, v, out, dout, lse)
    for a, b_ in zip(got, again, strict=True):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_resident_backward_past_one_launch_chunk(cuda_device):
    """B·Hkv = 65,537: two launches of the kernel, one call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _bwd_case(cuda_device, torch.float32, 65537, 1, 1, 16, 16, 32, 6)
    out, _, got = _resident_bwd_call(q, k, v, dout)
    want = attention_bwd_ref(q, k, v, out, dout, False, None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        flash_bwd_close(name, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d", [(1, 8, 1, 200, 200, 64), (2, 2, 2, 800, 800, 32)])
def test_resident_forward_with_the_general_backward(cuda_device, b, h, hkv, lq, lk, d):
    """fp32 calls whose K and V fit the resident forward but whose group's
    Q and dO do not fit the resident backward: the autograd backward takes
    the general kernels, prep computes delta alone from the forward's lse,
    and the gradients are within ``FLASH_BWD_TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert FK.flash_route(torch.float32, h, hkv, lq, lk, d, False, None) == "resident"
    assert FK.bwd_route(torch.float32, h, hkv, lq, lk, d, False, None) == "general"
    q, k, v, dout = _bwd_case(cuda_device, torch.float32, b, h, hkv, lq, lk, d, lq + d)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, False, None)
    assert lse is not None
    same, delta = FK.bwd_prep_cuda(q, k, out, dout, False, None, v=v, lse=lse)
    assert same is lse
    torch.testing.assert_close(delta, FK.bwd_prep_cuda(q, k, out, dout, False, None, v=v)[1],
                               rtol=0, atol=0)
    # The route's gradients are those of dK/dV and dQ fed the forward's lse.
    given = (*FK.bwd_dkdv_cuda(q, k, v, dout, lse, delta, False, None),
             FK.bwd_dq_cuda(q, k, v, dout, lse, delta, False, None))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
    got = torch.autograd.grad(flash_attention(*leaves, causal=False), leaves, dout)
    torch.cuda.synchronize()
    assert {n: B.LAUNCHES[n] - before[n] for n in BWD_KERNELS} == {
        n: int(n in BWD_ROUTE_KERNELS["general"]) for n in BWD_KERNELS}
    for g, w in zip(got, (given[2], given[0], given[1]), strict=True):
        assert torch.equal(g, w)
    want = attention_bwd_ref(q, k, v, out, dout, False, None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        flash_bwd_close(name, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window",
                         [c for c in FLASH_CASES
                          if FK.flash_route(torch.float32, *c[1:]) == "resident"])
def test_resident_forward_lse_equals_the_plain_lse(cuda_device, b, h, hkv, lq, lk, d, causal,
                                                   window):
    """The forward asked for its lse writes the same output as without it,
    and each row's log-sum-exp within ``FLASH_BWD_TOL["float32"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, torch.float32, b, h, hkv, lq, lk, d, seed=lq + d,
                           model_layout=lk % 2 == 0)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, causal, window)
    assert torch.equal(out, FK.flash_attention_cuda(q, k, v, causal, window))
    assert lse.dtype == torch.float32 and lse.shape == (b * h, lq) and lse.is_contiguous()
    want = bwd_prep_ref(q, k, out, out, causal, window)[0]
    rtol, atol = FLASH_BWD_TOL["float32"]
    torch.testing.assert_close(lse, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_resident_backward_refuses_misaligned_bases_and_strides(cuda_device):
    q, k, v, dout = _bwd_case(cuda_device, torch.float32, 2, 2, 2, 40, 40, 32, 2)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, False, None)
    shifted = torch.zeros(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    wide = torch.zeros((2, 2, 40, 33), device=cuda_device)[..., :32]
    before = dict(B.LAUNCHES)
    for bad in ((shifted, k, v, out, dout), (q, wide, v, out, dout), (q, k, v, out, wide)):
        with pytest.raises(ValueError, match="16-byte"):
            FK.bwd_resident_cuda(*bad, lse)
    with pytest.raises(ValueError, match="lse"):
        FK.bwd_resident_cuda(q, k, v, out, dout, lse[:, :39])
    assert B.LAUNCHES == before  # refused before any launch, no fallback


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", FLASH_CASES)
def test_flash_attention_equals_plain(cuda_device, dtype, b, h, hkv, lq, lk, d, causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=lq + lk + d,
                           model_layout=lk % 2 == 0)
    route = FK.flash_route(dtype, h, hkv, lq, lk, d, causal, window)
    before = dict(B.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention_kernel"] == before["flash_attention_kernel"] + 1
    launched = {n: B.LAUNCHES[n] - before[n] for n in FLASH_VARIANTS}
    assert launched == {n: VARIANT_LAUNCHES[route].get(n, 0) for n in FLASH_VARIANTS}
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    extra = p_rounding_term(q, k, v, causal, window) if route == "sm90" else None
    flash_close(got, attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window),
                extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window",
                         [c for c in FLASH_CASES
                          if FK.flash_route(torch.bfloat16, *c[1:]) == "decode"])
def test_flash_decode_kernels_equal_their_plain_versions(cuda_device, dtype, b, h, hkv, lq, lk, d,
                                                         causal, window):
    """The split kernel's partials against ``decode_partials_ref`` (fp32
    sums in another order: rtol 1e-4, atol 1e-4 of the largest |acc|), and
    the combine kernel on the plain partials against ``combine_ref``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=lk + d, model_layout=True)
    plan = FK.decode_plan(lq, lk, window, b * hkv,
                          torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    ml, acc = FK.decode_partials_cuda(q, k, v, causal, window, plan)
    want_ml, want_acc = decode_partials_ref(q, k, v, causal, window, plan)
    torch.testing.assert_close(ml, want_ml, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-4 * float(want_acc.abs().max()))
    out = torch.empty_like(q)
    FK.combine_cuda(want_ml, want_acc, out, hkv)
    want = combine_ref(want_ml, want_acc, b, h, hkv, lq, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    else:  # one rounding to bf16 of nearly the same fp32 value
        torch.testing.assert_close(out.float(), want, rtol=2**-8, atol=1e-5)


def _offset_view(shape, dtype, device, offset):
    """A dense (B, H, L, D) view starting ``offset`` elements into a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype, device=device)[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,h,hkv,d,dtype", [(1, 8, 4, 256, torch.bfloat16),
                                              (1, 4, 4, 64, torch.float32),
                                              (128, 8, 4, 256, torch.bfloat16)],
                         ids=["decode_bf16", "decode_f32", "sm90"])
def test_flash_attention_refuses_misaligned_bases_and_strides(cuda_device, lq, h, hkv, d, dtype):
    lk = 200
    route = FK.flash_route(dtype, h, hkv, lq, lk, d, True, None)
    q = torch.zeros((1, h, lq, d), dtype=dtype, device=cuda_device)
    k = torch.zeros((1, hkv, lk, d), dtype=dtype, device=cuda_device)
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(_offset_view(q.shape, dtype, cuda_device, 1), k, k)
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(q, _offset_view(k.shape, dtype, cuda_device, 1), k)
    # a position stride of D + 1 elements
    wide = torch.zeros((1, hkv, lk, d + 1), dtype=dtype, device=cuda_device)[..., :d]
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(q, k, wide)
    assert B.LAUNCHES == before  # refused before any launch, no fallback


@pytest.mark.cuda
def test_flash_attention_window_of_one_is_the_value_of_the_own_key(cuda_device):
    q, k, v = flash_inputs(cuda_device, torch.float32, 1, 2, 2, 20, 50, 64, seed=3)
    got = flash_attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(got, v[:, :, 30:], rtol=1e-6, atol=1e-6)


# Past gridDim.y's 65,535: (variant, dtype, B, H, Hkv, Lq, Lk, D, causal).
# Every variant at B·H = 65,536 and 131,072 (the decode variant's grid
# rows are B·Hkv, sm90's B·Hkv when it pairs the two heads of a group):
# resident at BERT4Rec's shape (fp32, D = 32, 200 positions, not causal)
# and at B·H = 65,542 (a launch of 65,535 pairs and one of 7), general at
# the same shape made causal, decode at bf16 D = 128, sm90 at bf16 D = 64
# with 64 positions, unpaired and paired.
BIG_BH_CASES = [
    ("general", torch.float32, 32768, 2, 2, 200, 200, 32, True),
    ("general", torch.float32, 65536, 2, 2, 200, 200, 32, True),
    ("resident", torch.float32, 32768, 2, 2, 200, 200, 32, False),
    ("resident", torch.float32, 32771, 2, 2, 200, 200, 32, False),
    ("resident", torch.float32, 65536, 2, 2, 200, 200, 32, False),
    ("decode", torch.bfloat16, 65536, 1, 1, 1, 100, 128, True),
    ("decode", torch.bfloat16, 65536, 2, 2, 1, 100, 128, True),
    ("sm90", torch.bfloat16, 65536, 1, 1, 64, 64, 64, True),
    ("sm90", torch.bfloat16, 65536, 2, 2, 64, 64, 64, True),
    ("sm90", torch.bfloat16, 131072, 2, 1, 64, 64, 64, True),
]


def _check_flash_call(q, k, v, causal, variant):
    """One ``flash_attention`` call through ``variant`` (read from the
    counters) held to ``FLASH_TOL`` of the plain version in float32 (over
    chunks of query rows, ``attention_ref_chunked``), plus
    ``p_rounding_term`` on sm90."""
    assert FK.flash_route(q.dtype, q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                          causal, None) == variant
    before = dict(B.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    launched = {n: B.LAUNCHES[n] - before[n] for n in FLASH_VARIANTS}
    assert launched == {n: VARIANT_LAUNCHES[variant].get(n, 0) for n in FLASH_VARIANTS}
    want = attention_ref_chunked(q.float(), k.float(), v.float(), causal)
    extra = p_rounding_term(q, k, v, causal, None) if variant == "sm90" else None
    flash_close(got, want, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype,b,h,hkv,lq,lk,d,causal", BIG_BH_CASES,
                         ids=[f"{c[0]}-bh{c[2] * c[3]}-hkv{c[4]}" for c in BIG_BH_CASES])
def test_flash_attention_past_65535_batch_heads(cuda_device, variant, dtype, b, h, hkv, lq, lk,
                                                d, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=b + h + hkv + d)
    _check_flash_call(q, k, v, causal, variant)


@pytest.mark.cuda
def test_flash_attention_at_bert4recs_call(cuda_device):
    """BERT4Rec's encoder call at a serving slice of 32,768 rows: q, k, v
    (32768, 2, 200, 32) float32 as the model hands them, (B, H, L, D) views
    of (B, L, H, D) buffers, bidirectional: the resident variant, and the
    general kernel forced on the same inputs, each within ``FLASH_TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, torch.float32, 32768, 2, 2, 200, 200, 32, seed=4,
                           model_layout=True)
    _check_flash_call(q, k, v, False, "resident")
    before = B.LAUNCHES["flash_attention_general"]
    got = FK._general_forced(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention_general"] == before + 1
    flash_close(got, attention_ref_chunked(q.float(), k.float(), v.float(), False))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32768, 32771], ids=["bh65536", "bh65542"])
def test_flash_attention_resident_equals_plain_at_bert4recs_call(cuda_device, b):
    """The resident variant within ``FLASH_TOL`` of its plain version at
    BERT4Rec's call in the model's layout, at a bulk slice's B·H = 65,536
    and at 65,542, past one launch's 65,535 (batch, head) pairs; a second
    call gives the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, torch.float32, b, 2, 2, 200, 200, 32, seed=b,
                           model_layout=True)
    before = dict(B.LAUNCHES)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    launched = {n: B.LAUNCHES[n] - before[n] for n in FLASH_VARIANTS}
    assert launched == {n: VARIANT_LAUNCHES["resident"].get(n, 0) for n in FLASH_VARIANTS}
    assert got.stride() == q.stride()
    flash_close(got, attention_ref_chunked(q.float(), k.float(), v.float(), False))
    assert torch.equal(flash_attention(q, k, v, causal=False), got)


@pytest.mark.cuda
def test_flash_attention_resident_refuses_misaligned_bases_and_strides(cuda_device):
    q = torch.zeros((2, 2, 200, 32), dtype=torch.float32, device=cuda_device)
    assert FK.flash_route(q.dtype, 2, 2, 200, 200, 32, False, None) == "resident"
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match="resident variant needs 16-byte aligned"):
        flash_attention(_offset_view(q.shape, q.dtype, cuda_device, 1), q, q, causal=False)
    wide = torch.zeros((2, 2, 200, 33), dtype=q.dtype, device=cuda_device)[..., :32]
    with pytest.raises(ValueError, match="resident variant needs 16-byte aligned"):
        flash_attention(q, wide, q, causal=False)
    assert B.LAUNCHES == before  # refused before any launch, no fallback


# (tokens, d_model, d_expert, experts, top_k, capacity factor): the SMOKE
# configs' routing (8 of top 2), qwen3-moe-30b-a3b's (128 of top 8) at a
# decode batch (capacity 1, most slots dropped) and a prefill chunk.
MOE_CARD_CASES = [(64, 64, 64, 8, 2, 1.25), (8, 256, 96, 128, 8, 1.25),
                  (512, 256, 96, 128, 8, 1.25), (96, 128, 64, 16, 2, 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,f,e,top_k,cf", MOE_CARD_CASES)
def test_moe_apply_on_the_card_equals_its_cpu_run(cuda_device, t, d, f, e, top_k, cf):
    """float32, TF32 off.  The router's logits round apart between the two
    devices' float32 products, so a token's experts may differ only at a
    near-tie (the CPU run's probabilities of the two within 1e-6); every
    token whose experts and keep flags agree has its output within
    rtol=atol=1e-5 (sums in another order)."""
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = L.MoE(d, f, e, top_k, cf, "silu", torch.float32, "cpu")
    gen = torch.Generator().manual_seed(t + e)
    cpu.router.reset(gen)
    cpu.reset(gen)
    card = L.MoE(d, f, e, top_k, cf, "silu", torch.float32, cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((t, d), generator=gen)
    want, want_aux, want_r = L.moe_apply(cpu, x, top_k, cf)
    got, aux, got_r = L.moe_apply(card, x.to(cuda_device), top_k, cf)
    probs = torch.softmax(cpu.router(x), dim=-1)
    got_e, got_k = got_r.experts.cpu(), got_r.keep.cpu()
    for i, j in (got_e != want_r.experts).nonzero().tolist():
        gap = float(probs[i, want_r.experts[i, j]] - probs[i, got_e[i, j]])
        assert abs(gap) <= 1e-6, f"token {i} slot {j}: experts differ beyond a near-tie"
    same = ((got_e == want_r.experts) & (got_k == want_r.keep)).all(dim=1)
    assert int(same.sum()) >= t - 2
    torch.testing.assert_close(got.cpu()[same], want[same], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)
    # the card's dispatch adds in a fixed order: a second run is bit-equal
    again, _, again_r = L.moe_apply(card, x.to(cuda_device), top_k, cf)
    assert torch.equal(again, got) and torch.equal(again_r.keep, got_r.keep)


# The mesh decode (``layers._flash_decode``) on slots of the card: (mesh
# dims, batch, cache positions, H, Hkv, D, dtype, int8 cache, length,
# window).  Shards after the query's hold no visible key, and with a
# window so do those wholly before it; one case writes on a shard boundary.
MESH_DECODE_CASES = [((1, 4), 4, 64, 8, 4, 128, torch.bfloat16, False, 37, None),
                     ((1, 4), 4, 64, 8, 1, 128, torch.bfloat16, True, 40, 20),
                     ((2, 4), 4, 64, 4, 4, 64, torch.float32, False, 32, None),
                     ((2, 4), 1, 64, 16, 2, 128, torch.bfloat16, True, 50, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,b,s,h,hkv,d,dtype,quantized,length,window", MESH_DECODE_CASES)
def test_mesh_decode_on_the_card_equals_its_plain_version(cuda_device, dims, b, s, h, hkv, d,
                                                          dtype, quantized, length, window):
    """The split kernel once per shard with visible keys and one combine.
    The output within ``FLASH_TOL`` of the plain attention in float32 over
    the visible prefix of its own cache as the layer reads it (an int8
    cache dequantized to the activation dtype), as is the same function's
    plain version on CPU slots; the cache written as that plain version
    writes it.  An int8 scale may lie one unit in the last place from the
    plain version's (on the card PyTorch takes ``amax / 127.0``, a
    division by a host scalar, as a multiply by its reciprocal); a row
    whose scale is equal has equal codes, one with a scale 1 ulp apart
    codes within one step."""
    from repro_torch.dist import sharding as sh
    from repro_torch.dist.fault_tolerance import ElasticMesh
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(length)
    q, kn, vn = (torch.randn((b, 1, n, d), generator=gen).to(dtype) for n in (h, hkv, hkv))
    k, v = (torch.randn((b, s, hkv, d), generator=gen).to(dtype) for _ in range(2))
    caches = {}
    for where, dev in (("card", cuda_device), ("plain", "cpu")):
        if quantized:
            (kq, ks), (vq, vs) = L._quantize(k), L._quantize(v)
            caches[where] = L.KVCache(kq.to(dev), vq.to(dev), ks.to(dev), vs.to(dev), length)
        else:
            caches[where] = L.KVCache(k.to(dev), v.to(dev), length=length)
    visible = sum(min(p1, length + 1) > max(p0, length - window + 1 if window else p0)
                  for _, _, _, p0, p1 in L.decode_shards(
                      ElasticMesh(dims[1]).remesh(["cpu"] * (dims[0] * dims[1])), b, s))
    try:
        sh.set_mesh(ElasticMesh(dims[1]).remesh([cuda_device] * (dims[0] * dims[1])))
        assert L._flash_decode_applicable(caches["card"], b)
        B.reset_launch_counts()
        got = L._flash_decode(q.to(cuda_device), kn.to(cuda_device), vn.to(cuda_device),
                              caches["card"], window)
        torch.cuda.synchronize()
        launches = {n: B.LAUNCHES[n] for n in FLASH_VARIANTS}
        sh.set_mesh(ElasticMesh(dims[1]).remesh(["cpu"] * (dims[0] * dims[1])))
        plain = L._flash_decode(q, kn, vn, caches["plain"], window)
    finally:
        sh.set_mesh(None)
    assert 0 < visible < dims[0] * dims[1]
    assert launches == {"flash_attention_decode": visible, "flash_attention_combine": 1,
                        "flash_attention_sm90": 0, "flash_attention_resident": 0,
                        "flash_attention_general": 0}
    for name, out in (("card", got), ("plain", plain)):
        keys, values = L.cache_read(caches[name], dtype)
        want = attention_ref(q.float().transpose(1, 2).to(out.device),
                             keys.float().transpose(1, 2), values.float().transpose(1, 2),
                             causal=True, window=window)
        try:
            flash_close(out.transpose(1, 2), want)
        except AssertionError as exc:
            raise AssertionError(f"the {name} mesh decode: {exc}") from exc
    card, plain_cache = caches["card"], caches["plain"]
    assert card.length == plain_cache.length == length + 1
    if not quantized:
        assert torch.equal(card.k.cpu(), plain_cache.k) and torch.equal(card.v.cpu(), plain_cache.v)
        return
    for codes, scale in (("k", "k_scale"), ("v", "v_scale")):
        a, w = getattr(card, scale).cpu(), getattr(plain_cache, scale)
        same = a == w
        torch.testing.assert_close(a, w, rtol=2**-23, atol=0)  # 1 ulp at most
        ca, cw = getattr(card, codes).cpu().int(), getattr(plain_cache, codes).int()
        assert torch.equal(ca[same], cw[same]), codes
        assert int((ca - cw).abs().max()) <= 1, codes


def _aggregate_on_card(dev, hs, hd, src, dst, w, n, run_edges):
    """The kernel pair against the float64 reference on the card, on one
    graph (numpy inputs), through ``_torch_parity.AggregateCheck``; returns
    the shares of the limits."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    csr = edge_csr(t(src), t(dst), t(w), n)
    grads = [t(g) for g in aggregate_grads(7, n, hs.shape[1])]
    a, b = t(hs).requires_grad_(True), t(hd).requires_grad_(True)
    B.reset_launch_counts()
    got = segment_aggregate(a, b, csr, run_edges)
    torch.autograd.backward(got[:4], grads)
    torch.cuda.synchronize()
    assert (B.LAUNCHES["segment_aggregate_fwd"], B.LAUNCHES["segment_aggregate_bwd"]) == (1, 1)
    saved = AK.segment_aggregate_fwd_cuda(t(hs), t(hd), csr, run_edges)
    again = AK.segment_aggregate_fwd_cuda(t(hs), t(hd), csr, run_edges)
    for x, y in zip(saved, again, strict=True):
        assert torch.equal(x, y)  # the same bits run to run
    for x, y in zip(got, saved, strict=False):
        assert torch.equal(x.detach(), y)
    check = AggregateCheck(t(hs), a.grad)
    check.add(t(hd), csr.src, csr.dst, csr.w, grads, (*saved[:7],), b.grad)
    shares = check.finish()["shares"]
    assert check.within(), shares
    return shares


@pytest.mark.cuda
@pytest.mark.parametrize("case", AGGREGATE_CASES, ids=lambda c: f"seed{c[0]}_d{c[3]}_run{c[4]}")
def test_segment_aggregate_equals_plain(cuda_device, case):
    seed, n, e, d, run_edges = case
    _aggregate_on_card(cuda_device, *aggregate_inputs(seed, n, e, d), n, run_edges)


@pytest.mark.cuda
def test_segment_aggregate_past_a_million_edges_into_one_node(cuda_device):
    n, e, d = 3000, 1_200_000, 75
    hs, hd, src, dst, w = aggregate_inputs(11, n, e, d)
    dst[: 1_050_000] = 0  # node 0 spans ~1,026 runs of 1,024 edges
    _aggregate_on_card(cuda_device, hs, hd, src, dst, w, n, AK.RUN_EDGES)


@pytest.mark.cuda
@pytest.mark.parametrize("edges", [0, 5000], ids=["no_edges", "all_masked"])
def test_segment_aggregate_with_every_degree_zero(cuda_device, edges):
    n, d = 200, 16
    hs, hd, src, dst, w = aggregate_inputs(12, n, max(edges, 1), d)
    src, dst, w = src[:edges], dst[:edges], np.zeros(edges, np.float32)
    _aggregate_on_card(cuda_device, hs, hd, src, dst, w, n, 64)


@pytest.mark.cuda
def test_segment_aggregate_past_128_features(cuda_device):
    """d = 150: the forward walks each run once for every 32 features, the
    backward (4 a lane) twice, the second time for the last 22."""
    hs, hd, src, dst, w = aggregate_inputs(13, 400, 20000, 150)
    _aggregate_on_card(cuda_device, hs, hd, src, dst, w, 400, 64)
