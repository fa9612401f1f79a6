"""The CUDA kernels of the port against their plain PyTorch versions.

The ``cuda`` tests need the card and skip without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The search kernels' outputs are integers: kernel and plain version must
be equal.  The δ⁺ scores of ``cluster_scores`` are fp32 sums over at most
L terms, taken in another order than the plain version's, so they must
agree within ``rtol=2e-5, atol=1e-5`` (the tolerance of the reference's
``tests/test_kernels_cluster_score.py``).  The tests without the marker
check, on any machine, that a launcher refuses what its kernel does not
take and that a missing compiler raises.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import make_rows
from repro_torch.kernels import build as B
from repro_torch.kernels.cluster_score import kernel as CK
from repro_torch.kernels.cluster_score import ops as cops
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref
from repro_torch.kernels.intersect import kernel as K
from repro_torch.kernels.intersect import ops, ref
from repro_torch.kernels.intersect.ref import PAD

SHAPES = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512), (3, 257, 1000),
          (4, 33, 0), (0, 8, 8), (6, 0, 5), (7, 1, 1)]
# (N, L, TC, K): the reference test's shapes, empty and narrow ones, a K
# above 256 (column chunks), and the path's L = 742, TC = 3000 at the top
# TopDown split's K = 8 and the flat algorithm's K = 256.
SCORE_SHAPES = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
                (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
                (300, 742, 3000, 8), (300, 742, 3000, 256)]
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,tc,k", SCORE_SHAPES)
def test_cluster_scores_equals_plain(cuda_device, n, l, tc, k):
    rng = np.random.default_rng(n + l + tc + k)
    ell, p, tables = (torch.from_numpy(a).to(cuda_device) for a in _score_inputs(rng, n, l, tc, k))
    before = B.LAUNCHES["cluster_scores_kernel"]
    got = cops.cluster_scores(ell, p, tables)
    torch.cuda.synchronize()
    assert B.LAUNCHES["cluster_scores_kernel"] == before + (1 if n else 0)
    assert got.is_cuda and got.shape == (n, k) and got.dtype == torch.float32
    want = cluster_scores_ref(ell, p, tables)
    torch.testing.assert_close(got, want, **SCORE_TOL)
    if n and l >= 3:
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
def test_cluster_scores_is_deterministic(cuda_device):
    rng = np.random.default_rng(9)
    ell, p, tables = (torch.from_numpy(a).to(cuda_device)
                      for a in _score_inputs(rng, 500, 200, 3000, 8))
    assert torch.equal(cops.cluster_scores(ell, p, tables), cops.cluster_scores(ell, p, tables))
