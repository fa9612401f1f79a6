"""The port's runtime sanitizers (``repro_torch.analysis.sanitize``): the
guard catches the implicit host<->device conversions and lets the
explicit transfers through, restores everything on exit or exception, a
warm ``device_counts(device="cpu")`` (and the warm block path of the
search service) runs clean inside it with the counts of the JAX
package's engine, and the compile counter stays constant over the
quantization grid's drifting batch sizes (nothing is compiled per
shape).  On the card the same guard adds
``torch.cuda.set_sync_debug_mode("error")``; ``chip_smoke.py`` holds the
warm fold there and plants a ``.item()`` that must raise."""

import numpy as np
import pytest
import torch

from repro.core.cluster_index import build_cluster_index as ref_build_cluster_index
from repro.core.device_engine import device_counts as ref_device_counts
from repro.core.queries import ConjunctiveQueries as RefQueries
from repro.data.corpus import Corpus as RefCorpus
from repro.index.build import build_index as ref_build_index
from repro.index.build import permute_docs as ref_permute_docs
from repro_torch.analysis.sanitize import (ImplicitTransferError, jit_cache_size,
                                           no_implicit_transfers)
from repro_torch.core.batched_query import batched_query
from repro_torch.core.cluster_index import build_cluster_index
from repro_torch.core.device_engine import _quantize, device_counts, device_fold, device_index
from repro_torch.core.queries import ConjunctiveQueries
from repro_torch.core.reorder import cluster_ranges, reorder_permutation
from repro_torch.data.corpus import Corpus
from repro_torch.index.build import build_index, permute_docs


def _corpus_arrays():
    rng = np.random.default_rng(42)
    n_docs, n_terms, k = 220, 90, 6
    rows, ptr = [], [0]
    for _ in range(n_docs):
        r = np.unique(rng.integers(0, n_terms, 18))
        rows.append(r)
        ptr.append(ptr[-1] + len(r))
    assign = rng.integers(0, k, n_docs)
    return np.asarray(ptr, np.int64), np.concatenate(rows).astype(np.int32), n_terms, assign, k


@pytest.fixture(scope="module")
def cidx():
    ptr, terms, n_terms, assign, k = _corpus_arrays()
    corpus = Corpus(doc_ptr=ptr, doc_terms=terms, n_terms=n_terms)
    perm = reorder_permutation(assign, k)
    return build_cluster_index(permute_docs(build_index(corpus), perm), cluster_ranges(assign, k))


@pytest.fixture(scope="module")
def ref_cidx():
    ptr, terms, n_terms, assign, k = _corpus_arrays()
    corpus = RefCorpus(doc_ptr=ptr, doc_terms=terms, n_terms=n_terms)
    perm = reorder_permutation(assign, k)
    return ref_build_cluster_index(ref_permute_docs(ref_build_index(corpus), perm),
                                   cluster_ranges(assign, k))


def _lists(rng, n_q, n_terms, max_arity=4):
    return [rng.integers(0, n_terms, int(rng.integers(1, max_arity + 1))).tolist()
            for _ in range(n_q)]


def test_guard_catches_implicit_transfers():
    x = torch.arange(8, dtype=torch.int32)
    h = np.arange(8, dtype=np.int32)
    with no_implicit_transfers():
        for implicit in (lambda: np.asarray(x), lambda: np.array(x), lambda: x[0].item(),
                         lambda: x.tolist(), lambda: bool(x[1]), lambda: int(x[1]),
                         lambda: float(x[1]), lambda: torch.as_tensor(h),
                         lambda: torch.tensor(h), lambda: torch.asarray(h)):
            with pytest.raises(ImplicitTransferError):
                implicit()
        # the explicit transfers stay legal
        back = x.cpu().numpy()
        np.testing.assert_array_equal(back, np.arange(8))
        up = torch.from_numpy(back).to("cpu")
        assert up.dtype == torch.int32
    # outside the guard everything is back to normal
    np.testing.assert_array_equal(np.asarray(x), np.arange(8))
    assert x[3].item() == 3 and torch.as_tensor(h).shape == (8,)


def test_guard_restores_on_exception():
    before = (np.asarray, np.array, torch.as_tensor, torch.tensor, torch.Tensor.item,
              torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.__bool__)
    with pytest.raises(RuntimeError, match="boom"):
        with no_implicit_transfers():
            raise RuntimeError("boom")
    assert (np.asarray, np.array, torch.as_tensor, torch.tensor, torch.Tensor.item,
            torch.Tensor.cpu, torch.Tensor.to, torch.Tensor.__bool__) == before


def test_warm_device_counts_is_clean_and_equals_the_reference(cidx, ref_cidx):
    rng = np.random.default_rng(3)
    lists = _lists(rng, 24, cidx.index.n_terms)
    cq = ConjunctiveQueries.from_lists(lists)
    counts_warm, _ = device_counts(cidx, cq, device="cpu")  # warm: upload the index
    with no_implicit_transfers():
        counts, info = device_counts(cidx, cq, device="cpu")
        counts2, docs, _ = device_counts(cidx, cq, return_docs=True, device="cpu")
    np.testing.assert_array_equal(counts, counts_warm)
    np.testing.assert_array_equal(counts2, counts_warm)
    assert info["n_kernel_calls"] == 1.0
    ptr, docs_ref, _w = batched_query(cidx, cq)
    np.testing.assert_array_equal(counts, np.diff(ptr))
    np.testing.assert_array_equal(docs, docs_ref)
    want, _ = ref_device_counts(ref_cidx, RefQueries.from_lists(lists))
    np.testing.assert_array_equal(counts, want)


def test_a_planted_item_in_the_warm_path_raises(cidx, monkeypatch):
    from repro_torch.core import device_engine

    rng = np.random.default_rng(4)
    cq = ConjunctiveQueries.from_lists(_lists(rng, 12, cidx.index.n_terms))
    device_counts(cidx, cq, device="cpu")  # warm
    real = device_engine.device_fold

    def leaky(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0].sum().item()  # a sync the hot path must not make
        return out

    monkeypatch.setattr(device_engine, "device_fold", leaky)
    device_counts(cidx, cq, device="cpu")  # fine outside the guard
    with no_implicit_transfers(), pytest.raises(ImplicitTransferError, match="item"):
        device_counts(cidx, cq, device="cpu")


def test_warm_search_service_block_path_is_clean(cidx):
    from repro_torch.serve.search_service import SearchService

    class _Res:
        cluster_index = cidx

    svc = SearchService(_Res(), device="cpu")
    rng = np.random.default_rng(9)
    cq = ConjunctiveQueries.from_lists(_lists(rng, 16, cidx.index.n_terms))
    want, _ = svc.serve_counts_device(cq)  # warm
    with no_implicit_transfers():
        counts, _info = svc.serve_counts_device(cq)
    np.testing.assert_array_equal(counts, want)


def test_compile_count_is_constant_over_the_quantized_grid(cidx):
    """Drifting batch sizes compile nothing: the fold's library count
    (0 on the CPU, where nothing is built) stays where it was, and
    replaying every batch leaves it there too."""
    rng = np.random.default_rng(7)
    n_terms = cidx.index.n_terms
    device_index(cidx, "cpu")
    before = jit_cache_size(device_fold)
    sizes = [20, 21, 22, 23, 24, 25, 26, 27]
    batches = [ConjunctiveQueries.from_lists(_lists(rng, n, n_terms, 3)) for n in sizes]
    for n_q, cq in zip(sizes, batches, strict=True):
        counts, _ = device_counts(cidx, cq, device="cpu")
        assert len(counts) == n_q
    assert jit_cache_size(device_fold) == before
    for cq in batches:
        device_counts(cidx, cq, device="cpu")
    assert jit_cache_size(device_fold) == before == 0
    with pytest.raises(AttributeError):
        jit_cache_size(lambda: None)


def test_quantize_is_monotone_padding():
    for n in (1, 5, 8, 100, 1000, 12345):
        q = _quantize(n)
        assert q >= n and q % 8 == 0
