"""The port's non-clustered baseline (``repro_torch.index.batched``)
against the JAX package's ``repro.index.batched``.

Both sides bin the same term pairs of ``small_log`` over the same
randomized-id baseline index: the JAX fit's ``base_index``, and the port's
built from the same corpus with the fit's ``base_perm``
(``_torch_parity.arrays_of``; nothing is fitted again).  Every array of
every bin must be equal, the bins in the same order, with and without
truncation; every query's count through the port's
``count_intersections`` (the plain version on the CPU) equals JAX's
``count_intersections_jnp`` and ``np.intersect1d``.  All outputs are
integers: tolerance 0.  The count kernels' form route is pure Python and
checked here; the forms themselves run on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from _torch_parity import arrays_of
from repro.index.batched import batch_queries as jax_batch_queries
from repro.index.batched import count_intersections_jnp
from repro_torch.data.corpus import Corpus
from repro_torch.index import BatchedQueries, batch_queries
from repro_torch.index import batched as port_batched
from repro_torch.index.build import build_index, permute_docs
from repro_torch.kernels.intersect import kernel as K
from repro_torch.kernels.intersect import ops
from repro_torch.kernels.intersect.ref import PAD

BIN_FIELDS = ("short", "long", "n_short", "n_long", "query_ids")
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.fixture(scope="module")
def base_indexes(small_corpus, small_seclud):
    corpus = Corpus(doc_ptr=np.asarray(small_corpus.doc_ptr),
                    doc_terms=np.asarray(small_corpus.doc_terms), n_terms=small_corpus.n_terms)
    port = permute_docs(build_index(corpus), arrays_of(small_seclud)["base_perm"])
    return small_seclud.base_index, port


@pytest.mark.parametrize("max_list_len", [None, 8, 100])
def test_bins_equal_the_jax_package_array_for_array(base_indexes, small_log, max_list_len):
    jax_index, port_index = base_indexes
    np.testing.assert_array_equal(port_index.post_ptr, np.asarray(jax_index.post_ptr))
    np.testing.assert_array_equal(port_index.post_docs, np.asarray(jax_index.post_docs))
    want = jax_batch_queries(jax_index, small_log.queries, max_list_len=max_list_len)
    got = batch_queries(port_index, small_log.queries, max_list_len=max_list_len)
    assert isinstance(got, BatchedQueries) and got.n_queries == want.n_queries
    assert len(got.bins) == len(want.bins) > 1
    for g, w in zip(got.bins, want.bins, strict=True):
        for field in BIN_FIELDS:
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.padding_overhead() == want.padding_overhead()
    if max_list_len is not None:
        assert all(int(b.n_long.max()) <= max_list_len for b in got.bins)
        assert all(b.long.shape[1] < 2 * max(max_list_len, 4) for b in got.bins)


@pytest.mark.parametrize("max_list_len", [None, 8])
def test_counts_equal_jax_and_brute_force(base_indexes, small_log, max_list_len):
    jax_index, port_index = base_indexes
    queries = small_log.queries
    batched = batch_queries(port_index, queries, max_list_len=max_list_len)
    got = np.full(len(queries), -1, np.int64)
    want = np.full(len(queries), -1, np.int64)
    for b, jb in zip(batched.bins, jax_batch_queries(jax_index, queries, max_list_len).bins,
                     strict=True):
        counts = port_batched.count_intersections(b.short, b.long)
        assert counts.dtype == torch.int32 and counts.device.type == "cpu"
        got[b.query_ids] = counts.numpy()
        want[jb.query_ids] = np.asarray(count_intersections_jnp(jb.short, jb.long))
    np.testing.assert_array_equal(got, want)
    for qi, (t, u) in enumerate(queries):
        a, b = port_index.postings(int(t)), port_index.postings(int(u))
        if max_list_len is not None:
            short, long = (a, b) if len(a) <= len(b) else (b, a)
            a, b = short[:max_list_len], long[:max_list_len]
        assert got[qi] == len(np.intersect1d(a, b))


def test_count_intersections_is_the_kernel_oracle():
    """The counterpart of the JAX package's one oracle: the port's per-bin
    count is the intersect kernel's public wrapper, over the same PAD."""
    from repro.kernels.intersect.ref import PAD as JAX_PAD

    assert port_batched.count_intersections is ops.intersect_count
    assert port_batched._PAD == PAD == JAX_PAD


def test_batched_imports_nothing_of_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(port_batched))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and all(not (m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
                         for m in names)


@pytest.mark.parametrize("n_rows,ls,ll,form", [
    # the non-clustered baseline's widest bins (wiki, 200,000 documents,
    # the arity-2 log of 2,000 queries): few rows of long short lists
    (30, 131072, 262144, "split"),
    (11, 262144, 262144, "split"),
    (22, 32768, 262144, "split"),
    (25, 512, 262144, "split"),
    # at <= 256 short elements a row the row form's one launch wins
    (34, 64, 262144, "row"),
    (90, 256, 256, "row"),
    (1, 4, 262144, "row"),
    # the block path's pairs and mixed blocks: enough rows to fill the card
    (14910, 512, 896, "row"),
    (13285, 768, 768, "row"),
    # past WIDE_LS short elements the split form at every row count
    (20000, 32768, 65536, "split"),
    (20000, 16384, 65536, "row"),
    (K.ROW_FORM_ROWS_PER_SM * H100_SMS, 4096, 8192, "row"),
    (K.ROW_FORM_ROWS_PER_SM * H100_SMS - 1, 4096, 8192, "split"),
    (5, 4096, 0, "row"),
    (0, 4096, 8192, "split"),
])
def test_count_route(n_rows, ls, ll, form):
    assert K.count_route(n_rows, ls, ll, H100_SMS) == form


def test_count_route_scales_its_cut_with_the_card():
    rows = K.ROW_FORM_ROWS_PER_SM * 66
    assert K.count_route(rows - 1, 4096, 8192, 66) == "split"
    assert K.count_route(rows, 4096, 8192, 66) == "row"
    assert K.count_route(rows, 4096, 8192, H100_SMS) == "split"


@pytest.mark.parametrize("ls,chunk", [(257, 512), (16384, 512), (16385, 2048), (262144, 2048)])
def test_split_chunk(ls, chunk):
    assert K.split_chunk(ls) == chunk


def test_split_form_refuses_what_its_kernel_does_not_take():
    s = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K._split_form_forced(s, s)
    with pytest.raises(ValueError, match="CUDA"):
        K._row_form_forced(s, s, members=True)
    assert {K.split_chunk(ls) for ls in (1, 2**20)} == set(K.SPLIT_CHUNKS)
    assert all(c % K.SPLIT_THREADS == 0 for c in K.SPLIT_CHUNKS)
