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


# The count-all-bins kernel's work table and its one-call count.  Designs
# (merge tile, search chunk, ratio cut): the kernel's defaults, and small
# tiles and chunks that cut the test rows into many items of both kinds,
# all merge items, all search items.
DESIGNS = [(K.MERGE_TILE, K.SEARCH_CHUNK, K.RATIO_CUT), (32, 8, 2.0), (64, 64, float("inf")),
           (16, 4, 0.0)]
DESIGN_IDS = ["default", "tiny", "all-merge", "all-search"]


def _coranks(a, b, d):
    """How many of a's elements the first d positions of the merge of the
    sorted a and b hold (ties: a first), for each d."""
    return np.searchsorted(np.arange(len(a)) + np.searchsorted(b, a, side="left"), d)


def check_work_table(batched, dbins):
    """Every row of ``batched`` lies in the buffers at its table offsets,
    and its items cover its true elements exactly once: merge items the
    positions [0, n_short + n_long) of its merge path, and through their
    co-ranks each short element once; search items each short element
    once.  No item reaches past a row's true lengths or its kind's cap;
    search items come first."""
    short, long = dbins.short.numpy(), dbins.long.numpy()
    rows = {}
    for b, (sb, lb, n, ls, ll, rb) in zip(batched.bins, dbins.bins, strict=True):
        assert (n, ls, ll) == (b.short.shape[0], b.short.shape[1], b.long.shape[1])
        for r in range(n):
            so, lo, ns, nl, q = dbins.rows[rb + r].tolist()
            assert (so, lo) == (sb + r * ls, lb + r * ll)
            assert (ns, nl, q) == (b.n_short[r], b.n_long[r], b.query_ids[r])
            np.testing.assert_array_equal(short[so:so + ns], b.short[r, :ns])
            np.testing.assert_array_equal(long[lo:lo + nl], b.long[r, :nl])
            assert not (short[so:so + ns] == PAD).any() and not (long[lo:lo + nl] == PAD).any()
            assert so % 4 == 0 and lo % 4 == 0
            rows[so] = (lo, ns, nl, q, [])
    assert dbins.query_ids.tolist() == dbins.rows[:, 4].tolist()
    items = dbins.items.numpy()
    assert items.dtype == np.int64 and items.shape[1] == len(K.ITEM_COLUMNS)
    kinds = items[:, 7]
    assert set(kinds.tolist()) <= {K.MERGE, K.SEARCH}
    assert not (np.diff((kinds == K.MERGE).astype(int)) < 0).any(), "search items first"
    for so, lo, ns, nl, start, length, q, kind in items.tolist():
        assert rows[so][:4] == (lo, ns, nl, q)
        cap, span = ((dbins.merge_tile, ns + nl) if kind == K.MERGE
                     else (dbins.search_chunk, ns))
        assert 0 < length <= cap and 0 <= start and start + length <= span
        rows[so][4].append((kind, start, length))
    for so, (lo, ns, nl, q, got) in rows.items():
        if ns == 0 or nl == 0:
            assert not got
            continue
        kinds = {k for k, _, _ in got}
        assert len(kinds) == 1
        kind = kinds.pop()
        span = ns + nl if kind == K.MERGE else ns
        cover = np.zeros(span, np.int64)
        for _, start, length in got:
            cover[start:start + length] += 1
        assert (cover == 1).all()
        if kind == K.MERGE:
            starts = np.array([start for _, start, _ in got])
            ends = starts + np.array([length for _, _, length in got])
            a0, a1 = (_coranks(short[so:so + ns], long[lo:lo + nl], d) for d in (starts, ends))
            owned = np.zeros(ns + 1, np.int64)
            np.add.at(owned, a0, 1)
            np.add.at(owned, a1, -1)
            assert (np.cumsum(owned)[:ns] == 1).all()
        else:
            assert nl > dbins.ratio_cut * ns and ns + nl > dbins.merge_tile


def _brute_force(batched):
    want = np.zeros(batched.n_queries, np.int64)
    for b in batched.bins:
        for r in range(b.short.shape[0]):
            want[b.query_ids[r]] = len(np.intersect1d(b.short[r, :b.n_short[r]],
                                                      b.long[r, :b.n_long[r]]))
    return want


@pytest.fixture(scope="module")
def handbuilt():
    from _torch_parity import handbuilt_batch

    return handbuilt_batch()


@pytest.mark.parametrize("design", DESIGNS, ids=DESIGN_IDS)
@pytest.mark.parametrize("max_list_len", [None, 8, 100])
def test_work_table_covers_every_true_element_once(base_indexes, small_log, max_list_len,
                                                   design):
    batched = batch_queries(base_indexes[1], small_log.queries, max_list_len=max_list_len)
    check_work_table(batched, port_batched.upload_bins(batched, "cpu", *design))


@pytest.mark.parametrize("design", DESIGNS, ids=DESIGN_IDS)
def test_work_table_of_the_hand_built_batch(handbuilt, design):
    assert sorted(b.short.shape[0] for b in handbuilt.bins) == [1, 1, 91, 91]
    assert max(b.short.shape[1] for b in handbuilt.bins) == 262144
    assert {0, 1} <= {int(n) for b in handbuilt.bins for n in b.n_short}
    dbins = port_batched.upload_bins(handbuilt, "cpu", *design)
    check_work_table(handbuilt, dbins)
    assert len(dbins.items) == len(port_batched.work_table(dbins.rows, *design))


def test_work_table_puts_the_heaviest_items_first():
    rows = np.array([[0, 0, 4, 8, 0], [4, 8, 600, 700, 1], [604, 708, 10, 5000, 2],
                     [614, 5708, 20, 9000, 3]], np.int64)
    table = port_batched.work_table(rows, 512, 64, 16.0)
    kinds, n_long, length = table[:, 7], table[:, 3], table[:, 5]
    assert kinds.tolist() == [K.SEARCH] * 2 + [K.MERGE] * 4
    assert n_long[:2].tolist() == [9000, 5000] and length[2:].tolist() == [512, 512, 276, 12]


@pytest.mark.parametrize("max_list_len", [None, 8, 100])
def test_count_queries_equal_jax_and_brute_force(base_indexes, small_log, max_list_len):
    jax_index, port_index = base_indexes
    queries = small_log.queries
    batched = batch_queries(port_index, queries, max_list_len=max_list_len)
    got = port_batched.count_queries(port_batched.upload_bins(batched, "cpu"))
    assert got.dtype == torch.int32 and got.device.type == "cpu" and got.shape == (len(queries),)
    want = np.full(len(queries), -1, np.int64)
    for jb in jax_batch_queries(jax_index, queries, max_list_len).bins:
        want[np.asarray(jb.query_ids)] = np.asarray(count_intersections_jnp(jb.short, jb.long))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _brute_force(batched))


def test_count_queries_of_the_hand_built_batch(handbuilt):
    got = port_batched.count_queries(port_batched.upload_bins(handbuilt, "cpu"))
    want = np.zeros(handbuilt.n_queries, np.int64)
    for b in handbuilt.bins:
        want[b.query_ids] = np.asarray(count_intersections_jnp(b.short, b.long))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _brute_force(handbuilt))
    assert got.numpy().max() > 10_000 and (got.numpy() == 0).any()


@pytest.mark.parametrize("design", DESIGNS, ids=DESIGN_IDS)
def test_kernel_algorithm_emulated_equals_brute_force(base_indexes, small_log, design):
    """The kernel's co-ranks, staged tiles, lanes' merges and searches,
    emulated on the CPU over the table, count every query exactly."""
    from _torch_parity import bins_count_emulation

    batched = batch_queries(base_indexes[1], small_log.queries)
    got = bins_count_emulation(port_batched.upload_bins(batched, "cpu", *design))
    np.testing.assert_array_equal(got, _brute_force(batched))


@pytest.mark.parametrize("design", [DESIGNS[0], (512, 64, float("inf"))],
                         ids=["default", "all-merge"])
def test_kernel_algorithm_emulated_on_the_hand_built_batch(handbuilt, design):
    from _torch_parity import bins_count_emulation

    got = bins_count_emulation(port_batched.upload_bins(handbuilt, "cpu", *design))
    np.testing.assert_array_equal(got, _brute_force(handbuilt))


def test_upload_bins_runs_on_the_card_unless_told():
    batched = BatchedQueries(bins=[], n_queries=0)
    if torch.cuda.is_available():
        assert port_batched.upload_bins(batched).short.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_batched.upload_bins(batched)
    empty = port_batched.upload_bins(batched, "cpu")
    assert port_batched.count_queries(empty).shape == (0,) and empty.items.shape == (0, 8)


@pytest.mark.parametrize("ls, ll", [(6, 8), (4, 10), (4, 1 << 31)])
def test_upload_bins_refuses_widths_its_kernel_does_not_take(ls, ll):
    """Rows must start 16-byte aligned, and their positions fit int32."""
    empty = np.zeros(0, np.int32)
    bin_ = port_batched.QueryBin(short=np.zeros((0, ls), np.int32),
                                 long=np.zeros((0, ll), np.int32), n_short=empty,
                                 n_long=empty, query_ids=empty)
    with pytest.raises(ValueError, match="multiples of 4"):
        port_batched.upload_bins(BatchedQueries(bins=[bin_], n_queries=0), "cpu")


def test_bins_launcher_refuses_what_its_kernel_does_not_take():
    buf = torch.zeros(16, dtype=torch.int32)
    items = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_count_bins_cuda(buf, buf, items, 4)
    rows = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_count_bins_cuda(rows, rows, items, 4)
    assert all(t % 32 == 0 for t in K.SEARCH_CHUNKS) and max(K.SEARCH_CHUNKS) == 256
    assert K.MERGE_TILE in K.MERGE_TILES and K.SEARCH_CHUNK in K.SEARCH_CHUNKS
