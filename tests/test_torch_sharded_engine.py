"""The port's sharded engine and its failover against the JAX package's,
on the CPU.

The reference shards over the 8 fake CPU devices of ``tests/conftest.py``
(``shard_mesh(S)``); the port over ``devices=["cpu"] * S`` — S slots of
one device.  Both serve the session fit (carried across with
``result_from_arrays``).  Everything compared is an integer, a key or a
ratio of integers, so every comparison is exact: the partition
(``top_bounds``, ``local_pos``, the stacked rows), the sharded lowering,
counts and docs, the sharding attribution, the state after evict ->
remesh, and the block path split over S devices.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import port_result, ragged_queries
from repro.core import device_engine as J
from repro.core.batched_query import plan_segment_pairs as jax_plan
from repro.core.queries import ConjunctiveQueries as JaxQueries
from repro.serve.search_service import SearchService as JaxService
from repro_torch.core import device_engine as T
from repro_torch.core.batched_query import batched_query
from repro_torch.core.batched_query import plan_segment_pairs as torch_plan
from repro_torch.core.queries import ConjunctiveQueries as TorchQueries
from repro_torch.dist.fault_tolerance import ElasticMesh, NoDevicesError, ShardSlot
from repro_torch.kernels.intersect.ref import PAD
from repro_torch.serve.search_service import SearchService, _row_blocks

SHARDS = [1, 2, 4, 8]
LOWERED_ARRAYS = ("cells", "stage_seg", "n_cells_true", "grp_shard", "grp_off", "grp_cnt")
LOWERED_SCALARS = ("group_width", "stage_iters", "n_queries", "n_queries_pad",
                   "shards_touched", "n_shards")
INFO_EXACT = ("n_pairs", "n_shards", "shards_touched", "shard_cells", "agg_throughput",
              "load_balance", "padding_overhead")


@pytest.fixture(scope="module")
def fits(small_seclud):
    return small_seclud, port_result(small_seclud)


@pytest.fixture(scope="module")
def lists(small_corpus, small_log):
    out = [list(map(int, t)) for t in small_log.as_conjunctive()[:100]]
    out += ragged_queries(np.random.default_rng(3), 40, small_corpus.n_terms)
    absent = np.flatnonzero(small_corpus.term_doc_freq() == 0)
    if len(absent):
        out += [[int(absent[0])], [int(absent[0]), out[0][0]]]
    return out


def _indexes(fits, n_shards):
    jres, tres = fits
    jsidx = J.sharded_device_index(jres.hier_index, mesh=J.shard_mesh(n_shards))
    tsidx = T.sharded_device_index(tres.hier_index, devices=["cpu"] * n_shards)
    return jsidx, tsidx


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_index_is_the_reference_partition(fits, n_shards):
    jsidx, tsidx = _indexes(fits, n_shards)
    assert tsidx.n_shards == jsidx.n_shards == n_shards
    for f in ("top_bounds", "doc_bounds", "local_pos", "shard_counts"):
        np.testing.assert_array_equal(getattr(tsidx, f), getattr(jsidx, f), err_msg=f)
    assert (tsidx.post_width, tsidx.search_iters) == (jsidx.post_width, jsidx.search_iters)
    rows = np.stack([t.numpy() for t in tsidx.post_docs])
    np.testing.assert_array_equal(rows, np.asarray(jsidx.post_docs))
    assert all(t.device.type == "cpu" for t in tsidx.post_docs)
    assert tsidx.nbytes == jsidx.nbytes
    tsidx.validate()


@pytest.mark.parametrize("n_shards", SHARDS)
def test_lower_plan_sharded_gives_the_reference_arrays(fits, lists, n_shards):
    jsidx, tsidx = _indexes(fits, n_shards)
    jlow = J.lower_plan_sharded(
        jax_plan(jsidx.host, JaxQueries.from_lists(lists), track_work=False), jsidx)
    tlow = T.lower_plan_sharded(
        torch_plan(tsidx.host, TorchQueries.from_lists(lists), track_work=False), tsidx)
    for f in LOWERED_ARRAYS:
        np.testing.assert_array_equal(getattr(tlow, f), getattr(jlow, f), err_msg=f)
    for f in LOWERED_SCALARS:
        assert getattr(tlow, f) == getattr(jlow, f), f


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_counts_equal_reference_and_host(fits, lists, n_shards):
    jsidx, tsidx = _indexes(fits, n_shards)
    jres, tres = fits
    jc, jd, jinfo = J.sharded_device_counts(jres.hier_index, JaxQueries.from_lists(lists),
                                            sidx=jsidx, return_docs=True)
    tcq = TorchQueries.from_lists(lists)
    tc, td, tinfo = T.sharded_device_counts(tres.hier_index, tcq, sidx=tsidx, return_docs=True)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    for key in INFO_EXACT:
        assert tinfo[key] == jinfo[key], key
    assert set(tinfo) == set(jinfo)
    assert tinfo["jit_compiles"] == 0.0 and tinfo["n_kernel_calls"] == float(n_shards)
    assert tinfo["shard_times"] == [tinfo["t_fold_s"]] * n_shards
    ptr, docs, _ = batched_query(tres.hier_index, tcq)
    np.testing.assert_array_equal(tc, np.diff(ptr))
    np.testing.assert_array_equal(td, docs)
    # and against the single-device engine
    sc, sd, _ = T.device_counts(tres.hier_index, tcq, return_docs=True, device="cpu")
    np.testing.assert_array_equal(tc, sc)
    np.testing.assert_array_equal(td, sd)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_empty_batches_and_absent_terms(fits, small_corpus, n_shards):
    jsidx, tsidx = _indexes(fits, n_shards)
    jres, tres = fits
    absent = np.flatnonzero(small_corpus.term_doc_freq() == 0)
    if len(absent) < 2:
        pytest.skip("the session corpus uses every term")
    for queries in (np.empty((0, 2), np.int64), np.array([[absent[0], absent[1]]])):
        tc, td, tinfo = T.sharded_device_counts(tres.hier_index, queries, sidx=tsidx,
                                                return_docs=True)
        jc, jd, jinfo = J.sharded_device_counts(jres.hier_index, queries, sidx=jsidx,
                                                return_docs=True)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td, jd)
        assert tinfo == {**jinfo, "t_plan_s": tinfo["t_plan_s"]}
        assert tinfo["shards_touched"] == 0.0 and tinfo["n_kernel_calls"] == 0.0


def test_sharded_index_is_cached_per_slot_tuple(fits):
    _jres, tres = fits
    mesh = T.shard_devices(devices=["cpu"] * 3)
    a = T.sharded_device_index(tres.hier_index, mesh=mesh)
    assert T.sharded_device_index(tres.hier_index, mesh=mesh) is a
    assert T.sharded_device_index(tres.hier_index, devices=["cpu"] * 3) is a
    # two slots of the same device are distinct: another tuple, another index
    b = T.sharded_device_index(tres.hier_index, devices=["cpu"] * 2)
    assert b is not a and b.n_shards == 2
    assert mesh == tuple(ShardSlot(id=i, device=torch.device("cpu")) for i in range(3))
    # only the last tuple's index stays cached: the old mesh's rows are released
    assert T.sharded_device_index(tres.hier_index, mesh=mesh) is not a


def test_shard_devices_bounds():
    assert len(T.shard_devices(devices=["cpu"] * 3)) == 3
    assert [slot.id for slot in T.shard_devices(2, ["cpu"] * 3)] == [0, 1]
    with pytest.raises(ValueError, match="outside"):
        T.shard_devices(4, ["cpu"] * 3)
    with pytest.raises(ValueError, match="outside"):
        T.shard_devices(0, ["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.shard_devices(1)


def test_validate_runs_under_repro_debug_and_catches_a_broken_partition(fits, monkeypatch):
    from repro_torch.analysis.runtime import force_debug

    fresh = port_result(fits[0])  # a new host index: nothing cached yet
    calls = []
    real = T.ShardedDeviceIndex.validate
    monkeypatch.setattr(T.ShardedDeviceIndex, "validate",
                        lambda self: calls.append(self) or real(self))
    with force_debug(True):
        sidx = T.sharded_device_index(fresh.hier_index, devices=["cpu"] * 4)
    assert calls == [sidx]
    monkeypatch.undo()
    swapped = sidx.local_pos.copy()
    swapped[[0, -1]] = swapped[[-1, 0]]
    with pytest.raises(ValueError, match="partition is not exact"):
        dataclasses.replace(sidx, local_pos=swapped).validate()
    counts = sidx.shard_counts.copy()
    counts[0] += 1
    with pytest.raises(ValueError, match="shard_counts"):
        dataclasses.replace(sidx, shard_counts=counts).validate()


# ----------------------------------------------------------------------
# Failover: evict -> remesh through the service
# ----------------------------------------------------------------------


@pytest.mark.parametrize("strikes", [1, 3])
def test_failover_matches_reference_and_stays_exact(fits, lists, strikes):
    jres, tres = fits
    s = 4
    jsvc, tsvc = JaxService(jres), SearchService(tres, device="cpu")
    jsvc.enable_sharded(n_shards=s, strikes_to_evict=strikes)
    tsvc.enable_sharded(devices=["cpu"] * s, strikes_to_evict=strikes)
    evict = 1
    lost = tsvc.sharded_index.mesh[evict]
    times = np.ones(s)
    times[evict] = 1e6
    for k in range(strikes):
        jv, jr = jsvc.record_shard_times(times)
        tv, tr = tsvc.record_shard_times(times)
        assert [dataclasses.astuple(v) for v in tv] == [dataclasses.astuple(v) for v in jv]
        assert tr == jr == (k == strikes - 1)
    after = tsvc.sharded_index
    assert after.n_shards == jsvc.n_shards == s - 1
    np.testing.assert_array_equal(after.top_bounds, jsvc.sharded_index.top_bounds)
    np.testing.assert_array_equal(after.doc_bounds, jsvc.sharded_index.doc_bounds)
    # one slot left the pool, not every slot on its (shared) device
    assert lost not in after.mesh
    assert [slot.id for slot in after.mesh] == [0, 2, 3]
    assert {slot.device for slot in after.mesh} == {lost.device}
    assert tsvc._elastic.epoch == jsvc._elastic.epoch == 2
    assert tsvc._monitor.n_hosts == s - 1
    jcq, tcq = JaxQueries.from_lists(lists), TorchQueries.from_lists(lists)
    jc, jd, _ = jsvc.serve_counts_device(jcq, return_docs=True)
    tc, td, tinfo = tsvc.serve_counts_device(tcq, return_docs=True)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    assert tinfo["n_shards"] == float(s - 1) and tinfo["remeshed"] is False


def test_record_shard_times_requires_enable(fits):
    with pytest.raises(RuntimeError, match="not enabled"):
        SearchService(fits[1], device="cpu").record_shard_times([1.0, 1.0])


def test_elastic_mesh_excludes_one_slot_and_raises_typed_when_empty():
    em = ElasticMesh()
    mesh = em.remesh(["cpu"] * 4)
    assert [s.id for s in mesh] == [0, 1, 2, 3]
    em.exclude_device(mesh[0].id)
    mesh2 = em.remesh()  # a bare remesh reuses the pool
    assert [s.id for s in mesh2] == [1, 2, 3]
    assert all(s.device == torch.device("cpu") for s in mesh2)
    assert em.epoch == 2
    for slot in mesh2:
        em.exclude_device(slot.id)
    with pytest.raises(NoDevicesError, match="no mesh can be built"):
        em.remesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ElasticMesh().remesh()


# ----------------------------------------------------------------------
# The block path split over devices
# ----------------------------------------------------------------------


def _block_queries(corpus, kind, n):
    rng = np.random.default_rng(n)
    if kind == "pairs":
        alive = np.flatnonzero(corpus.term_doc_freq() > 1)
        q = rng.choice(alive, (n, 2))
        return q[q[:, 0] != q[:, 1]]
    lists = ragged_queries(rng, n, corpus.n_terms)
    lists.append([1, 2, 3, 4, 5])
    return TorchQueries.from_lists(lists).padded()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("kind", ["pairs", "mixed"])
def test_block_path_split_over_devices_equals_reference(fits, small_corpus, kind, n_shards):
    jres, tres = fits
    jsvc, tsvc = JaxService(jres), SearchService(tres, device="cpu")
    queries = _block_queries(small_corpus, kind, 23 + n_shards)
    packed = tsvc.pack(queries)
    if n_shards > 1:
        assert packed.short.shape[0] % n_shards, "pick a row count that needs padding"
    got = tsvc.device_counts(packed, devices=["cpu"] * n_shards)
    assert got.shape == (packed.n_queries,) and got.dtype == torch.int32
    want = np.asarray(JaxService.device_counts(jsvc.pack(queries), mesh=J.shard_mesh(n_shards)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tsvc.serve_counts(queries)[0])
    np.testing.assert_array_equal(got.numpy(), tsvc.device_counts(packed).numpy())


def test_block_padding_rows_credit_no_query(fits, small_corpus):
    tsvc = SearchService(fits[1], device="cpu")
    packed = tsvc.pack(_block_queries(small_corpus, "mixed", 30))
    n_rows, nq = packed.short.shape[0], packed.n_queries
    blocks = _row_blocks(packed, ["cpu"] * 4)
    pad = 4 * blocks[0][1].shape[0] - n_rows
    assert 0 < pad < 4
    segs = [np.concatenate([b[0][r] for b in blocks]) for r in range(len(packed.segments))]
    rq = np.concatenate([b[1] for b in blocks])
    ra = np.concatenate([b[2] for b in blocks])
    np.testing.assert_array_equal(rq[:n_rows], packed.row_query)
    assert (rq[n_rows:] == nq).all() and (ra[n_rows:] == 0).all()
    assert all((s[n_rows:] == PAD).all() for s in segs)
    # a query's count is the same whether the pad rows exist or not
    np.testing.assert_array_equal(tsvc.device_counts(packed, devices=["cpu"] * 4).numpy(),
                                  tsvc.serve_counts(_block_queries(small_corpus, "mixed", 30))[0])
