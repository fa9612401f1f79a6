"""The port's serving tier against the JAX package's, on the CPU: the
deadline batcher, the shape-grid prewarm, sealed and async replay, fault
injection and the resilience ladder.

Both packages serve the session fit (carried across with
``result_from_arrays``) and replay the same query logs (the same arrays,
arrival timestamps included).  Sharded runs use the reference's fake CPU
devices and the port's ``devices=["cpu"] * S``.  Under the same
``FaultSchedule`` the sealed replays must agree exactly: batch
composition, counts, SHED positions, per-request outcomes, per-batch
attempts and ladder levels, and the shard count after failover.  Chaos
replays set ``dispatch_timeout_s`` far beyond any dispatch, as the
reference's own tests do, so wall-clock noise cannot open a breaker.
"""

import asyncio
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core.device_engine as J
import repro.serve.faults as JF
import repro.serve.loop as JL
import repro.serve.replay as JR
import repro.serve.resilience as JS
import repro_torch.core.device_engine as T
import repro_torch.serve.faults as TF
import repro_torch.serve.loop as TL
import repro_torch.serve.replay as TR
import repro_torch.serve.resilience as TS
from _torch_parity import port_result
from repro.data.query_log import poisson_arrivals, synth_query_log
from repro.serve.search_service import SearchService as JaxService
from repro_torch.data.query_log import QueryLog
from repro_torch.serve.search_service import SearchService

REPO = Path(__file__).resolve().parents[1]
# The replays' batching policy: a deadline that seals about eight of the
# chaos log's requests a batch, so the reference compiles few shapes.
MAX_BATCH, DEADLINE_S = 16, 0.02


@pytest.fixture(scope="module")
def fits(small_seclud):
    return small_seclud, port_result(small_seclud)


def _logs(jlog):
    """The reference's log, and the port's log of the same arrays."""
    return jlog, QueryLog(queries=jlog.queries.copy(), arrivals=jlog.arrivals.copy())


@pytest.fixture(scope="module")
def traffic(small_corpus):
    return _logs(synth_query_log(small_corpus, n_queries=150, seed=5, arity=(1, 2, 3),
                                 arity_weights=(0.2, 0.6, 0.2), arrival_qps=400.0))


@pytest.fixture(scope="module")
def chaos_log(small_corpus):
    return _logs(synth_query_log(small_corpus, n_queries=80, seed=11, arrival_qps=400.0))


def _services(fits, n_shards=0, strikes=3):
    jres, tres = fits
    jsvc, tsvc = JaxService(jres), SearchService(tres, device="cpu")
    if n_shards:
        jsvc.enable_sharded(n_shards=n_shards, strikes_to_evict=strikes)
        tsvc.enable_sharded(devices=["cpu"] * n_shards, strikes_to_evict=strikes)
    return jsvc, tsvc


# ----------------------------------------------------------------------
# The pure batching policy
# ----------------------------------------------------------------------


@pytest.mark.parametrize("qps,max_batch,deadline_s", [
    (400.0, 16, 0.002), (2000.0, 64, 0.002), (8000.0, 64, 0.002), (50.0, 4, 0.0),
    (5000.0, 1, 0.01)])
def test_plan_batches_and_seal_times_equal_reference(qps, max_batch, deadline_s):
    arrivals = poisson_arrivals(500, qps, seed=int(qps))
    jb = JL.plan_batches(arrivals, max_batch, deadline_s)
    tb = TL.plan_batches(arrivals, max_batch, deadline_s)
    assert tb == jb
    np.testing.assert_array_equal(TL.seal_times(arrivals, tb, max_batch, deadline_s),
                                  JL.seal_times(arrivals, jb, max_batch, deadline_s))


def test_policy_validation_matches_reference():
    for mod in (JL, TL):
        with pytest.raises(ValueError, match="max_batch"):
            mod.ServeConfig(max_batch=0)
        with pytest.raises(ValueError, match="deadline_s"):
            mod.ServeConfig(deadline_s=-1.0)
        with pytest.raises(ValueError, match="nondecreasing"):
            mod.plan_batches(np.array([0.0, 1.0, 0.5]), 4, 0.1)
    for mod in (JS, TS):
        with pytest.raises(ValueError, match="max_retries"):
            mod.ResilienceConfig(max_retries=-1)
        with pytest.raises(ValueError, match="shed_queue_depth"):
            mod.ResilienceConfig(shed_queue_depth=-1)


def test_chaos_schedules_and_injector_match_reference():
    js = JF.FaultSchedule.chaos(seed=7, n_batches=40, n_events=6, n_shards=4)
    ts = TF.FaultSchedule.chaos(seed=7, n_batches=40, n_events=6, n_shards=4)
    assert [vars(e) for e in ts.events] == [vars(e) for e in js.events]
    ji, ti = JF.FaultInjector(js), TF.FaultInjector(ts)
    for n_shards in (4, 4, 4, 3, 3, 3) * 7:
        ji.begin_batch(), ti.begin_batch()
        for _attempt in range(2):
            raised = []
            for inj, err in ((ji, JF.InjectedFault), (ti, TF.InjectedFault)):
                try:
                    inj.on_dispatch(n_shards=n_shards)
                    raised.append(None)
                except err as e:
                    raised.append((type(e).__name__, e.shard, e.batch))
            assert raised[0] == raised[1]
        np.testing.assert_array_equal(ti.perturb_shard_times(np.ones(4)),
                                      ji.perturb_shard_times(np.ones(4)))
        assert ti.extra_queue_depth() == ji.extra_queue_depth()
        assert ti.take_delay() == ji.take_delay()
    assert ti.fired == ji.fired
    assert TF.SHED == JF.SHED and TS.LEVELS == JS.LEVELS


def _fake_engines(fail_first, error):
    calls = {"device": 0}
    truth = np.arange(10, dtype=np.int64)

    def device(q):
        calls["device"] += 1
        if calls["device"] <= fail_first:
            raise error
        return truth.copy(), {"path": "device"}

    return device, lambda q: (truth.copy(), {"path": "host"})


@pytest.mark.parametrize("fail_first,timeout,no_devices", [
    (0, 1.0, False), (1, 1.0, False), (3, 1.0, False), (10_000, 1.0, False),
    (10_000, 1.0, True), (0, 0.0, False)])
def test_dispatcher_ladder_matches_reference(fail_first, timeout, no_devices):
    from repro.dist.fault_tolerance import NoDevicesError as JaxNoDevices
    from repro_torch.dist.fault_tolerance import NoDevicesError

    runs = []
    for mod, no_dev in ((JS, JaxNoDevices), (TS, NoDevicesError)):
        error = no_dev("pool empty") if no_devices else RuntimeError("boom")
        device, host = _fake_engines(fail_first, error)
        cfg = mod.ResilienceConfig(max_retries=1, breaker_threshold=2, probe_after=2,
                                   dispatch_timeout_s=timeout)
        d = mod.ResilientDispatcher(config=cfg, engine=device, host_engine=host)
        runs.append([(o.level, o.attempts, o.timed_out, d.breaker.state)
                     for o in (d.dispatch(None)[2] for _ in range(9))])
    assert runs[1] == runs[0]


@pytest.mark.parametrize("error,where,level", [
    ("kernel", "cuda", None), ("kernel", "sharded_cuda", None), ("kernel", "cpu", "host"),
    ("injected", "cuda", "host"), ("device_lost", "sharded_cuda", "host"),
    ("no_devices", "cuda", "host")])
def test_dispatcher_absorbs_only_typed_faults_on_a_cuda_service(error, where, level):
    """On a service whose device path is on CUDA only the typed faults go
    down the ladder: a kernel's own error raises rather than being answered
    on the host.  Off the card every error goes down, as in the reference."""
    from types import SimpleNamespace

    import torch

    from repro_torch.dist.fault_tolerance import NoDevicesError

    err = {"kernel": RuntimeError("segment_fold: CUDA launch failed with error 700"),
           "injected": TF.InjectedFault("injected dispatch failure"),
           "device_lost": TF.DeviceLostError("shard lost"),
           "no_devices": NoDevicesError("pool empty")}[error]
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    svc = SimpleNamespace(
        device=cuda if where == "cuda" else cpu,
        sharded_index=SimpleNamespace(devices=(cuda, cuda)) if where == "sharded_cuda" else None)
    device, host = _fake_engines(10_000, err)
    d = TS.ResilientDispatcher(svc, TS.ResilienceConfig(max_retries=1), engine=device,
                               host_engine=host)
    if level is None:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            d.dispatch(None)
    else:
        assert d.dispatch(None)[2].level == level


# ----------------------------------------------------------------------
# Prewarm and sealed replay
# ----------------------------------------------------------------------


def test_prewarm_keys_equal_reference(fits, traffic):
    jres, tres = fits
    jlog, tlog = traffic
    batches = TL.plan_batches(tlog.arrivals, 16, 0.002)[:12]
    jpw = J.prewarm(jres.hier_index, jlog.queries, batches=batches)
    tpw = T.prewarm(tres.hier_index, tlog.queries, batches=batches)
    assert tpw["keys"] == jpw["keys"] and len(tpw["keys"]) >= 2
    assert (tpw["n_batches"], tpw["n_keys"]) == (jpw["n_batches"], jpw["n_keys"])
    assert tpw["n_compiles"] == 0 and T.fold_cache_size() == 0
    sizes = T.prewarm(tres.hier_index, tlog.queries, batch_sizes=[1, 8])
    assert sizes["keys"] == J.prewarm(jres.hier_index, jlog.queries, batch_sizes=[1, 8])["keys"]
    with pytest.raises(ValueError, match="batch_sizes"):
        T.prewarm(tres.hier_index, tlog.queries)


def test_warm_fold_masks_dead_cells(fits, monkeypatch):
    from repro_torch.kernels.intersect import ops

    di = T.device_index(fits[1].hier_index, "cpu")
    T.warm_fold(di, (64, 16, (4, 6, 2), 24), return_members=True)
    # a fold that counted dead cells is refused
    real = ops.segment_fold_ref
    monkeypatch.setattr(ops, "segment_fold_ref",
                        lambda *a: (real(*a)[0] + 1,) + real(*a)[1:])
    with pytest.raises(RuntimeError, match="dead cells counted"):
        T.warm_fold(di, (64, 16, (4,), 24))


@pytest.mark.parametrize("n_shards", [0, 2, 4])
def test_sealed_replay_equals_reference(fits, chaos_log, n_shards):
    jsvc, tsvc = _services(fits, n_shards)
    jlog, tlog = chaos_log
    jrep = JR.replay(jsvc, jlog, config=JL.ServeConfig(MAX_BATCH, DEADLINE_S))
    trep = TR.replay(tsvc, tlog, config=TL.ServeConfig(MAX_BATCH, DEADLINE_S))
    assert trep.batches == jrep.batches
    np.testing.assert_array_equal(trep.counts, jrep.counts)
    np.testing.assert_array_equal(trep.counts, tsvc.serve_counts(tlog.queries)[0])
    assert trep.jit_compiles == 0 and set(trep.stats.batch_compiles) == {0}
    assert trep.stats.batch_sizes == jrep.stats.batch_sizes
    assert trep.stats.batch_levels == jrep.stats.batch_levels == ["device"] * len(trep.batches)
    s = trep.summary()
    assert s["mode"] == "sealed" and s["n_requests"] == tlog.n_queries
    assert s["p99_ms"] >= s["p50_ms"] >= 0.0


def _schedules(F):
    return {
        "shard_loss": F.FaultSchedule.shard_loss(0, at=2),
        "shard_loss_first_batch": F.FaultSchedule.shard_loss(0, at=0),
        "slowdown": F.FaultSchedule.shard_slowdown(0, at=0, factor=50.0),
        "flood": F.FaultSchedule.flood(at=3, depth=600, n_batches=2),
        "flaky": F.FaultSchedule.flaky(at=1, n_batches=2, n_attempts=1),
        "chaos": F.FaultSchedule.chaos(seed=7, n_batches=10, n_events=5, n_shards=4),
        "host": F.FaultSchedule((F.FaultEvent("exception", at=1, n_batches=3),)),
    }


@pytest.mark.parametrize("name", sorted(_schedules(TF)))
def test_chaos_replay_equals_reference(fits, chaos_log, name):
    jsvc, tsvc = _services(fits, 4)
    jlog, tlog = chaos_log
    truth, _ = tsvc.serve_counts(tlog.as_conjunctive())
    reps = []
    for svc, log, F, L, R, S in ((jsvc, jlog, JF, JL, JR, JS), (tsvc, tlog, TF, TL, TR, TS)):
        rc = S.ResilienceConfig(dispatch_timeout_s=1e9, shed_queue_depth=500)
        reps.append(R.replay(svc, log, config=L.ServeConfig(MAX_BATCH, DEADLINE_S),
                             mode="sealed", faults=_schedules(F)[name], resilience=rc))
    jrep, trep = reps
    np.testing.assert_array_equal(trep.counts, jrep.counts)
    shed = trep.counts == TF.SHED
    np.testing.assert_array_equal(trep.counts[~shed], truth[~shed])  # every answer exact
    for f in ("outcomes", "batch_levels", "batch_attempts", "batch_sizes", "shed_batches"):
        assert getattr(trep.stats, f) == getattr(jrep.stats, f), f
    assert tsvc.n_shards == jsvc.n_shards
    assert tsvc._elastic.epoch == jsvc._elastic.epoch
    levels = trep.stats.batch_levels
    if name == "shard_loss":
        assert levels[2] == "remesh" and set(levels[3:]) == {"device"} and tsvc.n_shards == 3
    if name == "host":
        assert "host" in levels  # the exact host rung answered
    if name == "flood":
        assert len(trep.stats.shed_batches) == 2 and shed.any()


# ----------------------------------------------------------------------
# The async loop
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [0, 2])
def test_async_replay_answers_exactly(fits, small_corpus, n_shards):
    _jsvc, tsvc = _services(fits, n_shards)
    _jlog, tlog = _logs(synth_query_log(small_corpus, n_queries=40, seed=21,
                                        arrival_qps=2000.0))
    rep = TR.replay(tsvc, tlog, config=TL.ServeConfig(max_batch=8, deadline_s=0.005),
                    mode="async")
    assert rep.mode == "async" and sum(rep.stats.batch_sizes) == 40
    np.testing.assert_array_equal(rep.counts, tsvc.serve_counts(tlog.queries)[0])
    assert rep.jit_compiles == 0


def test_async_chaos_replay_answers_exactly(fits, chaos_log):
    _jsvc, tsvc = _services(fits, 4)
    _jlog, tlog = chaos_log
    rep = TR.replay(tsvc, tlog, mode="async",
                    faults=TF.FaultSchedule.flaky(at=0, n_batches=3, n_attempts=1),
                    resilience=TS.ResilienceConfig(dispatch_timeout_s=1e9))
    shed = rep.counts == TF.SHED
    np.testing.assert_array_equal(rep.counts[~shed], tsvc.serve_counts(tlog.queries)[0][~shed])
    assert "retry" in rep.stats.batch_levels


def test_async_submit_sheds_with_typed_error(fits, small_log):
    tsvc = SearchService(fits[1], device="cpu")
    loop = TL.AsyncServingLoop(tsvc, resilience=TS.ResilienceConfig(shed_queue_depth=0))
    cq = small_log.as_conjunctive()

    async def drive():
        await loop.start()
        with pytest.raises(TS.ShedError) as exc:
            await loop.submit(cq.terms(0))
        await loop.stop()
        return exc.value

    err = asyncio.run(drive())
    assert err.threshold == 0 and loop.stats.n_shed == 1
    assert loop.stats.summary()["frac_shed"] == 1.0


def test_async_loop_burst_splits_and_prewarms(fits, traffic):
    tsvc = SearchService(fits[1], device="cpu")
    _jlog, tlog = traffic
    reqs = [[int(t) for t in tlog.as_conjunctive().terms(r)] for r in range(10)]

    async def go():
        loop = tsvc.serve_async(max_batch=4, deadline_s=0.02)
        pw = loop.prewarm(tlog.queries)
        await loop.start()
        counts = await asyncio.gather(*(loop.submit(r) for r in reqs))
        await loop.stop()
        return counts, loop.stats, pw

    counts, stats, pw = asyncio.run(go())
    assert pw["n_compiles"] == 0 and pw["n_keys"] >= 1
    assert max(stats.batch_sizes) <= 4 and sum(stats.batch_sizes) == 10
    np.testing.assert_array_equal(counts, tsvc.serve_counts(tlog.queries[:10])[0])


# ----------------------------------------------------------------------
# What t_fold_s means
# ----------------------------------------------------------------------

COPY_S = 0.2


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_t_fold_s_leaves_the_member_docs_copy_out_in_both_packages(fits, traffic, sharded,
                                                                   monkeypatch):
    """The copy of the member docs to the host starts after the ``t_fold_s``
    window ends, in the reference (its ``jax.device_get`` of the member
    cells) and in the port.  The call's spans run in order from its start,
    so the window ends no earlier than start + t_plan_s + t_lower_s +
    t_fold_s; a copy inside it would start earlier than that by at least
    its own length, which the copy is slowed to (``COPY_S``)."""
    import jax

    from repro_torch.core.batched_query import plan_segment_pairs

    jres, tres = fits
    jlog, tlog = traffic
    queries = tlog.queries[:60]
    plan = plan_segment_pairs(tres.hier_index, queries, track_work=False)
    if sharded:
        tsidx = T.sharded_device_index(tres.hier_index, devices=["cpu"] * 2)
        low = T.lower_plan_sharded(plan, tsidx)
        n_members = low.n_shards * low.n_cells  # the reference's (S, C) member cells
    else:
        low = T.lower_plan(plan)
        n_members = low.n_cells
    assert n_members not in (low.n_queries_pad, low.n_stages)  # counts, stage totals
    copies = []
    real_get = jax.device_get

    def slow_get(x):
        if getattr(x, "size", None) == n_members:
            copies.append(time.perf_counter())
            time.sleep(COPY_S)
        return real_get(x)

    real_members = T._members_to_host

    def slow_members(members):
        copies.append(time.perf_counter())
        time.sleep(COPY_S)
        return real_members(members)

    if sharded:
        jsidx = J.sharded_device_index(jres.hier_index, mesh=J.shard_mesh(2))
        runs = [lambda: J.sharded_device_counts(jres.hier_index, jlog.queries[:60], sidx=jsidx,
                                                return_docs=True),
                lambda: T.sharded_device_counts(tres.hier_index, queries, sidx=tsidx,
                                                return_docs=True)]
    else:
        runs = [lambda: J.device_counts(jres.hier_index, jlog.queries[:60], return_docs=True),
                lambda: T.device_counts(tres.hier_index, queries, return_docs=True,
                                        device="cpu")]
    for run in runs:
        run()  # the reference compiles its fold on the first call
    monkeypatch.setattr(jax, "device_get", slow_get)
    monkeypatch.setattr(T, "_members_to_host", slow_members)
    outs = []
    for package, run in zip(("reference", "port"), runs, strict=True):
        copies.clear()
        t0 = time.perf_counter()
        outs.append(run())
        info = outs[-1][2]
        window_end = t0 + info["t_plan_s"] + info["t_lower_s"] + info["t_fold_s"]
        assert len(copies) == 1 and copies[0] >= window_end, (package, t0, copies, info)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


# ----------------------------------------------------------------------
# The launcher's serving tier
# ----------------------------------------------------------------------


def test_launcher_serving_tier_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.search", "--device", "cpu", "--docs", "1500",
         "--k", "16", "--queries", "300", "--tc", "600", "--shards", "2", "--qps", "2000"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    for line in ("sharded engine [arity2]: 2 shards", "-- 2000 qps", "sealed replay of 300 queries",
                 "async replay of 300 queries", "-- chaos, 2000 qps",
                 "chaos shard_loss(0, at=2) over 400 queries: shards 2 -> 1, recovery batches 1 "
                 "(2:remesh)", "3 by the flood, 0 by a real backlog"):
        assert line in out.stdout, out.stdout
